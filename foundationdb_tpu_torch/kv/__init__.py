"""Key-value core types of the port. So far the mutation wire types
(mutations.py) that a commit transaction carries."""
