"""Server roles of the port. So far the resolver (resolver.py) and the
messages it takes and returns (interfaces.py)."""
