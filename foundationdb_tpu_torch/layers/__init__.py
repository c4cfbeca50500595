"""Layers: the keyspace-structuring helpers every binding ships.

The analog of fdbclient/Tuple.cpp + Subspace.cpp and the bindings'
directory layer (bindings/python/fdb/tuple.py, subspace_impl.py,
directory_impl.py)."""

from .tuple import pack, unpack, range_of  # noqa: F401
from .subspace import Subspace  # noqa: F401
from .directory import DirectoryLayer  # noqa: F401
from .pubsub import Topic  # noqa: F401
