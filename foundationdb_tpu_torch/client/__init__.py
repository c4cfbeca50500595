"""Client API: Database / Transaction with read-your-writes semantics.

The analog of fdbclient's NativeAPI + ReadYourWrites (the semantics every
binding exposes — SURVEY.md §1 L2).
"""

from ..kv.selector import KeySelector  # noqa: F401
from .database import Database  # noqa: F401
from .transaction import Transaction, key_after, strinc  # noqa: F401
