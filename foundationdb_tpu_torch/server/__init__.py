"""Server roles of the port. So far the resolver (resolver.py), the tlog
(tlog.py, with log_system.py's interfaces and peek cursor) and the storage
server (storage.py, with watches.py, storage_metrics.py and systemdata.py),
and the messages they take and return (interfaces.py)."""
