"""Server roles of the port: the static cluster (cluster.py) that wires the
master's version authority (master.py), the proxies (proxy.py, with
admission.py and resolution_balance.py), the resolvers (resolver.py), the
tlogs (tlog.py, with log_system.py's interfaces and peek cursor) and the
storage servers (storage.py, with watches.py, storage_metrics.py and
systemdata.py), and the messages they take and return (interfaces.py)."""

from .cluster import Cluster, ClusterConfig  # noqa: F401
