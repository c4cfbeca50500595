"""Server roles of the port: the static and the dynamic cluster
(cluster.py); the coordinators (coordination.py), workers (worker.py) and
cluster controller (cluster_controller.py) that form the dynamic one; the
master's version authority and recovery (master.py), the proxies
(proxy.py, with admission.py and resolution_balance.py), the resolvers
(resolver.py), the tlogs (tlog.py, with log_system.py's interfaces and
peek cursor) and log routers (log_router.py), the storage servers
(storage.py, with watches.py, storage_metrics.py and systemdata.py), data
distribution and the Ratekeeper (data_distribution.py, movekeys.py), and
the messages they take and return (interfaces.py)."""

from .cluster import Cluster, ClusterConfig  # noqa: F401
