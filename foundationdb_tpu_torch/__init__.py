"""PyTorch/CUDA port of foundationdb_tpu's device path.

The resolver's MVCC conflict check (``conflict.api.new_conflict_set("torch")``,
or split into key-range partitions with ``"torch_mesh"``) and the storage
range index (``ops.range_index.TorchRangeIndex``) run on an NVIDIA Hopper card
through hand-written CUDA kernels (``conflict/kernels/csrc``), with a plain
PyTorch version of every kernel for tensors that lie on the CPU. Above them
run the resolver role (``server.resolver``), the storage role fed by its
tlog (``server.storage``, ``server.tlog``) and the commit path that joins
them in a static cluster (``server.Cluster``: master, proxies, resolvers,
tlogs, storage) with its client (``client.Database``), the dynamic
cluster that recovers from failures (``server.cluster.DynamicCluster``),
on the deterministic simulator (``net.sim``), the seeded chaos soak
that drives it (``tools.soak`` over ``workloads``, ``backup`` and
``layers``), the same cluster as real OS processes over TCP
(``net.tcp``, ``tools.fdbserver`` with ``--device``, ``tools.cli``,
``tools.fdbmonitor``, ``tools.tcp_soak``, ``tools.perf``) and the
bindingtester (``bindings``). The package imports torch and numpy only.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
