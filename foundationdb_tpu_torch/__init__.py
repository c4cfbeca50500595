"""PyTorch/CUDA port of foundationdb_tpu's device path.

The resolver's MVCC conflict check (``conflict.api.new_conflict_set("torch")``,
or split into key-range partitions with ``"torch_mesh"``) and the storage
range index (``ops.range_index.TorchRangeIndex``) run on an NVIDIA Hopper card
through hand-written CUDA kernels (``conflict/kernels/csrc``), with a plain
PyTorch version of every kernel for tensors that lie on the CPU. The package
imports torch and numpy only.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
