"""Device choice and the lane convention of the PyTorch port.

**Device.** Entry points run on the CUDA card unless the caller asks for
the CPU. ``resolve_device()`` returns ``cuda`` by default and raises when
no card is visible; the CPU is used only when the caller passes
``device="cpu"`` (the tests do). There is no silent CPU fallback.

**Lanes.** Key codes are big-endian uint32 lanes (conflict/keys.py). Torch
on the CPU has no ordering compares for ``UInt32``, so lanes live in
``torch.int32`` tensors that carry the uint32 bit pattern
(``np_u32.view(np.int32)``). Conversion happens only at the numpy boundary
(``lanes_to_torch`` / ``lanes_to_numpy``). The plain versions compare lanes
as ``x ^ INT32_MIN`` (``ordered``), which maps unsigned order onto signed
order; the CUDA kernels read the same bytes as ``uint32_t``. The all-0xFF
sentinel is ``-1`` in the int32 view (``SENTINEL``): every equality test
against the sentinel uses that value.
"""

from __future__ import annotations

import numpy as np
import torch

from .conflict.errors import DeviceUnavailableError

SENTINEL = -1  # 0xFFFFFFFF seen through the int32 view
INT32_MIN = -(1 << 31)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Raises ``DeviceUnavailableError`` when
    CUDA is asked for (by default or explicitly) and no card is visible, or
    ``cuda:N`` names a card past the visible ones."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        raise DeviceUnavailableError(
            f"{dev} requested but {torch.cuda.device_count()} CUDA card(s) are visible"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def ordered(x: torch.Tensor) -> torch.Tensor:
    """int32 lanes whose signed order equals the uint32 order of the bits."""
    return x ^ INT32_MIN


def lanes_to_torch(a: np.ndarray, device=None) -> torch.Tensor:
    """uint32 (or int32) numpy array → int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def lanes_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 lane tensor → uint32 numpy array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
