"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points default to the CUDA card and raise without one, and a
kernel wrapper never falls back to its plain version."""

import ast
import pathlib

import pytest
import torch

from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.conflict.api import new_conflict_set
from foundationdb_tpu_torch.device import resolve_device

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "foundationdb_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [
        name
        for name in _imports(path)
        if name.split(".")[0] in ("jax", "jaxlib", "foundationdb_tpu")
    ]
    assert not bad, f"{path.name} imports {bad}"


def _strings(path):
    """(line, value) of every string constant in ``path``, f-string parts
    included."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.lineno, node.value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_spawns_neither_jax_nor_the_jax_package(path):
    """A tool that spawns ``-m foundationdb_tpu.tools.fdbserver`` passes the
    import walk above while it runs the JAX package: no string of the port
    names a module of the JAX package, and none sets ``JAX_PLATFORMS``."""
    bad = [
        f"{path.name}:{line} {value[:60]!r}"
        for line, value in _strings(path)
        if value.startswith("foundationdb_tpu.") and not value.startswith("foundationdb_tpu_torch")
    ]
    assert not bad, bad
    assert "JAX_PLATFORMS" not in path.read_text(), f"{path.name} names JAX_PLATFORMS"


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        new_conflict_set("torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        new_conflict_set("torch", device="cuda")
    assert resolve_device("cpu").type == "cpu"


def test_mesh_backend_and_range_index_default_to_cuda():
    from foundationdb_tpu_torch.ops.range_index import TorchRangeIndex

    if torch.cuda.is_available():
        assert new_conflict_set("torch_mesh", capacity=1 << 10)._device.type == "cuda"
        assert TorchRangeIndex([b"k"])._codes.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        new_conflict_set("torch_mesh")
    with pytest.raises(RuntimeError, match="CUDA"):
        new_conflict_set("torch_mesh", n_parts=2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchRangeIndex([b"a", b"b"])
    assert TorchRangeIndex([b"a"], device="cpu").n == 1


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        new_conflict_set("tpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: no path to the plain
    version, and no build is attempted for a CPU tensor."""
    x = torch.zeros((8, 1, 3), dtype=torch.int32)
    grid = torch.zeros((8, 32, 4), dtype=torch.int32)
    b = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.history(torch.zeros((8, 3), dtype=torch.int32), grid, b, b, b, x, x, b)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.intra_batch(x, x, x, x, torch.zeros(8, dtype=torch.bool))
    # the staging wrappers, one grid and partitions
    w = torch.zeros((1, 8, 1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stage(w, w, torch.zeros(8, dtype=torch.bool), torch.zeros((1, 8, 3), dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stage_parts(w.repeat(2, 1, 1, 1), w.repeat(2, 1, 1, 1), torch.zeros(8, dtype=torch.bool),
                            torch.zeros((2, 8, 3), dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.maint_rebase(grid, b, b, 1)
    # the partitioned (K6, K7) and range-index (K5) wrappers
    g4 = torch.zeros((2, 8, 32, 4), dtype=torch.int32)
    b2 = torch.zeros((2, 8), dtype=torch.int32)
    bounds = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.history_parts(torch.zeros((2, 8, 3), dtype=torch.int32), g4, b2, b2, b2,
                              bounds, bounds, x, x, b)
    st = torch.zeros((4, 16, 3), dtype=torch.int32)
    u = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.merge_parts(grid.repeat(2, 1, 1), b.repeat(2), b.repeat(2), b.repeat(2),
                            st, st[..., 0], u, u, 1, 0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.maint_reshard_parts(g4, b2, b2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.maint_rebase_parts(g4, b2, b2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.search(torch.zeros((8, 3), dtype=torch.int32), torch.zeros((4, 3), dtype=torch.int32))
    assert kernels.launch_counts() == {name: 0 for name in kernels.WRAPPERS}


def _relative_imports(path):
    """(line, module, names) of every relative import in ``path``, at
    module level or inside a function body."""
    package = ".".join(path.relative_to(ROOT).with_suffix("").parts[:-1])
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            base = package.split(".")
            base = base[: len(base) - (node.level - 1)]
            module = ".".join(base + ([node.module] if node.module else []))
            yield node.lineno, module, [a.name for a in node.names]


@pytest.mark.parametrize(
    "path",
    [p for p in PORT_FILES if p.name != "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_every_relative_import_names_what_the_port_has(path):
    """A lazy import inside a function runs only when its line does: a
    module or name that the port does not have yet would show only then."""
    import importlib

    missing = []
    for line, module, names in _relative_imports(path):
        try:
            mod = importlib.import_module(module)
        except ImportError as e:
            missing.append(f"{path.name}:{line} {module} ({e})")
            continue
        for name in names:
            if hasattr(mod, name):
                continue
            try:
                importlib.import_module(f"{module}.{name}")
            except ImportError:
                missing.append(f"{path.name}:{line} {module}.{name}")
    assert not missing, missing
