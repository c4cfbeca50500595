"""The port's native B-tree engine (``foundationdb_tpu_torch/kv/native_engine.py``
over its own copy of ``btree_kvstore.cpp``) held to the JAX package's.

- The cases of ``tests/test_native_btree.py`` run on the port's engine.
- A seeded stream of sets, range clears and commits (keys up to 3,000
  bytes, so the tree grows three levels of pages; values past the 1,024-byte
  inline limit into overflow chains, one past the 1 MiB read buffer) goes
  through both packages' engines, each in its own file: every
  ``read_value`` and ``read_range`` along the way is equal, so are
  ``stats()`` and the files byte for byte but 4 unwritten bytes of each
  meta slot (the format does not depend on the build flags).
- Interop: a file committed by either package's engine reopens in the
  other's with the same rows.
- The port builds its library from its own source into ``build/native/``
  and never touches ``foundationdb_tpu/native``; a failed build raises.
"""

import os
import pathlib
import random
import struct

import numpy as np
import pytest

from foundationdb_tpu.kv.native_engine import KeyValueStoreBTree as JaxBTree
from foundationdb_tpu_torch.kv import native_engine
from foundationdb_tpu_torch.kv.native_engine import KeyValueStoreBTree

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAGE = 32768  # btree_kvstore.cpp PAGE_SIZE
META_MAGIC = 0xFDB7B7EE


@pytest.fixture
def path(tmp_path):
    return str(tmp_path / "test.btree")


def commit(bt):
    # the async commit never yields for the native engine; drive it inline
    coro = bt.commit()
    try:
        coro.send(None)
    except StopIteration:
        return
    raise AssertionError("native commit should not suspend")


def depth(path):
    """Levels of pages from the durable root to the leftmost leaf, read from
    the file (the newer valid meta slot, then each page's type and first
    child)."""
    with open(path, "rb") as f:
        data = f.read()
    metas = []
    for slot in (0, 1):
        magic, epoch, root = struct.unpack_from("<IQQ", data, slot * PAGE)
        if magic == META_MAGIC:
            metas.append((epoch, root))
    node = max(metas)[1]
    levels = 0
    while node:
        levels += 1
        kind, = struct.unpack_from("<H", data, node * PAGE + 8)
        if kind == 1:  # T_LEAF
            return levels
        node, = struct.unpack_from("<Q", data, node * PAGE + 12)
    return levels


# ---------------------------------------------------------------------------
# The cases of tests/test_native_btree.py, on the port's engine


def test_basic_crud(path):
    bt = KeyValueStoreBTree(path)
    bt.set(b"a", b"1")
    bt.set(b"b", b"2")
    bt.set(b"c", b"3")
    commit(bt)
    assert bt.read_value(b"a") == b"1"
    assert bt.read_value(b"b") == b"2"
    assert bt.read_value(b"zz") is None
    bt.set(b"b", b"22")
    assert bt.read_value(b"b") == b"22"
    bt.clear_range(b"a", b"b")
    assert bt.read_value(b"a") is None
    assert bt.read_range(b"", b"\xff") == [(b"b", b"22"), (b"c", b"3")]
    bt.close()


def test_many_keys_splits_and_range(path):
    bt = KeyValueStoreBTree(path)
    rnd = random.Random(7)
    keys = {}
    for i in range(5000):
        k = b"k%08d" % rnd.randrange(100000)
        v = bytes([i % 251]) * rnd.randrange(1, 80)
        keys[k] = v
        bt.set(k, v)
    commit(bt)
    assert bt.stats()["pages"] > 10  # multiple levels of pages exist
    for k, v in list(keys.items())[:200]:
        assert bt.read_value(k) == v
    assert bt.read_range(b"k", b"l") == sorted(keys.items())
    some = bt.read_range(b"k00001", b"k00002")
    assert some == sorted((k, v) for k, v in keys.items() if b"k00001" <= k < b"k00002")
    bt.close()


def test_overflow_values(path):
    rs = np.random.RandomState(3)
    big = rs.bytes(50_000)
    huge = rs.bytes(200_000)
    bt = KeyValueStoreBTree(path)
    bt.set(b"big", big)
    bt.set(b"huge", huge)
    bt.set(b"small", b"x")
    commit(bt)
    bt.close()
    bt = KeyValueStoreBTree(path)
    assert bt.read_value(b"big") == big
    assert bt.read_value(b"huge") == huge
    assert bt.read_value(b"small") == b"x"
    bt.close()


def test_persistence_across_reopen(path):
    bt = KeyValueStoreBTree(path)
    for i in range(1000):
        bt.set(b"p%04d" % i, b"v%d" % i)
    commit(bt)
    bt.clear_range(b"p0100", b"p0200")
    commit(bt)
    bt.close()
    bt = KeyValueStoreBTree(path)
    assert bt.read_value(b"p0050") == b"v50"
    assert bt.read_value(b"p0150") is None
    assert len(bt.read_range(b"p", b"q")) == 900
    assert len(bt) == 900
    bt.close()


def test_uncommitted_work_vanishes(path):
    bt = KeyValueStoreBTree(path)
    bt.set(b"committed", b"yes")
    commit(bt)
    bt.set(b"uncommitted", b"no")
    bt.clear_range(b"committed", b"committed\x00")
    bt.close()  # no commit: shadow pages unreachable from durable root
    bt = KeyValueStoreBTree(path)
    assert bt.read_value(b"committed") == b"yes"
    assert bt.read_value(b"uncommitted") is None
    bt.close()


def test_interleaved_clears_and_sets(path):
    bt = KeyValueStoreBTree(path)
    model = {}
    rnd = random.Random(13)
    for round_no in range(30):
        for _ in range(200):
            k = b"%05d" % rnd.randrange(3000)
            v = b"r%d" % round_no
            bt.set(k, v)
            model[k] = v
        if rnd.random() < 0.5:
            a = b"%05d" % rnd.randrange(3000)
            b = b"%05d" % rnd.randrange(3000)
            if a > b:
                a, b = b, a
            bt.clear_range(a, b)
            for k in [k for k in model if a <= k < b]:
                del model[k]
        commit(bt)
    assert bt.read_range(b"", b"\xff") == sorted(model.items())
    bt.close()
    bt = KeyValueStoreBTree(path)
    assert bt.read_range(b"", b"\xff") == sorted(model.items())
    bt.close()


# ---------------------------------------------------------------------------
# Both packages' engines on one seeded stream

VALUE_SIZES = (0, 5, 16, 200, 1024, 1025, 5000, 40_000)
HUGE = 1_500_000  # past the 1 MiB value buffer: read_value re-reads, read_range re-copies


def stream(seed, n_ops=1000):
    """(op, args) tuples: sets (keys of 6 to 3,006 bytes, values of the
    sizes above and one of ``HUGE`` bytes), clears of ranges of up to 40
    key prefixes, commits, and reads of points and ranges."""
    rs = np.random.RandomState(seed)

    def key():
        return b"k%05d" % rs.randint(0, 2000) + b"." * int(rs.choice([0, 40, 1000, 3000]))

    ops = []
    for i in range(n_ops):
        r = rs.rand()
        if i == n_ops // 2:
            ops.append(("set", key(), rs.bytes(HUGE)))
        elif r < 0.7:
            ops.append(("set", key(), rs.bytes(int(rs.choice(VALUE_SIZES)))))
        elif r < 0.75:
            n = rs.randint(0, 2000)
            ops.append(("clear_range", b"k%05d" % n, b"k%05d" % (n + rs.randint(1, 40))))
        elif r < 0.8:
            ops.append(("commit",))
        elif r < 0.92:
            ops.append(("read_value", key()))
        else:
            a, b = sorted((key(), key()))
            ops.append(("read_range", a, b, int(rs.randint(1, 50))))
    ops.append(("commit",))
    return ops


def replay(engine, ops):
    """Every read's answer, in order, and the stats after each commit."""
    out = []
    for op, *args in ops:
        if op == "set":
            engine.set(*args)
        elif op == "clear_range":
            engine.clear_range(*args)
        elif op == "commit":
            commit(engine)
            out.append(("stats", engine.stats()))
        elif op == "read_value":
            out.append((op, engine.read_value(*args)))
        else:
            b, e, limit = args
            out.append((op, engine.read_range(b, e, limit)))
    out.append(("all", engine.read_range(b"", b"\xff")))
    return out


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """The stream through each package's engine into its own file, closed."""
    d = tmp_path_factory.mktemp("btree_stream")
    ops = stream(seed=5)
    files, transcripts = {}, {}
    for name, cls in (("port", KeyValueStoreBTree), ("jax", JaxBTree)):
        files[name] = str(d / f"{name}.btree")
        bt = cls(files[name])
        transcripts[name] = replay(bt, ops)
        bt.close()
    return ops, files, transcripts


def test_stream_reads_and_stats_equal_the_jax_package(streamed):
    ops, files, transcripts = streamed
    port, jax = transcripts["port"], transcripts["jax"]
    assert port == jax
    # the stream reached what it is for: three levels, overflow values, the
    # huge value read back, partial range reads, and several epochs
    rows = port[-1][1]
    assert depth(files["port"]) >= 3
    assert max(len(k) for k, _v in rows) > 3000
    assert any(1024 < len(v) < HUGE for _k, v in rows)
    assert any(len(v) == HUGE for _k, v in rows) or any(
        op == "read_value" and v is not None and len(v) == HUGE for op, v in port)
    stats = [s for op, s in port if op == "stats"]
    assert stats[-1]["epoch"] == len(stats) > 5
    assert stats[-1]["pages"] > 1000 and stats[-1]["live_bytes"] > HUGE


def test_stream_files_are_byte_identical(streamed):
    """Every page equal; each meta slot equal in the 40 bytes the engine
    writes and reads (magic, epoch, root, page count, live bytes, crc):
    ``write_meta`` writes 44 bytes from a buffer it fills to 40, so the
    last 4 are whatever its stack held."""
    _ops, files, _t = streamed
    port, jax = (pathlib.Path(files[k]).read_bytes() for k in ("port", "jax"))
    assert len(port) == len(jax) > 1000 * PAGE
    assert port[2 * PAGE:] == jax[2 * PAGE:]
    for slot in (0, 1):
        at = slot * PAGE
        assert port[at:at + 40] == jax[at:at + 40]
        assert port[at + 44:at + PAGE] == jax[at + 44:at + PAGE]


@pytest.mark.parametrize("writer, reader", [("jax", KeyValueStoreBTree), ("port", JaxBTree)],
                         ids=["jax-file-in-port", "port-file-in-jax"])
def test_interop_both_ways(streamed, writer, reader):
    _ops, files, transcripts = streamed
    want = transcripts[writer][-1][1]
    bt = reader(files[writer])
    try:
        assert bt.read_range(b"", b"\xff") == want
        assert bt.stats() == transcripts[writer][-2][1]
        for k, v in want[::7]:
            assert bt.read_value(k) == v
    finally:
        bt.close()


def test_large_rows_grow_the_buffers(path):
    """``bt_get`` reports a value's true length and never truncates: a value
    over the 1 MiB buffer is re-read into a larger one; a range row over
    either buffer is held in the cursor and re-copied (``bt_cursor_current``)
    after the buffer grows, the key buffer too."""
    rs = np.random.RandomState(11)
    huge = rs.bytes(HUGE)
    long_key = b"L" * 8192  # the engine's largest key
    bt = KeyValueStoreBTree(path)
    bt.set(b"a", b"1")
    bt.set(b"huge", huge)
    bt.set(long_key, b"long")
    commit(bt)
    assert bt.read_value(b"huge") == huge and len(bt._vbuf) == HUGE
    bt._vbuf = native_engine.ctypes.create_string_buffer(16)
    bt._kbuf = native_engine.ctypes.create_string_buffer(4)
    assert bt.read_range(b"", b"\xff") == [(b"L" * 8192, b"long"), (b"a", b"1"), (b"huge", huge)]
    assert len(bt._kbuf) == 8192 and len(bt._vbuf) == HUGE
    with pytest.raises(ValueError, match="rc=-100"):
        bt.set(b"k" * 8193, b"too long")
    bt.close()


# ---------------------------------------------------------------------------
# The build


def _tree(path):
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in path.iterdir()}


def test_library_is_built_under_build_native():
    assert native_engine.BUILD_DIR == ROOT / "build" / "native"
    path = native_engine.lib_path()
    assert path.parent == ROOT / "build" / "native" and path.name.startswith("libbtree_kvstore-")
    assert native_engine._SRC == ROOT / "foundationdb_tpu_torch" / "native" / "btree_kvstore.cpp"
    assert native_engine._SRC.read_bytes() == (
        ROOT / "foundationdb_tpu" / "native" / "btree_kvstore.cpp").read_bytes()


def test_cold_build_writes_only_the_ports_build_dir(tmp_path, monkeypatch):
    jax_native = ROOT / "foundationdb_tpu" / "native"
    before = _tree(jax_native)
    monkeypatch.setattr(native_engine, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_engine, "_lib", None)
    path = native_engine.lib_path()
    assert not path.exists()
    bt = KeyValueStoreBTree(str(tmp_path / "db.btree"))
    bt.set(b"k", b"v")
    commit(bt)
    assert bt.read_value(b"k") == b"v"
    bt.close()
    assert [p.name for p in (tmp_path / "native").iterdir()] == [path.name]
    assert _tree(jax_native) == before


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails leaves no library and raises."""
    monkeypatch.setattr(native_engine, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_engine, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed for btree_kvstore.cpp"):
        KeyValueStoreBTree(str(tmp_path / "db.btree"))
    assert native_engine._lib is None
    assert not any((tmp_path / "native").iterdir())
    assert not os.path.exists(tmp_path / "db.btree")
