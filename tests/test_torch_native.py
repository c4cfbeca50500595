"""The port's native skip list (foundationdb_tpu_torch/conflict/native.py,
built from the port's own skiplist_conflict.cpp) held against the JAX
package's NativeConflictSet and both packages' oracles: seeded random
batches with TOO_OLD snapshots, ``clear`` and ``boundary_count``, with
identical verdicts (exact equality). Building the port's library writes
only under its own build directory, never under foundationdb_tpu/native."""

import pathlib

import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict.api import CommitTransaction as JTxn
from foundationdb_tpu.conflict.native import NativeConflictSet as JNative
from foundationdb_tpu.conflict.oracle import OracleConflictSet as JOracle
from foundationdb_tpu_torch.conflict import native
from foundationdb_tpu_torch.conflict.api import CommitTransaction, Verdict, new_conflict_set

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _random_batches(seed, n_batches=10, n_txns=48, keyspace=120, window=4):
    """Seeded batches: 0-3 read and 0-3 write ranges a transaction over
    ``keyspace`` keys, snapshots up to ``window + 2`` batches old, so some
    are TOO_OLD once the horizon moves; versions step by 10."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n_batches):
        now = 100 + 10 * i
        txs = []
        for _ in range(n_txns):
            def ranges(k):
                a = rs.randint(0, keyspace, size=k)
                n = rs.randint(1, 8, size=k)
                return [(b"k%05d" % x, b"k%05d" % (x + m)) for x, m in zip(a, n)]

            txs.append(CommitTransaction(
                read_snapshot=int(now - 10 * rs.randint(1, window + 3)),
                read_conflict_ranges=ranges(rs.randint(0, 4)),
                write_conflict_ranges=ranges(rs.randint(0, 4)),
            ))
        out.append((txs, now, max(0, now - 10 * window)))
    return out


def _jtxs(txs):
    return [JTxn(t.read_snapshot, list(t.read_conflict_ranges), list(t.write_conflict_ranges))
            for t in txs]


class Four:
    """The port's native, the JAX native and both oracles, fed the same
    batches; every call asserts identical verdicts."""

    def __init__(self):
        self.port = new_conflict_set("native")
        self.jax = JNative()
        self.oracle = new_conflict_set("oracle")
        self.joracle = JOracle()

    def batch(self, txs, now, oldest):
        got = self.port.detect_batch(txs, now, oldest)
        want = [
            [Verdict(int(v)) for v in cs.detect_batch(_jtxs(txs), now, oldest)]
            for cs in (self.jax, self.joracle)
        ] + [self.oracle.detect_batch(txs, now, oldest)]
        for w in want:
            assert got == w
        assert self.port.boundary_count == self.jax.boundary_count
        assert self.port.oldest_version == self.jax.oldest_version
        return got

    def clear(self, version):
        for cs in (self.port, self.jax, self.oracle, self.joracle):
            cs.clear(version)
        assert self.port.boundary_count == self.jax.boundary_count


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_equals_jax_native_and_both_oracles(seed):
    four = Four()
    seen = set()
    for txs, now, oldest in _random_batches(seed):
        seen.update(four.batch(txs, now, oldest))
    assert seen == {Verdict.COMMITTED, Verdict.CONFLICT, Verdict.TOO_OLD}


def test_clear_and_too_old_after_clear():
    four = Four()
    batches = _random_batches(9, n_batches=6)
    for txs, now, oldest in batches[:3]:
        four.batch(txs, now, oldest)
    four.clear(130)
    # every snapshot below the cleared version is TOO_OLD where it reads
    txs, now, _old = batches[3]
    got = four.batch(txs, 140, 0)
    for t, v in zip(txs, got):
        if t.read_snapshot < 130 and t.read_conflict_ranges:
            assert v == Verdict.TOO_OLD
    for txs, now, oldest in batches[4:]:
        four.batch(txs, now + 100, oldest + 100)


def test_empty_and_blind_batches():
    four = Four()
    assert four.batch([], 10, 0) == []
    blind = [CommitTransaction(write_conflict_ranges=[(b"a", b"c")])]
    assert four.batch(blind, 20, 0) == [Verdict.COMMITTED]
    reader = [CommitTransaction(read_snapshot=15, read_conflict_ranges=[(b"b", b"b\x00")])]
    assert four.batch(reader, 30, 0) == [Verdict.CONFLICT]
    assert four.port.boundary_count >= 2


def _tree(path):
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in path.iterdir()}


def test_build_writes_only_the_ports_build_dir(tmp_path, monkeypatch):
    """A cold build goes to ``native.BUILD_DIR`` from the port's own source;
    the JAX package's native directory is not touched and no make runs."""
    jax_native = ROOT / "foundationdb_tpu" / "native"
    before = _tree(jax_native)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    path = native.lib_path()
    assert not path.exists()
    cs = native.NativeConflictSet()
    assert path.exists() and path.parent == tmp_path / "native"
    assert path.name.startswith("libskiplist_conflict-")
    assert [p.name for p in (tmp_path / "native").iterdir()] == [path.name]
    assert cs.detect_batch([CommitTransaction(write_conflict_ranges=[(b"a", b"b")])], 5, 0) == [
        Verdict.COMMITTED
    ]
    assert _tree(jax_native) == before
    assert native._SRC == ROOT / "foundationdb_tpu_torch" / "native" / "skiplist_conflict.cpp"


def test_default_build_dir_is_git_ignored_build():
    assert native.BUILD_DIR == ROOT / "build" / "native"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
