"""The port's backup (``foundationdb_tpu_torch/backup/``: container, agent,
blob store) and HTTP codec (``net/http.py``) held against the JAX
package's on the CPU: each case of ``tests/test_backup.py`` and of
``tests/test_blobstore.py`` but the one that needs ``net/tcp.py`` gives
the same transcript in both packages (``tests/workload_slice.py``), the
cluster cases with ``oracle`` resolvers and with the port's ``torch``
against the JAX ``tpu1``. The real-socket case runs each package's HTTP
client and blob store over a localhost connection on an ephemeral port."""

import pytest
import torch

import workload_slice as WS

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

PURE = ("http_framing", "url_parse", "blob_crud_over_sim", "container_log_seq", "open_container_dispatch")
CLUSTER = ("taskbucket", "backup_restore_roundtrip", "dr_second_cluster", "backup_through_blobstore",
           "backup_through_blobstore_under_chaos")


def _same(case, backend="oracle"):
    port = WS.run_case(WS.PORT, case, backend)
    assert port == WS.run_case(WS.REFERENCE, case, backend)
    return port["rec"]


@pytest.mark.parametrize("case", PURE)
def test_http_and_blob_store_cases_equal_the_reference(case):
    rec = _same(case)
    if case == "blob_crud_over_sim":
        assert rec[:2] == [[b"one", None, ["a/1", "a/2"], ["a/1", "a/2", "b/1"]], [None, ["a/2"]]]
    if case == "container_log_seq":
        assert rec[0] == [[[b"k1", b"m1"], [b"k2", b"m2"]]]


@pytest.mark.parametrize("backend", ["oracle", "torch"])
@pytest.mark.parametrize("case", CLUSTER)
def test_backup_cases_on_a_cluster_equal_the_reference(case, backend):
    rec = _same(case, backend)
    if case == "backup_restore_roundtrip":
        (source, n, restored), _now = rec
        assert n > 0 and restored == source and [b"base001", b"overwritten"] in restored
    if case == "dr_second_cluster":
        (src, dst), _now = rec
        assert dst == src and [b"k001", b"changed"] in dst
    if case.startswith("backup_through"):
        assert ("ok", True) in [tuple(kv) for kv in rec[-1][1]]


def _blob_crud_over_real_http(pkg):
    """The reference test's round trips through ``pkg``'s RealLoop, HTTP
    client and blob store core, served by a localhost socket thread."""
    import importlib
    import socket
    import threading

    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    http, bs, L = m("net.http"), m("backup.blobstore"), m("runtime.loop")
    core = bs.BlobStoreServer()
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            with conn:
                buf = b""
                while http.parse_request(buf) is None:
                    data = conn.recv(1 << 16)
                    if not data:
                        break
                    buf += data
                conn.sendall(core.handle_raw(buf))

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    loop = L.RealLoop(seed=9)
    L.set_loop(loop)
    out = []
    try:
        cl = bs.BlobStoreClient(http.RealHttpTransport(loop, "127.0.0.1", srv.getsockname()[1]), "bkt")

        async def go():
            await cl.put("x/1", b"alpha")
            await cl.put("x/2", b"beta" * 10_000)  # a response over several reads
            out.append((await cl.get("x/1"), await cl.get("x/2"), await cl.list("x/")))
            await cl.delete("x/1")
            out.append((await cl.get("x/1"), await cl.list()))
            return True

        fut = m("runtime.futures").spawn(go())
        loop.run(until=loop.now() + 30.0, stop_when=fut.is_ready)
        assert fut.is_ready() and fut.get()
        return out
    finally:
        srv.close()
        thread.join(10.0)
        L.set_loop(None)
        loop.close()


def test_blob_crud_over_real_http_equals_the_reference():
    port = _blob_crud_over_real_http(WS.PORT)
    assert port == _blob_crud_over_real_http(WS.REFERENCE)
    assert port == [(b"alpha", b"beta" * 10_000, ["x/1", "x/2"]), (None, ["x/2"])]
