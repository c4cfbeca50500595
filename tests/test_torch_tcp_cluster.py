"""The port's cluster as real OS processes over TCP, the cases of
``tests/test_tcp_cluster.py``, ``test_fdbmonitor.py`` and
``test_tcp_soak.py`` and the two real-process cases of
``test_blobstore.py`` and ``test_chaos_extra.py``: the port's
``fdbserver`` processes (``--device cpu``), spawned by the port's
``tools.tcp_soak`` and ``tools.fdbmonitor``, driven by the port's ``cli``.
Then interop with the JAX package, spawned only as a subprocess: its
``cli`` sets and gets keys on a port cluster, and the port's ``cli`` on a
JAX cluster. And a worker without a card refuses to run; ``perf``'s
``tcp`` and ``tcp-inproc`` modes report what the JAX package's do."""

import os
import signal
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from foundationdb_tpu_torch.tools import tcp_soak as port_soak
from foundationdb_tpu_torch.tools.blobserver import RealBlobServer
from foundationdb_tpu_torch.tools.tcp_soak import TcpCluster, fdbcli, free_ports, wait_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = "foundationdb_tpu"
PORT = "foundationdb_tpu_torch"

torch.set_num_threads(1)  # the suite runs in several xdist workers


@pytest.fixture(autouse=True)
def one_thread_children(monkeypatch):
    """Every server and cli the tests spawn runs one torch thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def formed(cluster, key="boot", deadline=240):
    wait_for(lambda: (fdbcli(cluster.coord, f"set {key} ok", timeout=45)[0] == 0, key), deadline,
             "cluster never formed", cluster)


def test_tcp_cluster_boot_commit_kill_recover():
    """Boot a coordinator and four workers, commit through the port's cli,
    SIGKILL the stateless worker (the cluster controller's and master's
    preference), recover on the survivors and serve everything; then the
    JAX package's cli reads and writes the same cluster."""
    from foundationdb_tpu.tools.tcp_soak import fdbcli as jax_fdbcli

    with tempfile.TemporaryDirectory(prefix="torch-tcp-") as d:
        cluster = TcpCluster(d, device="cpu")
        try:
            formed(cluster, "hello")
            rc, out = fdbcli(cluster.coord, "get hello")
            assert rc == 0 and "`ok'" in out, out
            rc, out = fdbcli(cluster.coord, *[f"set k{i} v{i}" for i in range(5)])
            assert rc == 0, out
            victim = next(n for n in cluster.procs if n.startswith("stateless"))
            cluster.kill(victim)
            wait_for(lambda: (fdbcli(cluster.coord, "set after-kill yes", timeout=45)[0] == 0, "recovery"),
                     240, "no recovery", cluster, expect_dead=(victim,))
            rc, out = fdbcli(cluster.coord, "get hello", "get k3", "get after-kill", timeout=60)
            assert rc == 0 and "`ok'" in out and "v3" in out and "yes" in out, out
            # interop: the JAX package's cli on the port's cluster
            rc, out = jax_fdbcli(cluster.coord, "set from-jax cli", "get k4", "get after-kill", timeout=60)
            assert rc == 0 and "Committed" in out and "v4" in out and "yes" in out, out
            rc, out = fdbcli(cluster.coord, "get from-jax", timeout=45)
            assert rc == 0 and "`cli'" in out, out
            cluster.check_alive(expect_dead=(victim,))
        finally:
            cluster.stop()


def test_the_port_cli_on_a_jax_cluster():
    """Interop the other way: the port's cli sets and gets keys on a
    cluster of the JAX package's processes."""
    from foundationdb_tpu.tools.tcp_soak import TcpCluster as JaxCluster
    from foundationdb_tpu.tools.tcp_soak import fdbcli as jax_fdbcli

    with tempfile.TemporaryDirectory(prefix="jax-tcp-") as d:
        cluster = JaxCluster(d)
        try:
            wait_for(lambda: (jax_fdbcli(cluster.coord, "set boot ok", timeout=45)[0] == 0, "boot"), 240,
                     "cluster never formed", cluster)
            rc, out = fdbcli(cluster.coord, "set from-port cli", "get boot", "getrange a z 5", timeout=60)
            assert rc == 0 and "Committed" in out and "`ok'" in out and "`from-port' is `cli'" in out, out
            rc, out = jax_fdbcli(cluster.coord, "get from-port", timeout=45)
            assert rc == 0 and "`cli'" in out, out
            cluster.check_alive()
        finally:
            cluster.stop()


def test_fdbmonitor_supervises_cluster(tmp_path):
    """The port's fdbmonitor launches the conf's servers (``device = cpu``
    in [general]), restarts a SIGKILLed one, and stops them all on
    SIGTERM."""
    cport, w1, w2 = free_ports(3)
    coord = f"127.0.0.1:{cport}"
    conf = tmp_path / "cluster.conf"
    conf.write_text(f"""
[general]
restart_delay = 1
cluster_coordinators = {coord}
config = n_storage=1,replication=1,n_tlogs=1
device = cpu

[fdbserver.{cport}]
role = coordinator
listen = {coord}
datadir = {tmp_path}/c

[fdbserver.{w1}]
listen = 127.0.0.1:{w1}
class = storage
datadir = {tmp_path}/w1

[fdbserver.{w2}]
listen = 127.0.0.1:{w2}
class = stateless
datadir = {tmp_path}/w2
""")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    mon = subprocess.Popen(
        [sys.executable, "-m", f"{PORT}.tools.fdbmonitor", "--conffile", str(conf), "--poll-interval", "0.5"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.time() + 240
        while True:
            assert mon.poll() is None, mon.stdout.read()
            rc, out = fdbcli(coord, "set mon ok", timeout=45)
            if rc == 0:
                break
            assert time.time() < deadline, f"cluster never formed: {out}"
            time.sleep(2)
        out = subprocess.run(["pkill", "-9", "-f", f"{PORT}.tools.fdbserver.*{w1}"], capture_output=True)
        assert out.returncode == 0, "no child matched pkill"
        deadline = time.time() + 240
        while True:
            assert mon.poll() is None
            rc, out = fdbcli(coord, "get mon", timeout=45)
            if rc == 0 and "ok" in out:
                break
            assert time.time() < deadline, f"no recovery: {out}"
            time.sleep(2)
        mon.send_signal(signal.SIGTERM)
        mon.wait(timeout=30)
        text = mon.stdout.read()
        assert "exited rc=-9" in text and "stopping children" in text, text
    finally:
        if mon.poll() is None:
            mon.kill()
        for port in (cport, w1, w2):
            subprocess.run(["pkill", "-9", "-f", f"fdbserver.*{port}"], capture_output=True)


def test_tcp_soak_two_rounds():
    port_soak.soak(rounds=2, seed=1, keys_per_round=5, device="cpu")


def test_tcp_cluster_backup_to_real_blobstore():
    """A port cluster backs up to the port's live blob server through the
    cli's blobstore:// URL, and restores."""
    srv = RealBlobServer(port=0).start()
    with tempfile.TemporaryDirectory(prefix="torch-blob-tcp-") as d:
        cluster = TcpCluster(d, device="cpu")
        try:
            formed(cluster, "seed")
            rc, out = fdbcli(cluster.coord, "set bk1 v1", "set bk2 v2", timeout=45)
            assert rc == 0, out
            url = f"blobstore://127.0.0.1:{srv.port}/bkt/t1"
            rc, out = fdbcli(cluster.coord, f"backup start {url}", timeout=90)
            assert rc == 0, out
            assert any(k.startswith("t1/snap/") for (_b, k) in srv.core.objects), sorted(srv.core.objects)
            rc, out = fdbcli(cluster.coord, "set bk1 clobbered", timeout=45)
            assert rc == 0, out
            rc, out = fdbcli(cluster.coord, f"restore {url}", timeout=90)
            assert rc == 0, out
            rc, out = fdbcli(cluster.coord, "get bk1", "get bk2", timeout=45)
            assert rc == 0 and "v1" in out and "v2" in out, out
        finally:
            cluster.stop()
            srv.stop()


def test_tcp_cluster_save_kill_restart():
    """SIGKILL the whole tree, restart it on the same datadirs and ports:
    everything written before the kill is there, and writes go on."""
    with tempfile.TemporaryDirectory(prefix="torch-restart-tier-") as d:
        cluster = TcpCluster(d, device="cpu")
        try:
            formed(cluster)
            rc, out = fdbcli(cluster.coord, *[f"set rk{i} v{i}" for i in range(8)], timeout=60)
            assert rc == 0, out
            cluster.kill_all()
            cluster.restart_all()
            wait_for(lambda: (fdbcli(cluster.coord, "set reborn ok", timeout=45)[0] == 0, "reform"), 240,
                     "cluster never re-formed after full restart", cluster)
            rc, out = fdbcli(cluster.coord, *[f"get rk{i}" for i in range(8)], timeout=60)
            assert rc == 0, out
            for i in range(8):
                assert f"v{i}" in out, f"lost rk{i} after full restart:\n{out}"
        finally:
            cluster.stop()


def test_a_worker_without_a_card_exits_with_device_unavailable():
    """``--device cuda`` is the default; without a card the worker exits
    non-zero with ``DeviceUnavailableError`` before it serves anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    cport, wport = free_ports(2)
    out = subprocess.run(
        [sys.executable, "-m", f"{PORT}.tools.fdbserver", "--listen", f"127.0.0.1:{wport}", "--role", "worker",
         "--coordinators", f"127.0.0.1:{cport}"],
        env=port_soak._env(), cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "DeviceUnavailableError" in out.stderr, out.stderr[-2000:]
    assert "listening" not in out.stdout


def run_perf(pkg, argv):
    import json

    out = subprocess.run([sys.executable, "-m", f"{pkg}.tools.perf", *argv], env=port_soak._env(), cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads([line for line in out.stdout.splitlines() if line.startswith("{")][-1])


COUNTS = ("ops", "reads", "writes", "commits")


@pytest.mark.parametrize("extra", [[], ["--no-loopback"]], ids=["loopback", "sockets"])
def test_perf_tcp_inproc_mode(extra):
    """The whole cluster as RealWorlds on one RealLoop in one process: the
    port's run commits every transaction the JAX package's does, with the
    same report keys, over loopback or over sockets."""
    argv = ["--mode", "tcp-inproc", "--actors", "3", "--txns", "4", "--keyspace", "100", *extra]
    ref = run_perf(REFERENCE, argv)
    port = run_perf(PORT, argv + ["--device", "cpu"])
    assert set(port) == set(ref)
    assert {k: port[k] for k in COUNTS} == {k: ref[k] for k in COUNTS}
    assert port["commits"] == 12 and port["transport_knobs"] == ref["transport_knobs"]
    totals = [sum(s.get("loopbackMessages", 0) for s in port["transport"].values()),
              sum(s.get("tcpMessages", 0) for s in port["transport"].values())]
    assert (totals[0] > 0) == (not extra) and (totals[1] > 0) == bool(extra), totals


def test_perf_tcp_mode_with_a_client_process():
    """``--mode tcp``: a real-process cluster of the port's servers and one
    client process; every key of the bulk load is written."""
    port = run_perf(PORT, ["--mode", "tcp", "--workload", "bulkload", "--actors", "2", "--txns", "2",
                           "--keys-per-txn", "10", "--client-procs", "1", "--device", "cpu"])
    assert port["writes"] == 2 * 2 * 10 and port["client_procs"] == 1 and port["mode"] == "tcp"
