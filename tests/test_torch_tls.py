"""Mutual TLS on the port's real-TCP transport, the cases of
``tests/test_tls.py``: TLS request/reply between processes (also between a
port process and a JAX-package process, both ways), plaintext and wrong-CA
rejection; a TLS cluster of the port's ``fdbserver`` processes (``--device
cpu``) that serves an authed port ``cli`` and refuses the others; and one
that elects, recruits and recovers, from its trace files. Certificates come
from the local ``openssl`` CLI."""

import json
import os
import socket
import ssl
import subprocess
import sys
import time

import pytest

from test_tls import _CLIENT, _SERVER, gen_ca_and_cert

from foundationdb_tpu_torch.tools.tcp_soak import free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = "foundationdb_tpu"
PORT = "foundationdb_tpu_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def script(template: str, pkg: str, **kw) -> str:
    """``tests/test_tls.py``'s server or client script, in ``pkg``."""
    return template.format(repo=REPO, **kw).replace("from foundationdb_tpu.", f"from {pkg}.")


@pytest.mark.parametrize(
    "server_pkg, client_pkg",
    [(PORT, PORT), (REFERENCE, PORT), (PORT, REFERENCE)],
    ids=["port-port", "jax-server-port-client", "port-server-jax-client"],
)
def test_tls_transport_request_reply(tmp_path, server_pkg, client_pkg):
    crt, key, ca = gen_ca_and_cert(str(tmp_path))
    (port,) = free_ports(1)
    target = f"127.0.0.1:{port}"
    srv = subprocess.Popen(
        [sys.executable, "-c", script(_SERVER, server_pkg, listen=target, crt=crt, key=key, ca=ca)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.time() + 60
        while "up" not in (srv.stdout.readline() or ""):
            assert srv.poll() is None and time.time() < deadline
        out = subprocess.run(
            [sys.executable, "-c", script(_CLIENT, client_pkg, target=target, crt=crt, key=key, ca=ca)],
            env=_env(), capture_output=True, text=True, timeout=120,
        )
        assert "OK 6" in out.stdout, (out.stdout, out.stderr[-500:])
        if server_pkg != PORT:
            return
        # plaintext peer: nothing intelligible, or dropped
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        s.settimeout(3)
        s.sendall(b"not a tls hello")
        try:
            data = s.recv(100)
            assert data == b"" or b"127.0.0.1" not in data, data
        except (socket.timeout, ConnectionError):
            pass
        finally:
            s.close()
        # wrong CA: mutual auth rejects the handshake
        wrong_crt, wrong_key, wrong_ca = gen_ca_and_cert(str(tmp_path), name="intruder")
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_cert_chain(wrong_crt, wrong_key)
        ctx.load_verify_locations(wrong_ca)
        ctx.check_hostname = False
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        s.settimeout(5)
        try:
            with ctx.wrap_socket(s) as w:
                w.recv(100)
            raise AssertionError("wrong-CA handshake unexpectedly succeeded")
        except (ssl.SSLError, socket.timeout, ConnectionError):
            pass
        finally:
            s.close()
    finally:
        srv.kill()
        try:
            srv.wait(timeout=5)
        except subprocess.TimeoutExpired:
            pass


def fdbcli(coordinators, *cmds, tls3=None, timeout=60):
    extra = []
    if tls3:
        crt, key, ca = tls3
        extra = ["--tls-cert", crt, "--tls-key", key, "--tls-ca", ca]
    try:
        out = subprocess.run(
            [sys.executable, "-m", f"{PORT}.tools.cli", "-C", coordinators,
             *[a for c in cmds for a in ("--exec", c)], "--timeout", str(max(timeout - 10, 5)), *extra],
            env=_env(), cwd=REPO, capture_output=True, text=True, timeout=timeout,
        )
    except subprocess.TimeoutExpired as e:
        return -1, f"timed out: {e.stdout or ''}"
    return out.returncode, out.stdout


def boot_tls_cluster(tmp_path, tls3, traces=None):
    crt, key, ca = tls3
    cport, w1, w2 = free_ports(3)
    coord = f"127.0.0.1:{cport}"

    def boot(args, i):
        extra = ["--tracefile", traces[i]] if traces else []
        return subprocess.Popen(
            [sys.executable, "-m", f"{PORT}.tools.fdbserver", *args, *extra,
             "--tls-cert", crt, "--tls-key", key, "--tls-ca", ca],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

    procs = [boot(["--listen", coord, "--role", "coordinator", "--datadir", str(tmp_path / "c")], 0)]
    for i, (port, pclass) in enumerate(((w1, "storage"), (w2, "stateless")), 1):
        procs.append(boot([
            "--listen", f"127.0.0.1:{port}", "--role", "worker", "--class", pclass,
            "--coordinators", coord, "--config", "n_storage=1,replication=1,n_tlogs=1",
            "--datadir", str(tmp_path / f"w{port}"), "--device", "cpu",
        ], i))
    return coord, procs


def stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=5)
        except subprocess.TimeoutExpired:
            pass


def test_tls_cluster_serves_and_rejects(tmp_path):
    """The port's TLS cluster serves an authed port ``cli``; plaintext and
    wrong-CA clients get nothing."""
    tls3 = gen_ca_and_cert(str(tmp_path))
    wrong3 = gen_ca_and_cert(str(tmp_path), name="intruder")
    coord, procs = boot_tls_cluster(tmp_path, tls3)
    try:
        deadline = time.time() + 240
        while True:
            for p in procs:
                assert p.poll() is None, p.stdout.read()
            rc, out = fdbcli(coord, "set sec ure", tls3=tls3, timeout=45)
            if rc == 0:
                break
            assert time.time() < deadline, f"TLS cluster never formed: {out}"
            time.sleep(2)
        rc, out = fdbcli(coord, "get sec", tls3=tls3)
        assert rc == 0 and "ure" in out, out
        rc, out = fdbcli(coord, "get sec", tls3=None, timeout=25)
        assert rc != 0 or "ure" not in out, out
        rc, out = fdbcli(coord, "get sec", tls3=wrong3, timeout=25)
        assert rc != 0 or "ure" not in out, out
    finally:
        stop(procs)


def test_tls_cluster_forms(tmp_path):
    """A mutual-TLS cluster of the port's processes elects, recruits every
    role and fully recovers (from the trace files)."""
    tls3 = gen_ca_and_cert(str(tmp_path))
    traces = [str(tmp_path / f"t{i}.trace") for i in range(3)]
    coord, procs = boot_tls_cluster(tmp_path, tls3, traces)
    try:
        deadline = time.time() + 240
        while True:
            for p in procs:
                assert p.poll() is None, p.stdout.read()
            types = set()
            for tf in traces:
                try:
                    with open(tf) as f:
                        for line in f:
                            types.add(json.loads(line)["Type"])
                except FileNotFoundError:
                    pass
            if "MasterFullyRecovered" in types:
                break
            assert time.time() < deadline, f"no recovery over TLS: {sorted(types)}"
            time.sleep(2)
        assert "ElectionWon" in types and "RoleRecruited" in types
    finally:
        stop(procs)
