"""TCP chaos soak: the cluster as real OS processes, kicked repeatedly.

The real-process sibling of tools/soak.py (which soaks the deterministic
simulator): boot a coordinator + workers as subprocesses over real TCP,
then run rounds of

    write a batch → SIGKILL a random worker → restart it on the SAME
    datadir (durable-role resurrection) → verify EVERY key ever written

Run: python -m foundationdb_tpu_torch.tools.tcp_soak [rounds] [seed] [--device cpu]

The port's copy of ``foundationdb_tpu/tools/tcp_soak.py``: the servers and
the fdbcli it spawns are the port's (``foundationdb_tpu_torch.tools.*``),
and every worker gets ``--device`` (``cuda`` by default: its resolvers and
storage servers run on the card). Each server writes its output to
``<name>.log`` in the cluster's datadir, where the reference pipes it to
a reader that only reads it once the server has died: under load that
pipe fills and stalls the server.
"""

from __future__ import annotations

import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_ports(n):
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def spawn_server(args, log_path):
    """One fdbserver process, its output appended to ``log_path`` (a
    restart on the same datadir continues the same log)."""
    with open(log_path, "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "foundationdb_tpu_torch.tools.fdbserver", *args],
            env=_env(),
            cwd=REPO,
            stdout=log,
            stderr=subprocess.STDOUT,
        )


def fdbcli(coordinators, *cmds, timeout=60):
    try:
        out = subprocess.run(
            [
                sys.executable,
                "-m",
                "foundationdb_tpu_torch.tools.cli",
                "-C",
                coordinators,
                *[a for c in cmds for a in ("--exec", c)],
                "--timeout",
                str(max(timeout - 10, 5)),
            ],
            env=_env(),
            cwd=REPO,
            capture_output=True,
            text=True,
            timeout=timeout,
        )
    except subprocess.TimeoutExpired as e:
        return -1, f"fdbcli timed out: {e.stdout or ''}"
    return out.returncode, out.stdout


class TcpCluster:
    """A real-process cluster: one coordinator + classed workers, each
    worker on ``device`` (``"cuda"``, the card, or ``"cpu"``)."""

    def __init__(self, datadir, config="n_storage=2,replication=1,n_tlogs=1",
                 classes=("storage", "storage", "transaction", "stateless"),
                 knobs=(), device="cuda"):
        self.datadir = datadir
        self.config = config
        self.device = device
        # server-side knob overrides ("NAME=value" strings, the fdbserver
        # --knob flag path) — the bench A/B drivers pin e.g.
        # STORAGE_EPOCH_BATCHING per leg through here
        knob_args = [a for kv in knobs for a in ("--knob", kv)]
        cport, *wports = free_ports(1 + len(classes))
        self.coord = f"127.0.0.1:{cport}"
        self.procs: dict[str, subprocess.Popen] = {}
        self.spawn_args: dict[str, list] = {}
        args = ["--listen", self.coord, "--role", "coordinator",
                "--datadir", os.path.join(datadir, "coord")] + knob_args
        self.spawn_args["coord"] = args
        self.procs["coord"] = spawn_server(args, self.log_path("coord"))
        for port, pclass in zip(wports, classes):
            name = f"{pclass}-{port}"
            args = [
                "--listen", f"127.0.0.1:{port}",
                "--role", "worker",
                "--class", pclass,
                "--coordinators", self.coord,
                "--config", config,
                "--datadir", os.path.join(datadir, name),
                "--device", device,
            ] + knob_args
            self.spawn_args[name] = args
            self.procs[name] = spawn_server(args, self.log_path(name))

    def log_path(self, name):
        """Where the server ``name`` writes its output."""
        return os.path.join(self.datadir, f"{name}.log")

    def output(self, name):
        with open(self.log_path(name), errors="replace") as f:
            return f.read()

    def check_alive(self, expect_dead=()):
        for name, p in self.procs.items():
            if name in expect_dead:
                continue
            if p.poll() is not None:
                out = self.output(name)
                raise AssertionError(
                    f"server {name} died rc={p.returncode}:\n{out[-4000:]}"
                )

    def kill(self, name):
        p = self.procs[name]
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=10)

    def restart(self, name):
        """Relaunch on the SAME datadir: durable roles resurrect from
        manifests (worker._rescan_disk)."""
        self.procs[name] = spawn_server(self.spawn_args[name], self.log_path(name))

    def kill_all(self):
        """SIGKILL the whole process tree, keeping every datadir — the
        restarting-test tier's save-and-kill (SaveAndKill.actor.cpp)."""
        for p in self.procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in self.procs.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    def restart_all(self):
        """Relaunch the ENTIRE cluster on the same ports + datadirs:
        coordinators recover the cstate, durable roles resurrect from
        manifests, and a recovery re-forms the database."""
        for name, args in self.spawn_args.items():
            self.procs[name] = spawn_server(args, self.log_path(name))

    def stop(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass


def wait_for(fn, deadline_s, what, cluster=None, expect_dead=()):
    deadline = time.time() + deadline_s
    while True:
        if cluster is not None:
            cluster.check_alive(expect_dead=expect_dead)
        ok, detail = fn()
        if ok:
            return detail
        if time.time() > deadline:
            raise AssertionError(f"{what}: {detail}")
        time.sleep(2)


def soak(rounds: int = 3, seed: int = 0, keys_per_round: int = 8,
         device: str = "cuda") -> None:
    rnd = random.Random(seed)
    with tempfile.TemporaryDirectory(prefix="fdbtpu-tcp-soak-") as datadir:
        cluster = TcpCluster(datadir, device=device)
        written: dict[str, str] = {}
        try:
            wait_for(
                lambda: (fdbcli(cluster.coord, "set boot ok", timeout=30)[0] == 0, "boot"),
                180,
                "cluster never formed",
                cluster,
            )
            written["boot"] = "ok"
            killable = [n for n in cluster.procs if n != "coord"]
            for r in range(rounds):
                for i in range(keys_per_round):
                    k, v = f"r{r}k{i}", f"v{r}.{i}"
                    rc, out = fdbcli(cluster.coord, f"set {k} {v}", timeout=30)
                    assert rc == 0, out
                    written[k] = v
                victim = rnd.choice(killable)
                print(f"round {r}: kill {victim}", flush=True)
                cluster.kill(victim)
                time.sleep(rnd.uniform(0.0, 2.0))
                cluster.restart(victim)
                # cluster heals (recovery if the victim hosted txn roles,
                # resurrection either way): a probe write must succeed
                wait_for(
                    lambda r=r: (
                        fdbcli(
                            cluster.coord, f"set probe{r} ok", timeout=30
                        )[0] == 0,
                        "probe",
                    ),
                    180,
                    f"round {r}: no recovery after killing {victim}",
                    cluster,
                )
                written[f"probe{r}"] = "ok"
                # every key ever written is still there (reads retried —
                # the cluster may still be settling right after recovery;
                # a MISSING key, however, fails immediately)
                items = sorted(written.items())
                for g in range(0, len(items), 16):
                    chunk = items[g : g + 16]

                    def read_chunk(chunk=chunk):
                        rc, out = fdbcli(
                            cluster.coord,
                            *[f"get {k}" for k, _ in chunk],
                            timeout=60,
                        )
                        return rc == 0, out

                    out = wait_for(
                        read_chunk,
                        120,
                        f"round {r}: reads never succeeded",
                        cluster,
                    )
                    for k, v in chunk:
                        assert v in out, f"round {r}: lost {k}={v}\n{out[-2000:]}"
                print(f"round {r}: {len(written)} keys verified", flush=True)
        finally:
            cluster.stop()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="tcp_soak")
    ap.add_argument("rounds", type=int, nargs="?", default=3)
    ap.add_argument("seed", type=int, nargs="?", default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    rounds = args.rounds
    soak(rounds=rounds, seed=args.seed, device=args.device)
    print(f"tcp soak: {rounds} rounds green")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
