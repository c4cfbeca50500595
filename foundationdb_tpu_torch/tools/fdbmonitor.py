"""fdbmonitor: supervise a machine's fdbserver processes.

The analog of fdbmonitor/fdbmonitor.cpp: read a foundationdb.conf-style
INI, launch one fdbserver per [fdbserver.<N>] section, restart any child
that exits (with backoff doubling up to a cap, reset after a stable run),
forward SIGTERM/SIGINT to the children, and log lifecycle events.

  python -m foundationdb_tpu_torch.tools.fdbmonitor --conffile cluster.conf

Config format (a trimmed foundationdb.conf):

    [general]
    restart_delay = 5
    cluster_coordinators = 127.0.0.1:4500

    [fdbserver.4500]
    role = coordinator
    listen = 127.0.0.1:4500
    datadir = /var/lib/fdbtpu/4500

    [fdbserver.4600]
    listen = 127.0.0.1:4600
    class = storage
    datadir = /var/lib/fdbtpu/4600

The port's copy of ``foundationdb_tpu/tools/fdbmonitor.py``: it launches
the port's fdbserver, and a section's (or [general]'s) ``device`` key
(``cuda``, the default, or ``cpu``) becomes a worker's ``--device``.
"""

from __future__ import annotations

import configparser
import signal
import subprocess
import sys
import time


def build_args(section: dict, general: dict) -> list[str]:
    args = ["--listen", section["listen"]]
    role = section.get("role", "worker")
    args += ["--role", role]
    if role == "worker":
        coords = section.get(
            "coordinators", general.get("cluster_coordinators", "")
        )
        args += ["--coordinators", coords]
        if section.get("class"):
            args += ["--class", section["class"]]
        if section.get("config", general.get("config")):
            args += ["--config", section.get("config", general.get("config"))]
        if section.get("device", general.get("device")):
            args += ["--device", section.get("device", general.get("device"))]
    for key in ("datadir", "zone", "dc", "tracefile"):
        val = section.get(key)
        if val:
            args += [f"--{key}", val]
    return args


class _Child:
    def __init__(self, name: str, args: list[str], restart_delay: float):
        self.name = name
        self.args = args
        self.base_delay = restart_delay
        self.delay = restart_delay
        self.proc: subprocess.Popen = None
        self.started_at = 0.0
        self.restart_at: float = None  # pending-restart deadline

    def start(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "foundationdb_tpu_torch.tools.fdbserver", *self.args]
        )
        self.started_at = time.time()
        print(
            f"fdbmonitor: started {self.name} pid={self.proc.pid}", flush=True
        )

    def poll_and_restart(self):
        # deadline-based, never sleeps: one child's 60s backoff must not
        # stall restarts of the other children or signal handling for the
        # whole window (the monitor loop stays responsive at poll period)
        if self.restart_at is not None:
            if time.time() >= self.restart_at:
                self.restart_at = None
                self.delay = min(self.delay * 2, 60.0)
                self.start()
            return
        if self.proc.poll() is None:
            return
        rc = self.proc.returncode
        ran_for = time.time() - self.started_at
        # a stable run resets the backoff (fdbmonitor's RESET_AFTER)
        if ran_for > 60:
            self.delay = self.base_delay
        print(
            f"fdbmonitor: {self.name} exited rc={rc} after {ran_for:.1f}s; "
            f"restarting in {self.delay:.1f}s",
            flush=True,
        )
        self.restart_at = time.time() + self.delay

    def stop(self, sig=signal.SIGTERM):
        if self.proc and self.proc.poll() is None:
            self.proc.send_signal(sig)

    def wait(self, timeout=10.0):
        if self.proc is None:
            return
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="fdbmonitor")
    ap.add_argument("--conffile", required=True)
    ap.add_argument(
        "--poll-interval", type=float, default=1.0, help="child poll period"
    )
    args = ap.parse_args(argv)

    cp = configparser.ConfigParser()
    read = cp.read(args.conffile)
    if not read:
        ap.error(f"cannot read {args.conffile}")
    general = dict(cp["general"]) if "general" in cp else {}
    restart_delay = float(general.get("restart_delay", 5.0))

    children: list[_Child] = []
    for section in cp.sections():
        if not section.startswith("fdbserver."):
            continue
        name = section.split(".", 1)[1]
        children.append(
            _Child(name, build_args(dict(cp[section]), general), restart_delay)
        )
    if not children:
        ap.error("no [fdbserver.*] sections")

    stopping = []

    def on_signal(signum, _frame):
        stopping.append(signum)

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    for c in children:
        c.start()
    try:
        while not stopping:
            time.sleep(args.poll_interval)
            for c in children:
                if stopping:
                    break
                c.poll_and_restart()
    finally:
        print("fdbmonitor: stopping children", flush=True)
        for c in children:
            c.stop()
        for c in children:
            c.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
