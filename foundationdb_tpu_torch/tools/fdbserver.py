"""fdbserver — one real OS process of the cluster, over TCP.

The analog of fdbserver/fdbserver.actor.cpp main (role flag parsing
:956-971) + fdbd (worker.actor.cpp:962): boots either a coordinator
(generation + leader registers) or a worker (registers with the elected
cluster controller, hosts whatever roles get recruited) on the real TCP
transport (net/tcp.py). Every role runs unmodified — the Sim-compatible
surface of RealWorld is the whole porting layer.

  python -m foundationdb_tpu_torch.tools.fdbserver \\
      --listen 127.0.0.1:4500 --role coordinator --datadir /tmp/c0
  python -m foundationdb_tpu_torch.tools.fdbserver \\
      --listen 127.0.0.1:4600 --role worker --class storage \\
      --coordinators 127.0.0.1:4500 --config n_storage=2,replication=1

The port's copy of ``foundationdb_tpu/tools/fdbserver.py``, with one more
flag: ``--device {cuda,cpu}`` (default ``cuda``), the device of every
resolver and storage server the worker hosts (``Worker(..., device=)``).
A worker checks it before it boots: with ``--device cuda`` and no card
visible it exits non-zero with ``DeviceUnavailableError`` and never runs
a role on the CPU; with a card it creates its CUDA context and loads the
kernels first. A coordinator needs no device.
"""

from __future__ import annotations

import argparse
import faulthandler
import signal
import sys

# live stack dump on demand (kill -USR1 <pid>): the debugging hook for a
# wedged server (the reference's slow-task profiler serves this role)
faulthandler.register(signal.SIGUSR1, all_threads=True)


def parse_config(text: str) -> dict:
    out: dict = {}
    if not text:
        return out
    for part in text.split(","):
        k, _, v = part.partition("=")
        out[k.strip()] = int(v) if v.strip().isdigit() else v.strip()
    return out


def warm_card() -> None:
    """Create this process's CUDA context and build (or load) the kernel
    libraries before the worker serves: a role recruited here would
    otherwise pay both under its first dispatch deadline."""
    import torch

    from ..conflict.kernels import build

    torch.empty(1, device="cuda")
    build.load()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fdbserver")
    ap.add_argument("--listen", required=True, help="host:port to bind")
    ap.add_argument(
        "--role", choices=["coordinator", "worker"], default="worker"
    )
    ap.add_argument("--coordinators", default="", help="comma-separated")
    ap.add_argument(
        "--class",
        dest="process_class",
        default="unset",
        choices=["storage", "transaction", "stateless", "unset"],
    )
    ap.add_argument("--config", default="", help="k=v,... cluster shape")
    ap.add_argument("--datadir", default=None)
    ap.add_argument("--zone", default=None)
    ap.add_argument("--dc", default="dc0")
    ap.add_argument("--tracefile", default=None, help="JSONL trace output")
    ap.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="device of the resolvers and storage servers this worker hosts",
    )
    ap.add_argument("--tls-cert", default=None, help="PEM certificate chain")
    ap.add_argument("--tls-key", default=None, help="PEM private key")
    ap.add_argument("--tls-ca", default=None, help="PEM CA bundle (mutual auth)")
    ap.add_argument(
        "--knob",
        action="append",
        default=[],
        help="NAME=value (repeatable; the --knob_name flag path)",
    )
    args = ap.parse_args(argv)

    from ..net.tcp import RealWorld
    from ..runtime.knobs import Knobs

    # None is the card (the port's convention); any role the worker hosts
    # may need it, so a worker without one stops here
    device = None if args.device == "cuda" else "cpu"
    if args.role == "worker":
        from ..device import resolve_device

        resolve_device(device)
        if device is None:
            warm_card()

    knob_overrides = {}
    for kv in args.knob:
        name, _, val = kv.partition("=")
        if val.lower() in ("true", "false"):
            # bool knobs: the bare string "false" would be truthy
            parsed: object = val.lower() == "true"
        else:
            try:
                parsed = int(val)
            except ValueError:
                try:
                    parsed = float(val)
                except ValueError:
                    parsed = val
        knob_overrides[name.upper()] = parsed
    knobs = Knobs(**knob_overrides)

    if args.tracefile:
        from ..runtime.trace import TraceLog, set_trace_log

        # knob-controlled size-based rolling (the reference's 10 MB
        # trace_roll_size); rolled files are what trace_analyze consumes
        set_trace_log(
            TraceLog(
                args.tracefile,
                max_file_bytes=knobs.TRACE_ROLL_BYTES,
                keep_files=knobs.TRACE_ROLL_KEEP,
            )
        )

    tls = None
    if args.tls_cert or args.tls_key or args.tls_ca:
        if not (args.tls_cert and args.tls_key and args.tls_ca):
            ap.error("--tls-cert, --tls-key and --tls-ca go together")
        tls = dict(
            certfile=args.tls_cert, keyfile=args.tls_key, cafile=args.tls_ca
        )

    world = RealWorld(
        args.listen,
        knobs=knobs,
        data_dir=args.datadir,
        zone=args.zone,
        dc=args.dc,
        die_on_actor_error=True,  # a server with a dead actor must crash loudly
        tls=tls,
    )
    world.activate()

    if args.role == "coordinator":
        from ..server.coordination import CoordinatorServer

        CoordinatorServer(disk=world.disk("coordination")).register(world.node)
    else:
        from ..server.worker import Worker

        coordinators = [c for c in args.coordinators.split(",") if c]
        if not coordinators:
            ap.error("--role worker requires --coordinators")
        Worker(
            world.node,
            coordinators,
            process_class=args.process_class,
            initial_config=parse_config(args.config),
            knobs=knobs,
            device=device,
        ).start()

    if args.role == "coordinator":
        # workers spawn their own SystemMonitor (Worker.start); only the
        # coordinator role needs one here — two loops would alternately
        # overwrite last_process_metrics
        from ..runtime.monitor import system_monitor

        world.node.spawn(system_monitor(world.node))

    print(f"fdbserver: {args.role} listening on {args.listen}", flush=True)
    try:
        world.run()
    except KeyboardInterrupt:
        pass
    finally:
        world.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
