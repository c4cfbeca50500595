"""The port's in-process network: the deterministic simulator (sim.py),
its simulated disks (files.py), the transport counters (metrics.py) and
the wire codec (wire.py)."""
