"""The port's in-process network: the deterministic simulator (sim.py),
its simulated disks (files.py) and the transport counters (metrics.py)."""
