"""The port's runtime: its own copies of ``foundationdb_tpu/runtime``'s
modules that the resolver, tlog and storage roles and the simulator need
(rng, knobs, loop, trace, buggify, futures, stats, timeseries, serialize,
locality, validation, profiler), with the same names, seeds and counter
names."""
