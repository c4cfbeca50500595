"""The port's runtime: its own copies of ``foundationdb_tpu/runtime``'s
modules that the resolver role needs (rng, knobs, loop, trace, buggify,
futures, stats, timeseries), with the same names, seeds and counter names."""
