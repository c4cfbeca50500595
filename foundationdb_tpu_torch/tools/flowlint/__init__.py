"""flowlint — AST-based determinism & actor-discipline analyzer.

The static-analysis counterpart of the reference's Flow actor compiler:
where ActorCompiler.cs rejects actor-model violations at C++ generation
time, flowlint walks this package's AST and rejects them at lint time —
before they can desynchronize a seeded simulation or ship a dark endpoint.

Port of ``foundationdb_tpu/tools/flowlint``: the same rules, ids,
messages and engine, with its own ``config.json`` and ``baseline.json``
for the ``foundationdb_tpu_torch`` tree. Given another tree, config and
baseline through ``lint(root=..., config=..., baseline=...)``, it gives
the JAX package's analyzer's result on them.

Usage:
    python -m foundationdb_tpu_torch.tools.flowlint            # whole tree
    python -m foundationdb_tpu_torch.tools.flowlint --json     # machine-readable
    python -m foundationdb_tpu_torch.tools.cli lint            # pretty per-rule counts

Suppressions:
    some_call()  # flowlint: disable=<rule-id>           (that line only)
    # flowlint: disable-file=<rule-id>                   (whole file)
plus the checked-in baseline (baseline.json) for grandfathered findings.
"""

from .core import (  # noqa: F401
    Finding,
    LintResult,
    Module,
    Rule,
    all_rules,
    format_baseline,
    lint,
    lint_source,
    load_baseline,
    load_config,
)
