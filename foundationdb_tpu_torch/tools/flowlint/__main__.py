"""flowlint CLI: ``python -m foundationdb_tpu_torch.tools.flowlint``.

Exit 0 iff the tree has zero unsuppressed findings (parse errors fail too).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .core import (
    DEFAULT_ROOT,
    all_rules,
    format_baseline,
    lint,
    load_baseline,
    load_config,
)


def render(result, config, verbose: bool = True) -> str:
    lines = [
        f"flowlint: {result.files} files, {len(all_rules())} rules, "
        f"{result.seconds:.2f}s"
    ]
    per = result.per_rule()
    rules = {r.id: r for r in all_rules()}
    lines.append(f"  {'rule':<26} {'fail':>5} {'baseline':>9} {'disabled':>9}")
    for rid in sorted(rules):
        c = per.get(rid, {"fail": 0, "baseline": 0, "disabled": 0})
        lines.append(
            f"  {rid:<26} {c['fail']:>5} {c['baseline']:>9} {c['disabled']:>9}"
        )
    host_only = config.get("host_only", {})
    if host_only:
        lines.append("host-only manifest (determinism rules skipped):")
        for rel, why in sorted(host_only.items()):
            lines.append(f"  {rel} — {why}")
    for err in result.parse_errors:
        lines.append(f"PARSE ERROR: {err}")
    for f in result.failing:
        lines.append(f.format())
    for key in result.stale_baseline:
        lines.append(f"stale baseline entry (site is gone — prune it): {key}")
    if result.clean:
        lines.append("clean: no unsuppressed findings")
    else:
        lines.append(
            f"FAILED: {len(result.failing)} unsuppressed finding(s), "
            f"{len(result.parse_errors)} parse error(s)"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flowlint",
        description="AST determinism & actor-discipline analyzer",
    )
    ap.add_argument("paths", nargs="*", help="restrict reported findings to these relpaths")
    ap.add_argument("--root", default=None, help="repo root (default: autodetected)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="rewrite baseline.json grandfathering every current finding",
    )
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore baseline.json (show grandfathered findings as failing)",
    )
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            print(f"{r.id:<26} [{r.scope:>7}]  {r.title}")
        return 0

    root = Path(args.root) if args.root else DEFAULT_ROOT
    config = load_config()
    baseline = {} if args.no_baseline else load_baseline(root, config)
    result = lint(
        root=root, config=config, baseline=baseline, paths=args.paths or None
    )

    if args.write_baseline:
        reasons = load_baseline(root, config)  # keep reasons already reviewed
        text = format_baseline(result.failing + result.baselined, reasons)
        (root / config["baseline"]).write_text(text)
        print(
            f"baseline rewritten: {len(result.failing) + len(result.baselined)} "
            f"entries ({len(result.failing)} newly grandfathered)"
        )
        return 0

    if args.json:
        print(json.dumps(result.to_json(), indent=2))
    else:
        print(render(result, config))
    return 0 if result.clean else 1


if __name__ == "__main__":
    sys.exit(main())
