"""Static serve-path audit of the port: the graph audit, the lint and,
with ``--cost``, the cost audit, as one gate.

  PYTHONPATH=src python -m repro_torch.analysis
  PYTHONPATH=src python -m repro_torch.analysis --json report.json
  PYTHONPATH=src python -m repro_torch.analysis --families ssm,hybrid
  PYTHONPATH=src python -m repro_torch.analysis --cost \\
      --cost-json cost-report.json

Runs every serve-path target (families × dense/paged × mesh/no mesh) at
smoke size on the CPU and prints each violation with its source line.
``--json`` writes the ``analysis-v1`` record and ``--cost-json`` (which
implies ``--cost``) the ``analysis-v2`` record; each is validated by
``scripts/check_bench_schema.py`` (loaded by its path) before it is
written, so a malformed report cannot pass. Exits 1 on any
error-severity violation; warnings print but do not gate.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def _load_schema_registry():
    """``scripts/`` is not a package: load the validator by its path."""
    path = os.path.join(REPO_ROOT, "scripts", "check_bench_schema.py")
    spec = importlib.util.spec_from_file_location("check_bench_schema", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def validated_dump(report: dict, path: str) -> bool:
    """Write ``report`` to ``path`` if it passes its own schema."""
    errors = _load_schema_registry().validate(report)
    if errors:
        for e in errors:
            print(f"INTERNAL: report fails its own schema: {e}",
                  file=sys.stderr)
        return False
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {path} ({report['schema']})")
    return True


def main(argv=None) -> int:
    from repro_torch.analysis import (SERVE_FAMILIES, audit_targets,
                                      build_cost_report, build_report,
                                      cost_audit_targets, enumerate_targets,
                                      run_lint, summarize)
    from repro_torch.analysis.cost_audit import FLOPS_RTOL, KV_BYTES_RTOL

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", default=",".join(SERVE_FAMILIES),
                    help="comma-separated families to audit")
    ap.add_argument("--mesh-modes", default="none,mesh",
                    help="comma-separated subset of: none, mesh")
    ap.add_argument("--skip-lint", action="store_true",
                    help="graph audit only")
    ap.add_argument("--skip-graph", action="store_true", help="lint only")
    ap.add_argument("--cost", action="store_true",
                    help="cost audit reconciled against launch/costing.py")
    ap.add_argument("--json", metavar="PATH",
                    help="write a schema-validated analysis-v1 report")
    ap.add_argument("--cost-json", metavar="PATH",
                    help="write a schema-validated analysis-v2 report "
                         "(implies --cost)")
    args = ap.parse_args(argv)
    if args.cost_json:
        args.cost = True
    families = tuple(f for f in args.families.split(",") if f)
    mesh_modes = tuple(m for m in args.mesh_modes.split(",") if m)
    unknown = set(families) - set(SERVE_FAMILIES)
    if unknown:
        ap.error(f"unknown families: {sorted(unknown)}")

    t0 = time.time()
    violations, targets = [], []
    if not args.skip_graph or args.cost:
        targets = enumerate_targets(families=families, mesh_modes=mesh_modes)
    if not args.skip_graph:
        print(f"auditing {len(targets)} serve-path targets "
              f"({len(families)} families x {mesh_modes})...")
        violations.extend(audit_targets(targets))
    files_linted = 0
    if not args.skip_lint:
        lint_violations, files_linted = run_lint(REPO_ROOT)
        print(f"linted {files_linted} source files")
        violations.extend(lint_violations)

    cost_records, cost_violations = [], []
    if args.cost:
        print(f"cost-auditing {len(targets)} targets against "
              "launch/costing.py...")
        cost_records, cost_violations = cost_audit_targets(targets)
        checked = sum(1 for r in cost_records if r["drift_checked"])
        worst = max((abs(d) for r in cost_records if r["drift"]
                     for d in r["drift"].values()), default=0.0)
        print(f"cost audit: {len(cost_records)} targets, {checked} "
              f"drift-checked, max |drift| {worst:.3%}")

    for v in violations + cost_violations:
        print(v.format())
    print(summarize(violations + cost_violations))
    print(f"({time.time() - t0:.1f}s)")

    ok = True
    config = {"families": list(families), "mesh_modes": list(mesh_modes),
              "package": "repro_torch"}
    if args.json:
        ok &= validated_dump(build_report(
            violations, targets_audited=0 if args.skip_graph
            else len(targets), files_linted=files_linted, config=config),
            args.json)
    if args.cost_json:
        ok &= validated_dump(build_cost_report(
            cost_records, cost_violations,
            config=dict(config, flops_rtol=FLOPS_RTOL,
                        kv_bytes_rtol=KV_BYTES_RTOL)), args.cost_json)
    errors = [v for v in violations + cost_violations
              if v.severity == "error"]
    return 0 if ok and not errors else 1


if __name__ == "__main__":
    sys.exit(main())
