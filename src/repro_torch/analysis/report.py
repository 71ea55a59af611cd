"""Violation records and the ``analysis-v1`` / ``analysis-v2`` reports —
the port of ``repro/analysis/report.py``.

The rule ids are the reference's where the port has a counterpart (the
graph rules keep their ids; ``donation-honored`` is the port's "the cache
is written in place"), and the lint rules name what the port checks
(``docs/torch-static-analysis.md``). Both records pass
``scripts/check_bench_schema.py`` as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

__all__ = ["ANALYSIS_SCHEMA", "ANALYSIS_V2_SCHEMA", "RULES", "Violation",
           "build_report", "build_cost_report", "summarize"]

ANALYSIS_SCHEMA = "analysis-v1"
ANALYSIS_V2_SCHEMA = "analysis-v2"

#: rule id → one-line description (the catalog in
#: docs/torch-static-analysis.md)
RULES: Dict[str, str] = {
    "no-host-transfer": (
        "no .item(), no copy to another device and no data-dependent-shape "
        "op inside a serve-path tick body"),
    "donation-honored": (
        "the cache is written in place: every donated KV and state leaf "
        "keeps its storage, and no op outputs a copy of a KV leaf"),
    "f32-upcast-allowlist": (
        "bf16/f16 -> f32 widening only at the named accumulation sites, "
        "each with its reason"),
    "kv-constraint-coverage": (
        "every KV leaf's placement spec on a mesh equals the "
        "serve_rules_for(family) table"),
    "determinism": (
        "bitwise-reproducible targets: no RNG op on a deterministic path, "
        "no model-axis collective or spec on ssm/hybrid"),
    "lint-compile-in-init": (
        "no torch.compile or CUDA-graph capture inside __init__ outside "
        "serve/graphs.py"),
    "lint-sync-in-loop": (
        "no device sync (.item(), .cpu(), synchronize, ...) inside a "
        "serve/ Python loop"),
    "lint-torch-in-loop": (
        "no torch.* call inside a per-token Python loop in serve/ (batch "
        "device work into one call per tick)"),
    "lint-dead-module": (
        "every src/repro_torch module is imported by something "
        "(dead-code census)"),
    "audit-cost-drift": (
        "the static FLOP/byte counts of every serve-path tick reconcile "
        "with launch/costing.py within tolerance"),
    "audit-unbounded-loop": (
        "every serve-path loop's trip count is known (eagerly executed "
        "loops run their real count)"),
    "lint-stale-allow": (
        "every '# torch-audit: allow(rule)' comment suppresses a live "
        "violation"),
}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken invariant, with its source site: ``file``/``line`` the
    innermost ``src/repro_torch`` frame of the offending op (graph rules)
    or the linted line; ``provenance`` the op and its function, or the
    lint rule's context."""

    rule: str
    target: str
    file: str
    line: int
    message: str
    provenance: str = ""
    severity: str = "error"

    def format(self) -> str:
        loc = f"{self.file}:{self.line}" if self.file else "<unknown>"
        tail = f" [{self.provenance}]" if self.provenance else ""
        return f"{loc}: {self.rule} ({self.target}): {self.message}{tail}"


def _violation_records(violations: Sequence[Violation]) -> List[Dict]:
    return [{"rule": v.rule, "severity": v.severity, "target": v.target,
             "file": v.file, "line": int(v.line), "message": v.message,
             "provenance": v.provenance} for v in violations]


def build_report(violations: Sequence[Violation], *, targets_audited: int,
                 files_linted: int, config: Dict) -> Dict:
    """The ``analysis-v1`` record."""
    return {
        "schema": ANALYSIS_SCHEMA,
        "config": dict(config),
        "summary": {
            "targets_audited": int(targets_audited),
            "files_linted": int(files_linted),
            "violations": len(violations),
            "rules_checked": sorted(RULES),
        },
        "violations": _violation_records(violations),
    }


def build_cost_report(records: Sequence[Dict], violations: Sequence[Violation],
                      *, config: Dict) -> Dict:
    """The ``analysis-v2`` record: each target's static against analytic
    counts, its drift and its loops."""
    checked = [r for r in records if r.get("drift_checked")]
    max_abs_drift = 0.0
    for r in checked:
        for d in (r.get("drift") or {}).values():
            if d == d and abs(d) > abs(max_abs_drift):     # NaN-safe
                max_abs_drift = d
    return {
        "schema": ANALYSIS_V2_SCHEMA,
        "config": dict(config),
        "summary": {
            "targets_costed": len(records),
            "targets_drift_checked": len(checked),
            "violations": len(violations),
            "unbounded_loops": sum(r["loops"]["unbounded"] for r in records),
            "max_abs_drift": float(max_abs_drift),
        },
        "targets": [dict(r) for r in records],
        "violations": _violation_records(violations),
    }


def summarize(violations: List[Violation]) -> str:
    if not violations:
        return "analysis: clean (0 violations)"
    by_rule: Dict[str, int] = {}
    for v in violations:
        by_rule[v.rule] = by_rule.get(v.rule, 0) + 1
    parts = ", ".join(f"{r}={n}" for r, n in sorted(by_rule.items()))
    return f"analysis: {len(violations)} violation(s) ({parts})"
