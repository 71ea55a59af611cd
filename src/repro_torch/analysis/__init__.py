"""Static analysis of the port's serve path — the port of
``repro/analysis``: a graph audit, a cost audit and a lint, run by
``python -m repro_torch.analysis``.

* :mod:`repro_torch.analysis.graph_audit` runs every serve-path callable
  (families × dense/paged × mesh/no mesh, from
  :mod:`repro_torch.analysis.targets`) at smoke size under a dispatch mode
  that sees each aten op and its source line, and checks the repo's
  invariants (host transfers, the cache written in place, the f32-upcast
  allowlist, KV placement coverage, determinism);
* :mod:`repro_torch.analysis.cost_audit` counts the same runs' products
  and gathered bytes, with the kernel entry points priced by their
  contracts, and reconciles each target against the analytic model in
  :mod:`repro_torch.launch.costing` (the ``analysis-v2`` record);
* :mod:`repro_torch.analysis.lint` checks the port's source for the
  serve-path regressions and runs a dead-module census.

docs/torch-static-analysis.md has the rule catalog and the pricing
conventions.
"""

from repro_torch.analysis.cost_audit import (DRIFT_PHASES, FLOPS_RTOL,
                                             KV_BYTES_RTOL, LoopRecord,
                                             StaticCost, cost_audit_targets,
                                             cost_target, reconcile_target)
from repro_torch.analysis.graph_audit import (AuditTarget, audit_target,
                                              audit_targets)
from repro_torch.analysis.lint import run_lint
from repro_torch.analysis.report import (ANALYSIS_SCHEMA, ANALYSIS_V2_SCHEMA,
                                         RULES, Violation, build_cost_report,
                                         build_report, summarize)
from repro_torch.analysis.targets import (AUDIT_SHAPE, SERVE_FAMILIES,
                                          SMOKE_BY_FAMILY,
                                          build_family_targets,
                                          enumerate_targets, make_audit_mesh)

__all__ = [
    "ANALYSIS_SCHEMA", "ANALYSIS_V2_SCHEMA", "RULES", "Violation",
    "build_report", "build_cost_report", "summarize",
    "AuditTarget", "audit_target", "audit_targets", "run_lint",
    "StaticCost", "LoopRecord", "cost_target", "cost_audit_targets",
    "reconcile_target", "DRIFT_PHASES", "FLOPS_RTOL", "KV_BYTES_RTOL",
    "AUDIT_SHAPE", "SERVE_FAMILIES", "SMOKE_BY_FAMILY",
    "build_family_targets", "enumerate_targets", "make_audit_mesh",
]
