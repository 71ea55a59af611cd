"""Static FLOP/byte accounting of the serve-path targets, reconciled
against the analytic model — the port of ``repro/analysis/cost_audit.py``.

The reference walks each jaxpr and multiplies loop bodies by their trip
counts. The port runs each target eagerly under the same
:class:`~repro_torch.analysis.graph_audit.OpTrace` as the graph audit, so
every Python loop (the layers, the K chunks of a serialized product, a
scanned verify) runs its real number of times, and counts:

* ``flops`` — products only: ``mm``, ``addmm``, ``bmm``, ``baddbmm``
  (and ``mv``, ``dot``) at ``2·|out|·K``, ``convolution`` at
  ``2·|out|·C_in/groups·Πk``, plus the kernel entry points' calls as the
  recorder prices them (:class:`repro_torch.kernels.ops.KernelRecorder`:
  ``dot_moa`` ``2·m·k·n``, ``flash_attention`` the full ``Sq × Skv``
  rectangle, ``paged_attention`` the whole block table's width); the ops of
  a recorded call's plain version are not counted again, so a CPU run and
  a card run count the same;
* ``gather_bytes`` / ``scatter_bytes`` — the output bytes of the index
  ops (``index``, ``gather``, ``index_select``, ``embedding``, ...) and
  the update bytes of the scatters (``index_put_``, ``index_copy_``,
  ``scatter``, ...), with ``kv_gather_bytes`` the KV stream: the ≥3-D
  gathers issued from ``layers/attention.py`` (the reference's rule) that
  read a KV leaf of the target's cache;
* ``pallas_stream_bytes`` — the operand bytes of every kernel entry-point
  call (what the kernels read; recorded, not reconciled);
* ``peak_bytes`` — peak live bytes by weakref liveness: the arguments,
  plus every op output's storage until the storage is released (a weak
  reference to the storage itself, so what autograd holds stays
  counted);
* ``loops`` — ``scans`` is 0 (nothing is traced, so no loop is counted
  once: each runs its real count), ``pallas_grids`` the kernel entry-point
  calls (each a grid launched on the card), ``max_trip_count`` the most
  times one source line's op ran in the call (the deepest loop's trip
  count), ``unbounded`` the sites that repeated after a host read of
  device data (a loop whose count the data decides: the count holds for
  this run's data only, ``audit-unbounded-loop``).

Targets whose phase has a model-forward counterpart (:data:`DRIFT_PHASES`)
are reconciled against :func:`repro_torch.launch.costing.
serve_target_cost`; drift past :data:`FLOPS_RTOL` / :data:`KV_BYTES_RTOL`
is an ``audit-cost-drift`` violation. Helper targets are recorded with
``analytic: null``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.graph_audit import (AuditTarget, _tensors,
                                              kv_leaves, op_site, run_target)
from repro_torch.analysis.report import Violation

__all__ = ["StaticCost", "LoopRecord", "Liveness", "storage_key",
           "product_flops", "cost_target", "count_target",
           "reconcile_target", "cost_audit_targets", "target_phase",
           "FLOPS_RTOL", "KV_BYTES_RTOL", "DRIFT_PHASES"]

#: FLOPs within ±2 % (the reference's); KV gather bytes exact up to float
#: noise (both sides derive from the same cache layout)
FLOPS_RTOL = 0.02
KV_BYTES_RTOL = 1e-6

#: target phases with a model-forward analytic counterpart
DRIFT_PHASES = (
    "prefill", "decode", "verify", "prefill_chunk",
    "paged_decode", "paged_decode_hw", "paged_decode_fused",
    "paged_verify", "paged_verify_fused", "paged_suffix_prefill",
)

#: the file whose gathers stream the KV cache (``gather_paged_kv``)
_KV_GATHER_FILE = "src/repro_torch/layers/attention.py"

_GATHER_OPS = {"index", "gather", "index_select", "embedding", "take",
               "take_along_dim"}
#: scatter op → the position of its update operand
_SCATTER_OPS = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
                "index_copy": 3, "index_copy_": 3, "index_add": 3,
                "index_add_": 3, "scatter": 3, "scatter_": 3,
                "scatter_add": 3, "scatter_add_": 3, "scatter_reduce": 3,
                "scatter_reduce_": 3}
_HOST_READS = {"_local_scalar_dense", "equal", "is_nonzero"}


@dataclasses.dataclass
class LoopRecord:
    """One loop: its kind, trip count (``None``: decided by the data) and
    source site."""

    kind: str                 # "data-dependent"
    length: Optional[int]
    path: str
    file: str
    line: int


@dataclasses.dataclass
class StaticCost:
    """What one run of a target counted."""

    flops: float = 0.0
    gather_bytes: float = 0.0
    scatter_bytes: float = 0.0
    kv_gather_bytes: float = 0.0
    pallas_stream_bytes: float = 0.0
    peak_bytes: float = 0.0
    arg_bytes: float = 0.0
    out_bytes: float = 0.0
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: float = 0.0
    max_trip_count: int = 0
    unbounded: List[LoopRecord] = dataclasses.field(default_factory=list)


def _numel(t: torch.Tensor) -> int:
    return math.prod(t.shape)


def _nbytes(t: torch.Tensor) -> float:
    return float(_numel(t) * t.element_size())


def product_flops(name: str, args, result) -> float:
    """``2·|out|·K`` of a product op (0 for any other op)."""
    if name in ("mm", "bmm", "mv", "dot", "vdot"):
        k = args[0].shape[-1]
    elif name in ("addmm", "baddbmm", "addbmm", "addmv"):
        k = args[1].shape[-1]
    elif name in ("convolution", "_convolution"):
        w = args[1]
        k = math.prod(w.shape[1:])            # C_in / groups · Πk
    else:
        return 0.0
    out = result if isinstance(result, torch.Tensor) else result[0]
    return 2.0 * max(_numel(out), 1) * k


def storage_key(t: torch.Tensor) -> int:
    """An identity of ``t``'s storage that its views share (also on
    ``meta``, where every data pointer is 0)."""
    return t.untyped_storage()._cdata


class Liveness:
    """Live bytes by storage: a storage counts from the first time a
    tensor of it is held until the storage is released (a weak reference
    to the storage itself: what autograd saves stays counted)."""

    def __init__(self):
        self.live: Dict[int, float] = {}         # storage → bytes
        self.now = self.peak = 0.0

    def hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = self.live[key] = float(st.nbytes())
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._drop, key)

    def _drop(self, key: int) -> None:
        self.now -= self.live.pop(key, 0.0)


def count_target(target: AuditTarget) -> StaticCost:
    """Run ``target`` once and count its costs."""
    cost = StaticCost()
    args = target.make_args()
    kv_storage = {t.untyped_storage().data_ptr()
                  for t in kv_leaves(target, args)}
    live = Liveness()
    arg_tensors = _tensors(args)
    cost.arg_bytes = float(sum({storage_key(t): t.untyped_storage().nbytes()
                                for t in arg_tensors}.values()))
    for t in arg_tensors:
        live.hold(t)
    sites: Dict[Tuple[str, int, str], int] = collections.Counter()
    reads = [0]
    first_read: Dict[Tuple[str, int, str], int] = {}
    flagged = set()

    def on_op(name, a, kw, result):
        for t in _tensors(result):
            live.hold(t)
        file, line, fn = op_site()
        key = (file, line, name)
        sites[key] += 1
        if key not in first_read:
            first_read[key] = reads[0]
        elif reads[0] > first_read[key] and key not in flagged:
            flagged.add(key)
            cost.unbounded.append(LoopRecord(
                kind="data-dependent", length=None, path=f"{name} in {fn}",
                file=file, line=line))
        if name in _HOST_READS:
            reads[0] += 1
        cost.flops += product_flops(name, a, result)
        if name in _GATHER_OPS:
            b = float(sum(_nbytes(t) for t in _tensors(result)))
            cost.gather_bytes += b
            src = a[0]                # the gathered-from operand
            if file == _KV_GATHER_FILE and src.dim() >= 3 and \
                    src.untyped_storage().data_ptr() in kv_storage:
                cost.kv_gather_bytes += b
        elif name in _SCATTER_OPS:
            i = _SCATTER_OPS[name]
            upd = a[i] if len(a) > i else None
            if isinstance(upd, torch.Tensor):
                cost.scatter_bytes += _nbytes(upd)

    _, out, rec = run_target(target, on_op, args=args)
    cost.out_bytes = float(sum(_nbytes(t) for t in _tensors(out)))
    cost.kernel_calls = dict(rec.calls)
    cost.kernel_flops = rec.total_flops()
    cost.flops += cost.kernel_flops
    cost.pallas_stream_bytes = rec.stream_bytes
    cost.max_trip_count = max(sites.values(), default=0)
    cost.peak_bytes = live.peak
    return cost


def target_phase(name: str) -> str:
    """``"moe/paged_decode_hw@mesh"`` → ``"paged_decode_hw"``."""
    return name.split("/", 1)[1].split("@", 1)[0]


def cost_target(target: AuditTarget) -> Tuple[StaticCost, List[Violation]]:
    """Count one target; a data-dependent loop is an
    ``audit-unbounded-loop`` violation (an error on a drift-checked phase,
    whose reconciliation would hold for this run's data only; a warning
    on a helper target)."""
    cost = count_target(target)
    checked = target_phase(target.name) in DRIFT_PHASES
    violations = [
        Violation(
            rule="audit-unbounded-loop", target=target.name, file=lr.file,
            line=lr.line, provenance=lr.path,
            severity="error" if checked else "warning",
            message=("a loop whose trip count the data decides (a site "
                     "repeated after a host read of device data): the "
                     "counts hold for this run's data only" + (
                         ", so the drift check is unsound for this target"
                         if checked else "")))
        for lr in cost.unbounded]
    return cost, violations


def _drift(static: float, analytic: float) -> float:
    if analytic == 0.0:
        return 0.0 if static == 0.0 else math.inf
    return static / analytic - 1.0


def reconcile_target(target: AuditTarget, static: StaticCost,
                     analytic: Optional[Dict[str, float]], *,
                     flops_rtol: float = FLOPS_RTOL,
                     kv_bytes_rtol: float = KV_BYTES_RTOL,
                     ) -> Tuple[Optional[Dict[str, float]], List[Violation]]:
    """``(drift, violations)``: each quantity's signed relative drift
    ``static/analytic − 1`` (``None`` without an analytic counterpart)."""
    if analytic is None:
        return None, []
    out: List[Violation] = []
    drift: Dict[str, float] = {}
    phase = target_phase(target.name)
    d = _drift(static.flops, analytic["flops"])
    drift["flops"] = d
    if abs(d) > flops_rtol:
        out.append(Violation(
            rule="audit-cost-drift", target=target.name, file="", line=0,
            provenance=f"phase={phase}",
            message=(f"static product FLOPs {static.flops:.6g} vs analytic "
                     f"{analytic['flops']:.6g} (drift {d:+.2%}, tolerance "
                     f"±{flops_rtol:.0%}) — launch/costing.py and the "
                     "executed computation disagree")))
    kv_pred = analytic.get("kv_gather_bytes")
    if kv_pred is not None:
        d = _drift(static.kv_gather_bytes, kv_pred)
        drift["kv_gather_bytes"] = d
        if abs(d) > kv_bytes_rtol:
            out.append(Violation(
                rule="audit-cost-drift", target=target.name, file="",
                line=0, provenance=f"phase={phase}",
                message=(f"static KV gather bytes {static.kv_gather_bytes:.6g}"
                         f" vs analytic {kv_pred:.6g} (drift {d:+.2%}) — "
                         "kv_bytes_per_token and the executed gather "
                         "disagree")))
    return drift, out


def _loop_meta(cost: StaticCost) -> Dict[str, int]:
    return {"scans": 0,
            "pallas_grids": int(sum(cost.kernel_calls.values())),
            "max_trip_count": int(cost.max_trip_count),
            "unbounded": len(cost.unbounded)}


def analytic_cost(cfg, phase: str, shape: Dict[str, int]
                  ) -> Optional[Dict[str, float]]:
    """``serve_target_cost`` of a drift-checked phase without its
    components (``None`` for a helper phase)."""
    from repro_torch.launch.costing import serve_target_cost

    if phase not in DRIFT_PHASES:
        return None
    return {k: v for k, v in serve_target_cost(cfg, phase, **shape).items()
            if k != "components"}


def cost_record(target: AuditTarget, cost: StaticCost,
                analytic: Optional[Dict[str, float]],
                drift: Optional[Dict[str, float]]) -> Dict[str, Any]:
    """One ``analysis-v2`` target record."""
    return {
        "target": target.name,
        "family": target.family,
        "phase": target_phase(target.name),
        "mesh": target.mesh is not None,
        "drift_checked": analytic is not None,
        "static": {
            "flops": cost.flops,
            "gather_bytes": cost.gather_bytes,
            "scatter_bytes": cost.scatter_bytes,
            "kv_gather_bytes": cost.kv_gather_bytes,
            "pallas_stream_bytes": cost.pallas_stream_bytes,
            "peak_bytes": cost.peak_bytes,
            "arg_bytes": cost.arg_bytes,
            "out_bytes": cost.out_bytes,
        },
        "kernel_calls": dict(cost.kernel_calls),
        "analytic": analytic,
        "drift": drift,
        "loops": _loop_meta(cost),
    }


def cost_audit_targets(targets: Sequence[AuditTarget], *, cfgs=None,
                       shape: Optional[Dict[str, int]] = None,
                       flops_rtol: float = FLOPS_RTOL,
                       kv_bytes_rtol: float = KV_BYTES_RTOL,
                       ) -> Tuple[List[Dict[str, Any]], List[Violation]]:
    """Cost-audit ``targets`` → (``analysis-v2`` target records,
    violations). Predictions are ``serve_target_cost`` of each family's
    config (``cfgs``: family → config; default the smoke configs the
    targets are built from) at ``shape`` (default ``AUDIT_SHAPE``)."""
    from repro_torch.analysis.targets import AUDIT_SHAPE, SMOKE_BY_FAMILY
    from repro_torch.configs.registry import get_config, smoke_config

    if cfgs is None:
        cfgs = {fam: smoke_config(get_config(arch))
                for fam, arch in SMOKE_BY_FAMILY.items()}
    shape = dict(AUDIT_SHAPE if shape is None else shape)
    records: List[Dict[str, Any]] = []
    violations: List[Violation] = []
    for t in targets:
        cost, v = cost_target(t)
        violations.extend(v)
        analytic = analytic_cost(cfgs[t.family], target_phase(t.name), shape)
        drift, dv = reconcile_target(t, cost, analytic,
                                     flops_rtol=flops_rtol,
                                     kv_bytes_rtol=kv_bytes_rtol)
        violations.extend(dv)
        records.append(cost_record(t, cost, analytic, drift))
    return records, violations
