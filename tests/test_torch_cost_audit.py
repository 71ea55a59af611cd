"""The port's cost audit (``repro_torch.analysis.cost_audit``) and the
kernel recorder of ``repro_torch.kernels.ops``, on the CPU.

* An eager loop of n products counts n of them.
* A kernel entry point counts once, priced by its contract, whether the
  MOA engine reaches it (the kernel route, under ``ops.interpret``) or
  takes its plain products (the torch route): the plain version's own ops
  are not counted again.
* The drift and data-dependent-loop fixtures fire.
* Every drift-checked target of the four families reconciles with
  ``serve_target_cost`` (FLOPs within ``FLOPS_RTOL``, KV gather bytes
  within ``KV_BYTES_RTOL``), the gather route's KV stream is nonzero and
  the kernel route's paged calls are recorded.
"""

import pytest
import torch

from repro_torch.analysis import (FLOPS_RTOL, KV_BYTES_RTOL,
                                  cost_audit_targets, enumerate_targets)
from repro_torch.analysis import fixtures
from repro_torch.analysis.cost_audit import (DRIFT_PHASES, cost_target,
                                             count_target, reconcile_target,
                                             target_phase)
from repro_torch.analysis.graph_audit import AuditTarget
from repro_torch.kernels import ops
from repro_torch.moa import resolve


@pytest.mark.parametrize("n", [1, 3, 8])
def test_loop_of_products_counts_every_trip(n):
    target, flops = fixtures.product_loop(n)
    cost = count_target(target)
    assert cost.flops == flops
    assert cost.max_trip_count == n
    assert cost.unbounded == []


@pytest.mark.parametrize("spec", ["serial?chunk=32", "tree"])
def test_kernel_entry_point_counts_once_on_either_route(spec):
    m, k, n = 3, 64, 5
    a = torch.randn(m, k).to(torch.bfloat16)
    b = torch.randn(k, n).to(torch.bfloat16)

    def target(backend):
        strat = resolve(f"{spec}{'&' if '?' in spec else '?'}"
                        f"backend={backend}")
        return AuditTarget(name="dense/dot", family="dense",
                           fn=lambda x, y: strat.dot(x, y),
                           make_args=lambda: (a, b))

    with ops.interpret():
        kernel = count_target(target("kernel"))
    plain = count_target(target("torch"))
    assert kernel.kernel_calls["dot_moa"] == 1
    assert kernel.flops == kernel.kernel_flops == 2.0 * m * k * n
    assert plain.kernel_calls["dot_moa"] == 0
    assert plain.flops == 2.0 * m * k * n
    assert kernel.pallas_stream_bytes == 2 * (m * k + k * n)


def test_attention_entry_points_priced_by_contract():
    B, S, H, Hk, D = 2, 8, 4, 2, 16
    q = torch.randn(B, S, H, D)
    kv = torch.randn(B, S, Hk, D)
    pool = torch.randn(5, 4, Hk, D)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    start = torch.tensor([3, 6], dtype=torch.int32)
    flash = AuditTarget(name="dense/flash", family="dense",
                        fn=lambda q, k, v: ops.flash_attention(q, k, v),
                        make_args=lambda: (q, kv, kv))
    paged = AuditTarget(
        name="dense/paged", family="dense",
        fn=lambda q, kp, vp: ops.paged_attention(q, kp, vp, tables, start,
                                                 dequant_dtype=torch.float32),
        make_args=lambda: (q[:, :1], pool, pool))
    f, p = count_target(flash), count_target(paged)
    assert f.kernel_calls["flash_attention"] == 1
    assert f.flops == 4.0 * B * S * S * H * D       # the whole rectangle
    assert p.kernel_calls["paged_attention"] == 1
    assert p.flops == 4.0 * B * 1 * (2 * 4) * H * D  # the table's width
    with ops.recording() as rec:
        ops.flash_attention(q, kv, kv)
        assert rec.inside == 0
    assert rec.calls["flash_attention"] == 1
    assert ops._RECORDER is None


def test_drift_fixture_fires():
    target, analytic = fixtures.COST_FIXTURES["audit-cost-drift"]()
    cost, violations = cost_target(target)
    assert violations == []
    drift, found = reconcile_target(target, cost, analytic)
    assert drift["flops"] == pytest.approx(1 / 0.75 - 1)
    assert [v.rule for v in found] == ["audit-cost-drift"]
    _, clean = reconcile_target(target, cost, {"flops": cost.flops})
    assert clean == []


def test_data_dependent_loop_fixture_fires():
    target = fixtures.COST_FIXTURES["audit-unbounded-loop"]()
    cost, violations = cost_target(target)
    assert violations and {v.rule for v in violations} == {
        "audit-unbounded-loop"}
    assert all(v.severity == "warning" for v in violations)
    assert cost.flops >= 2 * 2.0 * 4 ** 3


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_drift_checked_targets_reconcile(family):
    targets = [t for t in enumerate_targets((family,), ("none",))
               if target_phase(t.name) in DRIFT_PHASES]
    records, violations = cost_audit_targets(targets)
    assert [v.format() for v in violations] == []
    assert len(records) >= 4
    for r in records:
        assert r["drift_checked"] and r["loops"]["unbounded"] == 0
        assert abs(r["drift"]["flops"]) <= FLOPS_RTOL
        if "kv_gather_bytes" in r["drift"]:
            assert abs(r["drift"]["kv_gather_bytes"]) <= KV_BYTES_RTOL
        phase = r["phase"]
        if phase in ("paged_decode", "paged_decode_hw", "paged_verify"):
            assert r["static"]["kv_gather_bytes"] > 0
        if phase.endswith("_fused"):
            assert r["kernel_calls"]["paged_attention"] > 0
            assert r["static"]["kv_gather_bytes"] == 0
            assert r["static"]["pallas_stream_bytes"] > 0
