"""Speculative decoding in bf16 is output-neutral: a row's result may not
depend on the rows beside it (``repro_torch.kernels.{dot_moa,
paged_attention}``), on the CPU.

* **The reference's contract** (``tests/test_spec_decode.py``'s
  ``test_spec_greedy_bit_identical_to_plain``): with the oracle drafter at
  accept rate 1, in bf16 compute, speculative greedy tokens are those of
  plain greedy decode and ``accept_rate == 1.0``, for llama3 (dense-slot
  and paged caches) and moonshot (dense-slot), 3 slots, ``max_len`` 48,
  block 8. The port meets it exactly; against the reference's tokens a
  divergence passes only at a bf16 near-tie (the cross-framework rule of
  ``tests/test_torch_serve.py``).
* **The plans** (pure Python, as ``test_torch_dot_moa_plan.py`` and
  ``test_torch_paged_plan.py``): ``dot_moa`` gives a row the same K split
  and in-slice order at every m up to 16 (bf16: up to 64) of one ``(n, k,
  block_k, dtype)``; the paged kernel lays a query row out and splits its
  page walk alike at T = 1 and T = k + 1 over one table.
* **A replay** of the kernels' per-row arithmetic in f32, each row alone
  (the paged kernel: a lane's 4-dim dot, the warp's butterfly tree, the
  16-position online update, the warps' and splits' ordered folds;
  ``dot_moa``: the plan's sub-ranges folded in order): a T-query call's row
  ``t`` equals a one-query call at ``start + t`` bit for bit, an m-row
  product's row equals the one-row product's, and both lie within the
  tolerances ``chip_smoke.py`` holds the kernels to of the plain versions
  (1e-5 in f32, one bf16 ulp of ``max|ref|`` in bf16).

The kernels themselves run on the card only, where ``chip_smoke.py`` and
``scripts/row_invariance.py`` hold the same properties on the real bits.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.models.api import build_model as jbuild
from repro.serve import OracleDrafter as JOracle
from repro.serve import Sampler as JSampler
from repro.serve import ServeEngine as JEngine
from repro.serve import poisson_workload as j_poisson
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.kernels import dot_moa as dm
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import (OracleDrafter, Sampler, ServeEngine,
                               poisson_workload)

ENGINE = dict(n_slots=3, max_len=48, block_size=8, clock=lambda: 0.0)
NEG_INF = -1e30
_BUILT = {}


def _pair(arch):
    """Both packages' bf16 smoke model on the reference's ``PRNGKey(0)``
    parameters."""
    if arch not in _BUILT:
        jm = jbuild(jsmoke(jget(arch)))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tbuild(tsmoke(tget(arch)))
        tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                               device="cpu"))
        _BUILT[arch] = jm, jp, tm, tp
    return _BUILT[arch]


def _workload(fn, vocab):
    sampler = (Sampler if fn is poisson_workload else JSampler)(0.0)
    return fn(n_requests=6, rate_rps=100.0, vocab=vocab,
              prompt_len_range=(4, 12), gen_len_range=(3, 10),
              sampler=sampler, seed=1)


@pytest.mark.parametrize("arch,paged", [
    ("llama3-8b", False), ("llama3-8b", True),
    ("moonshot-v1-16b-a3b", False)])
def test_bf16_oracle_is_output_neutral(arch, paged):
    """The reference's bf16 acceptance case on the port: the oracle
    accepts every draft, its tokens are plain greedy's, and both are the
    reference's."""
    jm, jp, tm, tp = _pair(arch)
    plain, _ = ServeEngine(tm, tp, paged=paged, device="cpu",
                           **ENGINE).run(_workload(poisson_workload,
                                                   tm.cfg.vocab))
    spec, report = ServeEngine(tm, tp, paged=paged, device="cpu",
                               drafter=OracleDrafter(3), **ENGINE).run(
        _workload(poisson_workload, tm.cfg.vocab))
    jspec, jreport = JEngine(jm, jp, paged=paged, rng=jax.random.PRNGKey(0),
                             drafter=JOracle(3), **ENGINE).run(
        _workload(j_poisson, jm.cfg.vocab))
    assert report["spec"]["accept_rate"] == 1.0
    assert jreport["spec"]["accept_rate"] == 1.0
    assert report["spec"]["tokens_per_step"] > 1.5
    requests = _workload(poisson_workload, tm.cfg.vocab)
    for req, a, b, c in zip(requests, plain, spec, jspec):
        assert a.tokens.tolist() == b.tokens.tolist()
        _same_but_near_ties(jm, jp, req, np.asarray(c.tokens), b.tokens)


#: across frameworks a bf16 divergence must sit at a top-2 gap below this
#: (``tests/test_torch_serve.py``'s rule: XLA and PyTorch round after sums
#: taken in different orders); within the port there is no allowance
NEAR_TIE = 0.05


def _same_but_near_ties(jm, jp, req, want, got):
    """The port's greedy tokens are the reference's, or diverge only at a
    near-tie: on the shared context the reference's top-2 logits are
    within ``NEAR_TIE`` and each package picked one of those two."""
    import jax.numpy as jnp

    got = np.asarray(got)
    if np.array_equal(want, got):
        return
    i = int(np.flatnonzero(want[:len(got)] != got[:len(want)])[0])
    ctx = np.asarray(req.prompt + tuple(int(t) for t in want[:i]),
                     np.int32)[None]
    logits = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(ctx)}))
    top2 = np.argsort(logits[0, -1])[-2:]
    gap = float(logits[0, -1, top2[1]] - logits[0, -1, top2[0]])
    assert gap < NEAR_TIE, (req.uid, i, gap)
    assert {int(want[i]), int(got[i])} <= set(top2.tolist())


# ---------------------------------------------------------------------------
# dot_moa: one per-row arithmetic for every m up to 16
# ---------------------------------------------------------------------------

#: (n, k, block_k, dtype): the served projections (llama3-8b, moonshot's
#: attention and router), the parity phase's f32 ones and ragged shapes
ROW_SHAPES = [(n, k, 2048, dt)
              for k, n in ((4096, 6144), (4096, 4096), (4096, 1024),
                           (4096, 14336), (14336, 4096), (2048, 2048),
                           (2048, 64))
              for dt in (torch.bfloat16, torch.float32)]
ROW_SHAPES += [(333, 1000, 256, torch.float32),
               (333, 1000, 256, torch.bfloat16),
               (4096, 5000, 1000, torch.bfloat16),
               (50, 777, 100, torch.float32)]


def _row_arithmetic(p: dm.Plan) -> tuple:
    """What fixes a row's sums: the body (its in-slice order for a row
    does not depend on the tile's other rows), the column tile and stage,
    and the K ranges and their fold."""
    return (p.body, p.tile_n, p.k_step, p.sub, p.splits, p.one_slice,
            tuple(p.ranges()))


@pytest.mark.parametrize("n,k,bk,dt", ROW_SHAPES,
                         ids=[f"{k}x{n}-bk{bk}-{str(dt)[6:]}"
                              for n, k, bk, dt in ROW_SHAPES])
def test_dot_moa_plan_is_row_invariant(n, k, bk, dt):
    rows = 64 if dt == torch.bfloat16 else 16
    want = _row_arithmetic(dm.plan(1, n, k, bk, dt))
    for m in range(2, rows + 1):
        assert _row_arithmetic(dm.plan(m, n, k, bk, dt)) == want, m
    if dt == torch.bfloat16:      # every m: the tensor-core body
        assert want[0] == "wgmma"
    else:                         # the stream body, sized for 16 rows
        assert want[0] == "stream"


@pytest.mark.parametrize("E,n,k", [(64, 1408, 2048), (64, 2048, 1408)])
def test_batched_expert_plan_is_row_invariant(E, n, k):
    """moonshot's experts: the capacity C (the member's m) follows the
    token count, a decode's and a verify's apart; every C up to 64 gives a
    row the same arithmetic."""
    want = _row_arithmetic(dm.plan(1, n, k, 2048, torch.bfloat16, E))
    for c in range(2, 65):
        assert _row_arithmetic(dm.plan(c, n, k, 2048, torch.bfloat16,
                                       E)) == want


def _dot_replay(a: torch.Tensor, b: torch.Tensor, p: dm.Plan):
    """Each row alone: every K range of the plan summed in K order in f32
    (one FMA chain a column), the ranges folded in order (a slice's
    sub-ranges, then the slices)."""
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32)
    af, bf = a.float(), b.float()
    bk = p.block_k
    for r in range(a.shape[0]):
        slices = {}
        for k0, k1 in p.ranges():
            acc = torch.zeros(b.shape[1], dtype=torch.float32)
            for kk in range(k0, k1):
                acc = acc + af[r, kk] * bf[kk]
            s = k0 // bk
            slices[s] = acc if s not in slices else slices[s] + acc
        total = None
        for s in sorted(slices):
            total = slices[s] if total is None else total + slices[s]
        out[r] = total
    return out.to(a.dtype)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_dot_moa_replay_rows_match(dt):
    """The replay under the plan: rows of an m = 16 product equal the
    one-row products', and lie within the kernel rows' tolerance of the
    plain version."""
    n, k, bk = 40, 300, 128
    g = torch.Generator().manual_seed(2)
    a = torch.randn(16, k, generator=g).to(dt)
    b = (torch.randn(k, n, generator=g) * k ** -0.5).to(dt)
    full = _dot_replay(a, b, dm.plan(16, n, k, bk, dt))
    for m in (1, 4):
        part = _dot_replay(a[:m], b, dm.plan(m, n, k, bk, dt))
        assert torch.equal(part, full[:m])
    want = ref.dot_moa_ref(a, b, block_k=bk)
    tol = (1e-5 * max(1.0, float(want.abs().max())) if dt == torch.float32
           else _bf16_ulp(float(want.float().abs().max())))
    assert float((full.float() - want.float()).abs().max()) <= tol


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


# ---------------------------------------------------------------------------
# paged attention: one row layout and split for T = 1 and T = k + 1
# ---------------------------------------------------------------------------

#: (B, H, Hk, D, bs, n_blocks, pool): the served shapes (llama3-8b H32/8,
#: moonshot H16/16) at each live-block bucket and at long context
PAGED = [(4, 32, 8, 128, 16, n, dt) for n in (1, 2, 4, 6, 64, 256)
         for dt in (torch.bfloat16, torch.int8)]
PAGED += [(4, 16, 16, 128, 16, n, torch.bfloat16) for n in (1, 6)]
PAGED += [(3, 8, 2, 32, 8, 6, torch.float32), (16, 32, 8, 128, 16, 512,
                                              torch.bfloat16)]


def _row_layout(p: pa.Plan) -> tuple:
    return (p.rows, p.cols, p.warps, p.stages, p.pages, p.splits)


@pytest.mark.parametrize("shape", PAGED, ids=str)
def test_paged_plan_is_row_invariant(shape):
    B, H, Hk, D, bs, n, dt = shape
    want = _row_layout(pa.plan(B, 1, H, Hk, D, bs, n, dt))
    for T in (2, 3, 4, 5, 8):
        p = pa.plan(B, T, H, Hk, D, bs, n, dt)
        assert _row_layout(p) == want, T
        assert p.rows == 4 and p.row_tiles == -(-T * (H // Hk) // 4)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``fmaf``: the product exact in f64, one rounding to f32 (two, in
    the rare double-rounding case)."""
    return (a.double() * b.double() + c.double()).float()


def _tree32(v: torch.Tensor) -> torch.Tensor:
    """The butterfly's sum over a warp's 32 lanes (last axis): pairs of
    lanes 16 apart, then 8, 4, 2, 1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _paged_row(q, kp, vp, table, q_pos, p: pa.Plan, n_live: int,
               scale: float):
    """One query row through the kernel's order of arithmetic."""
    D, bs = q.shape[0], kp.shape[1]
    qs = (q.float() * scale)
    lanes = -(-D // 4)
    qd = torch.zeros(lanes * 4)
    qd[:D] = qs
    qd = qd.reshape(lanes, 4)
    splits = []
    for s in range(p.live_splits(n_live)):
        warps = []
        for w in range(p.warps):
            m, l = torch.tensor(NEG_INF), torch.tensor(0.0)
            acc = torch.zeros(D)
            for j in p.warp_pages(s, w, n_live):
                k, v = kp[int(table[j])].float(), vp[int(table[j])].float()
                for c0 in range(0, bs, p.cols):
                    cols = range(c0, c0 + p.cols)
                    sc = torch.full((p.cols,), NEG_INF)
                    valid = torch.zeros(p.cols, dtype=torch.bool)
                    for i, c in enumerate(cols):
                        if c >= bs or j * bs + c > q_pos:
                            continue
                        kd = torch.zeros(lanes * 4)
                        kd[:D] = k[c]
                        kd = kd.reshape(lanes, 4)
                        part = qd[:, 0] * kd[:, 0]
                        for x in range(1, 4):
                            part = _fma(qd[:, x], kd[:, x], part)
                        full = torch.zeros(32)
                        full[:lanes] = part
                        sc[i], valid[i] = _tree32(full), True
                    m_new = torch.maximum(m, sc.max())
                    corr = torch.tensor(1.0) if bool(m_new == m) \
                        else torch.exp(m - m_new)
                    pr = torch.where(valid, torch.exp(sc - m_new),
                                     torch.tensor(0.0))
                    u = pr.reshape(-1, 2).sum(1)      # a lane's two
                    l = _fma(l, corr, _tree32(u))
                    m = m_new
                    acc = acc * corr
                    for i, c in enumerate(cols):
                        vx = v[c] if c < bs else torch.zeros(D)
                        acc = _fma(pr[i].expand(D), vx, acc)
            warps.append((m, l, acc))
        splits.append(_fold(warps))
    return splits[0] if len(splits) == 1 else _fold(splits)


def _fold(parts):
    m = torch.stack([x[0] for x in parts]).max()
    l, acc = torch.tensor(0.0), torch.zeros_like(parts[0][2])
    for pm, pl, pacc in parts:
        e = torch.exp(pm - m)
        l = _fma(pl, e, l)
        acc = _fma(pacc, e.expand_as(pacc), acc)
    return m, l, acc


def paged_replay(q, kp, vp, tables, start, pool_dtype):
    """The paged kernel's arithmetic, each query row alone, under the
    plan of this call's shapes."""
    B, T, H, D = q.shape
    bs, Hk = kp.shape[1], kp.shape[2]
    G = H // Hk
    p = pa.plan(B, T, H, Hk, D, bs, tables.shape[1], pool_dtype)
    out = torch.empty(B, T, H, D, dtype=q.dtype)
    for b in range(B):
        n_live = pa.live_pages(int(start[b]), T, bs, tables.shape[1])
        for h in range(Hk):
            for t in range(T):
                for g in range(G):
                    _, l, acc = _paged_row(
                        q[b, t, h * G + g], kp[:, :, h], vp[:, :, h],
                        tables[b], int(start[b]) + t, p, n_live, D ** -0.5)
                    out[b, t, h * G + g] = (
                        acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_paged_replay_rows_match(dt):
    """Row t of the replayed T = 4 verify equals a replayed one-query
    decode at ``start + t`` over the same table, and both lie within the
    kernel rows' tolerance of the plain version (a table of 6 pages of 4
    tokens: two splits of 4 pages, a page a warp)."""
    B, T, H, Hk, D, bs, n = 2, 4, 4, 2, 16, 4, 6
    g = torch.Generator().manual_seed(9)
    q = torch.randn(B, T, H, D, generator=g).to(dt)
    kp = torch.randn(1 + B * n, bs, Hk, D, generator=g).to(dt)
    vp = torch.randn(1 + B * n, bs, Hk, D, generator=g).to(dt)
    tables = (1 + torch.arange(B * n, dtype=torch.int32)).reshape(B, n)
    start = torch.tensor([5, 17], dtype=torch.int32)
    assert pa.plan(B, T, H, Hk, D, bs, n, dt).splits == 2
    full = paged_replay(q, kp, vp, tables, start, dt)
    for t in range(T):
        one = paged_replay(q[:, t:t + 1].contiguous(), kp, vp, tables,
                           start + t, dt)
        assert torch.equal(one[:, 0], full[:, t]), t
    want = ref.paged_attention_ref(q, kp, vp, tables, start,
                                   dequant_dtype=dt)
    tol = (1e-5 if dt == torch.float32
           else _bf16_ulp(float(want.float().abs().max())))
    assert float((full.float() - want.float()).abs().max()) <= tol


def test_dense_slot_view_is_the_paged_walk():
    """The dense-slot route's identity view: slot b's cache row of
    ``max_len`` tokens is pages ``b * max_len / 16 ..`` of the pool, in
    order, so the kernel reads the slot's own positions."""
    from repro_torch.layers import attention as att

    B, max_len, Hk, D = 3, 48, 2, 8
    cache = torch.randn(B, max_len, Hk, D)
    pages = max_len // att.DENSE_PAGE
    pool = cache.reshape(B * pages, att.DENSE_PAGE, Hk, D)
    tables = att._identity_tables(B, pages, "cpu")
    for b in range(B):
        for pos in range(max_len):
            page = tables[b, pos // att.DENSE_PAGE]
            assert torch.equal(pool[page, pos % att.DENSE_PAGE],
                               cache[b, pos])
