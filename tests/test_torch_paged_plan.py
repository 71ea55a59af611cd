"""The paged-attention kernel's plan and its order of arithmetic
(``repro_torch.kernels.paged_attention``).

``plan`` splits each slot's page walk from the shapes alone, so it is tested
here on the CPU: it reads no ``start`` and no table, every live page falls
to exactly one warp of one split, splits past a slot's live pages are empty,
the grid follows the stated waves and the shared memory fits. A plain
emulation of the kernel's order of arithmetic (each warp's interleaved pages
walked online in f32, one update per ``cols`` page positions; an int8 page
rounded through ``dequant_dtype``; the warps, then the live splits, folded
in order) is held against the reference's Pallas kernel in interpret mode,
within 1e-5 in f32 and one bf16 ulp of ``max|ref|`` in bf16 -- the
tolerances ``chip_smoke.py`` holds the kernel to on the card. The kernel
itself runs on the card only. Every call lays its query rows out in
4-row tiles, so a row's arithmetic is the same at every T
(``test_torch_spec_bf16.py`` replays it row by row).
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.paged_attention import live_pages, plan

NEG_INF = -1e30

#: (B, T, H, Hk, D, bs, n_blocks, pool): the served decode at the live-block
#: buckets up to max_len 4096 (and moonshot-v1-16b-a3b's, H16/16, up to
#: max_len 96), the long-context and verify rows of chip_smoke.py, and the
#: f32 row
SERVED = [(4, 1, 32, 8, 128, 16, n, dt)
          for n in (1, 2, 4, 6, 8, 16, 32, 64, 128, 256)
          for dt in (torch.bfloat16, torch.int8)]
SERVED += [(4, 1, 16, 16, 128, 16, n, dt) for n in (1, 2, 4, 6)
           for dt in (torch.bfloat16, torch.int8)]
SHAPES = SERVED + [
    (16, 1, 32, 8, 128, 16, 512, torch.bfloat16),
    (4, 4, 32, 8, 128, 16, 256, torch.bfloat16),
    (4, 4, 4, 2, 64, 16, 4, torch.float32),
    (4, 1, 32, 8, 128, 16, 32, torch.float32),
    (2, 5, 16, 4, 64, 8, 40, torch.bfloat16),     # R = 20: two row tiles
    (1, 1, 8, 8, 16, 4, 9000, torch.int8),        # S_MAX raises the pages
    (2, 4, 16, 4, 36, 8, 16, torch.float32),      # R = 16: four row tiles
]


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


def test_plan_reads_shapes_only():
    """The plan's inputs are shapes and the pool's type: it cannot read
    ``start`` or a table, so a call needs no synchronisation."""
    assert list(inspect.signature(plan).parameters) == [
        "B", "T", "H", "Hk", "D", "bs", "n_blocks", "pool_dtype"]
    assert plan(*SHAPES[0]) is plan(*SHAPES[0])        # cached by shape


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_covers_each_live_page_once(shape):
    p = plan(*shape)
    n_blocks = shape[6]
    for n_live in sorted({0, 1, 2, p.pages - 1, p.pages, p.pages + 1,
                          n_blocks // 2, n_blocks - 1, n_blocks}):
        if not 0 <= n_live <= n_blocks:
            continue
        seen = []
        for s in range(p.splits):
            pages = p.split_pages(s, n_live)
            if s >= p.live_splits(n_live):
                assert not pages, (s, n_live)
            elif n_live:
                assert pages, (s, n_live)
            split = sorted(j for w in range(p.warps)
                           for j in p.warp_pages(s, w, n_live))
            assert split == list(pages)
            seen += split
        assert sorted(seen) == list(range(n_live))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_grid_and_waves(shape):
    B, T, H, Hk, D, bs, n_blocks, dt = shape
    p = plan(*shape)
    R = T * H // Hk
    assert (p.rows, p.cols) == (4, 16)        # one row layout at every T
    assert p.row_tiles == -(-R // p.rows)
    assert p.grid == (p.splits, Hk * p.row_tiles, B)
    assert p.splits == -(-n_blocks // p.pages) <= pa.S_MAX
    heads = B * Hk                             # the split ignores row tiles
    two_waves = 2 * p.wave
    floor = -(-n_blocks // pa.S_MAX)           # pages S_MAX splits need
    assert p.pages >= p.warps                  # at least a page a warp
    if p.pages > floor:
        # the least power of two from a page a warp within two waves
        # (two waves of one row tile a KV head: the split is T's alike)
        assert p.pages & (p.pages - 1) == 0 \
            and p.blocks // p.row_tiles <= two_waves
        if p.pages > p.warps:
            assert heads * -(-n_blocks // (p.pages // 2)) > two_waves
    # workspace and tickets only where splits are folded
    assert (p.workspace > 0) == (p.tickets > 0) == (p.splits > 1)
    if p.splits > 1:
        assert p.workspace == heads * p.row_tiles * p.splits * (
            p.rows * D + 2 * p.rows) * 4
        assert p.tickets == heads * p.row_tiles


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_shared_memory_fits(shape):
    p = plan(*shape)
    assert p.smem <= pa.MAX_SMEM
    assert p.blocks_per_sm >= 1 and p.threads == 32 * p.warps
    assert 2 <= p.stages <= 4


def test_plan_served_layout():
    """The served decode (B4 T1 H32/8 D128 bs16, bf16 pool): four warps
    with a two-page ring each, three blocks an SM, a page a warp; the
    long-context and verify shapes and an int8 pool fit too, the verify
    (T = 4) in four 4-row tiles with the decode's split."""
    p = plan(4, 1, 32, 8, 128, 16, 32, torch.bfloat16)
    assert (p.warps, p.stages, p.rows, p.cols) == (4, 2, 4, 16)
    # ring 4 x 2 x 8 KB, q rows 2 KB, p buffers 2.5 KB, fold statistics
    assert p.smem == 65536 + 2048 + 2560 + (2 * 64 * 4 + 8) * 4
    assert p.blocks_per_sm == 3
    assert (p.pages, p.splits) == (4, 8)
    assert plan(4, 1, 32, 8, 128, 16, 256, torch.bfloat16).pages == 16
    assert plan(16, 1, 32, 8, 128, 16, 512, torch.bfloat16).pages == 128
    v = plan(4, 4, 32, 8, 128, 16, 256, torch.bfloat16)
    assert (v.rows, v.cols, v.row_tiles, v.blocks_per_sm) == (4, 16, 4, 3)
    assert v.pages == plan(4, 1, 32, 8, 128, 16, 256,
                           torch.bfloat16).pages   # T leaves the split be
    assert v.smem <= pa.MAX_SMEM
    i8 = plan(4, 1, 32, 8, 128, 16, 256, torch.int8)
    assert i8.stages == 3 and i8.blocks_per_sm == 3


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="head_dim"):
        plan(1, 1, 4, 2, 130, 16, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        plan(1, 1, 4, 2, 18, 16, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        plan(1, 1, 4, 2, 128, 256, 4, torch.float32)
    with pytest.raises(TypeError):
        plan(1, 1, 4, 2, 64, 16, 4, torch.float16)


def test_live_pages():
    assert live_pages(0, 1, 16, 8) == 1
    assert live_pages(15, 1, 16, 8) == 1
    assert live_pages(16, 1, 16, 8) == 2
    assert live_pages(13, 4, 16, 8) == 2          # deepest query at 16
    assert live_pages(500, 1, 16, 8) == 8         # the table's width
    assert live_pages(-3, 1, 16, 8) == 0


# ---------------------------------------------------------------------------
# the kernel's order of arithmetic against the Pallas kernel
# ---------------------------------------------------------------------------


def _fold(parts):
    """m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m),
    summed in the order of ``parts``."""
    m = torch.stack([x[0] for x in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for pm, pl, pacc in parts:
        e = torch.exp(pm - m)
        l = l + pl * e
        acc = acc + pacc * e[:, None]
    return m, l, acc


def emulate(q, kp, vp, tables, start, *, k_scale=None, v_scale=None,
            dequant_dtype=torch.bfloat16):
    """The kernel, block by block as ``plan`` lays it out, in f32."""
    B, T, H, D = q.shape
    bs, Hk = kp.shape[1], kp.shape[2]
    G, n_blocks = H // Hk, tables.shape[1]
    R = T * G
    p = plan(B, T, H, Hk, D, bs, n_blocks, kp.dtype)
    scale = torch.tensor(D ** -0.5, dtype=torch.float32)
    out = torch.empty_like(q)
    for b in range(B):
        n_live = live_pages(int(start[b]), T, bs, n_blocks)
        q_pos = int(start[b]) + torch.arange(R) // G
        for h in range(Hk):
            qs = q[b, :, h * G:(h + 1) * G].float().reshape(R, D) * scale

            def page(j):
                pg = int(tables[b, j])
                k, v = kp[pg, :, h].float(), vp[pg, :, h].float()
                if k_scale is not None:
                    k = (k * k_scale[pg, :, h, None]).to(dequant_dtype).float()
                    v = (v * v_scale[pg, :, h, None]).to(dequant_dtype).float()
                return k, v

            splits = []
            for s in range(p.live_splits(n_live)):
                warps = []
                for w in range(p.warps):
                    m = torch.full((R,), NEG_INF)
                    l = torch.zeros(R)
                    acc = torch.zeros(R, D)
                    for j in p.warp_pages(s, w, n_live):
                        k, v = page(j)
                        for c0 in range(0, bs, p.cols):
                            cols = torch.arange(c0, min(c0 + p.cols, bs))
                            valid = (j * bs + cols)[None, :] <= q_pos[:, None]
                            sc = torch.where(valid, qs @ k[cols].T,
                                             torch.tensor(NEG_INF))
                            m_new = torch.maximum(m, sc.amax(1))
                            corr = torch.where(m_new == m, torch.tensor(1.0),
                                               torch.exp(m - m_new))
                            pr = torch.where(valid,
                                             torch.exp(sc - m_new[:, None]),
                                             torch.tensor(0.0))
                            l = l * corr + pr.sum(1)
                            acc = acc * corr[:, None] + pr @ v[cols]
                            m = m_new
                    warps.append((m, l, acc))
                splits.append(_fold(warps))
            _, l, acc = splits[0] if len(splits) == 1 else _fold(splits)
            o = acc / torch.clamp(l, min=1e-30)[:, None]
            out[b, :, h * G:(h + 1) * G] = o.reshape(T, G, D).to(q.dtype)
    return out


#: name -> (T, q dtype, pool, dequant_dtype, n_blocks, starts[, (H, Hk)]);
#: B = 3, H 8 / Hk 2 unless given, D 32, bs 4: at n_blocks 20 the plan
#: takes pages of 4 (5 splits, a page a warp), and slot 0 is shallower than
#: the first split; at n_blocks 4 one split walks the table
CASES = {
    "T1 bf16 pool, 5 splits": (1, "bfloat16", "bfloat16", "bfloat16", 20,
                               (2, 41, 79)),
    "T4 f32 pool, 5 splits": (4, "float32", "float32", "float32", 20,
                              (0, 29, 76)),
    "T1 int8 pool via bf16": (1, "bfloat16", "int8", "bfloat16", 20,
                              (5, 33, 79)),
    "T4 int8 pool via f32": (4, "float32", "int8", "float32", 20,
                             (3, 44, 76)),
    "T1 f32 pool, one split": (1, "float32", "float32", "float32", 4,
                               (0, 9, 15)),
    "T4 bf16 pool, one split": (4, "bfloat16", "bfloat16", "bfloat16", 4,
                                (1, 6, 12)),
    # G 1 (moonshot's H16/16): one query row in a tile of the group's rows
    "T1 bf16 pool, G 1": (1, "bfloat16", "bfloat16", "bfloat16", 20,
                          (2, 41, 79), (4, 4)),
    "T1 int8 pool via bf16, G 1": (1, "bfloat16", "int8", "bfloat16", 20,
                                   (5, 33, 79), (4, 4)),
}


def _problem(T, qdt, pool, n_blocks, starts, B=3, H=8, Hk=2, D=32, bs=4):
    """Seeded numpy inputs; every dead table entry points at the last page,
    which is poisoned (NaN, or a NaN scale for an int8 pool): a read of a
    dead page would show."""
    rs = np.random.default_rng(16 + T + n_blocks)
    n_phys = 2 + B * n_blocks
    q = rs.standard_normal((B, T, H, D)).astype(np.float32)
    start = np.asarray(starts, np.int32)
    tables = np.full((B, n_blocks), n_phys - 1, np.int32)
    for b, s in enumerate(starts):
        n_live = live_pages(s, T, bs, n_blocks)
        tables[b, :n_live] = 1 + b * n_blocks + rs.permutation(n_live)
    ks = vs = None
    if pool == "int8":
        kp = rs.integers(-127, 128, (n_phys, bs, Hk, D)).astype(np.float32)
        vp = rs.integers(-127, 128, (n_phys, bs, Hk, D)).astype(np.float32)
        ks = rs.uniform(0.005, 0.03, (n_phys, bs, Hk)).astype(np.float32)
        vs = rs.uniform(0.005, 0.03, (n_phys, bs, Hk)).astype(np.float32)
        ks[-1] = vs[-1] = np.nan
    else:
        kp = rs.standard_normal((n_phys, bs, Hk, D)).astype(np.float32)
        vp = rs.standard_normal((n_phys, bs, Hk, D)).astype(np.float32)
        kp[-1] = vp[-1] = np.nan
    return q, kp, vp, ks, vs, tables, start


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_pallas(case):
    T, qdt, pool, dq, n_blocks, starts, *heads = CASES[case]
    q, kp, vp, ks, vs, tables, start = _problem(
        T, qdt, pool, n_blocks, starts,
        **(dict(zip(("H", "Hk"), heads[0])) if heads else {}))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "int8": jnp.int8}
    scales = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    got = emulate(torch.from_numpy(q).to(tdt[qdt]),
                  torch.from_numpy(kp).to(tdt[pool]),
                  torch.from_numpy(vp).to(tdt[pool]),
                  torch.from_numpy(tables), torch.from_numpy(start),
                  **{k: torch.from_numpy(v) for k, v in scales.items()},
                  dequant_dtype=tdt[dq])
    want = paged_attention_pallas(
        jnp.asarray(q).astype(jdt[qdt]), jnp.asarray(kp).astype(jdt[pool]),
        jnp.asarray(vp).astype(jdt[pool]), jnp.asarray(tables),
        jnp.asarray(start),
        **{k: jnp.asarray(v) for k, v in scales.items()},
        dequant_dtype=jdt[dq], interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    p = plan(3, T, 8, 2, 32, 4, n_blocks, tdt[pool])
    if n_blocks > p.pages:       # split cases: slot 0 within the first split
        assert p.splits > 1 and live_pages(starts[0], T, 4, n_blocks) \
            < p.pages
    else:
        assert p.splits == 1
    if qdt == "bfloat16":
        tol = bf16_ulp(float(np.abs(want).max()))
    else:
        tol = 1e-5
    np.testing.assert_array_less(np.abs(got - want), tol + 1e-30)
