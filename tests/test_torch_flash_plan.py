"""The flash-attention kernels' plan and the bf16 body's arithmetic
(``repro_torch.kernels.flash_attention``).

``plan`` gives the body, tiles, grid and block order from the shape alone,
so it is tested here on the CPU. A plain emulation of the bf16 ``wgmma``
body's order of arithmetic (64-row Q tiles, 64-wide KV tiles walked in
ascending order, the tiles above the causal diagonal skipped, the scores
scaled by ``D**-0.5 · log2(e)`` after the product and exponentiated by
``exp2``, ``p`` rounded to bf16 for ``P·V`` while ``l`` sums the f32 ``p``)
is held against the reference's Pallas kernel in interpret mode within one
bf16 ulp of ``max|ref|`` — the tolerance ``chip_smoke.py`` holds the kernel
to on the card. The kernel itself runs on the card only.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels.flash_attention import plan

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def emulate_wgmma(q, k, v, causal):
    """The bf16 body on ``q (B, Sq, H, D)``, ``k``/``v`` ``(B, Skv, Hk, D)``
    bf16 tensors, tile by tile as ``plan`` lays the grid out."""
    B, Sq, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    p = plan(B, Sq, Skv, H, Hk, D, torch.bfloat16, causal)
    bq, bkv, G = p.block_q, p.block_kv, H // Hk
    sl2 = torch.tensor(D ** -0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)

    def tile(x, r0, n):                       # rows r0.. of x, zero-filled
        t = torch.zeros((B, n) + tuple(x.shape[2:]), dtype=torch.float32)
        part = x[:, r0:r0 + n].float()
        t[:, :part.shape[1]] = part
        return t

    out = torch.empty((B, Sq, H, D), dtype=torch.bfloat16)
    for qt in p.q_tiles:
        q0 = qt * bq
        qf = tile(q, q0, bq)                                  # (B, bq, H, D)
        rows = q0 + torch.arange(bq)
        m = torch.full((B, H, bq), NEG_INF)
        l = torch.zeros((B, H, bq))
        acc = torch.zeros((B, H, bq, D))
        for t in range(p.kv_tiles[qt]):
            kv0 = t * bkv
            kf = tile(k, kv0, bkv).repeat_interleave(G, dim=2)
            vf = tile(v, kv0, bkv).repeat_interleave(G, dim=2)
            x = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sl2
            cols = kv0 + torch.arange(bkv)
            valid = (cols[None, :] < Skv).expand(bq, bkv)
            if causal:
                valid = valid & (cols[None, :] <= rows[:, None])
            x = torch.where(valid, x, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            pr = torch.exp2(x - m_new[..., None])
            l = l * corr + pr.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", pr.bfloat16().float(), vf)
            m = m_new
        o = (acc / torch.clamp(l, min=1e-30)[..., None]).permute(0, 2, 1, 3)
        n = min(bq, Sq - q0)
        out[:, q0:q0 + n] = o[:, :n].to(torch.bfloat16)
    return out


def _pallas(q, k, v, causal):
    """The reference's kernel on the same bf16 values, GQA expanded."""
    B, S, H, D = q.shape

    def bh(x):                  # (B, S, heads, D) -> (B·H, S, D)
        x = x.float().numpy()
        x = np.repeat(x, H // x.shape[2], axis=2)
        return jnp.asarray(np.moveaxis(x, 2, 1).reshape(
            B * H, x.shape[1], D)).astype(jnp.bfloat16)

    out = jops.flash_attention(bh(q), bh(k), bh(v), causal=causal)
    out = np.asarray(out.astype(jnp.float32)).reshape(B, H, S, D)
    return np.moveaxis(out, 1, 2)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [16, 64, 100, 512])
def test_wgmma_arithmetic_matches_pallas(s, causal, d):
    B, H, Hk = 1, 4, 2                       # GQA: two query heads a KV head
    rs = np.random.default_rng(s * 1000 + d + causal)
    q, k, v = (torch.from_numpy(rs.standard_normal((B, s, n, d), np.float32))
               .bfloat16() for n in (H, Hk, Hk))
    want = _pallas(q, k, v, causal)
    got = emulate_wgmma(q, k, v, causal).float().numpy()
    tol = bf16_ulp(float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("s", [16, 26, 44, 64])
def test_wgmma_arithmetic_matches_pallas_without_groups(s):
    """G = 1, as moonshot-v1-16b-a3b serves (H16/16), at exact-length
    prompts: one query head a KV head."""
    B, H, Hk, d = 1, 2, 2, 128
    rs = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rs.standard_normal((B, s, n, d), np.float32))
               .bfloat16() for n in (H, Hk, Hk))
    want = _pallas(q, k, v, True)
    got = emulate_wgmma(q, k, v, True).float().numpy()
    tol = bf16_ulp(float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol


def test_plan_at_the_served_shape():
    # llama3-8b prefill, S = 512: 8 tiles x 32 heads, one wave of two
    # blocks an SM (82 KB of shared memory each), longest tiles first
    p = plan(1, 512, 512, 32, 8, 128, torch.bfloat16, True)
    assert (p.body, p.block_q, p.block_kv) == ("wgmma", 64, 64)
    assert p.grid == (32, 8) and p.blocks == 256 <= 2 * 132
    assert 2 * (p.smem + 1024) <= 228 * 1024
    assert p.q_tiles == tuple(range(7, -1, -1))
    assert p.kv_tiles == tuple(range(1, 9))
    # D <= 64 takes one swizzle atom a tile, half the shared memory
    assert plan(1, 512, 512, 32, 8, 64, torch.bfloat16, True).smem == \
        5 * 64 * 128 + 1024


@pytest.mark.parametrize("s", [16, 32, 64, 96, 100, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_plan_covers_every_tile_once(s, causal):
    for dtype in (torch.bfloat16, torch.float32):
        p = plan(2, s, s, 4, 2, 64, dtype, causal)
        n_q = -(-s // p.block_q)
        assert sorted(p.q_tiles) == list(range(n_q))
        if p.body == "wgmma":
            assert p.grid == (2 * 4, n_q)
            # causal tiles longest first
            walked = [p.kv_tiles[t] for t in p.q_tiles]
            assert walked == sorted(walked, reverse=True)
        else:
            assert p.grid == (n_q, 2 * 4)
        for t in range(n_q):
            q_last = t * p.block_q + p.block_q - 1
            # a KV tile is walked iff it starts inside Skv and, causally,
            # at or left of the tile's last query row
            want = [j for j in range(-(-s // p.block_kv))
                    if not causal or j * p.block_kv <= q_last]
            assert p.kv_tiles[t] == len(want)


@pytest.mark.parametrize("d", [0, 8, 72, 136])
def test_plan_refuses_bf16_head_dims_off_16(d):
    with pytest.raises(ValueError, match="multiple of 16"):
        plan(1, 64, 64, 4, 2, d, torch.bfloat16, True)


def test_plan_takes_every_configured_head_dim():
    # the configs' head_dims (128, 80, 64) and the smoke configs' 16
    for d in (16, 64, 80, 128):
        assert plan(1, 64, 64, 4, 2, d, torch.bfloat16, True).body == "wgmma"
    assert plan(1, 64, 64, 4, 2, 72, torch.float32, True).body == "simt"
    with pytest.raises(ValueError, match="multiple of 4"):
        plan(1, 64, 64, 4, 2, 6, torch.float32, True)
    with pytest.raises(TypeError):
        plan(1, 64, 64, 4, 2, 64, torch.float16, True)
