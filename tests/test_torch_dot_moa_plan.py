"""The ``dot_moa`` kernels' plan (``repro_torch.kernels.dot_moa.plan``).

The plan picks the body and the split-K grid from the shape alone, so it is
tested here on the CPU: its K sub-ranges tile ``[0, k)`` exactly once and
none crosses a ``block_k`` boundary, and a plain emulation of the grid it
gives (each sub-range's partial, a fixed-order sum of each slice's
sub-partials, the slices folded in order) equals ``dot_moa_ref`` — bit for
bit for integers (LOA and the int32 wrap included), within the tolerances
``chip_smoke.py`` states for floats — and the reference's Pallas kernel in
interpret mode. Batched calls (the MoE's experts, one launch over E
members) are planned per member with the batch counted in the split, and
their plain version is the unbatched one over each member, as ``jax.vmap``
of the Pallas kernel computes. The kernels themselves run on the card
(``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dot_moa import dot_moa_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.dot_moa import MIN_BLOCKS, SMS, STREAM_ACC, plan

#: served llama3-8b projections (m = decode slots 4, prefill 64; block_k
#: 2048) and the paper path's contractions (block_k 75 / 256 / 363 / 2048)
SERVED = [(m, k, n, 2048, dt) for m in (1, 4, 16, 17, 64)
          for k, n in ((4096, 6144), (4096, 4096), (4096, 1024),
                       (4096, 14336), (14336, 4096))
          for dt in (torch.bfloat16, torch.int8)]
PAPER = [(2704, 2304, 384, 256, torch.int32), (2704, 2304, 384, 2048,
                                               torch.int32),
         (144, 75, 8, 75, torch.int32), (64, 512, 64, 256, torch.int32),
         (2, 4096, 3, 4096, torch.int32), (64, 384, 40, 128, torch.int32)]
PAPER += [(256, 4096, 256, bk, torch.float32) for bk in (2048, 1024, 512,
                                                          256)]
PAPER += [(48400, 363, 96, bk, torch.float32) for bk in (363, 256)]
PAPER += [(2704, 2304, 384, bk, torch.float32) for bk in (2048, 256)]
PAPER += [(12544, 25, 6, 25, torch.float32), (1600, 150, 16, 150,
                                               torch.float32)]
RAGGED = [(4, 5000, 4096, 1000, torch.bfloat16),
          (64, 5000, 4096, 1000, torch.bfloat16),
          (37, 1000, 333, 256, torch.float32),
          (37, 1000, 333, 256, torch.bfloat16),
          (37, 1000, 333, 256, torch.int8),
          (3, 1000, 333, 256, torch.int32),
          (16, 777, 50, 100, torch.float32),
          (8, 4097, 300, 4097, torch.bfloat16)]
LOA = [(64, 4096, 4096, 256, torch.int8), (37, 1024, 333, 256, torch.int8),
       (4, 4096, 64, 256, torch.int32), (16, 2048, 200, 512, torch.int32)]


def _ids(cases):
    return [f"{m}x{k}x{n}-bk{bk}-{str(dt)[6:]}" for m, k, n, bk, dt in cases]


@pytest.mark.parametrize("m,k,n,bk,dt", SERVED + PAPER + RAGGED + LOA,
                         ids=_ids(SERVED + PAPER + RAGGED + LOA))
def test_sub_ranges_tile_k_within_slices(m, k, n, bk, dt):
    p = plan(m, n, k, bk, dt)
    ranges = p.ranges()
    assert ranges and ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0                       # contiguous: each k once
    for k0, k1 in ranges:
        assert 0 <= k0 < k1 <= k
        assert k0 // bk == (k1 - 1) // bk     # inside one slice
    # the body follows the regime (bf16: wgmma at every m, one per-row
    # arithmetic); a split only where it adds blocks
    assert p.body == ("wgmma" if dt == torch.bfloat16
                      else "stream" if m * 16 // dt.itemsize <= STREAM_ACC
                      else "tc" if dt == torch.int8 else "simt")
    if p.splits:
        assert len(ranges) >= -(-k // bk)
        assert p.sub % p.k_step == 0 or p.sub >= bk
        assert p.workspace == p.slices * p.splits * m * n
    else:
        assert p.body != "stream"


def test_plan_fills_the_card_where_it_can():
    # decode gate/up in bf16: wgmma's 112 column tiles alone give half
    # the SMs a block, so direct mode, no workspace
    p = plan(4, 14336, 4096, 2048, torch.bfloat16)
    assert p.body == "wgmma" and p.splits == 0 and p.workspace == 0
    assert p.blocks >= SMS // 2
    # in f32 (stream, bound by bytes) its sub-ranges hold 16 rows' A in
    # shared memory at any m, workspace under 5 % of the weights
    p = plan(4, 14336, 4096, 2048, torch.float32)
    assert p.body == "stream" and p.blocks >= SMS
    assert p.sub <= 32 * 1024 // (4 * 16)
    assert p.workspace * 4 < 0.05 * 4096 * 14336 * 4
    # the tiles alone fill the card: one sub-range, no workspace
    p = plan(48400, 96, 363, 363, torch.float32)
    assert (p.splits, p.workspace) == (0, 0) and p.tiles >= MIN_BLOCKS
    # prefill down-projection: 32 tiles, so a split inside the 7 slices,
    # the fewest sub-ranges that give half the SMs a block (wgmma's target)
    p = plan(64, 4096, 14336, 2048, torch.bfloat16)
    assert p.body == "wgmma" and p.tiles < SMS // 2
    assert p.splits == 1 and p.blocks >= SMS // 2
    # int8 (mma.sync) still splits to two blocks an SM
    p = plan(64, 4096, 14336, 2048, torch.int8)
    assert p.splits >= 1 and p.blocks >= MIN_BLOCKS


def test_plan_is_deterministic_and_rejects_empty_shapes():
    assert plan(17, 333, 1000, 256, torch.int8) == plan(17, 333, 1000, 256,
                                                       torch.int8)
    with pytest.raises(ValueError):
        plan(0, 4, 4, 4, torch.float32)
    with pytest.raises(TypeError):
        plan(64, 64, 64, 64, torch.float16)


# ---------------------------------------------------------------------------
# the plan's arithmetic, emulated
# ---------------------------------------------------------------------------


def emulate(a: torch.Tensor, b: torch.Tensor, *, block_k: int,
            approx_bits: int = 0) -> torch.Tensor:
    """What the kernels compute under ``plan``: a partial per K range (a
    sub-range in split mode, a slice in direct mode), each slice's
    sub-partials summed in range order, the slices folded in slice order by
    ``+`` or the LOA combine, then one conversion."""
    (m, k), n = a.shape, b.shape[1]
    block_k = min(block_k, k)
    p = plan(m, n, k, block_k, a.dtype)
    accum = torch.int32 if a.dtype in (torch.int8, torch.int32) \
        else torch.float32
    slices = {}
    for k0, k1 in p.ranges():
        part = ref.matmul_accum(a[:, k0:k1], b[k0:k1], accum)
        s = k0 // block_k
        slices[s] = part if s not in slices else slices[s] + part
    acc = None
    for s in sorted(slices):
        acc = slices[s] if acc is None else ref.loa_combine(
            acc, slices[s], approx_bits)
    out = torch.int32 if accum == torch.int32 else a.dtype
    return acc.to(out)


def _operands(rng, m, k, n, kind):
    if kind == "int8":
        return (rng.integers(-127, 128, (m, k)), rng.integers(-127, 128, (k, n)),
                torch.int8)
    if kind == "q8x4":
        return rng.integers(0, 256, (m, k)), rng.integers(0, 16, (k, n)), \
            torch.int32
    if kind == "full":
        return (rng.integers(-2 ** 31, 2 ** 31, (m, k)),
                rng.integers(-2 ** 31, 2 ** 31, (k, n)), torch.int32)
    if kind == "2**38":
        return np.full((m, k), 2 ** 20), np.full((k, n), 64), torch.int32
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[kind]
    return rng.standard_normal((m, k)), rng.standard_normal((k, n)) * k ** -0.5, dt


INT_CASES = [(m, k, n, bk, kind, l)
             for m, k, n, bk, kind in ((4, 4096, 64, 256, "int8"),
                                       (37, 1024, 40, 256, "int8"),
                                       (40, 1024, 24, 256, "q8x4"),
                                       (3, 2048, 20, 512, "q8x4"))
             for l in (0, 1, 4, 6)]
INT_CASES += [(64, 384, 40, 128, "full", 3), (2, 4096, 3, 4096, "2**38", 0),
              (5, 1000, 30, 256, "full", 0), (20, 999, 17, 100, "int8", 0)]


@pytest.mark.parametrize("m,k,n,bk,kind,l", INT_CASES)
def test_emulated_plan_is_bit_exact_for_ints(m, k, n, bk, kind, l):
    rng = np.random.default_rng(m * 7 + k + l)
    x, y, dt = _operands(rng, m, k, n, kind)
    a, b = torch.from_numpy(x).to(dt), torch.from_numpy(y).to(dt)
    p = plan(m, n, k, min(bk, k), dt)
    assert len(p.ranges()) > p.slices or p.body != "stream"
    got = emulate(a, b, block_k=bk, approx_bits=l)
    want = ref.dot_moa_ref(a, b, block_k=bk, approx_bits=l)
    assert torch.equal(got, want)
    if kind == "2**38":
        assert not want.any()        # 4096 * 2**26 = 2**38 wraps to 0


FLOAT_CASES = [(4, 4096, 64, 2048, "bf16"), (4, 5000, 96, 1000, "bf16"),
               (64, 2048, 40, 512, "bf16"), (37, 1000, 33, 256, "f32"),
               (200, 4096, 24, 1024, "f32"), (16, 777, 50, 100, "f32")]


@pytest.mark.parametrize("m,k,n,bk,kind", FLOAT_CASES)
def test_emulated_plan_within_float_tolerance(m, k, n, bk, kind):
    rng = np.random.default_rng(m + k + n)
    x, y, dt = _operands(rng, m, k, n, kind)
    a = torch.from_numpy(x.astype(np.float32)).to(dt)
    b = torch.from_numpy(y.astype(np.float32)).to(dt)
    got = emulate(a, b, block_k=bk).float()
    want = ref.dot_moa_ref(a, b, block_k=bk).float()
    top = float(want.abs().max())
    if dt == torch.bfloat16:
        # chip_smoke.py: 1 bf16 ulp at max|ref| (8 significant bits)
        tol = 2.0 ** (np.floor(np.log2(top)) - 7)
    else:
        # chip_smoke.py: f32 reassociation inside the K clusters
        tol = 1e-4 + 1e-5 * top
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("dtype,l", [("int8", 0), ("int8", 4),
                                     ("float32", 0)])
def test_emulated_plan_matches_pallas_interpret(dtype, l):
    """One small shape through the reference's Pallas kernel in interpret
    mode, as ``tests/test_kernels.py`` runs it."""
    m, k, n, bk = 20, 512, 48, 128
    rng = np.random.default_rng(5)
    if dtype == "int8":
        x = rng.integers(-127, 128, (m, k)).astype(np.int8)
        y = rng.integers(-127, 128, (k, n)).astype(np.int8)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        y = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(dot_moa_pallas(jnp.asarray(x), jnp.asarray(y),
                                     block_m=32, block_n=32, block_k=bk,
                                     approx_bits=l, interpret=True))
    got = emulate(torch.from_numpy(x), torch.from_numpy(y), block_k=bk,
                  approx_bits=l).numpy()
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the batch: (E, m, k) @ (E, k, n) in one launch
# ---------------------------------------------------------------------------

#: moonshot-v1-16b-a3b's expert projections (64 experts, d_model 2048,
#: d_ff 1408, block_k 2048) at decode (C = 1), a short exact-length prefill
#: (C = 4), a 512-token prefill (C = 60) and a ragged C, and its router
EXPERTS = [(64, c, k, n, 2048, torch.bfloat16)
           for c in (1, 4, 5, 60) for k, n in ((2048, 1408), (1408, 2048))]
EXPERTS += [(8, 3, 1000, 333, 256, torch.float32),
            (4, 64, 4096, 256, 256, torch.int8),
            (3, 8, 1024, 64, 256, torch.int32)]


@pytest.mark.parametrize("E,m,k,n,bk,dt", EXPERTS,
                         ids=[f"{E}x{m}x{k}x{n}-{str(dt)[6:]}"
                              for E, m, k, n, bk, dt in EXPERTS])
def test_batched_plan(E, m, k, n, bk, dt):
    """A batched plan keeps the member's body, tile and K ranges, names
    the batch, counts every member's blocks and workspace, and at batch 1
    is the unbatched plan."""
    one, many = plan(m, n, k, bk, dt), plan(m, n, k, bk, dt, E)
    assert plan(m, n, k, bk, dt, 1) == one and one.batch == 1
    assert many.batch == E
    assert (many.body, many.tile_m, many.tile_n) == \
        (one.body, one.tile_m, one.tile_n)
    assert many.blocks == E * dataclasses.replace(many, batch=1).blocks
    assert many.workspace == E * dataclasses.replace(many,
                                                     batch=1).workspace
    ranges = many.ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for k0, k1 in ranges:
        assert k0 // many.block_k == (k1 - 1) // many.block_k
    # more members fill the card: never more sub-ranges than one member's
    assert many.splits <= one.splits or not one.splits
    if many.body == "stream":       # bound by bytes: one wave, or one split
        assert many.blocks <= MIN_BLOCKS or many.splits == \
            -(-many.block_k // (32 * 1024 // (4 * many.tile_m)))
    # the workspace stays under its cap for the whole batch
    cap = max(0.05 * E * (m * k + k * n) * dt.itemsize, 16 << 20)
    assert many.workspace * 4 <= cap or not many.splits


def test_served_expert_plans():
    """Decode's expert rows run on wgmma as every bf16 row does, in direct
    mode, one slice a block, 11 and 16 column tiles a member (704 and
    1024 blocks); the 512-token prefill's too."""
    gate = plan(1, 1408, 2048, 2048, torch.bfloat16, 64)
    down = plan(1, 2048, 1408, 1408, torch.bfloat16, 64)
    assert (gate.body, gate.splits, gate.blocks, gate.one_slice) == \
        ("wgmma", 0, 704, True)
    assert (down.body, down.splits, down.blocks, down.one_slice) == \
        ("wgmma", 0, 1024, True)
    pre = plan(60, 1408, 2048, 2048, torch.bfloat16, 64)
    assert (pre.body, pre.splits, pre.blocks, pre.one_slice) == \
        ("wgmma", 0, 704, True)


def test_plain_batched_version_is_member_by_member():
    rng = np.random.default_rng(3)
    for dt, l in ((torch.float32, 0), (torch.bfloat16, 0), (torch.int8, 4),
                  (torch.int32, 2)):
        if dt.is_floating_point:
            a = torch.from_numpy(rng.standard_normal((5, 3, 256))).to(dt)
            b = torch.from_numpy(rng.standard_normal((5, 256, 7))).to(dt)
        else:
            a = torch.from_numpy(rng.integers(-100, 100, (5, 3, 256))).to(dt)
            b = torch.from_numpy(rng.integers(-100, 100, (5, 256, 7))).to(dt)
        got = ref.dot_moa_batched_ref(a, b, block_k=64, approx_bits=l)
        assert got.shape == (5, 3, 7)
        for e in range(5):
            assert torch.equal(got[e], ref.dot_moa_ref(
                a[e], b[e], block_k=64, approx_bits=l))
    # bf16 operands with f32 output: the MoE router's product
    out = ref.dot_moa_batched_ref(torch.ones((2, 4, 8), dtype=torch.bfloat16),
                                  torch.ones((2, 8, 3), dtype=torch.bfloat16),
                                  block_k=4, out_dtype=torch.float32)
    assert out.dtype == torch.float32 and bool((out == 8).all())
    with pytest.raises(ValueError):
        ref.dot_moa_batched_ref(torch.ones((2, 3, 4)), torch.ones((3, 4, 5)))


@pytest.mark.parametrize("dtype,l", [("int8", 0), ("int8", 4),
                                     ("float32", 0)])
def test_batched_plain_matches_vmap_of_pallas_interpret(dtype, l):
    """``jax.vmap`` of ``dot_moa_pallas`` (interpret mode) over a batch of
    3 against the plain batched version: the vmap adds a leading batch
    grid axis, each member folds as the unbatched kernel."""
    E, m, k, n, bk = 3, 10, 256, 24, 64
    rng = np.random.default_rng(6)
    if dtype == "int8":
        x = rng.integers(-127, 128, (E, m, k)).astype(np.int8)
        y = rng.integers(-127, 128, (E, k, n)).astype(np.int8)
    else:
        x = rng.standard_normal((E, m, k)).astype(np.float32)
        y = rng.standard_normal((E, k, n)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda p, q: dot_moa_pallas(
        p, q, block_m=16, block_n=16, block_k=bk, approx_bits=l,
        interpret=True))(jnp.asarray(x), jnp.asarray(y)))
    got = ref.dot_moa_batched_ref(torch.from_numpy(x), torch.from_numpy(y),
                                  block_k=bk, approx_bits=l).numpy()
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
