"""The cluster reductions' plan and its order of arithmetic
(``repro_torch.kernels.moa_reduce.plan``, which ``moa_reduce`` and
``loa_reduce`` share).

``plan`` picks the route, the column tiles and the row splits from the
shapes alone, so it is tested here on the CPU: it reads no operand, every
row is read by exactly one split, no split of the ordered route crosses a
cluster boundary, the grid and the workspace stay legal at
``(70000, 4, block_n 1)``, the route follows the type and ``approx_bits``,
and what the kernel does not take raises. A CPU replay of the plan's
schedule (each split's partial, then the last block's fold: a cluster's
partials summed in split order, the cluster sums folded in cluster order;
or, ``direct``, x's rows folded one a cluster) is held against the
reference's Pallas kernels in interpret mode and the port's plain
versions: integer and LOA results bit for bit, f32 within atol 1e-4 +
rtol 1e-5 of max|ref| -- the tolerance ``chip_smoke.py`` holds the kernel
to on the card (the replay reassociates inside a cluster only). The kernel
itself runs on the card only.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.loa_add import loa_reduce_pallas
from repro.kernels.moa_reduce import moa_reduce_pallas
from repro_torch.kernels import ref
from repro_torch.kernels import moa_reduce as mr
from repro_torch.kernels.moa_reduce import plan

I32, F32 = torch.int32, torch.float32

#: (n, f, block_n, dtype, approx_bits): chip_smoke.py's rows (Fig. 4, the
#: tree, the ragged and the block_n 1 edges, conv3's LOA fan-in, the 268 MB
#: rows, the MoE combine, f of 1 and 2 over several splits, one-word bf16
#: and int8 rows, short clusters on the partials route) and the CPU
#: replay's cases
SHAPES = [
    (4096, 256, 512, F32, 0), (4096, 256, 4096, F32, 0),
    (4096, 256, 512, torch.bfloat16, 0), (4096, 256, 512, I32, 0),
    (4096, 256, 512, torch.int8, 0), (777, 130, 64, F32, 0),
    (513, 129, 100, I32, 0), (70000, 4, 1, I32, 0), (70000, 4, 1, F32, 0),
    (4096, 8, 512, I32, 0), (2304, 4096, 256, I32, 4),
    (2304, 4096, 256, I32, 0), (1024, 256, 256, I32, 2),
    (4096, 7, 64, I32, 8), (16384, 4096, 512, F32, 0),
    (16384, 4096, 256, I32, 4), (6, 1048576, 6, torch.bfloat16, 0),
    (256, 3, 1, F32, 0), (256, 7, 8, torch.bfloat16, 0),
    (300, 1, 7, F32, 0), (4096, 1024, 512, torch.int8, 0),
    (8192, 1, 512, I32, 0), (4096, 2, 4096, F32, 0),
    (1000, 7, 10, torch.bfloat16, 0), (4096, 12, 512, torch.int8, 0),
    (70000, 4, 15, F32, 0), (16384, 32, 4, F32, 0), (4096, 256, 8, F32, 0),
    (4096, 3, 1, F32, 0), (4096, 8, 1, torch.bfloat16, 0),
]


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 modulo 2**32."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(I32)


def replay(x: torch.Tensor, block_n: int, approx_bits: int = 0,
           aligned: bool = True) -> torch.Tensor:
    """The kernel's schedule on the CPU, from its plan: what each split
    block writes, then what the last block of a column tile folds, in the
    plan's order (the columns are independent, so one pass covers every
    column tile). Integer sums are exact modulo 2**32, as the kernel's."""
    n, f = x.shape
    p = plan(n, f, block_n, x.dtype, approx_bits, aligned)
    integer = not x.dtype.is_floating_point
    wide = x.long() if integer else x.float()

    def total(rows: torch.Tensor) -> torch.Tensor:
        s = rows.sum(0) if len(rows) else torch.zeros_like(wide[0])
        return _wrap32(s) if integer else s

    def fold(acc, part):
        if acc is None:
            return part
        if integer:
            return ref.loa_combine(acc, part, approx_bits)
        return acc + part

    if p.direct:
        source = wide
    else:
        source = torch.stack([total(wide[r.start:r.stop])
                              for r in map(p.rows, range(p.splits))])
        if p.splits == 1:
            return source[0]
        source = source.long() if integer else source
    acc = None
    for c0 in range(0, source.shape[0], p.group):
        part = source[c0]
        for j in range(c0 + 1, min(c0 + p.group, source.shape[0])):
            part = part + source[j]           # in split order
        acc = fold(acc, _wrap32(part) if integer else part)
    return acc


def _f32_tol(want: np.ndarray) -> float:
    return 1e-4 + 1e-5 * float(np.abs(want).max())


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


def test_plan_reads_shapes_only():
    """The plan's inputs are shapes, the type, ``l`` and the base's 16-byte
    alignment: it cannot read an operand, so a call needs no
    synchronisation."""
    assert list(inspect.signature(plan).parameters) == [
        "n", "f", "block_n", "dtype", "approx_bits", "aligned"]
    assert plan(*SHAPES[0]) is plan(*SHAPES[0])        # cached by shape


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_reads_each_row_once(shape):
    p = plan(*shape)
    n, f = shape[:2]
    if p.direct:        # one block a column tile folds x's rows in order
        assert (p.splits, p.workspace, p.tickets) == (0, 0, 0)
        assert p.blocks == p.col_tiles
        return
    seen = [r for s in range(p.splits) for r in p.rows(s)]
    assert sorted(seen) == list(range(n)), "a row read twice or never"
    assert max(len(p.rows(s)) for s in range(p.splits)) <= p.seg_rows
    assert p.blocks == p.col_tiles * p.splits


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_covers_each_column_once(shape):
    p = plan(*shape)
    f = shape[1]
    assert p.tile_v * p.lanes == mr.THREADS
    assert (p.col_tiles - 1) * p.cols < f <= p.col_tiles * p.cols
    if p.vec > 1:       # 16-byte loads: whole vectors, 16-byte rows
        assert p.vec * shape[3].itemsize == 16 and f % p.vec == 0
    if p.direct or p.splits > 1:   # the fold: a column of x, 4 of partials
        assert p.cols <= (1 if p.direct else 4) * mr.THREADS
        assert p.wp % 4 == 0 and p.wp >= p.cols


@pytest.mark.parametrize("shape", [s for s in SHAPES
                                   if plan(*s).route == "ordered"], ids=str)
def test_ordered_splits_stay_in_their_cluster(shape):
    n, f, block_n = shape[:3]
    p = plan(*shape)
    assert p.cluster_rows == block_n and p.n_clusters == -(-n // block_n)
    if p.direct:        # one row a cluster, folded straight from x
        assert block_n == 1 and p.group == 1 and p.chunk >= 1
        return
    assert p.splits == p.n_clusters * p.spc and p.group == p.spc
    for s in range(p.splits):
        c = s // p.spc
        rows = p.rows(s)
        assert c * block_n <= rows.start
        assert rows.stop <= min((c + 1) * block_n, n) or not rows


def _join_words(tv: int, vec: int) -> int:
    """Words ``join_lanes`` writes to shared memory: tv threads of vec
    accumulators a row lane, one row of tv * vec words for each warp (each
    row lane where it is a warp or more)."""
    groups = 8 if tv < 32 else 256 // tv
    return groups * tv * vec


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_smem_covers_what_the_kernel_writes(shape):
    """A block joins its lanes (tile_v threads of vec words); the last block
    of an assoc tile joins the partials (4 words a thread, so f of 1 or 2
    needs more than the block's join); the ordered fold keeps ``chunk``
    cluster sums; ``direct`` stages ``STAGES`` chunks of x's rows."""
    p = plan(*shape)
    item = shape[3].itemsize
    if p.direct:
        assert p.smem >= mr.STAGES * p.chunk * p.cols * item
    else:
        assert p.smem >= 4 * _join_words(p.tile_v, p.vec)
        if p.splits > 1 and p.route == "assoc":
            assert p.smem >= 4 * _join_words(max(1, p.cols // 4), 4)
        if p.splits > 1 and p.route == "ordered":
            assert p.smem >= 4 * p.chunk * p.wp
    assert p.smem <= mr.MAX_SMEM


def test_plan_grid_legal_at_block_n_1():
    """70 000 clusters of one row: the old two-pass grid capped gridDim.y at
    65 535 and strode; the plan's 1-D grid and its workspace stay small."""
    for dtype in (I32, F32):
        p = plan(70000, 4, 1, dtype)
        assert 1 <= p.blocks < 2 ** 31 and p.blocks <= mr.TARGET_BLOCKS
        assert p.smem <= mr.MAX_SMEM
        assert p.tickets == (p.col_tiles if p.splits > 1 else 0)
        assert p.workspace == (p.col_tiles * p.splits * p.wp * 4
                               if p.splits > 1 else 0)
        assert p.workspace <= 70000 * 4 * 4 // 64
    assert plan(70000, 4, 1, I32).route == "assoc"
    assert plan(70000, 4, 1, F32).direct


@pytest.mark.parametrize("dtype,l,block_n,route", [
    (I32, 0, 64, "assoc"), (torch.int8, 0, 64, "assoc"),
    (F32, 0, 64, "ordered"), (torch.bfloat16, 0, 64, "ordered"),
    (F32, 0, 4096, "assoc"),                # one cluster: no fold
    (I32, 1, 64, "ordered"), (I32, 31, 64, "ordered"),
    (I32, 4, 4096, "assoc"),                # one cluster: no LOA fold
], ids=str)
def test_route_follows_type_and_l(dtype, l, block_n, route):
    p = plan(4096, 64, block_n, dtype, l)
    assert p.route == route
    if route == "assoc":
        assert p.n_clusters == 1 and p.cluster_rows == 4096
    assert p.approx_bits == l


@pytest.mark.parametrize("args,direct", [
    ((70000, 4, 1, F32, 0), True),            # one 16-byte row a cluster
    ((256, 3, 1, F32, 0), True),              # 12-byte rows: word copies
    ((64, 4, 1, I32, 8), True),               # an LOA fold of single rows
    ((4096, 8, 1, torch.bfloat16, 0), True),  # one 16-byte vector
    ((4096, 7, 1, torch.bfloat16, 0), False),  # 2-byte words: no copy
    ((70000, 8, 1, F32, 0), False),           # 32-byte rows
    ((70000, 4, 2, F32, 0), False),           # two rows a cluster
    ((70000, 4, 1, I32, 0), False),           # integer +: assoc
], ids=str)
def test_direct_only_for_one_short_row_a_cluster(args, direct):
    """The direct route won at one 16-byte row a cluster and lost at every
    wider cluster measured (``DIRECT_ROW_BYTES``)."""
    assert plan(*args).direct == direct


def test_plan_takes_16_bytes_only_where_aligned():
    assert plan(4096, 256, 512, F32).vec == 4
    assert plan(4096, 256, 512, F32, aligned=False).vec == 1
    assert plan(4096, 130, 512, F32).vec == 1       # 520-byte rows
    assert plan(4096, 8, 512, torch.bfloat16).vec == 8
    assert plan(4096, 16, 512, torch.int8).vec == 16
    assert plan(4096, 12, 512, torch.int8).vec == 1


@pytest.mark.parametrize("args,err", [
    ((64, 8, 8, torch.float16, 0), TypeError),
    ((64, 8, 8, torch.int64, 0), TypeError),
    ((64, 8, 8, F32, 2), TypeError),         # LOA on floats
    ((64, 8, 0, I32, 0), ValueError),
    ((0, 8, 8, I32, 0), ValueError),
    ((64, 0, 8, I32, 0), ValueError),
    ((64, 8, 8, I32, 32), ValueError),
    ((64, 8, 8, I32, -1), ValueError),
    ((300, 8, 256, I32, 2), ValueError),     # LOA needs whole clusters
], ids=str)
def test_plan_raises_on_what_the_kernel_does_not_take(args, err):
    with pytest.raises(err):
        plan(*args)


# ---------------------------------------------------------------------------
# the replay against the Pallas kernels (interpret mode) and the plain
# versions
# ---------------------------------------------------------------------------

#: (n, f, block_n, dtype): Fig. 4's shape, a ragged last cluster, the int32
#: edge, block_n 1, f of 1, 3 and 7 (no 16-byte path), int8 and bf16, f of
#: 1 and 2 over several splits
MOA_CASES = [
    (4096, 256, 512, "float32"), (4096, 256, 4096, "float32"),
    (4096, 256, 512, "int32"), (777, 130, 64, "float32"),
    (513, 129, 100, "int32"), (256, 4, 1, "float32"), (256, 4, 1, "int32"),
    (300, 1, 7, "float32"), (256, 3, 16, "float32"), (256, 7, 32, "int32"),
    (1024, 256, 512, "int8"), (1024, 256, 128, "bfloat16"),
    (1000, 7, 10, "bfloat16"), (8192, 1, 512, "int32"),
    (4096, 2, 4096, "float32"),
]


def _operand(n, f, dtype, seed):
    rs = np.random.default_rng(seed)
    if dtype == "float32":
        return rs.standard_normal((n, f)).astype(np.float32)
    if dtype == "bfloat16":
        x = rs.standard_normal((n, f)).astype(np.float32)
        return np.asarray(torch.from_numpy(x).bfloat16().float())
    lo, hi = (-128, 128) if dtype == "int8" else (-2 ** 31, 2 ** 31)
    return rs.integers(lo, hi, (n, f)).astype(
        np.int8 if dtype == "int8" else np.int32)


@pytest.mark.parametrize("case", MOA_CASES, ids=str)
def test_moa_replay_matches_pallas(case):
    n, f, block_n, dtype = case
    x = _operand(n, f, dtype, seed=n + f + block_n)
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        tx, jx = tx.bfloat16(), jx.astype(jnp.bfloat16)
    got = replay(tx, block_n)
    want = np.asarray(moa_reduce_pallas(jx, block_n=block_n,
                                        interpret=True))
    plain = ref.moa_reduce_ref(tx, block_n=block_n)
    if dtype in ("int32", "int8"):
        assert got.dtype == I32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
    else:
        assert got.dtype == F32
        tol = _f32_tol(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                                   atol=tol)


def test_moa_replay_wraps_as_pallas():
    """2**20 summed 4096 times is 2**32, which wraps to 0 in int32."""
    x = np.full((4096, 8), 2 ** 20, np.int32)
    got = replay(torch.from_numpy(x), 512)
    want = np.asarray(moa_reduce_pallas(jnp.asarray(x), block_n=512,
                                        interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.any()


def test_moa_replay_unaligned_takes_the_word_path():
    x = _operand(640, 16, "float32", seed=3)
    p = plan(640, 16, 64, F32, 0, False)
    assert p.vec == 1 and p.route == "ordered"
    got = replay(torch.from_numpy(x), 64, aligned=False)
    want = np.asarray(moa_reduce_pallas(jnp.asarray(x), block_n=64,
                                        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_f32_tol(want))


#: (n, f, block_n) with l over full-range int32 words (negative words take
#: the arithmetic shifts; cluster sums wrap): a 16-byte row, f = 7 and
#: block_n 1
LOA_CASES = [(256, 8, 32), (192, 7, 64), (64, 4, 1)]


@pytest.mark.parametrize("l", [0, 1, 4, 8, 31])
@pytest.mark.parametrize("case", LOA_CASES, ids=str)
def test_loa_replay_matches_pallas(case, l):
    n, f, block_n = case
    x = _operand(n, f, "int32", seed=17 * l + n)
    got = replay(torch.from_numpy(x), block_n, l)
    want = np.asarray(loa_reduce_pallas(jnp.asarray(x), approx_bits=l,
                                        block_n=block_n, interpret=True))
    plain = ref.loa_reduce_ref(torch.from_numpy(x), approx_bits=l,
                               block_n=block_n)
    assert got.dtype == I32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert plan(n, f, block_n, I32, l).route == (
        "ordered" if l else "assoc")


def test_loa_replay_at_conv3_width():
    """conv3's LOA fan-in shape cut to 768 rows: 16-byte rows, three
    clusters of four segments each."""
    x = _operand(768, 512, "int32", seed=23) >> 20
    p = plan(768, 512, 256, I32, 4)
    assert p.spc > 1 and not p.direct
    got = replay(torch.from_numpy(x), 256, 4)
    want = np.asarray(loa_reduce_pallas(jnp.asarray(x), approx_bits=4,
                                        block_n=256, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
