"""The port's kernel entry points against the JAX reference's kernels.

On the CPU, ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version (the CUDA kernels need the card, where ``chip_smoke.py`` holds them
against these same plain versions). The reference runs its Pallas kernels
in interpret mode through ``repro.kernels.ops``. Inputs are made once with
numpy from a seed and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

#: bf16 outputs: both sides accumulate in f32 (in different orders) and
#: round once to bf16, so they may differ by one bf16 ulp, at most
#: 2**-7 of the larger magnitude
BF16_RTOL = 2.0 ** -7


def _both(x: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of ``dtype`` (the
    two round f32 → bf16 the same way: to nearest, ties to even)."""
    t = torch.from_numpy(x)
    j = jnp.asarray(x)
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    if dtype == "int8":
        return j.astype(jnp.int8), t.to(torch.int8)
    if dtype == "int32":
        return j.astype(jnp.int32), t.to(torch.int32)
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def _assert_bf16_close(got, want):
    g, w = _np(got), _np(want)
    np.testing.assert_array_less(np.abs(g - w),
                                 BF16_RTOL * np.maximum(np.abs(g), np.abs(w))
                                 + 1e-30)


# ---------------------------------------------------------------------------
# dot_moa
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(32, 64, 16), (100, 700, 130),
                                   (17, 33, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_moa_float(m, k, n, dtype):
    rs = np.random.default_rng(0)
    ja, ta = _both(rs.standard_normal((m, k), np.float32), dtype)
    jb, tb = _both(rs.standard_normal((k, n), np.float32), dtype)
    want = jops.dot_moa(ja, jb, block_m=64, block_n=64, block_k=256)
    got = tops.dot_moa(ta, tb, block_k=256)
    assert got.dtype == ta.dtype and tuple(got.shape) == (m, n)
    if dtype == "bfloat16":
        _assert_bf16_close(got, want)
    else:
        # f32: the same K clusters, reassociated inside each cluster
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("block_k", [64, 128, 512])
def test_dot_moa_int8_exact(block_k):
    rs = np.random.default_rng(1)
    ja, ta = _both(rs.integers(-8, 8, (64, 512)), "int8")
    jb, tb = _both(rs.integers(-8, 8, (512, 48)), "int8")
    want = jops.dot_moa(ja, jb, block_k=block_k)
    got = tops.dot_moa(ta, tb, block_k=block_k)
    assert got.dtype == torch.int32
    # integer accumulation: bit-exact
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype,lo,hi", [("int8", -127, 128),
                                         ("int32", 0, 8)])
@pytest.mark.parametrize("l", [1, 4])
def test_dot_moa_loa_bit_exact(dtype, lo, hi, l):
    """Every K-block partial after the first folds through the LOA
    combine; the int32 arithmetic (arithmetic right shifts on negative
    partials included) must match bit for bit."""
    rs = np.random.default_rng(2)
    ja, ta = _both(rs.integers(lo, hi, (16, 512)), dtype)
    jb, tb = _both(rs.integers(lo, hi, (512, 24)), dtype)
    want = jops.dot_moa(ja, jb, block_k=128, approx_bits=l)
    got = tops.dot_moa(ta, tb, block_k=128, approx_bits=l)
    np.testing.assert_array_equal(_np(got), _np(want))
    exact = _np(ta).astype(np.int64) @ _np(tb).astype(np.int64)
    assert not np.array_equal(_np(got), exact)   # the approximation bites


def test_dot_moa_loa_needs_whole_blocks():
    a = torch.ones((4, 100), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of block_k"):
        tops.dot_moa(a, torch.ones((100, 4), dtype=torch.int8), block_k=64,
                     approx_bits=2)


def test_loa_combine_matches_reference_adder():
    """The fold itself on signed int32 pairs, against the reference's."""
    from repro.kernels.dot_moa import _loa_combine

    rs = np.random.default_rng(3)
    x = rs.integers(-2 ** 20, 2 ** 20, 4096).astype(np.int32)
    y = rs.integers(-2 ** 20, 2 ** 20, 4096).astype(np.int32)
    for l in (1, 3, 8):
        want = _loa_combine(jnp.asarray(x), jnp.asarray(y), approx_bits=l)
        got = tref.loa_combine(torch.from_numpy(x), torch.from_numpy(y), l)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv,d,causal", [
    (64, 64, 32, True), (100, 100, 16, True),          # causal: sq == skv
    (64, 64, 32, False), (100, 100, 16, False), (128, 256, 64, False),
    (37, 53, 32, False)])
def test_flash_attention(sq, skv, d, causal):
    rs = np.random.default_rng(4)
    q = rs.standard_normal((3, sq, d), np.float32)
    k = rs.standard_normal((3, skv, d), np.float32)
    v = rs.standard_normal((3, skv, d), np.float32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, block_q=32,
                                block_k=32)
    # the port's layout is (B, S, H, D): the reference's BH rows as B
    got = tops.flash_attention(*(torch.from_numpy(x)[:, :, None]
                                 for x in (q, k, v)), causal=causal,
                               q_chunk=32, kv_chunk=32)
    # online-softmax tile order and f32 reassociation
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_gqa(dtype):
    """GQA is indexed in the port (kv head = h // G); the reference's
    kernel takes the expanded heads."""
    B, S, H, Hk, D = 2, 48, 4, 2, 16
    rs = np.random.default_rng(5)
    q = rs.standard_normal((B, S, H, D), np.float32)
    k = rs.standard_normal((B, S, Hk, D), np.float32)
    v = rs.standard_normal((B, S, Hk, D), np.float32)

    def bh(x):          # (B, S, heads, D) -> (B·H, S, D), GQA expanded
        x = np.repeat(x, H // x.shape[2], axis=2)
        return np.moveaxis(x, 2, 1).reshape(B * H, S, D)

    want = jops.flash_attention(*(_both(bh(x), dtype)[0] for x in (q, k, v)),
                                block_q=16, block_k=16)
    got = tops.flash_attention(*(_both(x, dtype)[1] for x in (q, k, v)),
                               q_chunk=16, kv_chunk=16)
    got = got.float().permute(0, 2, 1, 3).reshape(B * H, S, D)
    if dtype == "bfloat16":
        _assert_bf16_close(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------


def _pool_problem(T, *, B=3, Hk=2, G=2, D=16, bs=8, n_blocks=4):
    """Uneven depths (the reference suite's problem); dead table entries
    point at page 0, the engine's trash page."""
    rs = np.random.default_rng(6 + T)
    n_phys = B * n_blocks + 1
    q = rs.standard_normal((B, T, Hk * G, D), np.float32)
    k_pool = rs.standard_normal((n_phys, bs, Hk, D), np.float32)
    v_pool = rs.standard_normal((n_phys, bs, Hk, D), np.float32)
    start = np.asarray([0, 5, n_blocks * bs - T], np.int32)
    tables = np.zeros((B, n_blocks), np.int32)
    for b in range(B):
        n_live = (int(start[b]) + T - 1) // bs + 1
        tables[b, :n_live] = 1 + b * n_blocks + np.arange(n_live)
    return q, k_pool, v_pool, tables, start


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_paged_attention(T, pool):
    q, kp, vp, tables, start = _pool_problem(T)
    jq, tq = _both(q, pool)
    jk, tk = _both(kp, pool)
    jv, tv = _both(vp, pool)
    want = jops.paged_attention(jq, jk, jv, jnp.asarray(tables),
                                jnp.asarray(start))
    got = tops.paged_attention(tq, tk, tv, torch.from_numpy(tables),
                               torch.from_numpy(start))
    if pool == "bfloat16":
        _assert_bf16_close(got, want)
    else:
        # online (kernel) vs one-shot (gather) softmax reassociation
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dequant", ["float32", "bfloat16"])
def test_paged_attention_int8_pool(dequant):
    """int8 pages dequantize as ``(x * scale)`` rounded through
    ``dequant_dtype``, in both packages."""
    q, kp, _, tables, start = _pool_problem(2)
    rs = np.random.default_rng(9)
    k8 = rs.integers(-127, 128, kp.shape)
    v8 = rs.integers(-127, 128, kp.shape)
    ks = rs.uniform(0.01, 0.1, kp.shape[:3]).astype(np.float32)
    vs = rs.uniform(0.01, 0.1, kp.shape[:3]).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dequant]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dequant]
    want = jops.paged_attention(
        jnp.asarray(q), _both(k8, "int8")[0], _both(v8, "int8")[0],
        jnp.asarray(tables), jnp.asarray(start), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), dequant_dtype=jdt)
    got = tops.paged_attention(
        torch.from_numpy(q), _both(k8, "int8")[1], _both(v8, "int8")[1],
        torch.from_numpy(tables), torch.from_numpy(start),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs),
        dequant_dtype=tdt)
    # the same dequantized KV on both sides; f32 softmax reassociation
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# dot_moa on int32 operands (the LOA conv's unsigned 8-bit activations and
# 4-bit weights do not fit int8)
# ---------------------------------------------------------------------------


_INT32_DOTS = [
    (16, 512, 24, 128, 0, 256),            # the paper's operand ranges
    (9, 75, 8, 75, 0, 256),                # one ragged cluster (K = 75)
    (5, 363, 7, 363, 0, 256),              # AlexNet conv1's K, one cluster
    (12, 384, 10, 128, -2 ** 31, 2 ** 31),  # full range: products wrap
]


@pytest.mark.parametrize("m,k,n,block_k,lo,hi,l", [
    case + (l,) for case in _INT32_DOTS for l in (0, 1, 4)])
def test_dot_moa_int32(m, k, n, block_k, lo, hi, l):
    """int32 operands, exact and LOA folds, bit for bit against the Pallas
    kernel (XLA's int32 dot wraps modulo 2**32; so must the port)."""
    rs = np.random.default_rng(m * k + l)
    ja, ta = _both(rs.integers(lo, hi, (m, k)), "int32")
    jb, tb = _both(rs.integers(lo if lo else 0, hi if lo else 16, (k, n)),
                   "int32")
    want = jops.dot_moa(ja, jb, block_k=block_k, approx_bits=l)
    got = tops.dot_moa(ta, tb, block_k=block_k, approx_bits=l)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), _np(want))


def test_dot_moa_int32_wraps_as_xla():
    """2**20 · 2**6 · 4096 = 2**38: the int32 sum wraps to 0 in XLA; the
    plain matmul once went through float64 and saturated instead."""
    a = np.full((2, 4096), 2 ** 20, np.int32)
    b = np.full((4096, 3), 2 ** 6, np.int32)
    want = jops.dot_moa(jnp.asarray(a), jnp.asarray(b), block_k=4096)
    got = tops.dot_moa(torch.from_numpy(a), torch.from_numpy(b), block_k=4096)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert not got.any()
    got = tref.matmul_accum(torch.from_numpy(a), torch.from_numpy(b),
                            torch.int32)
    np.testing.assert_array_equal(got.numpy(), 0)


def test_dot_moa_int32_conv3_shape():
    """The LOA conv's contraction at AlexNet conv3's shape: (169, 2304) @
    (2304, 384), 9 clusters of 256, 8 LOA folds."""
    rs = np.random.default_rng(11)
    ja, ta = _both(rs.integers(0, 256, (169, 2304)), "int32")
    jb, tb = _both(rs.integers(0, 8, (2304, 384)), "int32")
    want = jops.dot_moa(ja, jb, block_k=256, approx_bits=4)
    got = tops.dot_moa(ta, tb, block_k=256, approx_bits=4)
    np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# moa_reduce (the shapes and types of tests/test_kernels.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 16), (100, 33), (1000, 256),
                                   (4096, 128), (7, 5), (513, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_moa_reduce(shape, dtype):
    rs = np.random.default_rng(shape[0])
    if dtype == "int32":
        x = rs.integers(-100, 100, shape)
    else:
        x = rs.standard_normal(shape).astype(np.float32)
    jx, tx = _both(x, dtype)
    want = jops.moa_reduce(jx)
    got = tops.moa_reduce(tx)
    if dtype == "int32":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        # f32 accumulation in both (of the same bf16 values): the cluster
        # sums reassociate, as tests/test_kernels.py allows
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("block_n", [64, 512, 128, 1024])
def test_moa_reduce_block_invariance(block_n):
    """The cluster size n_c must not change the result."""
    x = np.random.default_rng(5).standard_normal((777, 130)).astype(
        np.float32)
    want = jops.moa_reduce(jnp.asarray(x), block_n=block_n)
    got = tops.moa_reduce(torch.from_numpy(x), block_n=block_n)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(got), x.astype(np.float64).sum(0),
                               rtol=1e-5, atol=1e-4)


def test_moa_reduce_int_wraps():
    x = np.full((4096, 8), 2 ** 20, np.int32)      # sum 2**32 wraps to 0
    want = jops.moa_reduce(jnp.asarray(x))
    got = tops.moa_reduce(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), _np(want))
    assert not got.any()


# ---------------------------------------------------------------------------
# loa_add / loa_reduce (bit for bit; tests/test_kernels.py's cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 100, 1024, 5000])
@pytest.mark.parametrize("l", [0, 1, 3, 6, 8])
def test_loa_add(n, l):
    rs = np.random.default_rng(n + l)
    jx, tx = _both(rs.integers(0, 256, n), "int32")
    jy, ty = _both(rs.integers(0, 256, n), "int32")
    want = jops.loa_add(jx, jy, approx_bits=l)
    got = tops.loa_add(tx, ty, approx_bits=l)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), _np(want))


def test_loa_add_signed_words_and_shape():
    """Full-range int32 words (arithmetic shifts, wrapping adds), 2-D."""
    rs = np.random.default_rng(7)
    jx, tx = _both(rs.integers(-2 ** 31, 2 ** 31, (33, 17)), "int32")
    jy, ty = _both(rs.integers(-2 ** 31, 2 ** 31, (33, 17)), "int32")
    for l in (1, 5, 17, 31):
        want = jops.loa_add(jx, jy, approx_bits=l, width=32)
        got = tops.loa_add(tx, ty, approx_bits=l, width=32)
        assert tuple(got.shape) == (33, 17)
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("shape", [(256, 64), (512, 100), (1024, 256)])
@pytest.mark.parametrize("l", [0, 2, 4])
def test_loa_reduce(shape, l):
    rs = np.random.default_rng(shape[1] + l)
    jx, tx = _both(rs.integers(0, 128, shape), "int32")
    want = jops.loa_reduce(jx, approx_bits=l, block_n=min(256, shape[0]))
    got = tops.loa_reduce(tx, approx_bits=l, block_n=min(256, shape[0]))
    np.testing.assert_array_equal(_np(got), _np(want))
    if l:
        assert not np.array_equal(_np(got), _np(tx).sum(0)) or \
            shape[0] == 256                          # one cluster: exact


def test_loa_reduce_exact_at_l0_and_needs_whole_clusters():
    x = np.random.default_rng(8).integers(0, 128, (512, 32))
    got = tops.loa_reduce(torch.from_numpy(x).to(torch.int32), approx_bits=0,
                          block_n=128)
    np.testing.assert_array_equal(_np(got), x.sum(0))
    with pytest.raises(ValueError, match="multiple of block_n"):
        tops.loa_reduce(torch.zeros((300, 4), dtype=torch.int32),
                        approx_bits=2, block_n=256)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches a CUDA kernel: the wrappers raise (the
    dispatch in ``ops`` sends CPU tensors to the plain versions)."""
    from repro_torch.kernels.dot_moa import dot_moa_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    a = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        dot_moa_cuda(a, a.t().contiguous(), block_k=8)
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    from repro_torch.kernels.loa_add import loa_add_cuda, loa_reduce_cuda
    from repro_torch.kernels.moa_reduce import moa_reduce_cuda

    i = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        moa_reduce_cuda(i)
    with pytest.raises(ValueError, match="CUDA"):
        loa_add_cuda(i, i, approx_bits=2)
    with pytest.raises(ValueError, match="CUDA"):
        loa_reduce_cuda(i, approx_bits=2, block_n=4)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(q[:, :1], torch.zeros((2, 4, 2, 8)),
                             torch.zeros((2, 4, 2, 8)),
                             torch.zeros((1, 1), dtype=torch.int32),
                             torch.zeros((1,), dtype=torch.int32))
    for counter in tops.launch_counts().values():
        assert counter == 0


@pytest.mark.parametrize("d", [8, 24, 72, 136])
def test_flash_wrapper_refuses_bf16_head_dims_off_16(d):
    """The bf16 body steps D by wgmma's k16: a head_dim that is not a
    multiple of 16 (or above 128) raises before any launch or device
    check; an f32 one of 24 or 72 reaches the device check."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q = torch.zeros((1, 4, 2, d), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention_cuda(q, q, q)
    if d % 4 == 0 and d <= 128:
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_cuda(q.float(), q.float(), q.float())
    assert tops.launch_counts()["flash_attention"] == 0
