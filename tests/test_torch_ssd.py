"""The port's Mamba-2 SSD layer (``repro_torch.layers.ssd``) against the
JAX reference (``repro.layers.ssd``), on the CPU.

Every input is drawn from a seeded numpy generator and fed to both
packages; the reference's block parameters cross into the port through
:mod:`repro_torch.interop`. All in f32: the two packages contract the SSD's
products in different orders (the port pairwise, as written in its
module; XLA as it chooses), so results agree to f32 reassociation error,
``rtol=1e-5`` against values of order 1 with ``atol=1e-6`` for the ones
near zero. The depthwise conv's K-term sum runs in the same order in both,
so it is compared at the same tolerance only for the products' rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import ssd as jssd
from repro_torch import interop
from repro_torch.layers import ssd as tssd

RTOL, ATOL = 1e-5, 1e-6
D_MODEL, D_STATE, HEADDIM, N_GROUPS = 32, 8, 8, 2


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S,chunk", [(16, 8), (13, 8), (5, 8), (24, 4)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked(S, chunk, with_h0):
    """The chunked scan, with S a multiple of the chunk and not (the zero
    pad), from a zero and from a given initial state."""
    B, H, P, N = 2, 3, 4, 5
    x = _rand((B, S, H, P), 0)
    a = -np.abs(_rand((B, S, H), 1, 0.5))
    b = _rand((B, S, H, N), 2)
    c = _rand((B, S, H, N), 3)
    h0 = _rand((B, H, P, N), 4) if with_h0 else None
    jy, jh = jssd.ssd_chunked(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(c), chunk=chunk,
                              h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tssd.ssd_chunked(torch.from_numpy(x), torch.from_numpy(a),
                              torch.from_numpy(b), torch.from_numpy(c),
                              chunk=chunk,
                              h0=None if h0 is None else torch.from_numpy(h0))
    assert ty.shape == (B, S, H, P) and th.shape == (B, H, P, N)
    assert th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


def test_ssd_chunked_gradients_at_steep_decay():
    """Gradients through the chunked scan where the decays are steep (log
    decays to ~-300 a step: an upper-triangle sum of ``_segsum`` would
    overflow ``exp`` in f32): the masked sums are ``-inf`` before the
    ``exp``, whose backward multiplies by ``exp(-inf) = 0``, so every
    gradient is finite, as the reference's are, and equal to them."""
    B, S, H, P, N, chunk = 2, 16, 3, 4, 5, 8
    x, b, c = (_rand(s, i) for i, s in enumerate(
        [(B, S, H, P), (B, S, H, N), (B, S, H, N)]))
    a = -100 * np.abs(_rand((B, S, H), 3))
    h0 = _rand((B, H, P, N), 4)
    wy, wh = _rand((B, S, H, P), 5), _rand((B, H, P, N), 6)

    def jloss(*args):
        y, h = jssd.ssd_chunked(*args[:4], chunk=chunk, h0=args[4])
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(t) for t in (x, a, b, c, h0)))
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, a, b, c, h0)]
    y, h = tssd.ssd_chunked(*ts[:4], chunk=chunk, h0=ts[4])
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(h * torch.from_numpy(wh))).backward()
    assert float(np.abs(a).max()) > 88.0
    for t, w in zip(ts, want):
        assert np.isfinite(np.asarray(w)).all()
        assert torch.isfinite(t.grad).all()
        # the backward's transposed contractions sum more products than
        # the forward, in orders of their own in each package
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


def test_segsum_mask():
    a = _rand((3, 6), 5)
    got = tssd._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(jssd._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_hist", [False, True])
def test_causal_depthwise_conv(with_hist):
    B, S, C, K = 2, 7, 6, 4
    x, w, b = _rand((B, S, C), 6), _rand((K, C), 7), _rand((C,), 8)
    hist = _rand((B, K - 1, C), 9) if with_hist else None
    want = jssd._causal_depthwise_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        hist=None if hist is None else jnp.asarray(hist))
    got = tssd._causal_depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        hist=None if hist is None else torch.from_numpy(hist))
    _close(got, want)


def test_conv_history_continues_one_conv():
    """A conv continued from its history equals the same positions of one
    long conv, bit for bit."""
    B, S, C, K = 1, 12, 5, 4
    x, w, b = (torch.from_numpy(_rand(s, i))
               for i, s in enumerate(((B, S, C), (K, C), (C,))))
    whole = tssd._causal_depthwise_conv(x, w, b)
    tail = tssd._causal_depthwise_conv(x[:, 5:], w, b, hist=x[:, 2:5])
    assert torch.equal(tail, whole[:, 5:])


def test_ssd_continues_one_scan():
    """The scan continued chunk by chunk from its carried state equals the
    one-shot scan over the same steps, bit for bit (the chunked prefill's
    contract)."""
    B, S, H, P, N, chunk = 1, 24, 3, 4, 5, 8
    x, b, c = (torch.from_numpy(_rand((B, S, H, n), i))
               for i, n in ((10, P), (11, N), (12, N)))
    a = torch.from_numpy(-np.abs(_rand((B, S, H), 13, 0.5)))
    y, h = tssd.ssd_chunked(x, a, b, c, chunk=chunk)
    state, ys = None, []
    for i in range(0, S, chunk):
        yi, state = tssd.ssd_chunked(x[:, i:i + chunk], a[:, i:i + chunk],
                                     b[:, i:i + chunk], c[:, i:i + chunk],
                                     chunk=chunk, h0=state)
        ys.append(yi)
    assert torch.equal(torch.cat(ys, dim=1), y) and torch.equal(state, h)


def _block(seed=0):
    jp = jssd.init_mamba2_block(jax.random.PRNGKey(seed), d_model=D_MODEL,
                                d_state=D_STATE, headdim=HEADDIM,
                                n_groups=N_GROUPS)
    npp = jax.tree.map(np.asarray, jp)
    return jp, interop.from_numpy(npp, device="cpu")


KW = dict(d_state=D_STATE, headdim=HEADDIM, n_groups=N_GROUPS, expand=2)


def test_init_mamba2_block_tree():
    """The port's initializer draws the reference's tree, shapes, dtypes
    and the deterministic leaves (``a_log``, ``d_skip``, ``conv_b``)."""
    jp, _ = _block()
    gen = torch.Generator().manual_seed(0)
    tp = tssd.init_mamba2_block(gen, d_model=D_MODEL, d_state=D_STATE,
                                headdim=HEADDIM, n_groups=N_GROUPS)
    want = {p: (tuple(a.shape), str(a.dtype)) for p, a in
            interop.tree_leaves(jax.tree.map(np.asarray, jp))}
    got = {p: (tuple(t.shape), str(t.dtype)[6:]) for p, t in
           interop.tree_leaves(tp)}
    assert got == want
    for name in ("a_log", "d_skip", "conv_b"):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   rtol=1e-7)
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all())


@pytest.mark.parametrize("S", [11, 16])
@pytest.mark.parametrize("state", ["none", "h", "dict"])
def test_mamba2_forward(S, state):
    """The mixer over a segment: from no state, from an SSM state, and
    from a ``{"h", "conv"}`` state (the chunked-prefill continuation)."""
    jp, tp = _block()
    B = 2
    x = _rand((B, S, D_MODEL), 10)
    n_heads = 2 * D_MODEL // HEADDIM
    conv_dim = 2 * D_MODEL + 2 * N_GROUPS * D_STATE
    h0 = _rand((B, n_heads, HEADDIM, D_STATE), 11, 0.1)
    conv = _rand((B, 3, conv_dim), 12)
    init = {"none": (None, None), "h": (h0, None), "dict": (h0, conv)}[state]
    if init[1] is not None:
        ji = {"h": jnp.asarray(init[0]), "conv": jnp.asarray(init[1])}
        ti = {"h": torch.from_numpy(init[0]), "conv": torch.from_numpy(init[1])}
    elif init[0] is not None:
        ji, ti = jnp.asarray(init[0]), torch.from_numpy(init[0])
    else:
        ji = ti = None
    jy, jh = jssd.mamba2_forward(jp, jnp.asarray(x), ssd_chunk=8,
                                 compute_dtype=jnp.float32,
                                 initial_state=ji, **KW)
    ty, th = tssd.mamba2_forward(tp, torch.from_numpy(x), ssd_chunk=8,
                                 compute_dtype=torch.float32,
                                 initial_state=ti, **KW)
    _close(ty, jy)
    _close(th, jh)


def test_mamba2_decode():
    """Three one-token steps from a nonzero state: the output and the
    state the port updates in place against the reference's new state."""
    jp, tp = _block()
    B = 3
    n_heads = 2 * D_MODEL // HEADDIM
    conv_dim = 2 * D_MODEL + 2 * N_GROUPS * D_STATE
    h0 = _rand((B, n_heads, HEADDIM, D_STATE), 13, 0.1)
    conv0 = _rand((B, 3, conv_dim), 14)
    jstate = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0)}
    tstate = {"h": torch.from_numpy(h0.copy()),
              "conv": torch.from_numpy(conv0.copy())}
    for step in range(3):
        x = _rand((B, 1, D_MODEL), 20 + step)
        jy, jstate = jssd.mamba2_decode(jp, jnp.asarray(x), jstate,
                                        compute_dtype=jnp.float32, **KW)
        ty = tssd.mamba2_decode(tp, torch.from_numpy(x), tstate,
                                compute_dtype=torch.float32, **KW)
        _close(ty, jy)
        _close(tstate["h"], jstate["h"])
        _close(tstate["conv"], jstate["conv"])


def test_init_ssm_state():
    j = jssd.init_ssm_state(2, d_model=D_MODEL, d_state=D_STATE,
                            headdim=HEADDIM, n_groups=N_GROUPS)
    t = tssd.init_ssm_state(2, d_model=D_MODEL, d_state=D_STATE,
                            headdim=HEADDIM, n_groups=N_GROUPS)
    for name in ("h", "conv"):
        assert tuple(t[name].shape) == j[name].shape
        assert str(t[name].dtype)[6:] == str(j[name].dtype)
        assert not t[name].any()
