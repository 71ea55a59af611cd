"""Mamba-2 SSD (state-space duality) block, chunked scan formulation — the
port of ``repro/layers/ssd.py``.

The sequence reduction of ``ssd_chunked`` is split into chunks of
``ssd_chunk`` steps: inside a chunk a quadratic product, across chunks a
serial carry of the state, one chunk at a time (so an aligned chunked
prefill equals the one-shot prefill bit for bit on any device). Heads are
a leading axis of the state; all decay arithmetic is f32.

The reference's three- and four-operand einsums leave the contraction
order to XLA; ``torch.einsum`` would contract them left to right. Each is
written here as pairwise products in a stated order, so no intermediate
is larger than one chunk's decay matrix ``(B, H, L, L)`` in f32.
The group broadcast of B and C to the heads is an ``expand`` and a
``reshape`` (the reference's ``jnp.repeat``): nothing here reads a value
back to the host, so the decode step can be captured in a CUDA graph.

No TPU kernel runs here (the reference's SSD is plain jnp): the in and
out projections are plain products, as the reference's ``@`` is.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.layers.common import Params, dense_init, rms_norm
from repro_torch.layers.numerics import (f32_upcast, silu_f32, softplus_f32,
                                         sum_f32)

__all__ = [
    "init_mamba2_block", "mamba2_forward", "mamba2_decode",
    "init_ssm_state", "ssd_chunked", "conv_tail",
]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Within-chunk pairwise decay sums: ``out[..., l, s] = sum_{s<i<=l}
    a_i``. ``a: (..., L)`` → ``(..., L, L)``, lower-triangular (else
    ``-inf``)."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x, a, b, c, *, chunk: int, h0=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD: ``y_t = C_t^T h_t``, ``h_t = exp(a_t) h_{t-1} + B_t x_t^T``.

    ``x (B, S, H, P)`` per-head inputs (already dt-scaled), ``a (B, S, H)``
    per-step log decay, ``b``/``c`` ``(B, S, H, N)`` (groups already
    broadcast to heads), ``h0`` an optional ``(B, H, P, N)`` initial state.
    ``S`` not a multiple of ``chunk`` is zero-padded (a zero log decay and
    a zero input leave the state as it was). Returns ``(y (B, S, H, P) in
    x.dtype, h_last (B, H, P, N) f32)``.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    if S % chunk:
        pad = chunk - S % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
    n_chunks = x.shape[1] // chunk

    def to_chunks(t):
        return t.reshape((B, n_chunks, chunk) + tuple(t.shape[2:]))

    xc, ac, bc, cc = (to_chunks(f32_upcast(t)) for t in (x, a, b, c))
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else f32_upcast(h0))
    ys = []
    # chunk by chunk: each product's batch is (B, H) whatever the number of
    # chunks, so a chunk continued from its h0 computes its rows as the
    # one-shot scan does, bit for bit (a product batched over the chunks
    # may take another cuBLAS kernel than one over a single chunk)
    for i in range(n_chunks):
        xi, ai, bi, ci = xc[:, i], ac[:, i], bc[:, i], cc[:, i]
        a_cs = torch.cumsum(ai, dim=1)                        # (B, L, H)
        # 1. intra-chunk: (C·B) over n, times the decay matrix, then · x
        lmat = torch.exp(_segsum(ai.movedim(-1, 1)))          # (B, H, L, L)
        cb = torch.einsum("blhn,bshn->bhls", ci, bi)
        y_diag = torch.einsum("bhls,bshp->blhp", cb * lmat, xi)
        # 2. state → output: C · h over n, then the decay from the start
        y_off = torch.einsum("blhn,bhpn->blhp", ci, h) \
            * torch.exp(a_cs)[..., None]
        ys.append(y_diag + y_off)
        # 3. the chunk's end state: x scaled by its decay to the chunk's
        # end, · B over l, added to the carried state's decay
        decay_to_end = torch.exp(a_cs[:, -1:, :] - a_cs)      # (B, L, H)
        state = torch.einsum("blhp,blhn->bhpn",
                             xi * decay_to_end[..., None], bi)
        h = h * torch.exp(a_cs[:, -1, :])[..., None, None] + state
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# Mamba-2 block (in_proj → conv → SSD → gated norm → out_proj)
# ---------------------------------------------------------------------------


def init_mamba2_block(generator: torch.Generator, *, d_model: int,
                      d_state: int, headdim: int, n_groups: int = 1,
                      d_conv: int = 4, expand: int = 2, dtype=torch.float32,
                      device=None) -> Params:
    """One block's parameters with the reference's tree, shapes and
    initializers: scaled truncated normals for the projections and the
    conv, ``a_log = log(1..H)``, ``dt_bias`` the inverse softplus of a
    log-uniform dt in ``[1e-3, 0.1]``, ``d_skip`` ones (those three f32)."""
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_dim = d_inner + 2 * n_groups * d_state
    d_in_proj = 2 * d_inner + 2 * n_groups * d_state + n_heads
    in_proj = dense_init(generator, (d_model, d_in_proj), dtype,
                         fan_in=d_model, device=device)
    conv_w = dense_init(generator, (d_conv, conv_dim), dtype, fan_in=d_conv,
                        device=device)
    out_proj = dense_init(generator, (d_inner, d_model), dtype,
                          fan_in=d_inner, device=device)
    u = torch.rand((n_heads,), generator=generator, dtype=torch.float32,
                   device=device)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.arange(1, n_heads + 1, **f32)),
        "dt_bias": dt_bias,
        "d_skip": torch.ones((n_heads,), **f32),
        "gate_norm": {"scale": torch.ones((d_inner,), dtype=dtype,
                                          device=device)},
        "out_proj": out_proj,
    }


def _split_in_proj(proj, *, d_inner: int, n_groups: int, d_state: int):
    """``proj`` → ``(z, x, B, C, dt)`` along the last axis."""
    bs = n_groups * d_state
    return torch.split(proj, [d_inner, d_inner, bs, bs,
                              proj.shape[-1] - 2 * d_inner - 2 * bs], dim=-1)


def _to_heads(t, n_groups: int, heads_per_group: int):
    """``(..., G·N)`` → ``(..., G·hpg, N)``: each group's map repeated for
    its heads (``jnp.repeat`` along the head axis)."""
    lead = tuple(t.shape[:-1])
    n = t.shape[-1] // n_groups
    t = t.reshape(lead + (n_groups, 1, n))
    return t.expand(lead + (n_groups, heads_per_group, n)).reshape(
        lead + (n_groups * heads_per_group, n))


def _causal_depthwise_conv(x, w, b, hist=None):
    """``x (B, S, C)``, ``w (K, C)``: depthwise causal conv (left pad
    ``K - 1``), its K products summed in ``x.dtype`` in order.

    ``hist (B, K-1, C)``, when given, replaces the zero left pad with the
    last ``K - 1`` conv inputs of an earlier segment (the chunked-prefill
    continuation): the same K-term sum a position, so a chunk continued
    from its history equals those positions of one long conv."""
    K = w.shape[0]
    S = x.shape[1]
    if hist is None:
        xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([hist.to(x.dtype), x], dim=1)
    y = xp[:, 0:S] * w[0]
    for k in range(1, K):
        y = y + xp[:, k:k + S] * w[k]
    return y + b


def conv_tail(params: Params, hn, *, d_inner: int, n_groups: int,
              d_state: int, compute_dtype):
    """The conv inputs (``x``, ``B``, ``C`` of the in projection) of the
    last ``d_conv - 1`` positions of the normed input ``hn (B, S, d)``,
    recomputed from those positions alone (the prefill's conv state)."""
    k1 = params["conv_w"].shape[0] - 1
    proj = hn[:, -k1:].to(compute_dtype) @ params["in_proj"].to(compute_dtype)
    bs = n_groups * d_state
    return proj[..., d_inner:2 * d_inner + 2 * bs]


def mamba2_forward(params: Params, x, *, d_state: int, headdim: int,
                   n_groups: int = 1, expand: int = 2, ssd_chunk: int = 256,
                   compute_dtype=torch.bfloat16, initial_state=None):
    """Mamba-2 mixer over ``x (B, S, d_model)`` → ``(y, last_state)``.

    ``initial_state`` is the SSM state ``(B, H, P, N)`` or a dict ``{"h",
    "conv"}`` (one layer of :func:`init_ssm_state`): the dict form also
    seeds the conv with the previous segment's last ``d_conv - 1`` inputs,
    the chunked-prefill continuation."""
    B, S, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    cd = compute_dtype

    conv_hist = None
    if isinstance(initial_state, dict):
        conv_hist = initial_state["conv"]
        initial_state = initial_state["h"]

    proj = x.to(cd) @ params["in_proj"].to(cd)
    z, xp, b, c, dt = _split_in_proj(proj, d_inner=d_inner,
                                     n_groups=n_groups, d_state=d_state)
    conv_in = torch.cat([xp, b, c], dim=-1)
    conv_out = _causal_depthwise_conv(conv_in, params["conv_w"].to(cd),
                                      params["conv_b"].to(cd),
                                      hist=conv_hist)
    conv_out = silu_f32(conv_out, out_dtype=cd)
    bs = n_groups * d_state
    xp, b, c = torch.split(conv_out, [d_inner, bs, bs], dim=-1)

    dt = softplus_f32(dt, bias=params["dt_bias"])               # (B, S, H)
    A = -torch.exp(params["a_log"])                             # (H,)
    a = dt * A

    xh = xp.reshape(B, S, n_heads, headdim)
    hpg = n_heads // n_groups
    bh = _to_heads(b, n_groups, hpg)
    ch = _to_heads(c, n_groups, hpg)

    x_dt = xh * dt[..., None].to(xh.dtype)
    y, h_last = ssd_chunked(x_dt, a, bh, ch, chunk=ssd_chunk,
                            h0=initial_state)
    y = y + xh * params["d_skip"][None, None, :, None].to(y.dtype)

    y = y.reshape(B, S, d_inner)
    y = rms_norm(params["gate_norm"],
                 (f32_upcast(y) * silu_f32(z)).to(cd))
    return y @ params["out_proj"].to(cd), h_last


def init_ssm_state(batch: int, *, d_model: int, d_state: int, headdim: int,
                   n_groups: int = 1, d_conv: int = 4, expand: int = 2,
                   device=None) -> Params:
    """Zeroed recurrent state of ``batch`` sequences: ``h (B, H, P, N)``
    f32 and the conv history ``(B, d_conv - 1, conv_dim)`` in bf16 (the
    reference's, whatever the compute type)."""
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_dim = d_inner + 2 * n_groups * d_state
    return {
        "h": torch.zeros((batch, n_heads, headdim, d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, d_conv - 1, conv_dim),
                            dtype=torch.bfloat16, device=device),
    }


def mamba2_decode(params: Params, x, state: Params, *, d_state: int,
                  headdim: int, n_groups: int = 1, expand: int = 2,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One token a sequence, ``x (B, 1, d_model)`` → ``(B, 1, d_model)``:
    the one-step recurrence. ``state`` (one layer's ``{"h", "conv"}``) is
    updated **in place**, where the reference returns a new one."""
    B, _, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    cd = compute_dtype

    proj = x[:, 0].to(cd) @ params["in_proj"].to(cd)
    z, xp, b, c, dt = _split_in_proj(proj, d_inner=d_inner,
                                     n_groups=n_groups, d_state=d_state)
    conv_in = torch.cat([xp, b, c], dim=-1)                   # (B, C)
    conv_hist = torch.cat([state["conv"].to(cd), conv_in[:, None]], dim=1)
    w = params["conv_w"].to(cd)                               # (K, C)
    conv_out = sum_f32(conv_hist * w[None], dim=1, out_dtype=cd) \
        + params["conv_b"].to(cd)
    conv_out = silu_f32(conv_out, out_dtype=cd)
    bs = n_groups * d_state
    xp, b, c = torch.split(conv_out, [d_inner, bs, bs], dim=-1)

    dt = softplus_f32(dt, bias=params["dt_bias"])              # (B, H)
    A = -torch.exp(params["a_log"])
    dA = torch.exp(dt * A)                                     # (B, H)

    xh = f32_upcast(xp.reshape(B, n_heads, headdim))
    hpg = n_heads // n_groups
    bh = f32_upcast(_to_heads(b, n_groups, hpg))               # (B, H, N)
    ch = f32_upcast(_to_heads(c, n_groups, hpg))

    # the outer product dB·x as a K = 1 product (one rounding a term, as
    # the broadcast multiply it equals), the reference's einsum
    h = state["h"] * dA[..., None, None] \
        + torch.matmul((dt[..., None] * xh)[..., None], bh[:, :, None, :])
    y = torch.matmul(h, ch[..., None])[..., 0] \
        + xh * params["d_skip"][None, :, None]

    y = y.reshape(B, d_inner)
    y = rms_norm(params["gate_norm"], (y * silu_f32(z)).to(cd))
    out = y @ params["out_proj"].to(cd)
    state["h"].copy_(h)
    state["conv"].copy_(conv_hist[:, 1:])
    return out[:, None]
