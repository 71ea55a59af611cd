"""LeNet-5 and AlexNet — the paper's own subjects; the port of
``repro/models/cnn.py``.

The public functions keep the reference's layouts: activations NHWC, conv
weights OIHW, the patch features of :func:`im2col_conv` channel-major
``(C, kh, kw)`` (``w.reshape(O, C*kh*kw)``), pooling 2×2 stride 2 VALID,
and the flatten before ``fc1`` in NHWC order, so the reference's parameters
(through :func:`repro_torch.interop.from_numpy`) give the same logits.

Two accumulation paths: ``accum="conv"`` runs every conv as one PyTorch
convolution (the reference's ``lax.conv``: the fused one-shot reduction),
``accum="im2col"`` routes every ``groups == 1`` conv through
:func:`im2col_conv`, whose ``C·kh·kw`` contraction is the paper's MOA and
goes through ``strategy.dot`` (``tree``, ``serial``, ``loa``; on CUDA the
``dot_moa`` kernel). Grouped convs and the FC layers stay PyTorch
conv / matmul, as the reference leaves them to XLA; both run with TF32 off
(:func:`_full_f32`), so f32 means f32.
"""

from __future__ import annotations

import contextlib
from typing import Union

import torch
import torch.nn.functional as F

from repro_torch.device import as_dtype, is_integer, resolve_device
from repro_torch.layers.common import Params, dense_init
from repro_torch.moa import active_strategy, resolve

__all__ = ["init_lenet5", "init_alexnet", "lenet5_forward", "alexnet_forward",
           "im2col_conv", "im2col_patches", "LENET5_LAYOUT", "ALEXNET_LAYOUT"]

# (name, out_ch, in_ch(per group), kh, kw, stride, groups, padding, pool)
LENET5_LAYOUT = [
    ("conv1", 6, 1, 5, 5, 1, 1, "VALID", True),
    ("conv2", 16, 6, 5, 5, 1, 1, "VALID", True),
]
ALEXNET_LAYOUT = [
    ("conv1", 96, 3, 11, 11, 4, 1, "VALID", True),
    ("conv2", 256, 48, 5, 5, 1, 2, "SAME", True),
    ("conv3", 384, 256, 3, 3, 1, 1, "SAME", False),
    ("conv4", 384, 192, 3, 3, 1, 2, "SAME", False),
    ("conv5", 256, 192, 3, 3, 1, 2, "SAME", True),
]


@contextlib.contextmanager
def _full_f32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block
    (cuDNN's default is on), restored after."""
    conv, mm = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _init_convnet(seed, layout, fc_dims, n_classes, dtype, device) -> Params:
    device = resolve_device(device)
    dtype = as_dtype(dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    params = {}
    for name, oc, ic, kh, kw, *_ in layout:
        params[name] = {
            "w": dense_init(g, (oc, ic, kh, kw), dtype, fan_in=ic * kh * kw,
                            device=device),
            "b": torch.zeros((oc,), dtype=dtype, device=device)}
    prev = fc_dims[0]
    for i, d in enumerate(fc_dims[1:], 1):
        params[f"fc{i}"] = {
            "w": dense_init(g, (prev, d), dtype, fan_in=prev, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}
        prev = d
    params["head"] = {
        "w": dense_init(g, (prev, n_classes), dtype, fan_in=prev,
                        device=device),
        "b": torch.zeros((n_classes,), dtype=dtype, device=device)}
    return params


def init_lenet5(seed: int = 0, *, dtype=torch.float32,
                device: Union[str, torch.device] = "cuda") -> Params:
    """32×32×1 → 28 → pool 14 → 10 → pool 5: flatten 400 → 120 → 84 → 10."""
    return _init_convnet(seed, LENET5_LAYOUT, [400, 120, 84], 10, dtype,
                         device)


def init_alexnet(seed: int = 0, *, dtype=torch.float32,
                 device: Union[str, torch.device] = "cuda") -> Params:
    """227×227×3 → 55 → 27 → 13 → 13 → 13 → 6: flatten 9216 → 4096 →
    1000 (one hidden FC, as the reference)."""
    return _init_convnet(seed, ALEXNET_LAYOUT, [9216, 4096], 1000, dtype,
                         device)


def _same_pads(size: int, k: int, stride: int):
    """XLA's SAME padding (low, high) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _nchw_padded(x: torch.Tensor, kh: int, kw: int, stride: int,
                 padding: str) -> torch.Tensor:
    """NHWC → NCHW, zero-padded as ``padding`` (``"VALID"`` / ``"SAME"``)."""
    if padding not in ("VALID", "SAME"):
        raise ValueError(f"padding must be 'VALID' or 'SAME', got {padding!r}")
    x = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        ph, pw = (_same_pads(x.shape[2], kh, stride),
                  _same_pads(x.shape[3], kw, stride))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return x


def _conv(x, w, b, *, stride, groups, padding):
    """The one-shot conv: NHWC in and out, OIHW weights."""
    xp = _nchw_padded(x, w.shape[2], w.shape[3], stride, padding)
    with _full_f32():
        y = F.conv2d(xp, w, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1) + b


def im2col_patches(x: torch.Tensor, kh: int, kw: int, *, stride: int,
                   padding: str = "VALID"):
    """``x (B, H, W, C)`` → ``(cols (B·Ho·Wo, C·kh·kw), (B, Ho, Wo))``, the
    features channel-major ``(C, kh, kw)`` as the reference's
    ``conv_general_dilated_patches``. Any dtype; an exact copy."""
    B = x.shape[0]
    xp = _nchw_padded(x, kh, kw, stride, padding)
    # (B, C, Ho, Wo, kh, kw) → (B, Ho, Wo, C, kh, kw)
    patches = xp.unfold(2, kh, stride).unfold(3, kw, stride)
    Ho, Wo = patches.shape[2], patches.shape[3]
    cols = patches.permute(0, 2, 3, 1, 4, 5).reshape(B * Ho * Wo, -1)
    return cols, (B, Ho, Wo)


def im2col_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                stride: int, padding: str = "VALID",
                strategy=None) -> torch.Tensor:
    """Explicit DHM-style conv: unfold patches, then one MOA per filter.

    ``x (B, H, W, C)``, ``w (O, C, kh, kw)``, any dtype (integer operands
    give an int32 result). The ``C·kh·kw`` contraction goes through
    ``strategy.dot`` (anything :func:`repro_torch.moa.resolve` takes;
    ``"tree"`` unless a :func:`~repro_torch.moa.moa_scope` is active)."""
    O, Ci, kh, kw = w.shape
    if Ci != x.shape[-1]:
        raise ValueError(f"input channels {x.shape[-1]} != filter channels "
                         f"{Ci}")
    cols, (B, Ho, Wo) = im2col_patches(x, kh, kw, stride=stride,
                                       padding=padding)
    wmat = w.reshape(O, -1).t()
    strat = active_strategy(strategy) or resolve("tree")
    if is_integer(cols.dtype):
        y = strat.dot(cols, wmat, out_dtype=torch.int32)
        return y.reshape(B, Ho, Wo, O) + b.to(torch.int32)
    with _full_f32():
        y = strat.dot(cols, wmat, out_dtype=torch.float32)
    return y.reshape(B, Ho, Wo, O) + b


def _stack_forward(params: Params, x: torch.Tensor, layout, n_fc: int,
                   accum: str = "conv", strategy=None) -> torch.Tensor:
    if accum not in ("conv", "im2col"):
        raise ValueError(f"accum must be 'conv' or 'im2col', got {accum!r}")
    h = x
    for name, oc, ic, kh, kw, stride, groups, padding, pool in layout:
        p = params[name]
        if accum == "im2col" and groups == 1:
            h = im2col_conv(h, p["w"], p["b"], stride=stride,
                            padding=padding, strategy=strategy)
        else:
            h = _conv(h, p["w"], p["b"], stride=stride, groups=groups,
                      padding=padding)
        h = F.relu(h)
        if pool:
            h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    h = h.reshape(h.shape[0], -1)
    with _full_f32():
        for i in range(1, n_fc + 1):
            p = params[f"fc{i}"]
            if h.shape[-1] != p["w"].shape[0]:
                raise ValueError(f"fc{i}: got {h.shape[-1]}, expected "
                                 f"{p['w'].shape[0]}")
            h = F.relu(h @ p["w"] + p["b"])
        p = params["head"]
        return h @ p["w"] + p["b"]


def lenet5_forward(params: Params, x: torch.Tensor, *, accum: str = "conv",
                   strategy=None) -> torch.Tensor:
    """``x (B, 32, 32, 1)`` → logits ``(B, 10)``."""
    return _stack_forward(params, x, LENET5_LAYOUT, n_fc=2, accum=accum,
                          strategy=strategy)


def alexnet_forward(params: Params, x: torch.Tensor, *, accum: str = "conv",
                    strategy=None) -> torch.Tensor:
    """``x (B, 227, 227, 3)`` → logits ``(B, 1000)``; under ``im2col`` the
    ``groups == 1`` layers (conv1, conv3) take the MOA strategy."""
    return _stack_forward(params, x, ALEXNET_LAYOUT, n_fc=1, accum=accum,
                          strategy=strategy)
