"""The port's CNNs (``repro_torch.models.cnn``) against ``repro.models.cnn``.

The reference's parameters go through ``interop.from_numpy`` into the
port; both run in f32 on the same numpy input. Tolerance: 1e-5 absolute
and relative on logits of magnitude ~1 — both sum in f32, in different
orders (XLA's and PyTorch's CPU convolutions and matmuls), through every
layer. The quantized LOA conv is compared route with route and bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scm import quantize_symmetric
from repro.models import cnn as jcnn
from repro_torch import interop
from repro_torch import moa as tmoa
from repro_torch.kernels import ops as tops
from repro_torch.launch import paper_repro
from repro_torch.models import cnn as tcnn

TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture(scope="module")
def params():
    """Reference parameters, and the same carried into the port."""
    out = {}
    for name, init in (("lenet5", jcnn.init_lenet5),
                       ("alexnet", jcnn.init_alexnet)):
        jp = init(jax.random.PRNGKey(0))
        out[name] = (jp, interop.from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu"))
    return out


@pytest.mark.parametrize("accum,strategy", [("conv", None),
                                            ("im2col", None),
                                            ("im2col", "serial?chunk=16")])
def test_lenet5(params, accum, strategy):
    jp, tp = params["lenet5"]
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 1)).astype(
        np.float32)
    want = jcnn.lenet5_forward(jp, jnp.asarray(x), accum=accum,
                               strategy=strategy)
    got = tcnn.lenet5_forward(tp, torch.from_numpy(x), accum=accum,
                              strategy=strategy)
    assert tuple(got.shape) == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("accum,strategy", [("conv", None),
                                            ("im2col", None),
                                            ("im2col", "serial?chunk=256")])
def test_alexnet_batch1(params, accum, strategy):
    jp, tp = params["alexnet"]
    x = np.random.default_rng(1).standard_normal((1, 227, 227, 3)).astype(
        np.float32)
    want = jcnn.alexnet_forward(jp, jnp.asarray(x), accum=accum,
                                strategy=strategy)
    got = tcnn.alexnet_forward(tp, torch.from_numpy(x), accum=accum,
                               strategy=strategy)
    assert tuple(got.shape) == (1, 1000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="accum"):
        tcnn.alexnet_forward(tp, torch.from_numpy(x), accum="winograd")


@pytest.mark.parametrize("x_shape,w_shape,stride,padding", [
    ((2, 16, 16, 3), (8, 3, 5, 5), 1, "VALID"),
    ((2, 9, 9, 3), (4, 3, 3, 3), 1, "SAME"),
    ((1, 27, 27, 3), (6, 3, 11, 11), 4, "VALID"),
    ((1, 10, 11, 4), (5, 4, 5, 5), 2, "SAME"),
])
def test_im2col_conv(x_shape, w_shape, stride, padding):
    rs = np.random.default_rng(2)
    x = rs.standard_normal(x_shape).astype(np.float32)
    w = rs.standard_normal(w_shape).astype(np.float32)
    b = rs.standard_normal(w_shape[0]).astype(np.float32)
    want = jcnn.im2col_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            stride=stride, padding=padding)
    got = tcnn.im2col_conv(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the one-shot conv of the port on the same operands
    conv = tcnn._conv(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), stride=stride, groups=1,
                      padding=padding)
    np.testing.assert_allclose(conv.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _quantized(x_shape, w_shape, seed=0):
    rs = np.random.default_rng(seed)
    xq = (quantize_symmetric(rs.standard_normal(x_shape), 8) + 128).astype(
        np.int32)
    wq = np.abs(quantize_symmetric(rs.standard_normal(w_shape), 4)).astype(
        np.int32)
    return xq, wq, np.zeros(w_shape[0], np.int32)


@pytest.mark.parametrize("x_shape,w_shape,padding", [
    ((1, 16, 16, 3), (8, 3, 5, 5), "VALID"),      # the paper example, K=75
    ((2, 13, 13, 32), (16, 32, 3, 3), "SAME"),    # conv3's geometry, K=288
])
@pytest.mark.parametrize("l", [0, 2, 4, 6])
def test_loa_conv_per_route(x_shape, w_shape, padding, l):
    """Quantized conv under ``loa?approx_bits=l&width=8``: the torch route
    against the reference's jnp route (an LOA at every tree adder), and the
    kernel route's plain version against the reference's Pallas route
    (exact clusters, LOA folds), bit for bit."""
    xq, wq, b = _quantized(x_shape, w_shape)
    spec = f"loa?approx_bits={l}&width=8"
    args = dict(stride=1, padding=padding)
    want = jcnn.im2col_conv(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(b),
                            strategy=spec + "&backend=jnp", **args)
    got = tcnn.im2col_conv(torch.from_numpy(xq), torch.from_numpy(wq),
                           torch.from_numpy(b),
                           strategy=spec + "&backend=torch", **args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jcnn.im2col_conv(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(b),
                            strategy=spec + "&backend=pallas", **args)
    cols, _ = tcnn.im2col_patches(torch.from_numpy(xq), *w_shape[2:], **args)
    wmat = torch.from_numpy(wq).reshape(w_shape[0], -1).t().contiguous()
    got = tops.dot_moa(cols, wmat, approx_bits=l,
                       block_k=tmoa.resolve(spec)._fold_block(cols.shape[1]))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(got.shape))


def test_loa_conv_conv3_shape_kernel_route():
    """AlexNet conv3 at full width (K = 2304 = 9 clusters of 256, 8 LOA
    folds): the kernel route's plain version against the Pallas route."""
    xq, wq, b = _quantized((1, 13, 13, 256), (384, 256, 3, 3), seed=1)
    spec = "loa?approx_bits=4&width=8"
    want = jcnn.im2col_conv(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(b),
                            stride=1, padding="SAME",
                            strategy=spec + "&backend=pallas")
    cols, _ = tcnn.im2col_patches(torch.from_numpy(xq), 3, 3, stride=1,
                                  padding="SAME")
    assert tuple(cols.shape) == (169, 2304)
    got = tops.dot_moa(cols, torch.from_numpy(wq).reshape(384, -1).t()
                       .contiguous(), block_k=256, approx_bits=4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(169, 384))


def test_port_init_layouts(params):
    """The port's own initializer gives the reference's tree of shapes, on
    the device it is asked for."""
    for name, tinit in (("lenet5", tcnn.init_lenet5),
                        ("alexnet", tcnn.init_alexnet)):
        want = jax.tree.map(lambda a: tuple(a.shape), params[name][0])
        got = interop.tree_map(lambda t: tuple(t.shape),
                               tinit(0, device="cpu"))
        assert got == want
        a, b = tinit(3, device="cpu"), tinit(3, device="cpu")
        assert torch.equal(a["conv1"]["w"], b["conv1"]["w"])
    assert tcnn.LENET5_LAYOUT == jcnn.LENET5_LAYOUT
    assert tcnn.ALEXNET_LAYOUT == jcnn.ALEXNET_LAYOUT


def test_paper_repro_sections_on_cpu():
    """The CLI's LOA-conv and CNN sections at a small size on the CPU: the
    paper example's MRED equals the reference's on the same operands."""
    from repro.core import metrics as jmetrics

    rows = paper_repro.loa_conv("cpu", batch=1, verbose=False)
    assert [r["l"] for r in rows] == [0, 2, 4, 6] * 2
    example = [r for r in rows if r["shape"] == "paper example"]
    assert all(r["K"] == 75 and r["loa_folds"] == 0 for r in example)
    assert all(r["loa_folds"] == 8 for r in rows if r["K"] == 2304)
    xq, wq = paper_repro._quantized_operands(
        np.random.default_rng(0), (1, 16, 16, 3), (8, 3, 5, 5), "cpu")
    xq, wq = jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy())
    b = jnp.zeros(8, jnp.int32)
    exact = jcnn.im2col_conv(xq, wq, b, stride=1, strategy="tree")
    for r in example:
        approx = jcnn.im2col_conv(
            xq, wq, b, stride=1,
            strategy=f"loa?approx_bits={r['l']}&width=8&backend=jnp")
        assert abs(r["mred"]["torch"]
                   - float(jmetrics.mred(approx, exact))) <= 1e-6
    cnn_rows = paper_repro.cnn_forward("cpu", batch=0, verbose=False)
    assert [(r["net"], r["strategy"]) for r in cnn_rows] == [
        ("lenet5", "tree"), ("lenet5", "serial?chunk=256")]
    assert all(r["max_abs_err"] <= r["tol"] and r["finite"]
               for r in cnn_rows)
