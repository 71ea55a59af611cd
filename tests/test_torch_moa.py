"""The port's MOA engine (``repro_torch.moa``) against ``repro.moa``.

Spec strings round-trip identically, ``cost()`` dicts are equal, and the
plain schedules (binary tree, serialized clusters, K-chunked matmul) and the
strategies' ``dot`` agree with the reference's jnp paths on the same numpy
inputs. The port's ``backend`` names its own substrates (``torch`` and
``kernel`` where the reference has ``jnp`` and ``pallas``), so specs are
compared with the backend left at ``auto``.

LOA routes are compared route with route: the two put the approximation in
different places (every adder of a tree on ``torch`` / ``jnp``; cluster
folds on ``kernel`` / ``pallas``), and ``auto`` picks ``jnp`` on the
reference's CPU but ``kernel`` on the port's GPU. On the CPU the port's
kernel route is its plain version: the dispatch in ``repro_torch.kernels.ops``
with the strategy's cluster size, held against the Pallas kernels in
interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import moa as jmoa
from repro_torch import moa as tmoa
from repro_torch.kernels import ops as tops
from repro_torch.moa import backends as tb
from repro.moa import backends as jb

SPECS = ["tree", "tree?accum=bfloat16", "serial", "serial?chunk=256",
         "serial?accum=float32&chunk=4096"]
LOA_SPECS = ["loa", "loa?approx_bits=0", "loa?approx_bits=4&width=12",
             "loa?approx_bits=2&chunk=128"]


@pytest.mark.parametrize("spec", SPECS + LOA_SPECS)
def test_spec_round_trip_and_cost(spec):
    j, t = jmoa.resolve(spec), tmoa.resolve(spec)
    assert t.spec == j.spec
    assert tmoa.resolve(t.spec) == t
    for n, dt in ((1, "bfloat16"), (4096, "bfloat16"), (14336, "float32"),
                  (777, "int8")):
        assert t.cost(n, dt) == j.cost(n, dt)


def test_registry_and_scope():
    assert set(tmoa.available_strategies()) == {"tree", "serial", "loa"}
    assert set(tmoa.available_strategies()) == set(
        jmoa.available_strategies())
    assert tmoa.active_strategy() is None
    with tmoa.moa_scope("serial?chunk=8") as s:
        assert tmoa.active_strategy("tree") is s
    assert tmoa.active_strategy("tree") == tmoa.resolve("tree")
    with pytest.raises(ValueError, match="unknown MOA strategy"):
        tmoa.resolve("wallace")
    with pytest.raises(ValueError, match="backend"):
        tmoa.resolve("serial?backend=pallas")
    with pytest.raises(ValueError, match="approx_bits"):
        tmoa.resolve("loa?approx_bits=9&width=8")
    for name in tmoa.available_strategies():
        j, t = jmoa.get_strategy_class(name), tmoa.get_strategy_class(name)
        assert t.integer_only == j.integer_only
        assert [s.replace("kernel", "pallas") for s in t.bench_specs()] == \
            list(j.bench_specs())


@pytest.mark.parametrize("n,f", [(1, 3), (7, 5), (64, 16), (513, 9)])
def test_reductions(n, f):
    x = np.random.default_rng(n).standard_normal((n, f)).astype(np.float32)
    tx = torch.from_numpy(x)
    # same pairing order, f32: equal up to the last bit of reassociation
    np.testing.assert_allclose(tb.tree_sum(tx, torch.float32).numpy(),
                               np.asarray(jb.tree_sum(x, jnp.float32)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.serial_sum(tx, 32, torch.float32).numpy(),
                               np.asarray(jb.serial_sum(x, 32, jnp.float32)),
                               rtol=1e-6, atol=1e-5)
    xi = (x * 100).astype(np.int32)
    np.testing.assert_array_equal(
        tb.serial_sum(torch.from_numpy(xi), 16, torch.int32).numpy(),
        np.asarray(jb.serial_sum(jnp.asarray(xi), 16, jnp.int32)))


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("m,k,n", [(3, 64, 5), (2, 700, 33)])
def test_strategy_dot(spec, m, k, n):
    rs = np.random.default_rng(k)
    a = rs.standard_normal((2, m, k)).astype(np.float32)   # leading batch
    b = rs.standard_normal((k, n)).astype(np.float32)
    want = jmoa.resolve(spec).dot(jnp.asarray(a), jnp.asarray(b))
    got = tmoa.resolve(spec).dot(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    # f32 K-chunked sums in both; reassociation within each chunk
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    ai = (a * 8).astype(np.int8)
    bi = (b * 8).astype(np.int8)
    want_i = jmoa.resolve(spec).dot(jnp.asarray(ai), jnp.asarray(bi))
    got_i = tmoa.resolve(spec).dot(torch.from_numpy(ai), torch.from_numpy(bi))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


# ---------------------------------------------------------------------------
# the LOA strategy, route by route; tree / serial sums on the kernel route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l", [0, 2, 4])
@pytest.mark.parametrize("shape,axis", [((512, 20), 0), ((300, 7), 0),
                                        ((3, 1024, 4), 1), ((6, 33), -1)])
def test_loa_sum_per_route(l, shape, axis):
    rs = np.random.default_rng(l + shape[0])
    x = rs.integers(0, 256, shape).astype(np.int32)
    spec = f"loa?approx_bits={l}"
    # torch route against the reference's jnp route: a tree of LOAs
    want = jmoa.resolve(spec + "&backend=jnp").sum(jnp.asarray(x), axis=axis)
    got = tmoa.resolve(spec + "&backend=torch").sum(torch.from_numpy(x),
                                                    axis=axis)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the kernel route's plain version against the Pallas kernel
    strat = tmoa.resolve(spec)
    x2 = np.moveaxis(x, axis, 0).reshape(x.shape[axis], -1)
    want = jmoa.resolve(spec + "&backend=pallas").sum(jnp.asarray(x),
                                                      axis=axis)
    got = tops.loa_reduce(torch.from_numpy(x2), approx_bits=l,
                          block_n=strat._fold_block(x2.shape[0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(-1))


@pytest.mark.parametrize("l", [0, 1, 4])
@pytest.mark.parametrize("m,k,n", [(5, 512, 6), (3, 75, 4)])
def test_loa_dot_per_route(l, m, k, n):
    rs = np.random.default_rng(k + l)
    a = rs.integers(0, 256, (2, m, k)).astype(np.int32)   # leading batch
    b = rs.integers(0, 16, (k, n)).astype(np.int32)
    spec = f"loa?approx_bits={l}"
    want = jmoa.resolve(spec + "&backend=jnp").dot(jnp.asarray(a),
                                                   jnp.asarray(b))
    got = tmoa.resolve(spec + "&backend=torch").dot(torch.from_numpy(a),
                                                    torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    strat = tmoa.resolve(spec)
    want = jmoa.resolve(spec + "&backend=pallas").dot(jnp.asarray(a),
                                                      jnp.asarray(b))
    got = tops.dot_moa(torch.from_numpy(a.reshape(-1, k)),
                       torch.from_numpy(b), block_k=strat._fold_block(k),
                       approx_bits=l)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(-1, n))


def test_loa_torch_route_chunks_rows(monkeypatch):
    """The LOA tree's row chunking bounds memory and changes nothing."""
    from repro_torch.moa import strategies

    rs = np.random.default_rng(3)
    a = torch.from_numpy(rs.integers(0, 256, (37, 96)).astype(np.int32))
    b = torch.from_numpy(rs.integers(0, 16, (96, 5)).astype(np.int32))
    strat = tmoa.resolve("loa?approx_bits=3&backend=torch")
    whole = strat.dot(a, b)
    monkeypatch.setattr(strategies, "_LOA_TREE_MAX_PARTIALS", 96 * 5 * 4)
    assert torch.equal(strat.dot(a, b), whole)


def test_loa_needs_integers():
    for mod in (jmoa, tmoa):
        with pytest.raises(TypeError, match="integer"):
            mod.resolve("loa").sum(np.zeros((4, 2), np.float32)
                                   if mod is jmoa else torch.zeros((4, 2)))


@pytest.mark.parametrize("spec", ["tree", "serial?chunk=512",
                                  "serial?chunk=100"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_kernel_route_sum(spec, dtype):
    """Tree / serial ``sum`` on the kernel route: the cluster the reference
    gives ``moa_reduce`` (``min(n or chunk, 4096)``), through the port's
    ``moa_reduce`` dispatch (its plain version on the CPU) against the
    Pallas kernel."""
    rs = np.random.default_rng(9)
    x = rs.standard_normal((4100, 6)).astype(np.float32)
    if dtype == "int32":
        x = (x * 1000).astype(np.int32)
    jstrat = jmoa.resolve(spec).replace(backend="pallas")
    want = np.asarray(jstrat.sum(jnp.asarray(x), axis=0))
    block_n = min(getattr(jstrat, "chunk", x.shape[0]), 4096)
    got = tops.moa_reduce(torch.from_numpy(x), block_n=block_n).numpy()
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_kernel_sum_backward_broadcasts():
    """The kernel route's autograd rule, on the plain version: the
    cotangent of every operand is the output's."""
    from repro_torch.moa.backends import _KernelSum

    x = torch.randn((10, 3), requires_grad=True)
    y = _KernelSum.apply(x, 4)
    y.backward(torch.tensor([1.0, 2.0, 3.0]))
    torch.testing.assert_close(x.grad, torch.tensor([[1.0, 2.0, 3.0]] * 10))
