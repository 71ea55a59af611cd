"""The port's MOA engine (``repro_torch.moa``) against ``repro.moa``.

Spec strings round-trip identically, ``cost()`` dicts are equal, and the
plain schedules (binary tree, serialized clusters, K-chunked matmul) and the
strategies' ``dot`` agree with the reference's jnp paths on the same numpy
inputs. The port's ``backend`` names its own substrates (``torch`` and
``kernel`` where the reference has ``jnp`` and ``pallas``), so specs are
compared with the backend left at ``auto``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import moa as jmoa
from repro_torch import moa as tmoa
from repro_torch.moa import backends as tb
from repro.moa import backends as jb

SPECS = ["tree", "tree?accum=bfloat16", "serial", "serial?chunk=256",
         "serial?accum=float32&chunk=4096"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_round_trip_and_cost(spec):
    j, t = jmoa.resolve(spec), tmoa.resolve(spec)
    assert t.spec == j.spec
    assert tmoa.resolve(t.spec) == t
    for n, dt in ((1, "bfloat16"), (4096, "bfloat16"), (14336, "float32"),
                  (777, "int8")):
        assert t.cost(n, dt) == j.cost(n, dt)


def test_registry_and_scope():
    assert set(tmoa.available_strategies()) == {"tree", "serial"}
    assert tmoa.active_strategy() is None
    with tmoa.moa_scope("serial?chunk=8") as s:
        assert tmoa.active_strategy("tree") is s
    assert tmoa.active_strategy("tree") == tmoa.resolve("tree")
    with pytest.raises(ValueError, match="unknown MOA strategy"):
        tmoa.resolve("loa")             # comes with the paper path
    with pytest.raises(ValueError, match="backend"):
        tmoa.resolve("serial?backend=pallas")


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
