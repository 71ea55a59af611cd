"""The port's paper path (``repro_torch.core``, ``repro_torch.paper``)
against the reference's ``repro.core`` and ``benchmarks``.

``core`` is compared function by function on the same numpy operands: the
LOA arithmetic bit for bit, the cost model and the DHM reports exactly, the
error metrics to within 1e-6. The runners' deterministic ``derived`` values
(Table 1's census, Fig. 4's ALM verdicts and working-set ratio, Fig. 5's
flat ALMs and op ratio) equal the reference runners'; Fig. 5's MRED draws
its own random operands in each package, so it is checked against the
paper's bound and, on shared operands, against the reference.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig4_serialization as jfig4
from benchmarks import fig5_loa as jfig5
from benchmarks import table1_moa_counts as jtable1
from repro.core import cost_model as jcost
from repro.core import dhm as jdhm
from repro.core import loa as jloa
from repro.core import metrics as jmetrics
from repro.core import scm as jscm
from repro_torch.core import cost_model as tcost
from repro_torch.core import dhm as tdhm
from repro_torch.core import loa as tloa
from repro_torch.core import metrics as tmetrics
from repro_torch.core import scm as tscm
from repro_torch.paper import (fig4_serialization, fig5_loa, moa_strategies,
                               table1_moa_counts)
from repro_torch.paper.timing import parse_derived


def _ops(bits, n=4096, seed=0):
    rs = np.random.default_rng(seed + bits)
    return (rs.integers(0, 2 ** bits, n).astype(np.int32),
            rs.integers(0, 2 ** bits, n).astype(np.int32))


# ---------------------------------------------------------------------------
# core/loa.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8, 12, 16])
def test_loa_add_bit_exact(bits):
    x, y = _ops(bits)
    for l in range(bits + 1):
        want = jloa.loa_add(jnp.asarray(x), jnp.asarray(y), approx_bits=l,
                            width=bits)
        got = tloa.loa_add(torch.from_numpy(x), torch.from_numpy(y),
                           approx_bits=l, width=bits)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="outside"):
        tloa.loa_add(torch.from_numpy(x), torch.from_numpy(y),
                     approx_bits=bits + 1, width=bits)


@pytest.mark.parametrize("n,axis", [(1, 0), (7, 0), (64, -1), (301, 1)])
@pytest.mark.parametrize("l", [0, 3, 6])
def test_loa_sum_bit_exact(n, axis, l):
    rs = np.random.default_rng(n)
    shape = [5, 3]
    shape.insert(axis % 3 if axis >= 0 else 2, n)
    x = rs.integers(0, 256, shape).astype(np.int32)
    want = jloa.loa_sum(jnp.asarray(x), approx_bits=l, width=8, axis=axis)
    got = tloa.loa_sum(torch.from_numpy(x), approx_bits=l, width=8, axis=axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_loa_scalars():
    for l in range(9):
        assert tloa.loa_error_bound(l) == jloa.loa_error_bound(l)
    for n in (1, 2, 3, 325, 2304):
        for w in (4, 8):
            assert tloa.exact_bits_required(n, w) == \
                jloa.exact_bits_required(n, w)
    x, y = _ops(8, n=64)
    for l in (0, 1, 4, 8):
        got = tloa.loa_add(torch.from_numpy(x), torch.from_numpy(y),
                           approx_bits=l).tolist()
        assert got == [jloa.loa_add_reference_python(int(a), int(b), l)
                       for a, b in zip(x, y)]
        assert got == [tloa.loa_add_reference_python(int(a), int(b), l)
                       for a, b in zip(x, y)]


# ---------------------------------------------------------------------------
# core/metrics.py, core/cost_model.py, core/scm.py, core/dhm.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8, 12, 16])
def test_metrics_on_shared_operands(bits):
    """MRED and relatives of the LOA, per l, from the same operands: equal
    to within 1e-6 (both in f32; the sums reassociate)."""
    x, y = _ops(bits, n=200_000)
    x[:3] = y[:3] = 0                     # zero exact sums are excluded
    for l in range(bits // 2 + 1):
        js = jloa.loa_add(jnp.asarray(x), jnp.asarray(y), approx_bits=l,
                          width=bits)
        ts = tloa.loa_add(torch.from_numpy(x), torch.from_numpy(y),
                          approx_bits=l, width=bits)
        exact_j, exact_t = jnp.asarray(x + y), torch.from_numpy(x + y)
        for jf, tf, kw in ((jmetrics.mred, tmetrics.mred, {}),
                           (jmetrics.nmed, tmetrics.nmed,
                            {"max_abs": 2.0 ** (bits + 1)}),
                           (jmetrics.max_red, tmetrics.max_red, {}),
                           (jmetrics.error_rate, tmetrics.error_rate, {})):
            assert abs(float(tf(ts, exact_t, **kw))
                       - float(jf(js, exact_j, **kw))) <= 1e-6


def test_cost_model_equal():
    for w in (1, 2, 7, 8, 12, 16):
        assert tcost.alm_binary_adder(w) == jcost.alm_binary_adder(w)
        assert tcost.alm_scm_multiplier(w) == jcost.alm_scm_multiplier(w)
        for n in (0, 1, 2, 3, 6, 64, 325, 1774, 2304):
            for f in ("alm_adder_tree", "alm_serializer", "alm_accumulator",
                      "alm_serial_moa"):
                assert getattr(tcost, f)(n, w) == getattr(jcost, f)(n, w), f
        for l in range(w + 1):
            assert tcost.alm_loa_adder(w, l) == jcost.alm_loa_adder(w, l)
    assert tcost.vpu_ops_loa_add() == jcost.vpu_ops_loa_add() == 6
    assert tcost.vpu_ops_exact_add() == jcost.vpu_ops_exact_add() == 1
    assert tcost.MCM_SHARING == jcost.MCM_SHARING


def test_scm_equal():
    w = np.random.default_rng(1).standard_normal((8, 4, 3, 3))
    for bits in (4, 8):
        np.testing.assert_array_equal(tscm.quantize_symmetric(w, bits),
                                      jscm.quantize_symmetric(w, bits))
        assert dataclasses.asdict(tscm.classify_weights(w, bits=bits)) == \
            dataclasses.asdict(jscm.classify_weights(w, bits=bits))
    q = jscm.quantize_symmetric(w, 8)
    assert dataclasses.asdict(tscm.classify_weights(
        q, already_quantized=True)) == dataclasses.asdict(
        jscm.classify_weights(q, already_quantized=True))


def _report(r):
    return (r.spec.name, r.spec.operands, dataclasses.asdict(r.census),
            r.moa_alms, r.multiplier_alms, r.moa_fraction, r.n_opd)


@pytest.mark.parametrize("seed", [0, 3])
def test_dhm_reports_equal(seed):
    assert [dataclasses.astuple(s) for s in tdhm.ALEXNET_CONV_SPECS] == \
        [dataclasses.astuple(s) for s in jdhm.ALEXNET_CONV_SPECS]
    assert tdhm.ALEXNET_PAPER_NOPD == jdhm.ALEXNET_PAPER_NOPD
    assert tdhm.paper_calibrated_densities() == \
        jdhm.paper_calibrated_densities()
    for densities in (tdhm.paper_calibrated_densities(), None):
        got = tdhm.analyze_network(tdhm.ALEXNET_CONV_SPECS,
                                   densities=densities, seed=seed)
        want = jdhm.analyze_network(jdhm.ALEXNET_CONV_SPECS,
                                    densities=densities, seed=seed)
        assert [_report(r) for r in got] == [_report(r) for r in want]
    got = tdhm.analyze_network(tdhm.LENET5_CONV_SPECS, seed=seed)
    want = jdhm.analyze_network(jdhm.LENET5_CONV_SPECS, seed=seed)
    assert [_report(r) for r in got] == [_report(r) for r in want]


# ---------------------------------------------------------------------------
# the runners: deterministic derived values equal the reference's
# ---------------------------------------------------------------------------


def test_table1_runner():
    got = parse_derived(table1_moa_counts.run(verbose=False,
                                              device="cpu")["derived"])
    want = parse_derived(jtable1.run(verbose=False)["derived"])
    assert got == want
    assert want["conv1_moa_frac"] == "0.690(paper:0.69)"


def test_fig4_runner():
    got = parse_derived(fig4_serialization.run(verbose=False,
                                               device="cpu")["derived"])
    want = parse_derived(jfig4.run(verbose=False)["derived"])
    assert got["fpga_serial_wins"] == want["fpga_serial_wins"] == \
        "0/11(paper:0)"
    assert got["tpu_vmem_reduction"] == want["tpu_vmem_reduction"] == "8x"
    assert got["route"] == "torch" and got["clock"] == "host"


def test_fig5_runner():
    got = parse_derived(fig5_loa.run(verbose=False, device="cpu")["derived"])
    want = parse_derived(jfig5.run(verbose=False)["derived"])
    for key in ("alm_flat", "tpu_loa_cost"):
        assert got[key] == want[key]
    assert got["tpu_loa_cost"] == "6x" and got["alm_flat"] == "True"
    # each package draws its own 200000 operand pairs per width
    g = float(got["mred8bit_max"].split("(")[0])
    w = float(want["mred8bit_max"].split("(")[0])
    assert g < 0.10 and abs(g - w) < 1e-3


def test_moa_mred_routes():
    """The 2304-operand LOA MOA of the Fig. 5 runner: the torch route equals
    the reference's jnp route on the same operands (64 outputs here)."""
    rs = np.random.default_rng(0)
    x = rs.integers(0, 256, (2304, 64)).astype(np.int32)
    from repro import moa as jmoa
    from repro_torch import moa as tmoa
    for l in (2, 6):
        want = jmoa.resolve(f"loa?approx_bits={l}&backend=jnp").sum(
            jnp.asarray(x), axis=0)
        got = tmoa.resolve(f"loa?approx_bits={l}&backend=torch").sum(
            torch.from_numpy(x), axis=0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert abs(float(tmetrics.mred(got, torch.from_numpy(x.sum(0))))
                   - float(jmetrics.mred(want, jnp.asarray(x.sum(0))))) \
            <= 1e-6


def test_moa_strategies_runner():
    d = parse_derived(moa_strategies.run(verbose=False,
                                         device="cpu")["derived"])
    assert float(d["strategy_max_err"]) < 1e-3     # f32 vs float64 product
    assert d["grad_compress"] == "4.0x"
