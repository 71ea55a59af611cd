"""The port's cell model (``repro_torch.launch.costing``) and cell shapes
(``repro_torch.configs``) against the reference's, on the CPU.

Both sides are host arithmetic on the same config, so every number must
agree to 1e-12 relative: ``estimate_cell`` over all ten archs × ``SHAPES``
× several meshes (``resident_kv_tokens`` unset and set), every
``serve_target_cost`` phase on each serve family's smoke config, the ring
collectives, ``kv_resident_bytes`` and ``_train_multiplier``; and the
shapes, skip rules, cells and arch list are the reference's.
"""

import dataclasses
import math

import pytest

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.launch import costing as jcost
from repro_torch.configs import alexnet, base as tbase, lenet5
from repro_torch.configs import registry as treg
from repro_torch.launch import costing as tcost

ARCHS = jreg.list_archs()
MESHES = [dict(pod=1, data=1, model=1),
          dict(pod=1, data=16, model=16),
          dict(pod=2, data=16, model=16, compress_grads=True, attn_cp=True),
          dict(pod=1, data=8, model=3, fsdp=False, kv_dim_shard=True),
          dict(pod=1, data=256, model=1)]
SERVE_FAMILIES = {"dense": "llama3-8b", "moe": "moonshot-v1-16b-a3b",
                  "ssm": "mamba2-370m", "hybrid": "zamba2-1.2b"}
AUDIT_SHAPE = dict(slots=2, max_len=32, window=4, block_size=8,
                   prefill_len=16)


def _close(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
        return
    assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0), \
        f"{where}: {got} != {want}"


def test_shapes_cells_and_archs_equal():
    assert treg.list_archs() == jreg.list_archs()
    assert {k: dataclasses.astuple(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    assert treg.valid_cells() == jreg.valid_cells()
    for arch in ARCHS:
        for name in jbase.SHAPES:
            assert tbase.shape_applicable(
                treg.get_config(arch), tbase.SHAPES[name]) == \
                jbase.shape_applicable(jreg.get_config(arch),
                                       jbase.SHAPES[name])
    assert (alexnet.NAME, alexnet.INPUT_SHAPE) == ("alexnet", (227, 227, 3))
    assert (lenet5.NAME, lenet5.INPUT_SHAPE) == ("lenet5", (32, 32, 1))
    assert len(alexnet.ALEXNET_CONV_SPECS) == 5
    assert len(lenet5.LENET5_CONV_SPECS) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_estimate_cell_equal(arch):
    j, t = jreg.get_config(arch), treg.get_config(arch)
    for name in jbase.SHAPES:
        for mesh in MESHES:
            jm, tm = jcost.MeshMeta(**mesh), tcost.MeshMeta(**mesh)
            assert (tm.chips, tm.dp, tm.kv_shard_ways(t)) == \
                (jm.chips, jm.dp, jm.kv_shard_ways(j))
            for resident in (None, 12345.0):
                want = jcost.estimate_cell(j, jbase.SHAPES[name], jm,
                                           resident_kv_tokens=resident)
                got = tcost.estimate_cell(t, tbase.SHAPES[name], tm,
                                          resident_kv_tokens=resident)
                _close(dataclasses.asdict(got), dataclasses.asdict(want),
                       f"{arch}/{name}/{mesh}/{resident}")


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_train_multiplier_and_remat_cells_equal(remat):
    j = dataclasses.replace(jreg.get_config("llama3-8b"), remat=remat)
    t = dataclasses.replace(treg.get_config("llama3-8b"), remat=remat)
    assert tcost._train_multiplier(t) == jcost._train_multiplier(j)
    mesh = dict(pod=1, data=4, model=2)
    _close(dataclasses.asdict(tcost.estimate_cell(
        t, tbase.SHAPES["train_4k"], tcost.MeshMeta(**mesh))),
        dataclasses.asdict(jcost.estimate_cell(
            j, jbase.SHAPES["train_4k"], jcost.MeshMeta(**mesh))))


@pytest.mark.parametrize("family", sorted(SERVE_FAMILIES))
def test_serve_target_cost_equal(family):
    j = jreg.smoke_config(jreg.get_config(SERVE_FAMILIES[family]))
    t = treg.smoke_config(treg.get_config(SERVE_FAMILIES[family]))
    assert tcost.SERVE_PHASES == jcost.SERVE_PHASES
    assert tcost.NONCONTRACTION_COMPONENTS == jcost.NONCONTRACTION_COMPONENTS
    for shape in (AUDIT_SHAPE, dict(slots=3, max_len=64, window=2,
                                    block_size=16, prefill_len=24)):
        for phase in jcost.SERVE_PHASES:
            _close(tcost.serve_target_cost(t, phase, **shape),
                   jcost.serve_target_cost(j, phase, **shape),
                   f"{family}/{phase}")
        assert tcost._ssd_conv_hist_flops(t, 3.0) == \
            jcost._ssd_conv_hist_flops(j, 3.0)
    with pytest.raises(ValueError, match="unknown serve phase"):
        tcost.serve_target_cost(t, "commit", **AUDIT_SHAPE)
    full_j, full_t = (jreg.get_config(SERVE_FAMILIES[family]),
                      treg.get_config(SERVE_FAMILIES[family]))
    _close(tcost.serve_target_cost(full_t, "paged_verify", **AUDIT_SHAPE),
           jcost.serve_target_cost(full_j, "paged_verify", **AUDIT_SHAPE))
    assert tcost.kv_resident_bytes(t, n_blocks_in_use=7, block_size=16) == \
        jcost.kv_resident_bytes(j, n_blocks_in_use=7, block_size=16)


def test_ring_collectives_equal():
    for b in (0.0, 1.0, 3.5e9):
        for k in (1, 2, 3, 16, 512):
            assert tcost.ring_all_reduce(b, k) == jcost.ring_all_reduce(b, k)
            assert tcost.ring_all_gather(b, k) == jcost.ring_all_gather(b, k)
            assert tcost.ring_reduce_scatter(b, k) == \
                jcost.ring_reduce_scatter(b, k)
            assert tcost.all_to_all(b, k) == jcost.all_to_all(b, k)
