"""The MoE, SSM and hybrid families on a device mesh (gloo ranks on the
CPU) against the port's engine on one device, f32: moonshot's experts
over ``model`` (expert parallelism, its attention heads tensor-parallel)
and its slots over ``data``; zamba2 and mamba2 data-parallel over slots,
their serve rules leaving the model axis idle. One spawn of ranks runs
each architecture's matrix (``torch_mesh_ranks.matrix``: both layouts
where the family pages, plain and oracle spec, a chunked prefill, the
teacher-forced logits, the specs, the cache across a decode step, a
3-slot engine, a reload).
"""

import pytest

import torch_mesh_ranks as ranks
from repro_torch.launch.mesh import run_ranks


@pytest.mark.parametrize("arch,meshes", [
    ("moonshot-v1-16b-a3b", [(1, 2), (2, 1)]),
    ("zamba2-1.2b", [(2, 1), (1, 2)]),
    ("mamba2-370m", [(2, 1)]),
])
def test_family_meshes(arch, meshes):
    want = ranks.single_device(arch, {})
    got = run_ranks(2, ranks.matrix, arch, {"smoke": ({}, meshes)},
                    join_timeout_s=ranks.JOIN_S)
    got = [{shape: mine for (_, shape), mine in r.items()} for r in got]
    for shape in meshes:
        ranks.check_matrix(got, want, shape)
    first = got[1][meshes[0]]
    if arch.startswith("moonshot"):
        ep = first
        assert ep["split"]["experts"] == (4, 8) and ep["split"]["heads"]
        assert "model" in ep["param_specs"]["layers.moe.w_gate"]
        assert "model" in ep["cache_specs"]["layers.k"]
        # the router replicates: every rank routes every token alike
        assert "model" in ep["rule_specs"]["layers.moe.router"]
        assert "model" not in ep["param_specs"]["layers.moe.router"]
        assert ep["local_shapes"]["layers.moe.w_gate"] == (2, 4, 64, 128)
        assert got[1][(2, 1)]["cache_specs"]["pos"] == ("data",)
    else:
        # data-parallel: no parameter splits, the slots do
        for shape in meshes:
            specs = got[1][shape]["param_specs"]
            assert all(e is None for spec in specs.values() for e in spec)
        assert first["rows"] == (1, 2)
        assert first["cache_specs"]["pos"] == ("data",)
    if arch.startswith("zamba2"):
        assert all(e is None for e in first["param_specs"]["shared_attn.wq"])
