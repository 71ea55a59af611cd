"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) and its
production meshes, on the CPU, against the JAX package's pure functions.

The reference's dry run compiles each cell for 512 host devices, which
fails on this install (``test_sharding``'s multi-pod compile), so the
port is held to what the reference computes without compiling, read from
one subprocess (``torch_dryrun_reference.py``: importing the reference's
dry run sets ``XLA_FLAGS``): the meshes, ``_model_flops`` and
``Model.input_specs`` of every valid cell, ``roofline_terms`` under
``TPU_V5E``, ``apply_variant`` of every item the port accepts (field by
field), and ``estimate_cell`` under the dry run's ``MeshMeta`` for every
valid cell of both meshes — each to 1e-12 relative or exactly. Then, on
fake process groups at smoke size, the trace itself:

* **no work lost or invented** — on a ``(1, 2)`` and a ``(2, 2)`` mesh
  where every split divides, the product and kernel FLOPs of every rank
  (each traced in turn) sum to the one-device trace of the same step, for
  the dense and the MoE family in train, prefill and decode; the MoE's
  router, which every model rank runs whole by design, counted ``M``
  times;
* **memory of the shards** — a rank's argument bytes are exactly its
  placement's local shards (parameters, moments, batch, cache);
* **``meta`` routes** — each kernel entry point on ``meta`` returns the
  plain version's output shape and dtype, and the recorder prices the
  call as on the CPU;
* **the run and its trace** — a rank's step run for real (on the CPU in
  the port's interpret mode, the kernel routes forced: what the card
  runs) counts the trace's kernel calls and product FLOPs exactly, and
  holds the same arguments;
* the paged kernel's head-offset read against the plain version, the CLI,
  and the refusals by name (mamba2 / zamba2 on a split model axis, the
  variants the port's layers cannot run).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeSpec, shape_applicable
from repro_torch.interop import tree_leaves
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD, fake_world,
                                     make_mesh, make_production_mesh)
from repro_torch.models.api import build_model
from repro_torch.parallel.placement import kv_slice
from repro_torch.parallel.sharding import local_shape

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL = 1e-12

#: smoke shapes of the three phases (decode: a cache a multiple of the
#: dense-slot kernel's 16-token pages)
PHASES = {"train": ShapeSpec("train", 16, 4, "train"),
          "prefill": ShapeSpec("prefill", 16, 4, "prefill"),
          "decode": ShapeSpec("decode", 32, 4, "decode")}
#: smoke configs whose every split over 2 divides (vocabulary, KV heads,
#: experts)
FAMILIES = {"dense": ("llama3-8b", dict(vocab=256, n_kv_heads=2)),
            "moe": ("moonshot-v1-16b-a3b", dict(vocab=256))}


def smoke(arch, **overrides):
    cfg = registry.smoke_config(registry.ARCHS[arch])
    return dataclasses.replace(cfg, **overrides)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_dryrun_reference.py")],
        check=True, capture_output=True, text=True, env=env, timeout=300)
    return json.loads(out.stdout)


def _close(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=RTOL, abs_tol=0.0), \
            (where, got, want)
    else:
        assert got == want, (where, got, want)


def _cells():
    for arch in sorted(registry.ARCHS):
        for name, shape in SHAPES.items():
            cfg = dryrun.serving_config(registry.get_config(arch), shape)
            if shape_applicable(cfg, shape)[0]:
                yield arch, name, cfg, shape


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: [list(tree.shape),
                          str(tree.dtype).replace("torch.", "")]}


def test_pure_functions_equal_the_reference(reference):
    """Meshes, ``_model_flops``, ``input_specs`` and ``estimate_cell``
    (the dry run's ``cost_analytic``) of every valid cell, the roofline
    and the accepted variants."""
    assert reference["single_pod"] == list(SINGLE_POD)
    assert reference["multi_pod"] == list(MULTI_POD)
    with fake_world(math.prod(SINGLE_POD)):
        m = make_production_mesh(device="cpu")
        got = [list(m.mesh.shape), list(m.mesh_dim_names)]
    assert got == reference["meshes"]["False"]
    with fake_world(math.prod(MULTI_POD), rank=300):
        m = make_production_mesh(multi_pod=True, device="cpu")
        got = [list(m.mesh.shape), list(m.mesh_dim_names)]
        assert tuple(m.get_coordinate()) == (1, 2, 12)
    assert got == reference["meshes"]["True"]

    n = 0
    for arch, name, cfg, shape in _cells():
        key = f"{arch}|{name}"
        _close(dryrun._model_flops(cfg, shape), reference["model_flops"][key],
               key)
        assert _flat(build_model(cfg).input_specs(shape)) \
            == reference["input_specs"][key], key
        for multi in (False, True):
            c = dryrun.analytic_cell(cfg, shape, multi_pod=multi)
            _close({"flops": c.flops, "hbm_bytes": c.hbm_bytes,
                    "collective_bytes": c.collective_bytes,
                    "components": c.components,
                    "bytes_components": c.bytes_components,
                    "collective_components": c.collective_components},
                   reference["estimate_cell"][f"{key}|{multi}"], key)
        n += 1
    assert n == len(reference["model_flops"]) == 31

    v5e = dryrun.ChipSpec("tpu_v5e", *reference["tpu_v5e"])
    from torch_dryrun_reference import ROOFLINE, VARIANTS

    for (f, b, c), want in zip(ROOFLINE, reference["roofline"]):
        _close(dryrun.roofline_terms(hlo_flops=f, hlo_bytes=b,
                                     collective_bytes_per_device=c,
                                     spec=v5e), want)
    for item in VARIANTS:
        for arch in ("llama3-8b", "mamba2-370m"):
            got = json.loads(json.dumps(dataclasses.asdict(
                dryrun.apply_variant(registry.get_config(arch), item))))
            assert got == reference["variants"][f"{arch}|{item}"], item


def _trace(cfg, shape, mesh_shape=None, rank=0):
    if mesh_shape is None:
        cell = dryrun.build_cell(cfg, shape, None)
        return cell, dryrun.trace_step(cell.fn, cell.args,
                                       grad=shape.phase == "train")
    with fake_world(math.prod(mesh_shape), rank):
        mesh = make_mesh(mesh_shape, device="cpu")
        cell = dryrun.build_cell(cfg, shape, mesh)
        return cell, dryrun.trace_step(cell.fn, cell.args,
                                       grad=shape.phase == "train")


def _router_flops(cfg, shape) -> float:
    """The router's products of one step over the whole batch: ``2·T·d·E``
    a layer, the training step's backward twice more (remat off)."""
    tokens = shape.global_batch * (1 if shape.phase == "decode"
                                   else shape.seq_len)
    mult = 3 if shape.phase == "train" else 1
    return mult * cfg.n_layers * 2.0 * tokens * cfg.d_model * cfg.n_experts


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("phase", sorted(PHASES))
def test_no_work_lost_or_invented(family, phase):
    arch, overrides = FAMILIES[family]
    cfg = smoke(arch, **overrides)
    if phase != "train":
        cfg = dryrun.serving_config(cfg, PHASES[phase])
    shape = PHASES[phase]
    _, one = _trace(cfg, shape)
    assert one.flops > 0 and one.kernel_calls
    for mesh_shape in ((1, 2), (2, 2)):
        total, calls = 0.0, 0
        for rank in range(math.prod(mesh_shape)):
            _, c = _trace(cfg, shape, mesh_shape, rank)
            total += c.flops
            calls += sum(c.kernel_calls.values())
        M = mesh_shape[-1]
        want = one.flops + (M - 1) * (_router_flops(cfg, shape)
                                      if family == "moe" else 0.0)
        assert total == pytest.approx(want, rel=1e-12), (mesh_shape, total,
                                                         want)
        assert calls == math.prod(mesh_shape) * sum(one.kernel_calls.values())


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_argument_bytes_are_the_local_shards(phase):
    arch, overrides = FAMILIES["dense"]
    cfg = smoke(arch, **overrides)
    shape = PHASES[phase]
    if phase != "train":
        cfg = dryrun.serving_config(cfg, shape)
    cell, c = _trace(cfg, shape, (2, 2), rank=3)
    pl = cell.placement
    specs = dict(tree_leaves(pl.param_specs))
    full = dict(tree_leaves(pl.full_shapes))
    item = cfg.pdtype.itemsize
    params = sum(math.prod(local_shape(full[p], specs[p], pl.mesh,
                                       pl.coords)) for p in specs)
    if phase == "train":
        state, batch = cell.args
        want = params * (item + 4 + 4) + state["opt"]["count"].nbytes \
            + state["step"].nbytes
    else:
        batch = cell.args[1] if phase == "prefill" else {
            "cache": cell.args[1], "tokens": cell.args[2]}
        want = params * item
    rows = shape.global_batch // 2
    for path, t in tree_leaves(batch):
        if path == "cache.pos":
            assert t.dim() == 0
        else:
            assert t.shape[1 if path.startswith("cache.layers") else 0] \
                == rows, path
        want += t.nbytes
    assert c.argument_bytes == want


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_a_run_counts_what_its_trace_counts(phase):
    """Rank 3 of a (2, 4) mesh whose model axis replicates the KV heads (8
    q heads, 2 KV heads): its step run on drawn tensors with the kernel
    routes forced (``ops.interpret``, the card's stand-in on the CPU)
    against its ``meta`` trace."""
    arch, overrides = FAMILIES["dense"]
    cfg = smoke(arch, **overrides, n_heads=8, attn_backend="kernel",
                moa="serial?backend=kernel&chunk=32")
    shape = PHASES[phase]
    if phase != "train":
        cfg = dryrun.serving_config(cfg, shape)
    with fake_world(8, 3):
        mesh = make_mesh((2, 4), device="cpu")
        cell = dryrun.build_cell(cfg, shape, mesh)
        traced = dryrun.trace_step(cell.fn, cell.args, grad=phase == "train")
        assert cell.placement.shard.kv_slice == (1, 2)
        with ops.interpret():
            cell = dryrun.build_cell(cfg, shape, mesh, device="cpu",
                                     generator=torch.Generator()
                                     .manual_seed(0))
            ran = dryrun.trace_step(cell.fn, cell.args,
                                    grad=phase == "train")
    assert ran.kernel_calls == traced.kernel_calls
    assert ran.product_flops == traced.product_flops
    assert ran.flops == traced.flops
    assert ran.argument_bytes == traced.argument_bytes


def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    f32 = dict(generator=g)
    q = torch.randn(2, 3, 4, 16, **f32)
    kp = torch.randn(6, 8, 4, 16, **f32)
    vp = torch.randn(6, 8, 4, 16, **f32)
    tables = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    start = torch.tensor([5, 17], dtype=torch.int32)
    ints = torch.randint(-8, 8, (64, 5), generator=g, dtype=torch.int32)
    return {
        "dot_moa": (ops.dot_moa, (torch.randn(5, 64, **f32).bfloat16(),
                                  torch.randn(64, 7, **f32).bfloat16()),
                    dict(block_k=32)),
        "dot_moa f32 out": (ops.dot_moa, (torch.randn(5, 64, **f32)
                                          .bfloat16(),
                                          torch.randn(64, 7, **f32)
                                          .bfloat16()),
                            dict(out_dtype=torch.float32)),
        "dot_moa int8": (ops.dot_moa, (torch.randint(-9, 9, (5, 64),
                                                     generator=g).to(
            torch.int8), torch.randint(-9, 9, (64, 7), generator=g).to(
            torch.int8)), dict(block_k=16)),
        "dot_moa batched": (ops.dot_moa, (torch.randn(3, 5, 64, **f32),
                                          torch.randn(3, 64, 7, **f32)),
                            dict(block_k=32)),
        "flash": (ops.flash_attention,
                  (torch.randn(2, 24, 4, 16, **f32),
                   torch.randn(2, 24, 2, 16, **f32),
                   torch.randn(2, 24, 2, 16, **f32)), dict(causal=True)),
        "paged": (ops.paged_attention, (q, kp, vp, tables, start), {}),
        "paged head offset": (ops.paged_attention,
                              (q[:, :, :2], kp, vp, tables, start),
                              dict(kv_start=2, kv_count=1)),
        "moa_reduce": (ops.moa_reduce, (torch.randn(40, 6, **f32),),
                       dict(block_n=16)),
        "moa_reduce bf16": (ops.moa_reduce,
                            (torch.randn(40, 6, **f32).bfloat16(),),
                            dict(block_n=16)),
        "moa_reduce int": (ops.moa_reduce, (ints,), dict(block_n=16)),
        "loa_add": (ops.loa_add, (ints[:8], ints[8:16]),
                    dict(approx_bits=3)),
        "loa_reduce": (ops.loa_reduce, (ints,),
                       dict(approx_bits=3, block_n=16)),
    }


def test_meta_routes_take_the_plain_versions_shape_and_price():
    for name, (fn, args, kw) in _kernel_cases().items():
        with ops.recording() as on_cpu:
            want = fn(*args, **kw)
        meta_args = tuple(a.to("meta") for a in args)
        with ops.recording() as on_meta:
            got = fn(*meta_args, **kw)
        assert got.is_meta, name
        assert (tuple(got.shape), got.dtype) == (tuple(want.shape),
                                                 want.dtype), name
        assert on_meta.calls == on_cpu.calls, name
        assert on_meta.flops == on_cpu.flops, name
        assert on_meta.stream_bytes == on_cpu.stream_bytes, name
        # unrecorded too: no plain version runs on meta
        assert fn(*meta_args, **kw).is_meta, name


def test_paged_head_offset_reads_the_pool_in_place():
    """The head-offset read equals attending a copy of those heads, and
    each rank's slice of the KV heads is its q heads' groups."""
    fn, args, _ = _kernel_cases()["paged"]
    q, kp, vp, tables, start = args
    for first, count in ((0, 1), (1, 2), (3, 1), (0, 4)):
        H = 2 * count
        got = ops.paged_attention(q[:, :, :H], kp, vp, tables, start,
                                  kv_start=first, kv_count=count)
        want = ref.paged_attention_ref(
            q[:, :, :H], kp[:, :, first:first + count].contiguous(),
            vp[:, :, first:first + count].contiguous(), tables, start)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    # llama3-8b's 32 q heads on 16 ranks: 2 a rank, a KV head each
    assert [kv_slice(32, 8, 16, r) for r in range(16)] == \
        [(r // 2, r // 2 + 1) for r in range(16)]
    # 8 q heads of 2 KV heads on 4 ranks; 128 of 8 on 16 (llama3-405b)
    assert [kv_slice(8, 2, 4, r) for r in range(4)] == \
        [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert kv_slice(128, 8, 16, 5) == (2, 3)
    assert kv_slice(16, 8, 2, 1) == (4, 8)


def test_refusals_by_name(tmp_path, capsys):
    """mamba2 and zamba2 on the production meshes' split model axis
    (ROADMAP item 21), the variants the port's layers cannot run; the
    CLI writes a record a cell and does not fail on a refusal."""
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        for name in SHAPES:
            for multi in (False, True):
                res = dryrun.run_cell(arch, name, multi_pod=multi)
                assert res["refused"] and "item 21" in res["reason"], \
                    (arch, name)
    for item in dryrun.REFUSED_VARIANTS:
        with pytest.raises(dryrun.Refused, match=item):
            dryrun.apply_variant(registry.get_config("llama3-8b"),
                                 f"remat_dots+{item}")
        res = dryrun.run_cell("llama3-8b", "decode_32k", multi_pod=False,
                              variant=item)
        assert res["refused"] and item in res["reason"]
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun.apply_variant(registry.get_config("llama3-8b"), "tpu_magic")
    dryrun.main(["--arch", "zamba2-1.2b", "--shape", "long_500k",
                 "--mesh", "both", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("REFUSED: ") == 2 and "item 21" in out
    assert sorted(os.listdir(tmp_path)) == [
        "zamba2-1.2b__long_500k__multi.json",
        "zamba2-1.2b__long_500k__single.json"]


def test_decode_cell_on_the_production_mesh(tmp_path, capsys):
    """llama3-8b's ``decode_32k`` rank 0 on 16 × 16 through the CLI: 8
    slots × 32 768 positions × all 8 KV heads of 32 layers (34.4 GB) in
    its arguments, one paged-kernel call a layer reading one KV head, the
    row-parallel sums its collectives, ``cost_analytic`` the reference's
    cell model, the roofline on the H100, the rules' layout. qwen1.5-32b's
    40 q heads do not split over 16: its record says the attention
    replicates."""
    dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    line = capsys.readouterr().out
    assert "llama3-8b__decode_32k__single: ok traced=" in line \
        and "dominant=memory_s" in line and "layout=" not in line
    res = json.load(open(tmp_path / "llama3-8b__decode_32k__single.json"))
    assert res["layout"] == "reference"
    kv = 32 * 8 * 32768 * 8 * 128 * 2 * 2
    assert res["memory"]["alias_bytes"] == kv + 4
    assert res["memory"]["argument_bytes"] > kv
    assert res["cost_traced"]["kernel_calls"] == {"dot_moa": 32 * 7,
                                                  "paged_attention": 32}
    census = res["collectives_census"]
    assert census["count"] == 65 and census["all-reduce"] > 0
    assert census["total_bytes"] == census["all-reduce"]
    cfg = dryrun.serving_config(registry.get_config("llama3-8b"),
                                SHAPES["decode_32k"])
    c = dryrun.analytic_cell(cfg, SHAPES["decode_32k"], multi_pod=False)
    assert res["cost_analytic"]["flops_per_device"] == c.flops
    assert res["roofline"]["spec"] == "h100_sxm"
    assert res["roofline"]["memory_s"] == c.hbm_bytes / 3.35e12
    qwen = dryrun.run_cell("qwen1.5-32b", "decode_32k", multi_pod=False)
    assert qwen["layout"] == "attention_replicated"
    assert dryrun.status_line(qwen).endswith(" layout=attention_replicated")
