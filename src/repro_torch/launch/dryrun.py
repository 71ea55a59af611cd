"""Multi-pod dry run: one rank of every (arch × shape × mesh) cell, traced
on ``meta`` tensors — the port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell's step for 512 placeholder
host devices and reads XLA's memory and cost analyses and the compiled
HLO. The port has no compiler to ask: inside :func:`repro_torch.launch.
mesh.fake_world` (torch's ``fake`` process group of 256 or 512 ranks, in
which this process stands as one) it builds the production mesh, places
the cell's state as the meshed steps place it, and runs **one rank's
step on ``meta`` tensors**: every aten op runs on shapes alone, each
kernel entry point returns an empty output of its shape
(:mod:`repro_torch.kernels.ops`), and each collective returns at once.
Under the cost audit's :class:`~repro_torch.analysis.graph_audit.OpTrace`
and the kernel recorder it counts:

* ``cost_traced`` — the products (``mm`` and kin, ``2·|out|·K``) and the
  kernel calls as the recorder prices them, per entry point; every Python
  loop runs its real trip count (XLA's ``cost_analysis`` counts a loop
  body once, so the reference's ``cost_raw_hlo`` undercounts);
* ``memory`` — the rank's argument, output, aliased (in place), temp and
  peak bytes by the liveness of each storage (a weak reference to it: a
  storage counts from its first op to its release, also where autograd
  holds it);
* ``collectives_census`` — the bytes of each collective the step makes
  (:func:`repro_torch.parallel.collectives.observing`), by the
  reference's names: what its HLO census read from the compiled program
  (:func:`collective_census` has no HLO to read).

Beside it ``cost_analytic`` is :func:`repro_torch.launch.costing.
estimate_cell` under the reference's ``MeshMeta``, and the roofline
prices it on an H100 (:data:`H100_SXM`).

The cells: training runs :func:`repro_torch.launch.steps.build_train_step`
on the mesh (FSDP over the data axes, ``fsdp_off`` and ``micro=``
honoured); prefill and decode run the meshed steps on bf16 weights, as
the reference serves. The recurrent families (mamba2, zamba2) are refused
on a split model axis: tensor parallelism of the SSD layer is ROADMAP
Queue 1 item 21. So are the variants the port's layers cannot run
(:data:`REFUSED_VARIANTS`).

MoE routing is counted per rank: each rank routes its own rows of the
batch, so its capacity groups hold its tokens alone and an expert's
capacity is ``capacity_factor · top_k / n_experts`` of a group's tokens,
as on one device; the global batch's capacity is the data ranks' sum.

Usage (no card needed)::

  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/torch_dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.cost_audit import Liveness, product_flops, \
    storage_key
from repro_torch.analysis.graph_audit import OpTrace, _tensors
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, \
    shape_applicable
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.interop import tree_map_with_keys
from repro_torch.kernels import ops
from repro_torch.launch import costing
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD, fake_world,
                                     make_production_mesh)
from repro_torch.models.api import build_model
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import DEFAULT_RULES, local_shape

__all__ = ["run_cell", "build_cell", "trace_step", "collective_census",
           "roofline_terms", "apply_variant", "ChipSpec", "H100_SXM", "Refused",
           "REFUSED_VARIANTS", "TraceCount", "analytic_cell",
           "serving_config", "cell_record", "status_line", "MetaMemo"]

_COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute")


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """A device's peak rates for the roofline (the reference's
    ``TPUSpec`` fields that :func:`roofline_terms` reads):
    ``ici_link_bandwidth`` is the bytes a second, one direction, of the
    link a collective crosses."""

    name: str
    peak_bf16_flops: float
    hbm_bandwidth: float
    ici_link_bandwidth: float


# H100 SXM (NVIDIA's datasheet): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3.
# NVLink 4 runs at 900 GB/s both directions (450 GB/s one way) among the 8
# cards of a node; across nodes one 400 Gb/s NDR InfiniBand port a card
# gives 50 GB/s one way. An axis of 16 cards spans two nodes, so its ring
# runs at the network's rate: every axis of the production meshes does.
#: an H100 whose collectives cross nodes (every production axis of 16)
H100_SXM = ChipSpec("h100_sxm", 989e12, 3.35e12, 50e9)


def collective_census(observed) -> Dict[str, float]:
    """Per-device collective buffer bytes by the reference's op names
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``, ``count``, ``total_bytes``) from the
    ``(kind, axis, nbytes)`` calls one rank's step made
    (:func:`repro_torch.parallel.collectives.observing`). The reference
    parses the compiled HLO; the port has none, and its step makes each
    collective itself, so the observer's record is the census."""
    census = {op: 0.0 for op in _COLLECTIVE_OPS}
    census["count"] = 0
    for kind, _, nbytes in observed:
        census[collectives.CENSUS_KIND[kind]] += nbytes
        census["count"] += 1
    census["total_bytes"] = sum(census[o] for o in _COLLECTIVE_OPS)
    return census


def roofline_terms(*, hlo_flops: float, hlo_bytes: float,
                   collective_bytes_per_device: float,
                   spec: ChipSpec = H100_SXM) -> Dict[str, float]:
    """The three roofline terms (seconds) of a cell's per-device cost on
    ``spec``, the dominant one and its bound (the reference's)."""
    compute_s = hlo_flops / spec.peak_bf16_flops
    memory_s = hlo_bytes / spec.hbm_bandwidth
    collective_s = collective_bytes_per_device / spec.ici_link_bandwidth
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    terms["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                            key=lambda k: terms[k])
    terms["bound_s"] = terms[terms["dominant"]]
    return terms


def _model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6·N·D for training, 2·N·D for prefill, 2·N a sequence for a decode
    step (N the active parameters)."""
    n = cfg.active_param_count()
    if shape.phase == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.phase == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


class Refused(ValueError):
    """A cell or variant the port's layers cannot run, by name."""


#: variant items the reference's dry run takes and the port's layers do
#: not run, each with its reason (ROADMAP Queue 1 item 14)
REFUSED_VARIANTS = {
    "attn_cp": "context-parallel attention (a layout all-to-all over model "
               "around each attention) has no port",
    "kv_dim_shard": "a cache split over head_dim needs attention over split "
                    "head dims, which the port's layers do not run",
    "seq_shard": "a residual split over the sequence (Megatron-SP) has no "
                 "port: the port's layers run the whole sequence a rank",
}


def apply_variant(cfg: ModelConfig, variant: str) -> ModelConfig:
    """The reference's hill-climb levers (``docs/architecture.md``):
    ``+``-joined items, each a config field or a step option
    (``fsdp_off``, ``compress_grads``, ``micro=N``, read by
    :func:`run_cell`). The items of :data:`REFUSED_VARIANTS` raise
    :class:`Refused`; an unknown item ``ValueError``."""
    if variant == "baseline" or not variant:
        return cfg
    updates: dict = {}
    for item in variant.split("+"):
        if item == "gather_ce":
            updates["loss_impl"] = "gather"
        elif item == "full_attn":
            updates["attn_impl"] = "full"
        elif item == "remat_none":
            updates["remat"] = "none"
        elif item == "remat_dots":
            updates["remat"] = "dots"
        elif item == "kv_int8":
            updates["kv_cache_dtype"] = "int8"
        elif item in REFUSED_VARIANTS:
            raise Refused(f"variant {item!r}: {REFUSED_VARIANTS[item]} "
                          "(ROADMAP Queue 1 item 14)")
        elif item.startswith("moa="):
            updates["moa"] = item.split("=", 1)[1]
        elif item.startswith("moa_chunk="):
            updates["moa"] = f"serial?chunk={int(item.split('=')[1])}"
        elif item.startswith("kv_chunk="):
            updates["kv_chunk"] = int(item.split("=")[1])
        elif item.startswith("q_chunk="):
            updates["q_chunk"] = int(item.split("=")[1])
        elif item.startswith("ssd_chunk="):
            updates["ssd_chunk"] = int(item.split("=")[1])
        elif item.startswith("capacity="):
            updates["capacity_factor"] = float(item.split("=")[1])
        elif item in ("fsdp_off", "compress_grads") \
                or item.startswith("micro="):
            pass  # step options, read by run_cell
        else:
            raise ValueError(f"unknown variant item {item!r}")
    return dataclasses.replace(cfg, **updates)


# ---------------------------------------------------------------------------
# one rank's step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """One rank's step of a cell: ``fn(*args)`` runs it."""

    cfg: ModelConfig
    shape: ShapeSpec
    placement: object
    fn: Callable
    args: tuple
    fsdp: bool
    compress_grads: bool


def _local(tree, specs, placement, device, fill: Optional[Callable] = None):
    """Each leaf of ``tree`` (full-size stand-ins) as this rank's piece
    under ``specs`` (the whole leaf without a ``placement``): zeros on
    ``device`` (on ``meta`` no memory), or the piece ``fill(shape,
    dtype)`` makes there."""
    def one(keys, leaf):
        shape = tuple(leaf.shape)
        if placement is not None:
            spec = specs
            for k in keys:
                spec = spec[k]
            shape = local_shape(shape, spec, placement.mesh,
                                placement.coords)
        if torch.device(device).type == "meta" or fill is None:
            return torch.zeros(shape, dtype=leaf.dtype, device=device)
        return fill(shape, leaf.dtype)

    return tree_map_with_keys(one, tree)


def _variant_options(variant: str, fsdp: bool, compress_grads: bool):
    items = variant.split("+") if variant else []
    micro = 1
    for item in items:
        if item.startswith("micro="):
            micro = int(item.split("=")[1])
    return ("fsdp_off" not in items and fsdp,
            "compress_grads" in items or compress_grads, micro)


def serving_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Serving runs on bf16 weights (f32 masters are a training artifact),
    as the reference's dry run serves."""
    if shape.phase != "train":
        return dataclasses.replace(cfg, param_dtype="bfloat16")
    return cfg


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               variant: str = "baseline", fsdp: bool = True,
               compress_grads: bool = False, device="meta",
               generator: Optional[torch.Generator] = None) -> Cell:
    """This rank's step of ``cfg`` at ``shape`` on ``mesh`` (a
    ``DeviceMesh`` of the initialized group, e.g. :func:`fake_world`'s;
    ``None``: the one-device step), with its arguments on ``device``:
    ``meta`` stand-ins, or on a card the parameters drawn whole from
    ``generator`` at full depth and cut to the rank's pieces, a batch
    drawn at the rank's rows, a decode cache of zeros whose cursor is at
    its last position. ``cfg`` is the cell's (:func:`serving_config`
    applied for prefill and decode)."""
    fsdp, compress_grads, micro = _variant_options(variant, fsdp,
                                                   compress_grads)
    meta = torch.device(device).type == "meta"
    model = build_model(cfg)
    rules = None if mesh is None else steps_lib.rules_for(
        cfg, shape, mesh, DEFAULT_RULES)
    specs = model.input_specs(shape)
    if shape.phase == "train":
        hyper = steps_lib.TrainHyper(compress_grads=compress_grads,
                                     microbatches=micro)
        step = steps_lib.build_train_step(model, hyper=hyper, mesh=mesh,
                                          rules=rules, fsdp=fsdp)
        pl = step.placement
        gen = generator if generator is not None else torch.Generator()
        state = steps_lib.init_train_state(model, gen, hyper=hyper,
                                           device=device, placement=pl)
        batch = _batch(model, shape, specs, pl, device, generator)
        return Cell(cfg, shape, pl, step, (state, batch), fsdp,
                    compress_grads)
    build = steps_lib.build_prefill_step if shape.phase == "prefill" \
        else steps_lib.build_decode_step
    kw = dict(max_len=shape.seq_len) if shape.phase == "prefill" else {}
    step = build(model, mesh=mesh, rules=rules, **kw)
    pl = step.placement
    if meta:
        params = _local(model.abstract_params(),
                        None if pl is None else pl.param_specs, pl, device)
    else:
        params = build_model(cfg).init(generator, device=device)
        if pl is not None:
            params = pl.local_params(params, device)
    if shape.phase == "prefill":
        batch = _batch(model, shape, specs, pl, device, generator)
        return Cell(cfg, shape, pl, step, (params, batch), False, False)
    cache_specs = tok_specs = None
    if pl is not None:
        cache_specs = steps_lib.cache_specs({"cache": specs["cache"]}, mesh,
                                            pl.rules)["cache"]
        tok_specs = steps_lib.batch_specs({"tokens": specs["tokens"]}, mesh,
                                          pl.rules)
    cache = _local(specs["cache"], cache_specs, pl, device)
    if not meta:
        cache["pos"].fill_(shape.seq_len - 1)
    tokens = _local({"tokens": specs["tokens"]}, tok_specs, pl, device,
                    fill=lambda shape, dtype: torch.randint(
                        0, cfg.vocab, shape, dtype=dtype,
                        generator=generator, device=device))["tokens"]
    return Cell(cfg, shape, pl, step, (params, cache, tokens), False, False)


def _batch(model, shape, specs, pl, device, generator):
    """This rank's rows of the cell's batch: ``meta`` stand-ins, or drawn
    from ``generator`` at the rank's row count."""
    bspecs = None if pl is None else steps_lib.batch_specs(specs, pl.mesh,
                                                           pl.rules)
    local = _local(specs, bspecs, pl, "meta")
    if torch.device(device).type == "meta":
        return local
    rows = next(iter(local.values())).shape[0]
    return model.make_batch(generator, shape, batch_override=rows)


@dataclasses.dataclass
class TraceCount:
    """What one traced run of a step counted (module docstring)."""

    product_flops: float = 0.0
    kernel_flops: float = 0.0
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_operand_bytes: float = 0.0
    ops: int = 0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    alias_bytes: float = 0.0
    peak_bytes: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)

    @property
    def flops(self) -> float:
        return self.product_flops + self.kernel_flops

    @property
    def temp_bytes(self) -> float:
        return self.peak_bytes - self.argument_bytes


def _signature(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_signature(i) for i in x)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    return x


class MetaMemo(TorchDispatchMode):
    """Runs each functional aten op (no argument or result aliased or
    mutated, one tensor out) on ``meta`` tensors once per signature (the
    op, its tensors' shapes, strides, dtypes and devices, its other
    arguments) and afterwards returns an empty tensor of the shape,
    strides and dtype that run gave: the same result, without re-running
    the op's Python shape rules (elementwise ops on ``meta`` take ~0.3 ms
    each in them, and the train path's chunk loops repeat a few hundred
    signatures some 10⁵ times)."""

    def __init__(self):
        super().__init__()
        self.functional: Dict[object, bool] = {}
        self.results: Dict[tuple, tuple] = {}

    @staticmethod
    def _is_functional(func) -> bool:
        s = func._schema
        return (not s.is_mutable and len(s.returns) == 1
                and s.returns[0].alias_info is None
                and str(s.returns[0].type) == "Tensor"
                and all(a.alias_info is None for a in s.arguments))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ok = self.functional.get(func)
        if ok is None:
            ok = self.functional[func] = self._is_functional(func)
        key = None
        if ok:
            try:
                key = (func, _signature(args), _signature(kwargs))
                hit = self.results.get(key)
            except TypeError:           # an unhashable argument
                key = hit = None
            if hit is not None:
                return torch.empty_strided(hit[0], hit[1], dtype=hit[2],
                                           device="meta")
        out = func(*args, **kwargs)
        if key is not None and isinstance(out, torch.Tensor) and out.is_meta:
            self.results[key] = (tuple(out.shape), out.stride(), out.dtype)
        return out


def trace_step(fn: Callable, args: tuple, *, grad: bool = False,
               memory: bool = True) -> TraceCount:
    """Run ``fn(*args)`` once under an :class:`~repro_torch.analysis.
    graph_audit.OpTrace`, the kernel recorder and a collective observer,
    and count it (:class:`TraceCount`); ``grad``: with autograd on (a
    train step), else under ``torch.no_grad()``. On ``meta`` arguments
    it runs no arithmetic; on a card it runs the step for real and counts
    the same. ``memory=False`` leaves the liveness out (a card run reads
    its allocator instead): the byte counts stay 0."""
    count = TraceCount()
    live = Liveness()
    arg_tensors = _tensors(args)
    arg_keys = {}
    for t in arg_tensors:
        arg_keys[storage_key(t)] = t.untyped_storage().nbytes()
        if memory:
            live.hold(t)
    if memory:
        count.argument_bytes = float(sum(arg_keys.values()))

    def on_op(name, a, kw, result):
        count.ops += 1
        if memory:
            for t in _tensors(result):
                live.hold(t)
        count.product_flops += product_flops(name, a, result)

    def on_collective(kind, axis, nbytes):
        count.collectives.append((kind, axis, nbytes))

    rec = ops.KernelRecorder()
    with contextlib.ExitStack() as stack:
        if any(t.is_meta for t in arg_tensors):
            stack.enter_context(MetaMemo())     # below the trace's mode
        stack.enter_context(collectives.observing(on_collective))
        if not grad:
            stack.enter_context(torch.no_grad())
        stack.enter_context(ops.recording(rec))
        stack.enter_context(OpTrace(on_op, rec))
        out = fn(*args)
    outs = {}
    for t in _tensors(out) if memory else ():
        outs[storage_key(t)] = t.untyped_storage().nbytes()
    count.output_bytes = float(sum(n for k, n in outs.items()
                                   if k not in arg_keys))
    count.alias_bytes = float(sum(n for k, n in outs.items()
                                  if k in arg_keys))
    count.peak_bytes = float(live.peak)
    count.kernel_calls = {k: v for k, v in rec.calls.items() if v}
    count.kernel_flops = rec.total_flops()
    count.kernel_operand_bytes = rec.stream_bytes
    return count


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------


def mesh_name(multi_pod: bool) -> str:
    return "multi_pod_2x16x16" if multi_pod else "single_pod_16x16"


def _refusal(cfg: ModelConfig, mesh_shape) -> Optional[str]:
    if cfg.family in ("ssm", "hybrid") and mesh_shape[-1] > 1:
        return (f"the {cfg.family} family on a model axis of "
                f"{mesh_shape[-1]}: tensor parallelism of the SSD layer "
                "(ssm_heads, ssm_inner over model) is ROADMAP Queue 1 "
                "item 21")
    return None


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             variant: str = "baseline", fsdp: bool = True,
             compress_grads: bool = False, rank: int = 0) -> dict:
    """Trace rank ``rank`` of one cell on ``meta`` tensors (module
    docstring) → its JSON record: the reference's keys where the meaning
    carries over (``skipped`` with ``reason`` for a cell the assignment
    skips; ``refused`` with ``reason`` for one the port refuses)."""
    shape = SHAPES[shape_name]
    base = {"arch": arch, "shape": shape_name, "phase": shape.phase,
            "mesh": mesh_name(multi_pod), "variant": variant}
    try:
        cfg = serving_config(apply_variant(get_config(arch), variant), shape)
    except Refused as e:
        return dict(base, skipped=False, refused=True, reason=str(e))
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": why}
    mesh_shape = MULTI_POD if multi_pod else SINGLE_POD
    why = _refusal(cfg, mesh_shape)
    if why:
        return dict(base, skipped=False, refused=True, reason=why)
    n_chips = math.prod(mesh_shape)
    t0 = time.monotonic()
    with fake_world(n_chips, rank):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        cell = build_cell(cfg, shape, mesh, variant=variant, fsdp=fsdp,
                          compress_grads=compress_grads)
        count = trace_step(cell.fn, cell.args,
                           grad=shape.phase == "train")
    trace_s = time.monotonic() - t0
    return cell_record(cell, count, arch=arch, variant=variant,
                       multi_pod=multi_pod, rank=rank, trace_s=trace_s)


def analytic_cell(cfg: ModelConfig, shape: ShapeSpec, *, multi_pod: bool,
                  fsdp: bool = True, compress_grads: bool = False):
    """:func:`repro_torch.launch.costing.estimate_cell` of the cell under
    the reference's dry-run ``MeshMeta`` (``dryrun.py:266-269``)."""
    mesh_meta = costing.MeshMeta(
        pod=2 if multi_pod else 1, data=16, model=16, fsdp=fsdp,
        compress_grads=compress_grads, attn_cp=cfg.attn_cp,
        kv_dim_shard=False)
    return costing.estimate_cell(cfg, shape, mesh_meta)


def cell_record(cell: Cell, count: TraceCount, *, arch: str, variant: str,
                multi_pod: bool, rank: int, trace_s: float) -> dict:
    """The JSON record of a traced cell."""
    cfg, shape = cell.cfg, cell.shape
    mesh_shape = MULTI_POD if multi_pod else SINGLE_POD
    n_chips = math.prod(mesh_shape)
    analytic = analytic_cell(cfg, shape, multi_pod=multi_pod,
                             fsdp=cell.fsdp,
                             compress_grads=cell.compress_grads)
    terms = roofline_terms(hlo_flops=analytic.flops,
                           hlo_bytes=analytic.hbm_bytes,
                           collective_bytes_per_device=(
                               analytic.collective_bytes), spec=H100_SXM)
    mflops = _model_flops(cfg, shape)
    return {
        "arch": arch,
        "shape": shape.name,
        "phase": shape.phase,
        "mesh": mesh_name(multi_pod),
        "n_chips": n_chips,
        "rank": rank,
        "variant": variant,
        "fsdp": cell.fsdp,
        # "attention_replicated": the model axis does not divide the q
        # heads, so the rank runs the whole attention, where the reference
        # splits its flattened projections mid-head
        "layout": ("attention_replicated" if cell.placement is not None
                   and cell.placement.attention_replicated else "reference"),
        "skipped": False,
        "refused": False,
        "trace_s": trace_s,
        "memory": {
            "argument_bytes": count.argument_bytes,
            "output_bytes": count.output_bytes,
            "alias_bytes": count.alias_bytes,
            "temp_bytes": count.temp_bytes,
            "peak_bytes": count.peak_bytes,
        },
        "cost_traced": {
            # every loop at its real trip count; products and kernel calls
            "flops_per_device": count.flops,
            "product_flops": count.product_flops,
            "kernel_flops": count.kernel_flops,
            "kernel_calls": dict(count.kernel_calls),
            "kernel_operand_bytes": count.kernel_operand_bytes,
            "ops": count.ops,
        },
        "cost_analytic": {
            "flops_per_device": analytic.flops,
            "hbm_bytes_per_device": analytic.hbm_bytes,
            "collective_bytes_per_device": analytic.collective_bytes,
            "flops_components_global": analytic.components,
            "bytes_components": analytic.bytes_components,
            "collective_components": analytic.collective_components,
        },
        "collectives_census": collective_census(count.collectives),
        "roofline": dict(terms, spec=H100_SXM.name),
        "model_flops_total": mflops,
        "model_flops_per_chip": mflops / n_chips,
        "useful_compute_ratio": (mflops / n_chips / analytic.flops
                                 if analytic.flops else None),
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }


def status_line(res: dict) -> str:
    """One cell's status: ``ok …``, ``REFUSED: …``, ``SKIP: …`` or
    ``ERROR: …``."""
    if res.get("skipped"):
        return "SKIP: " + res["reason"]
    if "error" in res:
        return "ERROR: " + res["error"][:160]
    if res.get("refused"):
        return "REFUSED: " + res["reason"]
    line = (f"ok traced={res['trace_s']:.2f}s "
            f"dominant={res['roofline']['dominant']} "
            f"bound={res['roofline']['bound_s']:.4f}s")
    if res["layout"] != "reference":
        line += f" layout={res['layout']}"
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Trace one rank of each (arch × shape × mesh) cell on "
                    "meta tensors over a fake process group; no card.")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="every valid (arch, shape) cell")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="artifacts/torch_dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [(arch, s) for arch in sorted(ARCHS) for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch, shape_name in cells:
        for multi_pod in meshes:
            tag = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
            if args.variant != "baseline":
                tag += f"__{args.variant.replace('=', '-').replace('+', '_')}"
            try:
                res = run_cell(arch, shape_name, multi_pod=multi_pod,
                               variant=args.variant)
            except Exception as e:   # a failed cell is a bug: surface it
                res = {"arch": arch, "shape": shape_name,
                       "mesh": "multi" if multi_pod else "single",
                       "error": f"{type(e).__name__}: {e}", "skipped": False}
                failures += 1
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
            print(f"[dryrun] {tag}: {status_line(res)}", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
