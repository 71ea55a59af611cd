"""What the JAX package's dry run computes without compiling a cell, for
``test_torch_dryrun.py`` — run as a script in a process of its own.

``repro/launch/dryrun.py`` asks XLA for 512 host devices when it is
imported, which would change the device count of every test a pytest
worker runs after it; so the test runs this file once, in a subprocess,
and reads one JSON object from its standard output: the production
meshes, ``_model_flops``, ``roofline_terms`` under ``TPU_V5E``,
``apply_variant`` of every item the port accepts, ``Model.input_specs``
and ``estimate_cell`` under the dry run's ``MeshMeta`` for every valid
(arch × shape) cell and both meshes.
"""

import dataclasses
import json
import sys

from repro.launch import dryrun  # noqa: I001  (sets XLA_FLAGS first)

import jax

from repro.configs.base import SHAPES, shape_applicable
from repro.configs.registry import ARCHS, get_config
from repro.core.cost_model import TPU_V5E
from repro.launch import costing
from repro.launch.mesh import MULTI_POD, SINGLE_POD, make_production_mesh
from repro.models.api import build_model

#: variant items the port's dry run accepts, one at a time and combined
VARIANTS = ("gather_ce", "full_attn", "remat_none", "remat_dots", "kv_int8",
            "moa=serial?chunk=512", "moa_chunk=256", "kv_chunk=256",
            "q_chunk=128", "ssd_chunk=128", "capacity=2.0", "fsdp_off",
            "compress_grads", "micro=4", "remat_dots+kv_int8+micro=2")

#: (hlo_flops, hlo_bytes, collective bytes) inputs of the roofline
ROOFLINE = ((1.0e15, 2.0e11, 3.0e9), (4.2e12, 9.9e11, 0.0),
            (7.0e13, 1.0e9, 8.5e10))


def _cfg(arch, shape):
    cfg = get_config(arch)
    if shape.phase != "train":
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    return cfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: [list(tree.shape), str(tree.dtype)]}


def main():
    out = {"single_pod": list(SINGLE_POD), "multi_pod": list(MULTI_POD),
           "meshes": {}, "model_flops": {}, "input_specs": {},
           "estimate_cell": {}, "variants": {}, "roofline": []}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        out["meshes"][str(multi)] = [list(mesh.devices.shape),
                                     list(mesh.axis_names)]
    for arch in sorted(ARCHS):
        for name, shape in SHAPES.items():
            cfg = _cfg(arch, shape)
            if not shape_applicable(cfg, shape)[0]:
                continue
            key = f"{arch}|{name}"
            out["model_flops"][key] = dryrun._model_flops(cfg, shape)
            specs = build_model(cfg).input_specs(shape)
            out["input_specs"][key] = _flat(specs)
            for multi in (False, True):
                meta = costing.MeshMeta(
                    pod=2 if multi else 1, data=16, model=16, fsdp=True,
                    compress_grads=False, attn_cp=cfg.attn_cp,
                    kv_dim_shard=False)
                c = costing.estimate_cell(cfg, shape, meta)
                out["estimate_cell"][f"{key}|{multi}"] = {
                    "flops": c.flops, "hbm_bytes": c.hbm_bytes,
                    "collective_bytes": c.collective_bytes,
                    "components": c.components,
                    "bytes_components": c.bytes_components,
                    "collective_components": c.collective_components}
    for item in VARIANTS:
        for arch in ("llama3-8b", "mamba2-370m"):
            cfg = dryrun.apply_variant(get_config(arch), item)
            out["variants"][f"{arch}|{item}"] = dataclasses.asdict(cfg)
    for f, b, c in ROOFLINE:
        out["roofline"].append(dryrun.roofline_terms(
            hlo_flops=f, hlo_bytes=b, collective_bytes_per_device=c,
            spec=TPU_V5E))
    out["tpu_v5e"] = [TPU_V5E.peak_bf16_flops, TPU_V5E.hbm_bandwidth,
                      TPU_V5E.ici_link_bandwidth]
    out["devices"] = jax.device_count()
    json.dump(out, sys.stdout)


if __name__ == "__main__":
    main()
