"""Fault-tolerant trainer of the port — ``repro/launch/train.py``.

Wires together: config registry → model → train step (AdamW, optional
int8 gradient compression) → synthetic data pipeline → atomic async
checkpoints in the reference's format → failure injection → restart
supervisor → heartbeats. Runs on the GPU unless ``--device cpu`` is
given. Every family trains: the encoder on ``frames``, ``mask`` and
``targets``, the VLM on ``patches`` before its text.

On a device mesh (``TrainLoop(mesh_shape=(data, model))`` inside each rank
of :func:`repro_torch.launch.mesh.run_ranks`; the CLI's ``--mesh DxM``,
which starts the ranks, standing for the reference's mesh of the devices
it sees) each rank trains its shards (:func:`repro_torch.launch.steps.
build_train_step` with ``mesh=``): FSDP over ``data``, tensor and expert
parallelism over ``model``, the recurrent families on ``(data, 1)`` only.
Every rank builds the same global batch from ``(seed, step)`` and takes its
rows; the metrics are the global batch's, printed by the lead rank;
checkpoints are the one-device run's files. A restart re-plans the mesh for
the ranks that remain (those a failure did not take,
``FailureInjector(lose=)``) and restores the newest checkpoint's slices
onto it (:meth:`TrainLoop.restore_state`).

  python -m repro_torch.launch.train --arch llama3-8b --layers 4 \
      --steps 10 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --device cpu --steps 50 --batch 8 --seq 128
  ... --ckpt-dir DIR --fail-at 20 --fail-at 35   # two injected node losses
  ... --compress-grads                           # int8 with error feedback
  ... --mesh 1x2 [--dist-backend gloo]           # two ranks, TP over model
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
      --smoke --device cpu --steps 20 --batch 4 --seq 32
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.interop import tree_map
from repro_torch.launch import steps as steps_lib
from repro_torch.models.api import build_model
from repro_torch.runtime import (FailureInjector, HeartbeatMonitor,
                                 Supervisor, plan_mesh_shape)

__all__ = ["TrainLoop", "main"]


class TrainLoop:
    """Reusable in-process trainer (the tests and ``chip_smoke.py`` drive
    it): one device, or one rank of a mesh (``mesh_shape``, inside a rank
    of :func:`~repro_torch.launch.mesh.run_ranks`; FSDP over ``data``
    under ``DEFAULT_RULES``, :func:`~repro_torch.launch.steps.
    build_train_step`). A mesh of one device outside a process group is
    one device."""

    def __init__(self, cfg, *, steps: int, global_batch: int, seq_len: int,
                 ckpt_dir: Optional[str] = None, save_every: int = 10,
                 hyper: Optional[steps_lib.TrainHyper] = None,
                 injector: Optional[FailureInjector] = None,
                 mesh_shape=None, seed: int = 0, log_every: int = 10,
                 async_save: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.steps = steps
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.save_every = save_every
        self.log_every = log_every
        self.async_save = async_save
        self.hyper = hyper or steps_lib.TrainHyper(
            warmup_steps=max(steps // 10, 1), total_steps=steps)
        self.injector = injector or FailureInjector()
        self.monitor = HeartbeatMonitor(n_workers=1)
        self.manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.seed = seed
        self.model = build_model(cfg)
        self.data = SyntheticLMData(
            vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
            seed=seed, family="encoder" if cfg.family == "encoder" else "lm",
            d_model=cfg.d_model, n_patches=cfg.n_patches)
        self.metrics_history: list = []
        if mesh_shape is not None and math.prod(mesh_shape) == 1 \
                and not torch.distributed.is_initialized():
            mesh_shape = None
        self._plan(None if mesh_shape is None else tuple(mesh_shape))

    def _plan(self, shape, ranks=None) -> None:
        """The mesh of ``shape`` over ``ranks`` (default: every rank of
        the process group) and this rank's step on it; ``None``: one
        device. A rank outside ``ranks`` keeps no step (``departed``)."""
        from repro_torch.launch.mesh import make_mesh

        self.mesh_shape, self.mesh, self.placement = shape, None, None
        self.lead, self.departed = True, False
        if shape is not None:
            world = torch.distributed.get_world_size() \
                if torch.distributed.is_initialized() else 1
            self.ranks = list(range(world)) if ranks is None else list(ranks)
            self.mesh = make_mesh(shape, device=self.device.type,
                                  ranks=ranks)
            if self.mesh.get_coordinate() is None:
                self.departed, self._step_fn = True, None
                return
        self._step_fn = steps_lib.build_train_step(
            self.model, hyper=self.hyper, mesh=self.mesh)
        self.placement = self._step_fn.placement
        if self.placement is not None:
            self.lead = self.placement.lead
            D = steps_lib.data_layout(self.placement)[1]
            if self.global_batch % D:
                raise ValueError(
                    f"a global batch of {self.global_batch} rows does not "
                    f"split over a data axis of {D}: each data rank takes "
                    "an equal share of the rows")

    # -- state management ----------------------------------------------------
    def fresh_state(self):
        return steps_lib.init_train_state(
            self.model, hyper=self.hyper, seed=self.seed, device=self.device,
            placement=self.placement)

    def _template(self) -> dict:
        """The train state's tree, whole shapes and dtypes as ``meta``
        tensors."""
        params = self.model.abstract_params()
        f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,
                                    device="meta")
        scalar = torch.empty((), dtype=torch.int32, device="meta")
        out = {"params": params,
               "opt": {"m": tree_map(f32, params), "v": tree_map(f32, params),
                       "count": scalar},
               "step": scalar}
        if self.hyper.compress_grads:
            out["err"] = tree_map(f32, params)
        return out

    def state_specs(self) -> Optional[dict]:
        """The train state's specs on this rank's mesh (``None`` off a
        mesh)."""
        if self.placement is None:
            return None
        return steps_lib.state_specs(self._template(), self.placement)

    def replan(self) -> None:
        """On a mesh, the elastic re-plan: a mesh for the ranks that remain
        (:func:`~repro_torch.runtime.plan_mesh_shape`, keeping the model
        axis where they allow it), if it differs from this one."""
        if self.mesh is None:
            return
        remain = [r for r in self.ranks if r not in self.injector.lost]
        if remain == self.ranks:
            return
        if not remain:
            raise RuntimeError("no rank of the mesh remains")
        shape = plan_mesh_shape(len(remain),
                                model_parallel=self.mesh_shape[-1])
        if self.lead:
            print(f"[train] re-plan: {len(remain)} of {len(self.ranks)} "
                  f"ranks remain, mesh {self.mesh_shape} -> {shape}",
                  flush=True)
        self._plan(shape, remain)

    def restore_state(self, step: int):
        """The checkpoint of ``step`` as this rank's state, on the mesh the
        re-plan gives (:meth:`replan`; each rank reads its slices), or on
        one device; ``None`` on a rank that no longer takes part."""
        self.replan()
        if self.departed:
            return None
        state, _ = self.manager.restore(self._template(), step=step,
                                        device=self.device, mesh=self.mesh,
                                        specs=self.state_specs())
        state["params"] = tree_map(steps_lib.trainable, state["params"])
        return state

    def batch(self, step: int) -> dict:
        """The global batch of ``step`` on the loop's device (on a mesh,
        this rank's rows of it)."""
        batch = self.data.batch_for_step(step)
        if self.placement is not None:
            batch = steps_lib.local_batch(batch, self.placement)
        return {k: v.to(self.device) for k, v in batch.items()}

    def _wait(self) -> None:
        """The pending checkpoint landed, on every rank of the mesh: the
        lead's write joined, then a sum over both axes, so no rank reads
        the directory before it has its newest step."""
        self.manager.wait()
        if self.mesh is not None:
            from repro_torch.parallel import collectives

            flag = torch.zeros(1, device=self.device)
            for axis in self.mesh.mesh_dim_names:
                if self.placement.sizes[axis] > 1:
                    collectives.all_reduce(flag, self.mesh.get_group(axis))

    def _save(self, step: int, state, metadata=None, *, wait: bool) -> None:
        save = self.manager.save if wait else self.manager.save_async
        save(step, state, metadata=metadata, mesh=self.mesh,
             specs=self.state_specs())

    # -- loop ----------------------------------------------------------------
    def run_segment(self, start_step: int, state):
        """Run from ``start_step`` to completion (may raise
        SimulatedFailure, once a pending checkpoint save has landed). A
        rank that no longer takes part returns ``None`` at once."""
        if self.departed:
            return None
        if state is None:
            state = self.fresh_state()
        try:
            for step in range(start_step, self.steps):
                t0 = time.monotonic()
                state, metrics = self._step_fn(state, self.batch(step))
                # failure window: after compute, before checkpoint — the
                # hardest point to get restart-exactness right
                self.injector.maybe_fail(step)
                dt = time.monotonic() - t0
                self.monitor.beat(0, step, dt)
                if step % self.log_every == 0 or step == self.steps - 1:
                    loss = float(metrics["loss"])
                    self.metrics_history.append(
                        {"step": step, "loss": loss, "dt": dt})
                    if self.lead:
                        print(f"[train] step={step} loss={loss:.4f} "
                              f"gnorm={float(metrics['grad_norm']):.3f} "
                              f"dt={dt*1e3:.0f}ms", flush=True)
                if self.manager and (step + 1) % self.save_every == 0:
                    self._save(step, state, {"loss": float(metrics["loss"])},
                               wait=not self.async_save)
        finally:
            if self.manager:
                self._wait()
        if self.manager:
            self._save(self.steps - 1, state, wait=True)
            self._wait()
        return state

    def run(self, *, max_restarts: int = 3):
        if self.manager is None:
            return self.run_segment(0, None), None
        sup = Supervisor(self.manager, max_restarts=max_restarts)
        result = sup.run(self.run_segment, restore_fn=self.restore_state)
        return result.final_state, result


def _train(args, mesh_shape=None) -> None:
    """The CLI's run: one device, or (``mesh_shape``) this rank's part of
    the mesh, whose lead rank prints."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    hyper = steps_lib.TrainHyper(
        peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps, compress_grads=args.compress_grads)
    loop = TrainLoop(cfg, steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                     save_every=args.save_every, hyper=hyper,
                     injector=FailureInjector(args.fail_at), seed=args.seed,
                     device=args.device, mesh_shape=mesh_shape)
    if loop.placement is not None and loop.lead:
        p = loop.placement
        split = [k for k in ("heads", "ff", "experts", "vocab")
                 if getattr(p.shard, k)]
        print(f"[train] mesh: (data={p.sizes['data']}, "
              f"model={p.sizes['model']}) over {math.prod(mesh_shape)} "
              f"ranks ({torch.distributed.get_backend()}; FSDP over data, "
              f"split over model: {', '.join(split) or 'nothing'})",
              flush=True)
    state, result = loop.run()
    if not loop.lead:
        return
    if result is not None:
        print(f"[train] done: restarts={result.restarts} "
              f"completed={result.completed} wall={result.wall_time_s:.1f}s")
    losses = [m["loss"] for m in loop.metrics_history]
    if len(losses) >= 2:
        print(f"[train] loss {losses[0]:.4f} → {losses[-1]:.4f}")


def _mesh_rank(rank: int, args, shape) -> None:
    _train(args, mesh_shape=shape)


def _run_mesh(args) -> None:
    """``--mesh``: check the request, then run every rank (a rank's
    failure fails the run)."""
    from repro_torch.launch.mesh import parse_mesh, run_ranks

    try:
        shape = parse_mesh(args.mesh)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}")
    if len(shape) != 2:
        raise SystemExit(f"--mesh {args.mesh}: the trainer takes DATAxMODEL")
    device = resolve_device(args.device)
    backend = args.dist_backend \
        or ("nccl" if device.type == "cuda" else "gloo")
    n = math.prod(shape)
    if device.type == "cpu" and backend != "gloo":
        raise SystemExit(f"--dist-backend {backend} needs the GPU; a CPU "
                         "mesh runs over gloo")
    if device.type == "cuda" and backend == "nccl" \
            and n > torch.cuda.device_count():
        raise SystemExit(
            f"--mesh {args.mesh} needs {n} ranks and this machine has "
            f"{torch.cuda.device_count()} GPU(s): NCCL refuses two ranks on "
            "one card; pass --dist-backend gloo to share cards")
    run_ranks(shape, _mesh_rank, args, shape, backend=backend,
              threads=1 if device.type == "cpu" else 0,
              join_timeout_s=24 * 3600.0)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a registry arch with the port's trainer")
    ap.add_argument("--arch", required=True,
                    help="a registry arch of any family (dense, moe, ssm, "
                         "hybrid, encoder, vlm)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override n_layers (depth only; 0 = the config's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; the CPU "
                         "runs the plain PyTorch versions of the kernels)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128,
                    help="positions a sequence (a VLM's patch prefix "
                         "included; the encoder's frames)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, action="append", default=[])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="",
                    help="train on a DATAxMODEL device mesh, one rank a "
                         "device: FSDP over data; heads, ff, experts and "
                         "vocab over model (the recurrent families: data "
                         "only)")
    ap.add_argument("--dist-backend", default="", choices=("", "nccl",
                                                           "gloo"),
                    help="[--mesh] process-group backend (default: nccl on "
                         "the GPU, gloo on the CPU; gloo lets ranks share "
                         "a card)")
    args = ap.parse_args(argv)
    if args.mesh:
        _run_mesh(args)
    else:
        _train(args)


if __name__ == "__main__":
    main()
