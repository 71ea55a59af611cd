"""Fault-tolerant training driver of the port — ``repro/launch/train.py``
on one device.

Wires together: config registry → model → train step (AdamW, optional
int8 gradient compression) → synthetic data pipeline → atomic async
checkpoints in the reference's format → failure injection → restart
supervisor → heartbeats. Runs on the GPU unless ``--device cpu`` is
given; there is no mesh (a mesh other than one device raises: meshed
training is ROADMAP Queue 1 item 18). Every family trains: the encoder on ``frames``,
``mask`` and ``targets``, the VLM on ``patches`` before its text.

  python -m repro_torch.launch.train --arch llama3-8b --layers 4 \
      --steps 10 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --device cpu --steps 50 --batch 8 --seq 128
  ... --ckpt-dir DIR --fail-at 20 --fail-at 35   # two injected node losses
  ... --compress-grads                           # int8 with error feedback
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
from repro_torch.runtime import FailureInjector, HeartbeatMonitor, Supervisor

__all__ = ["TrainLoop", "main"]


class TrainLoop:
    """Reusable in-process trainer on one device (the tests and
    ``chip_smoke.py`` drive it)."""

    def __init__(self, cfg, *, steps: int, global_batch: int, seq_len: int,
                 ckpt_dir: Optional[str] = None, save_every: int = 10,
                 hyper: Optional[steps_lib.TrainHyper] = None,
                 injector: Optional[FailureInjector] = None,
                 mesh_shape=None, seed: int = 0, log_every: int = 10,
                 async_save: bool = True, device="cuda"):
        if mesh_shape is not None and math.prod(mesh_shape) != 1:
            raise NotImplementedError(
                f"mesh {tuple(mesh_shape)}: the port trains on one device; "
                "meshed training (FSDP and TP) is ROADMAP Queue 1, item 18")
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
        self._step_fn = steps_lib.build_train_step(self.model,
                                                   hyper=self.hyper)

    # -- state management ----------------------------------------------------
    def fresh_state(self):
        return steps_lib.init_train_state(self.model, hyper=self.hyper,
                                          seed=self.seed, device=self.device)

    def _template(self) -> dict:
        """The train state's tree, shapes and dtypes as ``meta`` tensors."""
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

    def restore_state(self, step: int):
        state, _ = self.manager.restore(self._template(), step=step,
                                        device=self.device)
        state["params"] = tree_map(steps_lib.trainable, state["params"])
        return state

    def batch(self, step: int) -> dict:
        """The global batch of ``step`` on the loop's device."""
        return {k: v.to(self.device)
                for k, v in self.data.batch_for_step(step).items()}

    # -- loop ----------------------------------------------------------------
    def run_segment(self, start_step: int, state):
        """Run from ``start_step`` to completion (may raise
        SimulatedFailure, once a pending checkpoint save has landed)."""
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
                    print(f"[train] step={step} loss={loss:.4f} "
                          f"gnorm={float(metrics['grad_norm']):.3f} "
                          f"dt={dt*1e3:.0f}ms", flush=True)
                if self.manager and (step + 1) % self.save_every == 0:
                    save = (self.manager.save_async if self.async_save
                            else self.manager.save)
                    save(step, state, metadata={"loss": float(
                        metrics["loss"])})
        finally:
            if self.manager:
                self.manager.wait()
        if self.manager:
            self.manager.save(self.steps - 1, state)
        return state

    def run(self, *, max_restarts: int = 3):
        if self.manager is None:
            return self.run_segment(0, None), None
        sup = Supervisor(self.manager, max_restarts=max_restarts)
        result = sup.run(self.run_segment, restore_fn=self.restore_state)
        return result.final_state, result


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
    args = ap.parse_args(argv)

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
                     device=args.device)
    state, result = loop.run()
    if result is not None:
        print(f"[train] done: restarts={result.restarts} "
              f"completed={result.completed} wall={result.wall_time_s:.1f}s")
    losses = [m["loss"] for m in loop.metrics_history]
    if len(losses) >= 2:
        print(f"[train] loss {losses[0]:.4f} → {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
