"""Device meshes and the ranks that hold them — the port of
``repro/launch/mesh.py`` onto ``torch.distributed``.

Axis use (the reference's): ``pod`` — outer data parallelism; ``data`` —
data parallelism (serving: slots); ``model`` — tensor / expert
parallelism.

Where the reference asks XLA for host devices before JAX starts
(``ensure_host_devices``), a PyTorch mesh needs one process a device:
:func:`run_ranks` starts ``prod(shape)`` ranks (``torch.multiprocessing``,
spawn), joins them in a process group over a TCP rendezvous on localhost
and runs a function on each. Every rank's process group has a short,
explicit timeout, and the launcher has one for the whole run, so a rank
that fails or diverges fails the run instead of hanging it: the first
failure is raised in the launching process and every other rank is
stopped. :func:`make_mesh` then builds the ``DeviceMesh`` inside a rank.

The production meshes are the reference's: :data:`SINGLE_POD` (16 × 16,
``(data, model)``) and :data:`MULTI_POD` (2 × 16 × 16, ``(pod, data,
model)``). :func:`make_production_mesh` builds either over the
initialized process group; :func:`fake_world` gives one process such a
group of 256 or 512 ranks whose collectives move nothing (torch's ``fake``
backend), in which it stands as one rank: the dry run
(:mod:`repro_torch.launch.dryrun`) traces that rank's step, and the card
runs it for real.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import queue
import socket
import time
import traceback
from typing import Callable, Optional, Tuple

__all__ = ["parse_mesh", "mesh_axis_names", "make_mesh", "run_ranks",
           "free_port", "INIT_TIMEOUT_S", "SINGLE_POD", "MULTI_POD",
           "make_production_mesh", "fake_world"]

#: the reference's production meshes: one pod of 16 × 16 devices
#: ``(data, model)``, and two of them ``(pod, data, model)``
SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)

#: seconds a rank waits for the others at the rendezvous and in each
#: collective before it fails
INIT_TIMEOUT_S = 60.0


def parse_mesh(spec: str) -> Tuple[int, ...]:
    """CLI mesh spec ``"DxM"`` (or ``"PxDxM"``) → shape tuple.

    ``"2x4"`` → ``(data=2, model=4)``; ``"2x2x2"`` adds a leading ``pod``
    axis. Every factor must be a positive integer.
    """
    try:
        shape = tuple(int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}: expected DxM like '2x4'")
    if len(shape) not in (2, 3) or any(s < 1 for s in shape):
        raise ValueError(f"bad mesh spec {spec!r}: expected 2 or 3 positive "
                         "factors (data x model, optionally pod-leading)")
    return shape


def mesh_axis_names(shape: Tuple[int, ...]) -> Tuple[str, ...]:
    """The reference's axis names for a mesh of ``len(shape)`` dims:
    ``(data, model)`` or ``(pod, data, model)`` (their trailing ones for a
    shorter shape)."""
    if len(shape) == 3:
        return ("pod", "data", "model")
    return ("data", "model")[-len(shape):]


def make_mesh(shape: Tuple[int, ...], axes: Optional[Tuple[str, ...]] = None,
              *, device: str = "cuda", ranks=None):
    """A ``DeviceMesh`` of ``shape`` with the reference's axis names over
    the ranks of the initialized process group (whose size must be
    ``prod(shape)``; its backend is the mesh's), or over ``ranks`` of it
    (``prod(shape)`` of them, in mesh order: a mesh for the ranks that
    remain; every rank of the group makes the call, and on a rank outside
    ``ranks`` the mesh's ``get_coordinate()`` is ``None``). ``device`` is
    ``"cuda"`` or ``"cpu"``; on CUDA each rank's device is its rank modulo
    the cards, so ranks may share a card (over a gloo group)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    axes = tuple(axes) if axes is not None else mesh_axis_names(shape)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(run_ranks starts one)")
    n = dist.get_world_size() if ranks is None else len(ranks)
    if n != math.prod(shape):
        have = "the process group has" if ranks is None else "given"
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                         f"{have} {n}")
    device = torch.device(device).type
    if device == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    if ranks is None:
        return init_device_mesh(device, tuple(shape), mesh_dim_names=axes)
    return DeviceMesh(device, torch.tensor(list(ranks)).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The reference's production mesh (:data:`SINGLE_POD` or, with
    ``multi_pod``, :data:`MULTI_POD`) with its axis names, over the
    initialized process group of 256 or 512 ranks (:func:`fake_world`
    gives one process such a group)."""
    return make_mesh(MULTI_POD if multi_pod else SINGLE_POD, device=device)


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A process group of ``n`` ranks in which this one process stands as
    rank ``rank``: torch's ``fake`` backend, whose collectives return at
    once and move nothing (no transport, no other process). Meshes and
    their subgroups build over it as over a real group. Raises where a
    process group is already initialized."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized in this process")
    if not 0 <= rank < n:
        raise ValueError(f"fake_world: rank {rank} outside a world of {n}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str,
               timeout_s: float, threads: int, fn: Callable, args: tuple,
               out) -> None:
    import torch
    import torch.distributed as dist

    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", result))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def run_ranks(n_or_shape, fn: Callable, *args, backend: str = "gloo",
              timeout_s: float = INIT_TIMEOUT_S, join_timeout_s: float = 600.0,
              threads: int = 1) -> list:
    """Run ``fn(rank, *args)`` on ``n`` ranks (or ``prod(shape)``), each a
    spawned process in one process group (``backend``: ``"gloo"`` or
    ``"nccl"``) whose collectives fail after ``timeout_s`` seconds;
    returns each rank's result in rank order. ``fn``, ``args`` and the
    results must pickle. ``threads``: the intra-op threads of each rank
    (``torch.set_num_threads``; 0 leaves the default).

    A rank that raises or dies fails the run at once, and one that has not
    finished ``join_timeout_s`` seconds after the start fails it too: the
    other ranks are killed and ``RuntimeError`` carries the failing ranks'
    tracebacks (those that came within 3 s of the first)."""
    import torch.multiprocessing as mp

    n = n_or_shape if isinstance(n_or_shape, int) else math.prod(n_or_shape)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, backend, timeout_s, threads, fn,
                               args, out), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    results, error, reported = {}, None, set()
    deadline = time.monotonic() + join_timeout_s
    try:
        while len(results) < n and error is None:
            try:
                rank, status, value = out.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    error = (f"rank {dead[0]} died with exit code "
                             f"{procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    error = (f"ranks {sorted(set(range(n)) - set(results))} "
                             f"did not finish within {join_timeout_s} s")
                continue
            reported.add(rank)
            if status == "ok":
                results[rank] = value
            else:
                error = f"rank {rank} failed:\n{value}"
        # a failure makes the other ranks fail in their collectives: give
        # their reports a moment, so that the first cause is among them
        grace = time.monotonic() + 3.0
        while error is not None and len(reported) < n \
                and time.monotonic() < grace:
            try:
                rank, status, value = out.get(timeout=0.2)
            except queue.Empty:
                continue
            reported.add(rank)
            if status != "ok":
                error += f"\nrank {rank} failed:\n{value}"
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(f"run_ranks: {error}")
    return [results[r] for r in range(n)]

