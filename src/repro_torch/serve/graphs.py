"""CUDA graphs of one serve engine: the port's counterpart of the
reference's compile cache (``repro/serve/engine.py``: ``_cached_jit``,
``_build``, ``_decode_for``).

The reference never runs a tick eagerly. It jits every tick path once per
shape: one paged decode (and speculative verify) per live-block bucket
(the dense-slot decode and verify once), one padded prefill per prompt
bucket with ``prompt_len`` traced. On the card a CUDA graph per shape
stands for ``jax.jit``. :class:`GraphCache` captures

* the decode step: paged, once per live-block bucket; dense-slot once
  (bucket 0), its shape being fixed. Tokens ``(n_slots, 1)`` in, logits
  ``(n_slots, 1, V)`` out;
* the speculative verify, the same way (its live-block buckets cover the
  window of ``k + 1`` rows): tokens ``(n_slots, k + 1)`` in, logits
  ``(n_slots, k + 1, V)`` out. The acceptance and the commit run after the
  replay, as the reference's are separate jitted callables;
* the padded full-prompt prefill **and** its write into the cache (the
  scatter into the pool, or the copy into the slot's row), once per
  prompt bucket: tokens, ``write_ids`` and the table row (paged; empty
  for the dense-slot layout), ``slot`` and ``prompt_len`` in, the ``(1,
  1, V)`` logits out. The padded ``(L, 1, max_len, Hk, D)`` K/V stack
  stays inside the graph, so no bucket keeps one alive.

Some prefills stay eager: a prefix-hit (suffix) prefill, whose prefix
length varies, the exact-length prefill of a capacity-limited MoE or of
the SSM and hybrid families (where padding is not exact), which has a
shape per prompt length, and a chunked prefill's chunks, whose prefix
grows: one graph each would be a capture per admission. A recurrent
family's verify writes its state snapshots into a buffer of the cache,
made at its first (eager) run, which the commit reads after the
replay. So do an SLO spill and revive (a few copies) and a
drafter's model calls.

**One engine's graphs.** A graph binds addresses: of the parameters, of
the engine's cache tensors, of the static input buffers here and of the
kernels' workspaces for the capture stream. So a cache belongs to one
engine, where the reference's module cache is shared by engines of one
layout. Nothing may reassign a tensor of the engine's cache: every write is
in place. A weight reload (``ServeEngine.reload_params``) rebinds the
weights to the new tree, which may be shared with other engines and is
never written; it first drops every graph (:meth:`GraphCache.drop`), so
no graph outlives the tensors it reads: each is captured again at its
next call, and the cache's addresses stay where they were. The cache
holds the workspaces its graphs bind
(:func:`repro_torch.kernels._build.stream_workspaces`), so a later growth
cannot hand their memory back to the allocator.

**Capture.** The first call of a ``(path, bucket)`` runs the body eagerly
on the capture stream: at warmup on throwaway inputs, or as the real tick
of an engine run without warmup. That sizes the kernels' workspaces and
cuBLAS's handle for the stream. The capture follows and executes nothing;
later calls copy their inputs into the static buffers and replay. No body
runs twice on live state, and nothing falls back: a capture or a replay
that fails raises.

**Launch counts.** A capture runs the kernel wrappers' Python but no
kernel; a replay runs kernels without calling Python. So the counts are
restored after a capture, the difference is kept as the graph's launches,
and every replay adds them (:func:`repro_torch.kernels.ops.
add_launch_counts`).

**Memory.** All graphs of one engine share one pool: they are replayed one
at a time on one stream, and each graph's output lives as long as the
graph, so no later capture takes its memory.

The graph API is :data:`API`. A test injects a double with the same
members to run the bodies on CPU tensors.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build, ops

__all__ = ["API", "GraphCache", "TorchGraphs"]


class TorchGraphs:
    """``torch.cuda``'s graphs, as :class:`GraphCache` uses them."""

    def supports(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def new_stream(self, device: torch.device):
        return torch.cuda.Stream(device)

    def new_pool(self):
        return torch.cuda.graph_pool_handle()

    @contextlib.contextmanager
    def on(self, stream):
        """Run the block on ``stream``, after the current stream's work so
        far and before its work to come."""
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            yield
        current.wait_stream(stream)

    def capture(self, body: Callable[[], torch.Tensor], *, stream, pool
                ) -> Callable[[], torch.Tensor]:
        """Capture ``body()`` on ``stream`` into a graph of ``pool``.
        Returns ``replay()``: it launches the graph on the current stream
        and returns the body's output, the same tensor every time."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = body()

        def replay() -> torch.Tensor:
            graph.replay()
            return out

        return replay

    def bound_buffers(self, stream) -> list:
        """The kernel workspaces a graph captured on ``stream`` binds."""
        return _build.stream_workspaces(stream.device.index,
                                        stream.cuda_stream)

    def pool_bytes(self, pool) -> int:
        """Bytes of the allocator's segments that belong to ``pool``."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(pool))


#: the graph API every new :class:`GraphCache` uses
API = TorchGraphs()


@dataclasses.dataclass
class _Graph:
    """One captured body: ``replay`` and the launches its capture
    recorded."""

    replay: Callable[[], torch.Tensor]
    launches: Dict[str, int]

    def __call__(self) -> torch.Tensor:
        out = self.replay()
        ops.add_launch_counts(self.launches)
        return out


class GraphCache:
    """The graphs of one engine's decode and verify (paged: per live-block
    bucket; dense-slot: bucket 0) and padded full-prompt prefill (per
    prompt bucket).

    The bodies are the engine's: ``decode(tokens (n_slots, 1), hw)``,
    ``verify(tokens (n_slots, window), hw)`` and ``prefill(tokens (1,
    bucket), write_ids, row, slot, prompt_len)``, all returning logits;
    here they get the static buffers, ``slot`` as a ``(1,)`` and
    ``prompt_len`` as a 0-d int32 device tensor. ``max_bucket`` is the
    largest prompt bucket, ``max_blocks`` the length of ``write_ids`` and
    ``row`` (0 for the dense-slot layout), ``window`` the verify's tokens a
    slot (``k + 1``). Counters: ``eager_runs``, ``captures`` and
    ``replays`` per ``(path, bucket)``, and ``capture_s`` in all.
    """

    def __init__(self, decode: Callable, prefill: Callable,
                 verify: Optional[Callable] = None, *, n_slots: int,
                 max_blocks: int, max_bucket: int, device: torch.device,
                 window: int = 1):
        self._api = API
        self._decode, self._prefill = decode, prefill
        self._verify = verify
        self._stream = self._api.new_stream(device)
        self._pool = self._api.new_pool()
        self._graphs: Dict[tuple, _Graph] = {}
        self._bound: Dict[int, torch.Tensor] = {}
        self.eager_runs: collections.Counter = collections.Counter()
        self.captures: collections.Counter = collections.Counter()
        self.replays: collections.Counter = collections.Counter()
        self.capture_s = 0.0
        self.drops = 0
        # static inputs: decode's tokens, and the prefill's in one buffer
        # (one copy an admission): tokens | write_ids | row | slot | length
        self._tokens = torch.zeros((n_slots, 1), dtype=torch.int32,
                                   device=device)
        self._window = torch.zeros((n_slots, window), dtype=torch.int32,
                                   device=device)
        self._nb, self._mb = max_blocks, max_bucket
        self._prefill_host = np.zeros(max_bucket + 2 * max_blocks + 2,
                                      np.int32)
        self._prefill_in = torch.zeros(self._prefill_host.shape,
                                       dtype=torch.int32, device=device)

    def _prefill_body(self, bucket: int) -> torch.Tensor:
        buf, mb, nb = self._prefill_in, self._mb, self._nb
        return self._prefill(buf[:bucket].view(1, bucket), buf[mb:mb + nb],
                             buf[mb + nb:mb + 2 * nb],
                             buf[mb + 2 * nb:mb + 2 * nb + 1],
                             buf[mb + 2 * nb + 1])

    # ---- ticks -------------------------------------------------------------
    def decode(self, hw: int, tokens: np.ndarray) -> torch.Tensor:
        """Logits ``(n_slots, 1, V)`` of one paged decode step of
        ``tokens (n_slots, 1)`` over ``hw`` live blocks."""
        self._tokens.copy_(torch.from_numpy(tokens))
        return self._run(("decode", hw), lambda: self._decode(self._tokens,
                                                              hw))

    def verify(self, hw: int, tokens: np.ndarray) -> torch.Tensor:
        """Logits ``(n_slots, window, V)`` of one verify of ``tokens
        (n_slots, window)`` over ``hw`` live blocks (dense-slot: 0)."""
        self._window.copy_(torch.from_numpy(tokens))
        return self._run(("verify", hw), lambda: self._verify(self._window,
                                                              hw))

    def prefill(self, tokens: np.ndarray, write_ids: Sequence[int],
                row: np.ndarray, slot: int, prompt_len: int) -> torch.Tensor:
        """Logits ``(1, 1, V)`` of the full-prompt prefill of ``tokens (1,
        bucket)``, after its K/V went to the pages ``write_ids`` (one per
        logical block of ``max_len``) and ``slot``'s table row and cursor
        were installed."""
        bucket = tokens.shape[1]
        host, mb, nb = self._prefill_host, self._mb, self._nb
        host[:bucket] = tokens[0]
        host[mb:mb + nb] = write_ids
        host[mb + nb:mb + 2 * nb] = row
        host[mb + 2 * nb:] = (slot, prompt_len)
        self._prefill_in.copy_(torch.from_numpy(host))
        return self._run(("prefill", bucket),
                         lambda: self._prefill_body(bucket))

    def _run(self, key: tuple, body: Callable[[], torch.Tensor]
             ) -> torch.Tensor:
        graph = self._graphs.get(key)
        if graph is not None:
            self.replays[key] += 1
            return graph()
        with self._api.on(self._stream):
            out = body()
        self.eager_runs[key] += 1
        self._graphs[key] = self._capture(key, body)
        return out

    def _capture(self, key: tuple, body: Callable[[], torch.Tensor]
                 ) -> _Graph:
        """Capture ``body`` with Python's cyclic garbage collector paused:
        a collection during the capture could destroy another graph (an
        engine dropped in a reference cycle, a fleet's killed replica),
        and destroying a graph while a stream captures invalidates the
        capture. ``torch.cuda.graph`` collects before it begins."""
        before = ops.launch_counts()
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            replay = self._api.capture(body, stream=self._stream,
                                       pool=self._pool)
        finally:
            if collecting:
                gc.enable()
            after = ops.launch_counts()
            ops.reset_launch_counts()
            ops.add_launch_counts(before)
        self.capture_s += time.perf_counter() - t0
        self.captures[key] += 1
        self._bound.update((id(t), t)
                           for t in self._api.bound_buffers(self._stream))
        return _Graph(replay, {k: after[k] - before[k] for k in after})

    def drop(self) -> None:
        """Forget every graph, before the engine replaces tensors they bind
        (its weights, at a reload): the next call of each ``(path,
        bucket)`` runs its body eagerly and captures it again. Counted in
        ``drops``."""
        self._graphs.clear()
        self.drops += 1

    def report(self) -> dict:
        """Graphs held, captures, replays and eager first runs since the
        cache was made, the capture seconds, the pool's MB (of 2**20
        bytes), and each path's kernel launches per replay (the same for
        every bucket of a path)."""
        per_replay = {}
        for (path, _), graph in sorted(self._graphs.items()):
            per_replay[path] = {k: n for k, n in graph.launches.items() if n}
        return {"graphs": len(self._graphs),
                "captures": sum(self.captures.values()),
                "replays": sum(self.replays.values()),
                "eager_runs": sum(self.eager_runs.values()),
                "capture_s": self.capture_s,
                "pool_mb": self._api.pool_bytes(self._pool) / 2 ** 20,
                "launches_per_replay": per_replay}
