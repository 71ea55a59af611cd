#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--log PATH] [--parent DIR]

``--log`` also appends every JSON line to a file. ``--parent`` names a
checkout of the parent tree (``git archive`` unpacked): its ``dot_moa``,
paged-attention, ``moa_reduce`` and ``loa_reduce`` kernels are built from
its own sources and timed beside every unbatched ``dot_moa``, paged and
reduction row (``parent_device_ms``; ``dot_moa`` rows also give
``vs_parent``, this tree's device time over the parent's), and a second
``decode_long`` line serves the same requests through its paged kernel.

Phases, in order; each prints JSON lines and any failure ends the run with
a non-zero exit:

1. build    — compile the CUDA kernels from ``src/repro_torch/kernels/
              csrc`` with nvcc for sm_90a (one nvcc per source, and one
              per part of ``dot_moa.cu``, all at once); print the card's
              name and power limit.
   rows     — ``scripts/row_invariance.py`` at 2 layers of llama3-8b
              (bf16): one slot's decode step against row 0 of a verify
              over the same tokens, op by op (paged, dense-slot, the
              drafter's dense-slot decode against the paged verify;
              ``trace`` lines naming the first op that differs), and each
              op alone at m = 1..16 and T = 1 against T = 4 (``op``
              lines); then mamba2-370m's 1024-token prefill in one shot
              against 256-token chunks, op by op and its logits
              (``chunk`` lines); fails on any row that differs in a bit.
2. kernels  — each of the six kernels against its plain PyTorch version on
              the card, at the shapes its path gives it (the served model's
              projections and attention; the train phase's projections,
              llama3-8b's at m = 4096 and moonshot's attention at m =
              1024; the families phase's: hubert-xlarge's at 4000 (its
              encode) and 4096, llava-next-34b's at 2 (decode), 4736
              (prefill) and 5120, zamba2-1.2b's shared block at 4096;
              every contraction, reduction
              and LOA add of the paper path, the moa_scope loss line's
              smoke llama3-8b among them) plus ragged and wrapping
              edge cases: error against a stated tolerance (integer and LOA
              rows bit-exact), and the kernel's, the plain version's and
              (where one PyTorch call computes the same function) the
              library call's time, beside the least time the card could
              take (``bound_ms``); the kernel's and the library call's
              also as device time alone. Each ``dot_moa``,
              ``flash_attention`` and ``paged_attention`` row also names its
              plan (body, tile, splits, blocks) and the CUDA functions the
              call launched with the device time of each, and fails if any
              is not one of the kernel's own; flash and paged rows also
              fail on two calls that differ in a bit, paged rows on a read
              of a dead page (NaN-poisoned). Flash rows run at llama3-8b's,
              moonshot-v1-16b-a3b's and zamba2-1.2b's (H32/32, head_dim
              64) served prefills, hubert-xlarge's encode (bidirectional,
              H16/16, head_dim 80, 4 x 1000) and llava-next-34b's prefill
              (H56/8, 2 x 2368); paged rows at the three models' served
              decode (bf16 and int8 pools; zamba2's, and llava-next-34b's
              (B2 H56/8 over 2384 positions), through the dense-slot
              identity table, its dead pages poisoned), long
              context
              (to 4096 tokens, and 16 slots to 8192) and the T = 4 verify
              shape, also as served (B4 T4 H32/8, bf16 and int8 pools) at
              each live-block bucket of the spec phase's max_len, and a
              256-block table with 8, 16 and 32 live blocks (also timed
              on the table cut to its live-block bucket, ``cut_device_ms``).
              Each ``moa_reduce`` / ``loa_reduce`` row names its
              plan (route, splits, blocks), fails on two calls that differ
              in a bit, gives ``chain_ms`` (the ordered fold chain's floor)
              on the ordered route, and a time target, met or missed.
              moonshot-v1-16b-a3b's served and trained calls: the
              batched expert projections (64 experts, C = 1, 60, a ragged
              4 and 5, and the train step's 120 rows each, one launch),
              each also bit for bit against a member-by-member loop under
              the same plan and beside ``torch.bmm``; the router (bf16
              in, f32 out) and the top-6 combine (``moa_reduce``, one
              6-row cluster), also at the train step's 1024 tokens. Then
              zamba2-1.2b's decode unembedding alone (a cuBLAS product,
              failing below its byte bound). Then every call key the mesh
              phase's runs launch at their shard shapes that no row above
              checked (``mesh_call_keys``: TP2 and f32 TP2 llama3-8b, its
              DP2 shapes, EP2 moonshot's 32 experts a rank, DP2 zamba2),
              each against its plain version on random operands
              (``check_call_keys``; error and tolerance, no times). A last row gives the
              wrapper's host time per call.
3. serve    — llama3-8b at full width and full depth (bf16 weights from
              the port's own initializer, seed 0) served through the
              paged engine, 8 requests into 4 slots, twice in one
              process: every tick eager (``cuda_graphs=False``), then
              replaying the CUDA graphs captured at warmup. First with
              every request arriving at 0 (``graphs`` line): the run fails
              on any token, any bit of any step's logits or any launch
              count that differs, on a kernel workspace that grew after
              the captured engine's warmup, and on a served kernel
              launched no time. Then as the Poisson workload arrives
              (``serve`` lines, one a path: tok/s, TTFT, host ms by tick
              class, warmup and capture seconds, the graph pool's MB,
              launches a replay). Then the same workload is served again
              by fresh engines (an empty prefix cache), eager and
              captured, each tick under torch.profiler: device time by
              kernel of the decode and admission ticks, against the host
              clock; one 512-token prefill of the same model under
              torch.profiler (flash attention's share of it); and
              ``decode_long``: a captured engine at max_len 4096 (its
              warmup and capture cost on a line of its own) serving 4
              greedy requests of 3000-4000 prompt tokens, 8 new tokens
              each, every tick profiled (paged attention's share of a
              decode tick).
   spec     — the same llama3-8b, speculative (4 slots, k = 3, its
              served workload), paged and dense-slot, with the drafters
              ngram?n=3, oracle and oracle?accept=0.5: per layout and
              drafter an eager and a captured engine with every request at
              0 (``spec`` lines: tok/s, TTFT, accept rate, tokens per
              verify tick, the accept histogram, moa_flops, launches per
              verify replay and paged-attention calls by T; a ``graphs``
              line), failing on a token, a bit of a verify tick's logits
              or a launch count that differs, on a paged verify replay
              that does not launch paged attention once a layer at T = 4,
              on greedy tokens that differ in a bit from the plain
              captured engine's, and on an oracle whose accept rate is
              not 1.0 (no near-tie allowance: no kernel's row depends on
              the rows beside it); then the oracle's captured engine on
              the workload as it arrives (accept rate 1.0 again).
              Per layout the ngram drafter's verify ticks are profiled,
              and the dense-slot plain engine's decode ticks (the paged
              ones are the serve phase's) (``profile`` lines).
   slo      — the same llama3-8b, paged, captured, ``bursty_workload``
              (4 requests of 1024 prompt and 64 new tokens, then 8 of 32
              and 8 with a 0.25 s TTFT deadline): FIFO one-shot, FIFO with
              256-token prefill chunks, ``scheduling="slo"`` with chunks
              (``slo`` lines: burst TTFT, deadline-met share, preemptions,
              spills, chunk ticks, tok/s); tokens must equal the FIFO
              one-shot run's but at a near-tie, and the SLO run must
              preempt.
   fleet    — the same llama3-8b, 2 replicas of a captured paged engine
              (4 slots each) on a StepClock of 1 ms a read, 12 requests of
              the serve phase's shape: a plain engine, a failure-free
              fleet, and a chaos fleet (the busiest replica killed while
              it decodes, detected by heartbeat, its requests requeued,
              the replica revived, then a rolling reload to a new tree
              of the weights in memory); then the watcher path at 2
              layers (a CheckpointManager in a temporary directory, a
              CheckpointWatcher driving the rolling reload); then
              ``reload_params`` under graphs (a captured engine reloaded
              with seed 1's weights against a fresh one on them, tokens
              and every step's logits bit for bit; an engine on the old
              tree unchanged). Fails on a lost request, a dropped or
              unfinished reload, or a token that differs from the
              failure-free fleet's or the plain engine's. One ``fleet``
              line: kills, deaths detected, requeues, requeue latency,
              reloads, revival capture seconds, tok/s against the
              failure-free fleet, memory.
   audit    — the cost audit of the same llama3-8b's served ticks at
              ``repro_torch.analysis.targets.AUDIT_SHAPE`` (2 slots,
              max_len 32, window 4, pages of 8, 16-token prompts): the
              prefill (flash kernel), ``paged_decode`` and
              ``paged_verify`` (the gather route) and their ``_fused``
              twins (the paged kernel), ``dot_moa`` in every projection.
              Each eager body runs once under the cost audit's trace and
              kernel recorder: its product FLOPs must be within
              ``FLOPS_RTOL`` of ``serve_target_cost`` and its gathered KV
              bytes within ``KV_BYTES_RTOL``, and the recorded calls of
              each kernel must equal its launch count's rise over the same
              body (no launch unpriced); then once more under
              ``torch.cuda.set_sync_debug_mode("error")`` (any device sync
              fails). Every launch's call key is then held against the
              plain version. One ``audit`` line a target and a summary.
   Then moonshot-v1-16b-a3b at full width and depth (bf16 weights
              from the port's initializer, seed 0, after llama3-8b is
              freed; capacity factor 1.25, so exact-length prefills) in
              the dense-slot and the paged layout: per layout the
              bit-for-bit eager / captured check (``graphs`` line), the
              Poisson workload eager and captured (``serve`` lines; a
              captured decode tick must launch 384 ``dot_moa``, 48
              ``moa_reduce`` and, paged, 48 ``paged_attention``), and the
              captured engine's ticks profiled, by kernel group, beside the
              decode tick's weight floor; then its peak memory.
   hybrid   — zamba2-1.2b at full width and depth (38 Mamba-2 layers, 6
              applications of the shared attention + SwiGLU block, bf16
              weights from seed 0, after moonshot is freed) on llama3's
              workload, paged and dense-slot: per layout the bit-for-bit
              eager / captured check (a captured decode tick must launch
              42 ``dot_moa`` and 6 ``paged_attention``), a captured
              Poisson run (``serve`` line), and the captured engine with
              ``oracle`` and ``ngram?n=3`` at k = 3 (``spec`` lines: the
              oracle accepts 1.0 and both drafters' tokens equal the plain
              captured engine's bit for bit); paged, the decode ticks
              profiled by kernel group beside the tick's weight floor
              (weights, the shared block once an application, the
              recurrent state read and written) and the unembedding's
              device time (the kernels phase's ``zamba2 unembedding``
              line), and one preemption whose recurrent state comes back bit for bit
              (``slo`` line); then two 1024-token prompts in 256-token
              chunks against one shot (``chunked`` line, near-tie rule).
              Then mamba2-370m at full width (48 layers, dense-slot, no
              kernel launched): eager / captured bit for bit and chunked
              equal to one-shot bit for bit (every step's logits).
   train    — training, every served model freed: llama3-8b at full
              width cut to 4 layers (the reference's train state: f32
              weights and AdamW moments, 16 bytes a parameter; bf16
              compute, remat "full"), 8 × 512 tokens a step of
              ``SyntheticLMData``: one step's loss and gradients with
              ``dot_moa`` against the plain route (``backend=torch``),
              within ``TRAIN_LOSS_TOL`` and ``TRAIN_GRAD_REL_TOL``; the
              same 3 steps twice from one init, bit for bit (losses and
              every leaf of the state); 10 timed steps (``steps`` line:
              wall ms a step between synchronisations, tokens/s, model
              TFLOP/s and its share of 989, launches a step, peak memory,
              every loss finite) and one step profiled by group
              (``dot_moa``, cuBLAS, the optimizer, other). Then
              moonshot-v1-16b-a3b at full width cut to 2 layers, 4 × 256
              tokens (kernel against plain with the plain route's expert
              choices teacher-forced, each routing call's probabilities
              within ``TRAIN_GRAD_REL_TOL`` of the plain route's and each
              of its own choices that differs at a near-tie those
              probabilities allow; the same 3 steps twice, bit for bit;
              3 counted steps, ``dot_moa`` and ``moa_reduce`` launched).
              Each counted run fails on a kernel launch whose type,
              shapes and options no kernels-phase row checked. Then a
              smoke ``TrainLoop`` with
              two injected failures against the failure-free run, bit for
              bit (``restart``), and the quickstart's 60 smoke steps,
              which must lose more than ``LEARN_DROP`` (``learn``). The
              ``nvidia-smi`` name and power limit precede each line.
   families — the encoder and VLM families and the SSM and hybrid
              gradients, every earlier model freed. hubert-xlarge at full
              width and depth (48 layers, bf16 weights) encodes 4 x 1000
              frames through ``Model.prefill`` (``dot_moa``, the flash
              kernel bidirectional at head_dim 80) against the plain route
              (a ``families`` line: logits within
              ``FAMILY_LOGIT_REL_TOL``, every differing argmax at a
              near-tie); then trains at full depth (``train`` lines as
              above: kernel against plain, 3 steps twice bit for bit, 10
              counted steps, 8 x 512 frames). llava-next-34b at 2 layers
              in f32: prefill of 2 x (2304 patches + 64 text tokens) and
              16 greedy decode steps, kernel route against plain route
              (``parity`` line ``llava``: tokens equal but at a near-tie,
              teacher-forced logits within ``LOGIT_TOL``); at full width
              and depth (60 layers, 34.4 B parameters, bf16 weights) the
              same through the kernels, counted, then again for its times
              (bit for bit), then on the plain route (a ``families`` line:
              init, prefill and decode ms, the decode tick's weight floor,
              peak memory; logits within ``FAMILY_LOGIT_REL_TOL`` up to a
              divergence, which must be a near-tie); then trains at 2
              layers on 2 x 2560 tokens. zamba2-1.2b and mamba2-370m train
              at full depth, 8 x 512 tokens (zamba2's kernel route is also
              held to its bf16 noise floor, the plain route summed in
              other chunks: ``TRAIN_FLOOR_RATIO``; mamba2 launches no
              kernel: its gradients are checked finite in place of a
              kernel comparison). Each counted run fails on a launch whose call
              key no kernels row checked.
   mesh     — the served models on a device mesh, every earlier model
              freed (the kernels phase checks every call key of these runs
              at the shard shapes: ``mesh_call_keys``). First a (1, 1)
              mesh over NCCL in this process: llama3-8b at 2 layers
              (bf16, paged) captured in CUDA graphs, tokens and every
              step's logits bit for bit with the single-device captured
              engine. Then two ranks spawned on the one card over a gloo
              group carrying CUDA tensors (NCCL refuses two ranks on one
              card), which first report which collectives gloo carries
              for CUDA tensors here; both meshes, (1, 2) and (2, 1), over
              them; eager engines of the serve phase's shape (4 slots,
              max_len 96, 16-token pages), its 8 requests every one at 0:
              llama3-8b at full width and depth on DP2 (the single-device
              eager tokens bit for bit), TP2 (heads, ff and vocab over
              ``model``; tokens but at a near-tie, ``NEAR_TIE``) and TP2
              with the oracle drafter (the same rule); llama3-8b at 2
              layers in f32 on TP2 (tokens identical, every step's logits
              within 1e-4 of its largest); moonshot-v1-16b-a3b at 4 layers
              on EP2 (experts and heads over ``model``), fed the
              single-device run's tokens and expert choices, each own
              choice that differs at a gap under twice its token's router
              probability difference; zamba2-1.2b at full depth on DP2
              (its serve rules: nothing over ``model``), bit for bit.
              ``mesh`` lines: the mesh, backend and ranks, tokens or
              divergences, launches and peak memory by rank,
              ``unchecked_calls``, collective calls a tick. A failed rank
              fails the phase.
   mesh_train — training on a device mesh (the kernels phase checks every
              call key of its mesh runs: ``mesh_train_call_keys``). First a
              (1, 1) mesh over NCCL in this process: llama3-8b at 2 layers,
              8 x 512, two steps from seed 0 against the one-device train
              step, losses and every leaf of the state bit for bit. Then,
              for each run of ``MESH_TRAIN_RUNS`` (llama3-8b at full width
              and 2 layers, 8 x 512, on (2, 1) FSDP and on (1, 2) TP;
              moonshot-v1-16b-a3b at 2 layers, 4 x 256, on (1, 2) EP;
              zamba2-1.2b at full depth, 8 x 512, on (2, 1) FSDP; the
              reference's train state, bf16 compute) the one-device step
              on the card (its gradients kept on the host, the card freed),
              then two ranks spawned on the one card over gloo that place
              the state by the train step's specs and take 2 counted
              steps, the first's loss held within ``TRAIN_LOSS_TOL`` and
              every gradient leaf it applied within ``TRAIN_GRAD_REL_TOL``
              of the one-device step's (the MoE teacher-forced by its
              expert choices, each own choice that differs at a
              near-tie); last, a
              checkpoint a smoke llama3-8b run wrote on (1, 2) restored
              onto (2, 1), every rank's slices bit for bit against the
              saved leaves. While the two ranks run, this process runs
              the parity phases (phase 4: lines without a time, each
              bit-for-bit or bounded), so their lines come first.
              ``mesh_train`` lines: the bars' numbers, collective calls a
              step by kind, wall ms a step (not a speed result; the
              parity phases share the card and host), peak memory and
              launches by rank, ``unchecked_calls``.
4. parity   — the same engine at full width with 2 layers, once on the
              kernels (captured, each bucket at its first tick) and once
              on the plain PyTorch path (eager): float32 compute on the
              f32 and int8 KV pools, bf16 compute on the bf16 pool. On
              the f32 and int8 pools the kernel path first serves each
              workload eager and captured, held bit for bit as in phase
              3 (``graphs`` lines). f32 and bf16 pools: greedy tokens
              must agree (a divergence
              passes only at a near-tie of the top-2 logits). int8 pool:
              the free runs' divergences are printed; the kernel path is
              then fed the plain path's tokens (teacher forcing), and at
              every step its logits must stay within the move one int8
              quantum can cause, and its greedy token may differ only at
              a top-2 gap within twice the logits' difference. On the f32
              pool llama3's dense-slot engine is also held to its paged
              one (tokens equal but at a near-tie). Then zamba2-1.2b at 6
              layers (one application of the shared block, f32) in both
              layouts: tokens equal but at a near-tie, and the kernel
              path fed the plain path's tokens within ``LOGIT_TOL`` at
              every step. Then moonshot at 2 layers (f32, capacity factor
              1.25) in both layouts, kernel path teacher-forced on the
              plain path's tokens and expert choices: every step's logits
              agree within ``LOGIT_TOL`` (an f32 pool; every token whose
              own expert choice differs must sit at a near-tie of the
              plain path's router probabilities, ``ROUTE_GAP``) or within
              the one-quantum bound (an int8 pool). Last, speculative
              parity at 2 layers
              on f32 and bf16 pools: the oracle accepts every draft and
              its greedy tokens equal the plain engine's exactly, llama3
              and a dropless moonshot (capacity factor 11), both layouts,
              on the kernels. Then the serve CLI at its default lengths
              (llama3-8b, 2 layers, bf16): a dense-slot engine, the same
              with the oracle drafter, and 2 dense-slot replicas; each
              must finish with ``max_len`` rounded up to whole 16-token
              pages (``cli`` lines); then the train CLI (the smoke
              llama3-8b, 20 steps, a failure at step 7 survived).
   dryrun   — the multi-pod dry run (``repro_torch.launch.dryrun``) of
              llama3-8b's ``train_4k``, ``prefill_32k`` and
              ``decode_32k`` cells on the 16 × 16 production mesh: rank
              0 of each traced on ``meta`` tensors over a fake process
              group of 256 ranks, in a process of its own started after
              the build (no card); then, each cell whose predicted peak
              is under ``DRYRUN_PEAK_MAX``, the same rank run on the card
              over a fake group whose collectives move nothing, at full
              depth (parameters drawn whole from seed 0, cut to the
              rank's shards; the decode cache of zeros at its last
              position): once under the same trace, timed (the serving
              cells once more, timed alone). Fails on
              kernel calls, launches or product FLOPs other than the
              trace's, and on a measured peak (above the cell's start)
              outside ``DRYRUN_PEAK_RATIO`` of the predicted one; every
              call key of its launches is then checked against the plain
              version (the kernels phase already holds the paged
              kernel's head-offset read at the decode cell's shard shape,
              ``dryrun_call_keys``). ``dryrun`` lines: calls, FLOPs,
              peaks and their ratio, the step's device ms against the
              roofline's compute + memory, the trace's seconds.
5. paper    — the paper path, ``repro_torch.launch.paper_repro``, on the
              card: Table 1, Fig. 4 (serial ``moa_reduce``), Fig. 5 (LOA
              MRED, ``loa_add``, the LOA MOA through ``loa_reduce``) and the
              strategy sweep, whose deterministic values must equal the
              reference example's; the LOA conv at AlexNet conv3's shape
              (batch 16), kernel route bit-exact against its plain version,
              MRED per l on both routes; LeNet-5 and full-width AlexNet
              (batch 16, f32) under ``im2col`` with ``tree`` and
              ``serial?chunk=256`` against ``conv``. Every kernel of the
              path must have been launched by that run, and every launch,
              at its operand type, shapes and options, must be one that a
              ``kernels`` row held against its plain version.

The last lines are the kernel summary (JSON; ``launches_by_path`` has one
key per counted run: ``serve/llama3-8b``, ``serve/llama3-8b-spec-paged``,
``serve/llama3-8b-spec-dense-slot``, ``serve/llama3-8b-slo``,
``serve/llama3-8b-fleet``,
``serve/moonshot-dense-slot``, ``serve/moonshot-paged``,
``serve/zamba2-paged``, ``serve/zamba2-dense-slot``,
``serve/mamba2-dense-slot``, ``train/llama3-8b``, ``train/moonshot``,
``encode/hubert-xlarge``, ``vlm/llava-next-34b``, ``train/hubert-xlarge``,
``train/llava-next-34b``, ``train/zamba2-1.2b``, ``train/mamba2-370m``,
``mesh/llama3-8b-tp2``, ``mesh/llama3-8b-dp2``, ``mesh/moonshot-ep2``,
``mesh/zamba2-dp2``, ``train-mesh/llama3-8b-fsdp2``,
``train-mesh/llama3-8b-tp2``, ``train-mesh/moonshot-ep2``,
``train-mesh/zamba2-fsdp2`` (both ranks' launches),
``dryrun/llama3-8b-train_4k``, ``dryrun/llama3-8b-prefill_32k``,
``dryrun/llama3-8b-decode_32k`` (rank 0 of each cell), ``paper``; the
paged row also carries the served verify row), the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``. Without a GPU, or
without the rest of the repository beside it, the script exits non-zero
and prints no result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
#: operations/s by operand type (f32 is the CUDA-core rate). int32 has no
#: data-sheet rate: 132 SMs x 1.98 GHz x 64 int32 lanes per SM per clock
#: (CUDA C++ Programming Guide, instruction throughput, compute capability
#: 9.0) gives 16.7e12 adds or logic ops/s ("int32_alu") and 33.5e12 ops/s
#: counting a multiply-add as 2, as the f32 rate does ("int32").
HBM_BPS = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12,
            "int32": 33.5e12, "int32_alu": 16.7e12}

#: One port: the TPU kernel it replaces (the function that reaches
#: ``pl.pallas_call``), its CUDA source under ``kernels/csrc``, its
#: ``__global__`` functions, and the paths that launch it (the first one's
#: count is the summary's).
Kernel = collections.namedtuple("Kernel", "replaces source symbols paths")

#: cycles of one dependent step of an ordered fold, for ``chain_ms`` (the
#: fold chain's floor at the card's highest SM clock): assumed, not measured
CHAIN_CYCLES = {"add": 4, "loa": 20}
CHAIN_ASSUMES = {
    "add": "4 cycles a dependent f32 add",
    "loa": "20 cycles a loa_fold: 5 dependent integer operations (shift, "
           "logic, add, shift, logic) of 4 cycles"}


KERNELS = {
    "dot_moa": Kernel("src/repro/kernels/dot_moa.py:108", "dot_moa",
                      ("dot_moa_stream", "dot_moa_wgmma", "dot_moa_tc",
                       "dot_moa_simt", "dot_moa_fold"),
                      ("serve", "paper", "train", "encode", "vlm", "mesh",
                       "train-mesh", "dryrun")),
    "flash_attention": Kernel("src/repro/kernels/flash_attention.py:86",
                              "flash_attention",
                              ("flash_wgmma", "flash_simt"),
                              ("serve", "encode", "vlm", "mesh", "dryrun")),
    "paged_attention": Kernel("src/repro/kernels/paged_attention.py:119",
                              "paged_attention", ("paged_split",),
                              ("serve", "vlm", "mesh", "dryrun")),
    "moa_reduce": Kernel("src/repro/kernels/moa_reduce.py:47", "moa_reduce",
                         ("moa_reduce_kernel",),
                         ("serve", "paper", "train", "mesh", "train-mesh")),
    "loa_reduce": Kernel("src/repro/kernels/loa_add.py:92", "loa_add",
                         ("loa_reduce_kernel",), ("paper",)),
    "loa_add": Kernel("src/repro/kernels/loa_add.py:48", "loa_add",
                      ("loa_add_kernel",), ("paper",)),
}


#: the spec phase's verify: each live-block bucket of its max_len 96 (16
#: tokens a page) and four slots' cursors whose k + 1 = 4 rows it covers
VERIFY_BUCKETS = {1: (0, 3, 7, 12), 2: (10, 17, 23, 28),
                  4: (30, 41, 52, 60), 6: (62, 70, 81, 92)}


def path_kernels(path: str) -> list:
    return [name for name, k in KERNELS.items() if path in k.paths]


def served_kernels(cfg) -> list:
    """The kernels a served run of ``cfg`` must launch, in either layout:
    ``dot_moa`` for every projection (an MoE's experts batched), flash
    attention in prefill, paged attention in decode and verify (a
    dense-slot cache's rows walked as pages), and an MoE's top-k combine
    on ``moa_reduce``."""
    out = ["dot_moa", "flash_attention", "paged_attention"]
    if cfg.family == "moe":
        out.append("moa_reduce")
    return out


def parent_kernels(root: str):
    """The ``dot_moa_cuda`` (2-D), ``paged_attention_cuda``,
    ``moa_reduce_cuda`` and ``loa_reduce_cuda`` of the checkout at ``root``
    (``--parent``), with the same signatures as this tree's: its
    ``kernels/_build.py`` and the wrappers' modules loaded under other
    names, so that it builds its own ``csrc`` into ``root/build``. Returns
    ``{kernel: wrapper}`` and the nvcc build records."""
    import importlib.util

    from repro_torch import kernels as pkg

    kdir = os.path.join(os.path.abspath(root), "src", "repro_torch",
                        "kernels")

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod         # dataclasses look their module up
        spec.loader.exec_module(mod)
        return mod

    build = load("parent_repro_torch_build", os.path.join(kdir, "_build.py"))
    built = build.build(["dot_moa", "paged_attention", "moa_reduce",
                         "loa_add"])
    # its ``from repro_torch.kernels import _build`` and its loa_add's
    # ``from repro_torch.kernels.moa_reduce import ...`` find its own
    own_build = pkg._build
    own_mr = sys.modules["repro_torch.kernels.moa_reduce"]
    pkg._build = build
    try:
        dm = load("parent_dot_moa", os.path.join(kdir, "dot_moa.py"))
        paged = load("parent_paged_attention",
                     os.path.join(kdir, "paged_attention.py"))
        mr = load("parent_moa_reduce", os.path.join(kdir, "moa_reduce.py"))
        sys.modules["repro_torch.kernels.moa_reduce"] = mr
        la = load("parent_loa_add", os.path.join(kdir, "loa_add.py"))
    finally:
        pkg._build = own_build
        sys.modules["repro_torch.kernels.moa_reduce"] = own_mr
    return {"dot_moa": dm.dot_moa_cuda,
            "paged_attention": paged.paged_attention_cuda,
            "moa_reduce": mr.moa_reduce_cuda,
            "loa_reduce": la.loa_reduce_cuda}, built


def beside_parent(timer, parent: dict, kernel: str, call, want, err) -> dict:
    """Under ``--parent``: the parent tree's ``kernel`` on a row's inputs
    (``call(wrapper)`` runs it), its error against the row's plain result
    and the device time of its CUDA functions, which carry this tree's
    names; else nothing."""
    if kernel not in parent:
        return {}
    old = lambda: call(parent[kernel])
    return {"parent_max_abs_err": err(old(), want),
            "parent_device_ms": timer.device(old, kernel)}


#: the reference example's deterministic values (examples/paper_repro.py
#: through benchmarks/*.py; tests/test_torch_paper.py holds the port's
#: runners equal to them on the CPU)
PAPER_DERIVED = {
    "table1_moa_counts": {"max_nopd_err": "0.16%",
                          "conv1_moa_frac": "0.690(paper:0.69)"},
    "fig4_serialization": {"fpga_serial_wins": "0/11(paper:0)",
                           "tpu_vmem_reduction": "8x"},
    "fig5_loa": {"alm_flat": "True", "tpu_loa_cost": "6x"},
}

_LOG = None
_T0 = time.monotonic()


def emit(obj) -> None:
    """Print one JSON line (and log it), stamped with the seconds since the
    script started (``elapsed_s``)."""
    line = json.dumps(dict(obj, elapsed_s=time.monotonic() - _T0))
    print(line, flush=True)
    if _LOG is not None:
        _LOG.write(line + "\n")
        _LOG.flush()


def bound(nbytes: float, ops: float, dtype: str):
    """Least time (ms) for the work: bytes over HBM rate vs operations over
    the type's peak, whichever is larger, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / PEAK_OPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at magnitude ``x`` (8 significant
    bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def device_events(torch, prof) -> dict:
    """``{name: (device ms, count)}`` of the device events of a finished
    ``torch.profiler`` session: ``key_averages()``'s device time and count
    of each kernel, read from the profiler's own records. ``key_averages``
    first builds a Python event of each record, which held most of a
    profiled served run's wall time (moonshot-v1-16b-a3b: ~1.3 s a tick
    against ticks of 50-400 ms host time)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or getattr(e, "is_hidden_event",
                                              lambda: False)():
            continue
        ms, n = out.get(e.name(), (0.0, 0))
        # key_averages gives an event that ends on another thread no time
        timed = not e.is_async() and e.start_thread_id() == e.end_thread_id()
        out[e.name()] = (ms + (e.duration_ns() / 1e6 if timed else 0.0),
                         n + 1)
    return out


def _memop(name: str) -> bool:
    """A profiler's Memset / Memcpy record rather than a kernel's."""
    return name.startswith(("Memset", "Memcpy"))


class Timer:
    """Median device time of single launches, each after a read of 64 MiB
    that evicts the 50 MB L2 (the served model streams ~14 GB of weights
    per decode step, so its kernels find their operands cold). A read and
    not a write: a write leaves up to 50 MB of dirty lines, whose write-back
    the timed kernel would pay; the served path's L2 holds clean weights."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        # the flush's kernels, as three profiler sessions saw them: a
        # session may lose events, and a flush kernel missed here would be
        # counted as the timed call's own
        self.flush_kernels, seen = set(), 0
        for _ in range(6):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                self.evict()
                torch.cuda.synchronize()
            keys = set(device_events(torch, prof))
            self.flush_kernels |= keys
            seen += bool(keys)
            if seen == 3:
                break
        else:
            raise AssertionError("the profiler saw the flush in fewer than "
                                 "three of six sessions")
        #: what the last :meth:`device` call saw launched: the kernel's own
        #: CUDA functions with the device ms of each per call, and any other
        #: (neither the kernel's nor the flush's); and the device ms per
        #: call of its memsets and copies (``Memset`` / ``Memcpy`` events,
        #: the flush's among them), which the session check leaves out
        self.kernels, self.foreign, self.memops = {}, [], {}

    def evict(self) -> None:
        self.flush.max()

    def device(self, fn, kernel: str = None, iters: int = 10) -> float:
        """Mean device time (ms) per call of ``kernel``'s CUDA functions
        that ``fn`` launches (``kernel=None``: of every one but the
        flush's, as for a library call), from ``torch.profiler``'s kernel
        events, each call after the same L2 flush. This is the device work
        alone: the event pair of ``__call__`` also holds the host time of
        the call when it takes longer than the flush before it."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        symbols = KERNELS[kernel].symbols if kernel else ()
        # the profiler now and then returns no events, or only some: a
        # session whose flush or own kernels did not run a whole number of
        # times per call lost events, and is taken again. Only kernels
        # count there: a lost Memset or Memcpy record (a workspace's
        # tickets zeroed, a copy) says nothing of the kernels' events, and
        # their device time is reported apart (``memops``)
        for _ in range(6):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    self.evict()
                    fn()
                torch.cuda.synchronize()
            events = device_events(torch, prof)
            own = {k: v for k, v in events.items()
                   if any(sym in k for sym in symbols)
                   or not kernel and k not in self.flush_kernels}
            whole = all(n % iters == 0 for k, (_, n) in events.items()
                        if (k in own or k in self.flush_kernels)
                        and not _memop(k))
            if own and whole:
                break
        else:
            raise AssertionError(
                f"the profiler saw no whole set of {kernel or 'call'} "
                f"kernels in six tries of {iters} calls; the last: "
                f"{[(k[:60], n) for k, (_, n) in events.items()]}")
        self.kernels = {}
        for k, (ms, _) in own.items():
            name = k[:100]
            self.kernels[name] = self.kernels.get(name, 0.0) + ms / iters
        self.foreign = sorted({k[:100] for k in events if k not in own
                               and k not in self.flush_kernels})
        self.memops = {k[:100]: ms / iters for k, (ms, _) in events.items()
                       if _memop(k)}
        return sum(ms for ms, _ in own.values()) / iters

    def __call__(self, fn, iters: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ev:
            self.evict()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def ptxas_report(log: str) -> list:
    """``[function, registers, spill bytes (stores + loads)]`` per compiled
    ``__global__`` function, from ptxas's ``-v`` output."""
    import re

    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            out.append([name, None, 0])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and out:
            out[-1][2] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1][1] = int(m.group(1))
    return out


def sm_max_clock_mhz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


#: ``call_key`` of every launch a kernels-phase row held against its plain
#: version (filled by ``check``)
CHECKED = set()


def call_key(kernel: str, x, *rest, **kw) -> tuple:
    """What a launch of ``kernel``'s wrapper depends on besides the operand
    values: operand type, shapes and options, block sizes as the wrapper
    clips them. ``x, *rest, **kw`` are the wrapper's arguments. A batched
    ``dot_moa`` adds its member count, and an output type other than the
    default (the operands', int32 for integers) adds that type. Flash
    attention: q's type and shape, the KV length and heads, the mask;
    paged attention: q's type and shape, the pool's type, page size and
    heads, the table's width and the dequantization type (its plan reads
    no cursor), and where it reads a few of the pool's KV heads, the first
    and their count."""
    if kernel == "flash_attention":
        k = rest[0]
        return (kernel, str(x.dtype), *x.shape, k.shape[1], k.shape[2],
                bool(kw.get("causal", True)))
    if kernel == "paged_attention":
        pool, tables = rest[0], rest[2]
        key = (kernel, str(x.dtype), *x.shape, str(pool.dtype),
               *pool.shape[1:3], tables.shape[1],
               str(kw.get("dequant_dtype")))
        first, count = kw.get("kv_start", 0), kw.get("kv_count")
        if first or (count is not None and count != pool.shape[2]):
            key += (first, pool.shape[2] - first if count is None else count)
        return key
    if kernel == "dot_moa":
        *batch, m, k = x.shape
        n = rest[0].shape[-1]
        key = (kernel, str(x.dtype), m, k, n, min(int(kw["block_k"]), k),
               int(kw.get("approx_bits", 0)))
        out = str(kw.get("out_dtype") or x.dtype).replace("torch.", "")
        default = str(x.dtype if x.dtype.is_floating_point
                      else "int32").replace("torch.", "")
        return key + tuple(batch) + ((out,) if out != default else ())
    if kernel == "moa_reduce":    # the base's alignment picks the instance
        n, f = x.shape
        return (kernel, str(x.dtype), n, f,
                min(int(kw.get("block_n", 512)), n), x.data_ptr() % 16 == 0)
    if kernel == "loa_add":
        return (kernel, x.numel(), int(kw["approx_bits"]))
    if kernel == "loa_reduce":
        n, f = x.shape
        return (kernel, n, f, int(kw.get("block_n", 256)),
                int(kw["approx_bits"]), x.data_ptr() % 16 == 0)
    raise KeyError(kernel)


@contextlib.contextmanager
def partials_route(mr):
    """Plans without the direct route (``DIRECT_ROW_BYTES`` 0) while the
    block runs: a direct row's clusters go through split blocks and the
    ordered fold of their partials instead, for the A/B of the two
    routes."""
    saved = mr.DIRECT_ROW_BYTES
    mr.DIRECT_ROW_BYTES = 0
    mr.plan.cache_clear()
    mr._launch.cache_clear()
    try:
        yield
    finally:
        mr.DIRECT_ROW_BYTES = saved
        mr.plan.cache_clear()
        mr._launch.cache_clear()


@contextlib.contextmanager
def recorded_calls(ops, kernels):
    """Record the ``call_key`` of every launch of ``kernels`` that goes
    through ``ops`` (the dispatch every caller of the port uses) while the
    block runs; the wrappers, and so their launch counts, are unchanged."""
    calls = set()
    saved = {name: getattr(ops, f"{name}_cuda") for name in kernels}

    def recorder(name, fn):
        def call(*args, **kw):
            calls.add(call_key(name, *args, **kw))
            return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(ops, f"{name}_cuda", recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, f"{name}_cuda", fn)


def check(row: dict, key: tuple = None) -> dict:
    """Emit a row; fail if its error is over its tolerance; else record
    ``key`` (its launch's ``call_key``, where the paper path runs the
    kernel) as checked."""
    emit(dict({"phase": "kernels"}, **row))
    if not row["max_abs_err"] <= row["tol"]:
        raise AssertionError(f"{row['kernel']} {row['case']}: max_abs_err "
                             f"{row['max_abs_err']} > tol {row['tol']}")
    if key is not None:
        CHECKED.add(key)
    return row


def dot_moa_vs_parent(row: dict) -> dict:
    """A ``dot_moa`` row with ``vs_parent`` (its device time over the
    parent tree's) where ``--parent`` timed the parent's kernel."""
    if "parent_device_ms" in row:
        row["vs_parent"] = row["device_ms"] / row["parent_device_ms"]
    return row


def plan_info(p) -> dict:
    """The body and grid a ``dot_moa`` plan chose."""
    return {"body": p.body, "tile": [p.tile_m, p.tile_n], "sub": p.sub,
            "splits": p.splits, "blocks": p.blocks,
            "workspace_mb": p.workspace * 4 / 1e6}


def own_kernels(timer, kernel: str) -> dict:
    """The CUDA functions the last timed call launched, with the device ms
    of each per call; fail on one that is not the kernel's own (a library
    product, a copy, a fill)."""
    if timer.foreign:
        raise AssertionError(f"{kernel} launched {timer.foreign}, which are "
                             f"not its own kernels {KERNELS[kernel].symbols}")
    out = {"device_kernels": timer.kernels}
    if timer.memops:
        out["device_memops"] = timer.memops
    return out


def host_path(torch, iters: int = 1000) -> dict:
    """Host time per call of the ``dot_moa`` wrapper and of the MOA
    backend's ``kernel_dot`` under ``torch.no_grad()`` (as the engine calls
    it), at the decode shape 4 x 4096 @ 4096 x 1024 bf16: the host clock
    over ``iters`` enqueued calls, then one synchronise (``wall``)."""
    from repro_torch.kernels import dot_moa as dm
    from repro_torch.moa import backends

    g = torch.Generator(device="cuda").manual_seed(2)
    a = torch.randn((4, 4096), device="cuda", generator=g).bfloat16()
    b = (torch.randn((4096, 1024), device="cuda", generator=g)
         * 4096 ** -0.5).bfloat16()
    calls = {"dot_moa_cuda": lambda: dm.dot_moa_cuda(a, b, block_k=2048),
             "kernel_dot": lambda: backends.kernel_dot(
                 a, b, block_k=2048, out_dtype=torch.bfloat16)}
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out[name] = {"host_us_per_call": (t1 - t0) / iters * 1e6,
                         "wall_us_per_call": (t2 - t0) / iters * 1e6}
    return out


def kernel_phase(torch, timer, parent=None):
    """The served path's kernels against their plain versions; ``parent``:
    the parent tree's wrappers by kernel (``--parent``), timed beside each
    ``dot_moa`` and paged row. Returns the summary row of each kernel."""
    from repro_torch.kernels import dot_moa as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    F = torch.nn.functional
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    summary = {}        # kernel -> the row at the served model's main shape
    parent = parent or {}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(dtype)

    def randint8(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=g,
                             dtype=torch.int32).to(torch.int8)

    def err(got, want):
        return float((got.double() - want.double()).abs().max())

    # ---- dot_moa: every projection of the served model -------------------
    block_k = 2048                # min(chunk=4096, the Pallas cap 2048)
    # m = 4: decode; 16: the speculative verify (4 slots x k + 1 = 4);
    # 64: a prefill; 256: a prefill chunk (the slo phase's)
    cases = [(m, k, n, block_k, torch.bfloat16, 0)
             for m in (4, 16, 64, 256)
             for k, n in ((4096, 6144), (4096, 4096), (4096, 1024),
                          (4096, 14336), (14336, 4096))]
    cases += [(64, k, n, block_k, torch.int8, l)
              for l in (0, 4)
              for k, n in ((4096, 6144), (4096, 4096), (4096, 14336),
                           (14336, 4096))]
    # zamba2-1.2b's shared block (d_model 2048, d_ff 8192): q / k / v / o
    # (one 2048 slice), gate / up and down (four slices) at its decode
    # (4), verify (16), a ragged exact-length prefill (37) and a prefill
    # (64)
    cases += [(m, k, n, block_k, torch.bfloat16, 0)
              for m in (4, 16, 37, 64)
              for k, n in ((2048, 2048), (2048, 8192), (8192, 2048))]
    cases += [(37, 1000, 333, 256, torch.float32, 0),
              (37, 1000, 333, 256, torch.bfloat16, 0),
              (37, 1000, 333, 256, torch.int8, 0),
              (37, 1024, 333, 256, torch.int8, 4)]
    # the bodies' edges (kernels/dot_moa.py: plan): B is streamed while m
    # rows fit one row group (m <= 16 f32 / int32, 8 bf16, 4 int8); above,
    # the tensor cores (bf16, int8) or the tiled CUDA-core body (f32,
    # int32); the prefill down-projection is among the m = 64 rows
    cases += [(m, 4096, 14336, block_k, torch.bfloat16, 0)
              for m in (1, 8, 9, 17)]
    # the train runs' projections (forward and remat recompute):
    # llama3-8b's four shapes at m = 4096 (8 sequences of 512 tokens),
    # moonshot's attention at m = 1024 (4 of 256); the families phase's
    # hubert-xlarge (4096), llava-next-34b (5120: 2 x (2304 + 256)) and
    # zamba2-1.2b's shared block (4096)
    cases += [(m, k, n, block_k, torch.bfloat16, 0)
              for arch in TRAIN_RUNS for m, k, n in train_projections(arch)]
    # the families phase's served runs: hubert-xlarge's encode (m = 4000:
    # 4 x 1000 frames), llava-next-34b's prefill (4736: 2 x (2304 + 64))
    # and decode (2)
    cases += [(m, k, n, block_k, torch.bfloat16, 0)
              for arch, ms in FAMILY_SERVED_M.items() for m in ms
              for _, k, n in projections(arch, m)]
    # a ragged k whose block_k (1000) is not a multiple of the sub-range
    cases += [(m, 5000, 4096, 1000, torch.bfloat16, 0) for m in (4, 64)]
    # int8 at block_k 256, l = 4: 16 LOA folds, on both int8 bodies
    cases += [(m, 4096, 4096, 256, torch.int8, 4) for m in (4, 16, 64)]
    # float32 compute (the parity phase's decode and prefill shapes) and
    # every other instance: stream rows per block 4 / 8 / 16, int32
    cases += [(4, 4096, 4096, block_k, torch.float32, 0),
              (16, 4096, 4096, block_k, torch.float32, 0),
              (64, 4096, 14336, block_k, torch.float32, 0),
              (8, 1000, 333, 256, torch.float32, 0),
              (3, 1000, 333, 256, torch.int32, 0),
              (8, 1024, 256, 256, torch.int32, 2),
              (16, 2048, 1024, 512, torch.int32, 4)]
    names = {torch.bfloat16: "bfloat16", torch.float32: "float32",
             torch.int8: "int8", torch.int32: "int32"}
    for m, k, n, bk, dt, l in cases:
        if dt == torch.int8:
            a, b = randint8(m, k), randint8(k, n)
        elif dt == torch.int32:
            a = torch.randint(-1000, 1000, (m, k), device=dev, generator=g,
                              dtype=torch.int32)
            b = torch.randint(-1000, 1000, (k, n), device=dev, generator=g,
                              dtype=torch.int32)
        else:
            a, b = randn(m, k, dtype=dt), randn(k, n, scale=k ** -0.5,
                                                dtype=dt)
        run = lambda: dm.dot_moa_cuda(a, b, block_k=bk, approx_bits=l)
        plain = lambda: ref.dot_moa_ref(a, b, block_k=bk, approx_bits=l)
        got, want = run(), plain()
        torch.cuda.synchronize()
        item = a.element_size()
        name = names[dt]
        b_ms, b_by = bound((m * k + k * n) * item + m * n
                           * got.element_size(), 2.0 * m * k * n, name)
        if not dt.is_floating_point:
            tol, why = 0.0, ("integer accumulation is exact: int32 K-block "
                             "partials, folded by + or the LOA combine")
        elif dt == torch.bfloat16:
            tol = bf16_ulp(float(want.float().abs().max()))
            why = ("1 bf16 ulp at max|ref|: both accumulate in f32 in "
                   "different orders, then round once to bf16")
        else:
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            why = "f32 reassociation of the K sum, relative 1e-5"
        # the library call that computes the same function: torch.matmul
        # for floats; for exact int8 (l=0) torch._int_mm, an int32 product
        # (needs m > 16 and k, n multiples of 8); none for LOA
        library = None
        if dt.is_floating_point:
            library = lambda: torch.matmul(a, b)
        elif (dt == torch.int8 and l == 0 and m > 16 and k % 8 == 0
              and n % 8 == 0):
            library = lambda: torch._int_mm(a, b)
            if not torch.equal(library(), want):
                raise AssertionError(f"torch._int_mm != dot_moa_ref at "
                                     f"{m}x{k}x{n}")
        p = dm.plan(m, n, k, min(bk, k), dt)
        row = check(dot_moa_vs_parent({
            "kernel": "dot_moa", "case": f"{name} l={l}",
            "shape": {"m": m, "k": k, "n": n, "block_k": bk},
            "plan": plan_info(p),
            "max_abs_err": err(got, want), "tol": tol, "tol_reason": why,
            "kernel_ms": timer(run),
            "device_ms": timer.device(run, "dot_moa"),
            **own_kernels(timer, "dot_moa"),
            "plain_ms": timer(plain, 5),
            "library_ms": timer.device(library) if library else None,
            "bound_ms": b_ms, "bound_by": b_by,
            **beside_parent(timer, parent, "dot_moa", lambda f: f(
                a, b, block_k=bk, approx_bits=l), want, err),
        }), call_key("dot_moa", a, b, block_k=bk, approx_bits=l))
        if (m, k, n, dt) == (4, 4096, 14336, torch.bfloat16):
            summary["dot_moa"] = row          # decode's w_gate / w_up

    # ---- flash attention: prefill's causal softmax·V ----------------------
    # llama3-8b's served prefills (H32/8, prompts padded to the buckets 16 /
    # 32 / 64 / 96), S = 512 and 2048, a ragged 100; moonshot's (H16/16,
    # G 1, exact-length prompts of 16-64 tokens); f32 rows for the parity
    # phase's f32 compute and a full (non-causal) Sq != Skv edge
    cases = [(1, s, s, 32, 8, 128, torch.bfloat16, True)
             for s in (16, 32, 64, 96, 100, 512, 2048)]
    cases += [(1, s, s, 16, 16, 128, torch.bfloat16, True)
              for s in (16, 26, 44, 64)]
    # zamba2-1.2b's shared block (H32/32, head_dim 64): its exact-length
    # prefills (a ragged 37 among them), S = 512, and the 1024-token
    # one-shot prefill of the hybrid phase's chunked check
    cases += [(1, s, s, 32, 32, 64, torch.bfloat16, True)
              for s in (16, 37, 64, 512, 1024)]
    cases += [(2, 100, 100, 4, 2, 64, torch.float32, True),
              (2, 37, 53, 4, 2, 64, torch.float32, False)]
    # the families phase: hubert-xlarge's encode (bidirectional, H16/16,
    # head_dim 80, 4 x 1000 frames) and llava-next-34b's prefill (causal,
    # H56/8: a group of 7, 2 x 2368 tokens, not a multiple of 64)
    cases += [(4, 1000, 1000, 16, 16, 80, torch.bfloat16, False),
              (2, 2368, 2368, 56, 8, 128, torch.bfloat16, True)]
    for B, Sq, Skv, H, Hk, D, dt, causal in cases:
        q = randn(B, Sq, H, D, dtype=dt)
        k, v = randn(B, Skv, Hk, D, dtype=dt), randn(B, Skv, Hk, D, dtype=dt)
        run = lambda: fa.flash_attention_cuda(q, k, v, causal=causal)
        plain = lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                q_chunk=256, kv_chunk=512)
        got, want = run(), plain()
        if not torch.equal(run(), got):
            raise AssertionError("flash_attention: two calls gave other bits")
        torch.cuda.synchronize()
        pairs = (sum(min(i + 1, Skv) for i in range(Sq)) if causal
                 else Sq * Skv)
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        b_ms, b_by = bound((2 * B * Sq * H + 2 * B * Skv * Hk) * D
                           * q.element_size(), 4.0 * B * H * D * pairs, name)
        if dt == torch.bfloat16:
            tol = bf16_ulp(float(want.float().abs().max()))
            why = ("1 bf16 ulp at max|ref|: f32 online softmax in both, "
                   "other tile orders, p rounded to bf16 for p·v in the "
                   "kernel, one rounding to bf16")
        else:
            tol, why = 1e-5, "f32 reassociation of dot products and sums"
        # SDPA computes the same function (causal: top-left aligned, as
        # here, Sq == Skv); its device time is the yardstick
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = timer.device(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        p = fa.plan(B, Sq, Skv, H, Hk, D, dt, causal)
        row = check({
            "kernel": "flash_attention",
            "case": f"{name} {'causal' if causal else 'full'}",
            "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "Hk": Hk,
                      "D": D},
            "plan": {"body": p.body, "tile": [p.block_q, p.block_kv],
                     "blocks": p.blocks, "smem_kb": p.smem / 1024},
            "max_abs_err": err(got, want), "tol": tol, "tol_reason": why,
            "kernel_ms": timer(run),
            "device_ms": timer.device(run, "flash_attention"),
            **own_kernels(timer, "flash_attention"),
            "plain_ms": timer(plain, 5),
            "library_ms": lib, "library": "scaled_dot_product_attention",
            "bound_ms": b_ms, "bound_by": b_by,
        }, call_key("flash_attention", q, k, v, causal=causal))
        if (Sq, dt) == (512, torch.bfloat16):     # llama3-8b's, the first
            summary.setdefault("flash_attention", row)

    # ---- paged attention: decode over block tables ------------------------
    # the served decode (depths 5..511), the same with an int8 pool, long
    # context (depths to 4095, and 16 slots to 8191), the verify shape (T 4
    # over ~2-4k tokens) and an f32 instance; H32/8 D128 bs16 unless said;
    # moonshot's served decode (H16/16: G 1, one query row of a tile; its
    # depths 16..79 at max_len 96), bf16 and int8 pools;
    # two edges: rows of 384 and 144 bytes (copied in 16-byte chunks that
    # do not divide a warp), G 3, and 16 query rows of a head_dim that
    # takes two 8-row tiles
    long = (1023, 2047, 3071, 4095)
    cases = [(4, 1, 32, 8, 128, 16, (5, 70, 200, 511), torch.bfloat16,
              torch.bfloat16),
             (4, 1, 32, 8, 128, 16, (5, 70, 200, 511), torch.bfloat16,
              torch.int8),
             (4, 1, 16, 16, 128, 16, (16, 37, 58, 79), torch.bfloat16,
              torch.bfloat16),
             (4, 1, 16, 16, 128, 16, (16, 37, 58, 79), torch.bfloat16,
              torch.int8),
             (4, 1, 32, 32, 64, 16, (5, 70, 200, 511), torch.bfloat16,
              torch.bfloat16),
             (4, 4, 4, 2, 64, 16, (0, 13, 40, 60), torch.float32,
              torch.float32),
             (4, 1, 32, 8, 128, 16, long, torch.bfloat16, torch.bfloat16),
             (4, 1, 32, 8, 128, 16, long, torch.bfloat16, torch.int8),
             (16, 1, 32, 8, 128, 16, (2047, 4095, 6143, 8191) * 4,
              torch.bfloat16, torch.bfloat16),
             (4, 4, 32, 8, 128, 16, (2044, 2732, 3412, 4092), torch.bfloat16,
              torch.bfloat16),
             (2, 2, 12, 4, 96, 16, (100, 700), torch.bfloat16, torch.float32),
             (2, 4, 16, 4, 36, 8, (10, 60), torch.float32, torch.float32)]
    # the served verify (the spec phase: 4 slots, k = 3, max_len 96) at
    # each of its live-block buckets 1, 2, 4 and 6 (the table's width),
    # bf16 and int8 pools; the bucket is given, not rounded up
    for n_blocks, starts in VERIFY_BUCKETS.items():
        for pdt in (torch.bfloat16, torch.int8):
            cases.append((4, 4, 32, 8, 128, 16, starts, torch.bfloat16,
                          pdt, n_blocks))
    # a long max_len (4096: a 256-block table) with short contexts (8, 16
    # and 32 live blocks): the kernel plans the split for the whole table,
    # as the engine now calls it; ``cut_device_ms`` is the same kernel on
    # the table cut to the live-block bucket, planned for that width (and
    # under --parent the parent's kernel runs on the cut table, as the
    # parent's engine called it)
    for starts in ((60, 90, 110, 127), (130, 200, 240, 255),
                   (300, 400, 480, 511)):
        cases.append((4, 1, 32, 8, 128, 16, starts, torch.bfloat16,
                      torch.bfloat16, 256, True))
    for B, T, H, Hk, D, bs, starts, qdt, pdt, *given in cases:
        n_blocks = (max(starts) + T - 1) // bs + 1
        n_blocks = 1 << (n_blocks - 1).bit_length()   # a live-block bucket
        cut = n_blocks if given[1:] == [True] else None
        if given:
            n_blocks = given[0]
        n_phys = 2 + B * n_blocks       # trash page 0, poison page last
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        tables = torch.zeros((B, n_blocks), dtype=torch.int32, device=dev)
        for i, s in enumerate(starts):
            live = (s + T - 1) // bs + 1
            tables[i, :live] = 1 + i * n_blocks + torch.arange(live,
                                                               device=dev)
        q = randn(B, T, H, D, dtype=qdt)
        scales = {}
        if pdt == torch.int8:
            kp, vp = randint8(n_phys, bs, Hk, D), randint8(n_phys, bs, Hk, D)
            scales = {"k_scale": torch.rand((n_phys, bs, Hk), device=dev,
                                            generator=g) * 0.02,
                      "v_scale": torch.rand((n_phys, bs, Hk), device=dev,
                                            generator=g) * 0.02}
        else:
            kp, vp = randn(n_phys, bs, Hk, D, dtype=pdt), \
                randn(n_phys, bs, Hk, D, dtype=pdt)
        run = lambda: pa.paged_attention_cuda(q, kp, vp, tables, start,
                                              dequant_dtype=qdt, **scales)
        plain = lambda: ref.paged_attention_ref(q, kp, vp, tables, start,
                                                dequant_dtype=qdt, **scales)
        got, want = run(), plain()
        if not torch.equal(run(), got):
            raise AssertionError("paged_attention: two calls gave other bits")
        # pages past a slot's deepest query must never be read: point the
        # dead table entries at a page of NaNs (an int8 pool: NaN scales)
        # and expect the same bits
        if pdt == torch.int8:
            scales["k_scale"][-1] = scales["v_scale"][-1] = float("nan")
        else:
            kp[-1], vp[-1] = float("nan"), float("nan")
        poisoned = torch.where(tables == 0, n_phys - 1, tables)
        if not torch.equal(pa.paged_attention_cuda(
                q, kp, vp, poisoned, start, dequant_dtype=qdt, **scales),
                got):
            raise AssertionError("paged_attention read a dead page")
        torch.cuda.synchronize()
        tokens = sum(s + T for s in starts)
        kv_bytes = tokens * Hk * D * 2 * kp.element_size() + (
            tokens * Hk * 2 * 4 if scales else 0)
        ops = sum(4.0 * H * D * (s + t + 1) for s in starts for t in range(T))
        name = "float32" if qdt == torch.float32 else "bfloat16"
        b_ms, b_by = bound(kv_bytes + 2 * q.numel() * q.element_size()
                           + tables.numel() * 4 + B * 4, ops, name)
        if qdt == torch.bfloat16:
            tol = bf16_ulp(float(want.float().abs().max()))
            why = ("1 bf16 ulp at max|ref|: the same dequantized KV, f32 "
                   "split online vs one-shot softmax, one rounding to bf16")
        else:
            tol = 1e-5
            why = "f32 split online vs one-shot softmax reassociation"
        p = pa.plan(B, T, H, Hk, D, bs, n_blocks, pdt)
        row = {
            "kernel": "paged_attention",
            "case": f"pool={str(pdt)[6:]} T={T}",
            "shape": {"B": B, "T": T, "H": H, "Hk": Hk, "D": D, "bs": bs,
                      "n_blocks": n_blocks, "start": list(starts)},
            "plan": {"splits": p.splits, "pages": p.pages,
                     "warps": p.warps, "stages": p.stages, "rows": p.rows,
                     "cols": p.cols, "blocks": p.blocks,
                     "blocks_per_sm": p.blocks_per_sm,
                     "smem_kb": p.smem / 1024,
                     "workspace_mb": p.workspace / 1e6},
            "max_abs_err": err(got, want), "tol": tol, "tol_reason": why,
            "kernel_ms": timer(run),
            "device_ms": timer.device(run, "paged_attention"),
            **own_kernels(timer, "paged_attention"),
            "plain_ms": timer(plain, 5),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        }
        parent_tables = tables
        if cut is not None:
            parent_tables = tables[:, :cut].contiguous()
            run_cut = lambda: pa.paged_attention_cuda(
                q, kp, vp, parent_tables, start, dequant_dtype=qdt, **scales)
            pc = pa.plan(B, T, H, Hk, D, bs, cut, pdt)
            row.update({"cut_blocks": cut, "cut_splits": pc.splits,
                        "cut_max_abs_err": err(run_cut(), want),
                        "cut_device_ms": timer.device(run_cut,
                                                      "paged_attention")})
            if not row["cut_max_abs_err"] <= tol:
                raise AssertionError(f"paged_attention on a table cut to "
                                     f"{cut} blocks: {row['cut_max_abs_err']}"
                                     f" > tol {tol}")
        row.update(beside_parent(timer, parent, "paged_attention", lambda f: f(
            q, kp, vp, parent_tables, start, dequant_dtype=qdt, **scales),
            want, err))
        check(row, call_key("paged_attention", q, kp, vp, tables, start,
                            dequant_dtype=qdt, **scales))
        summary.setdefault("paged_attention", row)   # the served decode
        if given and n_blocks == max(VERIFY_BUCKETS) \
                and pdt == torch.bfloat16:
            summary["paged_attention verify"] = row
    dense_slot_rows(torch, timer, randn, err)
    return summary


#: dense-slot decodes walked as pages (``B, H, Hk, D, max_len, starts``):
#: zamba2-1.2b's served decode (H32/32, max_len 512), and llava-next-34b's
#: 16 decode steps after its 2 x 2368-token prefill (H56/8: a group of 7,
#: two 4-row tiles; max_len 2384, 149 pages)
DENSE_SLOT_ROWS = [(4, 32, 32, 64, 512, (5, 70, 200, 511)),
                   (2, 56, 8, 128, 2384, (2368, 2383))]


def dense_slot_rows(torch, timer, randn, err) -> None:
    """Each of ``DENSE_SLOT_ROWS``: a dense-slot decode (T1, bf16, the
    cache walked as 16-token pages through the identity block table,
    ``attention.dense_attention``) against the plain version over the same
    rows (``full_attention``, ``kv_len = start + 1``): a same-bits rerun,
    and the cache's pages past each slot's deepest query poisoned with NaN
    must give the same bits."""
    from repro_torch.layers import attention as A
    from repro_torch.kernels import ops

    for B, H, Hk, D, max_len, starts in DENSE_SLOT_ROWS:
        cache = {"k": randn(B, max_len, Hk, D, dtype=torch.bfloat16),
                 "v": randn(B, max_len, Hk, D, dtype=torch.bfloat16)}
        q = randn(B, 1, H, D, dtype=torch.bfloat16)
        start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        run = lambda: A.dense_attention(q, cache, start,
                                        compute_dtype=torch.bfloat16)
        plain = lambda: A.full_attention(q, cache["k"], cache["v"],
                                         causal=False, kv_len=start + 1)
        before = ops.launch_counts()["paged_attention"]
        with recorded_calls(ops, ["paged_attention"]) as calls:
            got, want = run(), plain()
        if ops.launch_counts()["paged_attention"] != before + 1:
            raise AssertionError("dense_attention did not launch "
                                 "paged_attention")
        (key,) = calls                  # the launch as the model makes it
        if not torch.equal(run(), got):
            raise AssertionError("dense-slot paged_attention: two calls "
                                 "gave other bits")
        for b, s in enumerate(starts):
            first_dead = (s // A.DENSE_PAGE + 1) * A.DENSE_PAGE
            cache["k"][b, first_dead:] = float("nan")
            cache["v"][b, first_dead:] = float("nan")
        if not torch.equal(run(), got):
            raise AssertionError("dense-slot paged_attention read a dead "
                                 "page")
        torch.cuda.synchronize()
        tokens = sum(s + 1 for s in starts)
        b_ms, b_by = bound(tokens * Hk * D * 2 * 2 + 2 * q.numel() * 2
                           + B * 4, sum(4.0 * H * D * (s + 1)
                                        for s in starts), "bfloat16")
        tol = bf16_ulp(float(want.float().abs().max()))
        check({
            "kernel": "paged_attention",
            "case": "dense-slot pool=bfloat16 T=1",
            "shape": {"B": B, "T": 1, "H": H, "Hk": Hk, "D": D,
                      "bs": A.DENSE_PAGE, "max_len": max_len,
                      "start": list(starts)},
            "max_abs_err": err(got, want), "tol": tol,
            "tol_reason": "1 bf16 ulp at max|ref|: f32 split online vs "
                          "one-shot softmax, one rounding to bf16",
            "kernel_ms": timer(run),
            "device_ms": timer.device(run, "paged_attention"),
            **own_kernels(timer, "paged_attention"),
            "plain_ms": timer(plain, 5), "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by}, key)


def moe_kernel_phase(torch, timer):
    """moonshot-v1-16b-a3b's served and trained kernel calls against their
    plain versions: the batched expert projections (64 experts, d_model
    2048, d_ff 1408; capacity C rows an expert: 1 at 4 decode slots, 60 in
    a 512-token prefill, ragged 4 and 5 of short exact-length prefills,
    and the train step's, :func:`train_moe_shapes`), the router (bf16
    operands, f32 logits) and the top-6 combine, each also at the train
    step's tokens. Each batched row also holds the launch bit for bit to a
    member-by-member loop under the same plan (``plan_batch``), and times
    ``torch.bmm`` on the same operands. Every row records its launch's
    ``call_key`` as checked. Returns the summary rows (the served combine,
    and the decode gate/up row as ``dot_moa batched``)."""
    from repro_torch.kernels import dot_moa as dm
    from repro_torch.kernels import moa_reduce as mr
    from repro_torch.kernels import ref

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(
            torch.bfloat16)

    def err(got, want):
        return float((got.double() - want.double()).abs().max())

    E, d, f = 64, 2048, 1408
    train = train_moe_shapes("moonshot-v1-16b-a3b")
    cases = [(c, k, n) for c in (1, 60, 4, 5, train["rows"])
             for k, n in ((d, f), (f, d))]
    for c, k, n in cases:
        a, w = randn(E, c, k), randn(E, k, n, scale=k ** -0.5)
        bk = min(2048, k)          # serial?chunk=4096 at the 2048 cap
        run = lambda: dm.dot_moa_cuda(a, w, block_k=bk)
        plain = lambda: ref.dot_moa_batched_ref(a, w, block_k=bk)
        got, want = run(), plain()
        loop = torch.stack([dm.dot_moa_cuda(a[e], w[e], block_k=bk,
                                            plan_batch=E) for e in range(E)])
        torch.cuda.synchronize()
        same = torch.equal(got, loop)
        p = dm.plan(c, n, k, bk, torch.bfloat16, E)
        b_ms, b_by = bound(2 * E * (c * k + k * n + c * n),
                           2.0 * E * c * k * n, "bfloat16")
        row = check({
            "kernel": "dot_moa", "case": "bfloat16 batched",
            "where": f"moonshot experts, C={c}",
            "shape": {"batch": E, "m": c, "k": k, "n": n, "block_k": bk},
            "plan": plan_info(p),
            "max_abs_err": err(got, want),
            "tol": bf16_ulp(float(want.float().abs().max())),
            "tol_reason": "1 bf16 ulp at max|ref|: both accumulate in f32 "
                          "in different orders, then round once to bf16",
            "same_bits_as_member_loop": same,
            "kernel_ms": timer(run),
            "device_ms": timer.device(run, "dot_moa"),
            **own_kernels(timer, "dot_moa"),
            "plain_ms": timer(plain, 2),
            "library_ms": timer.device(lambda: torch.bmm(a, w)),
            "library": "torch.bmm",
            "bound_ms": b_ms, "bound_by": b_by},
            call_key("dot_moa", a, w, block_k=bk))
        if not same:
            raise AssertionError(f"batched dot_moa C={c} {k}x{n}: differs "
                                 "from its member-by-member loop")
        if (c, k, n) == (1, d, f):
            out["dot_moa batched"] = row

    # the router: (tokens, 2048) @ (2048, 64), bf16 operands, f32 logits
    for t in (4, 512, train["tokens"]):
        a, w = randn(t, d), randn(d, E, scale=d ** -0.5)
        run = lambda: dm.dot_moa_cuda(a, w, block_k=2048,
                                      out_dtype=torch.float32)
        plain = lambda: ref.dot_moa_ref(a, w, block_k=2048,
                                        out_dtype=torch.float32)
        got, want = run(), plain()
        torch.cuda.synchronize()
        b_ms, b_by = bound(2 * (t * d + d * E) + 4 * t * E,
                           2.0 * t * d * E, "bfloat16")
        check({"kernel": "dot_moa", "case": "bfloat16 -> float32",
               "where": "moonshot router",
               "shape": {"m": t, "k": d, "n": E, "block_k": 2048},
               "plan": plan_info(dm.plan(t, E, d, 2048, torch.bfloat16)),
               "max_abs_err": err(got, want),
               "tol": 1e-5 * max(1.0, float(want.abs().max())),
               "tol_reason": "f32 reassociation of the K sum, relative 1e-5",
               "kernel_ms": timer(run),
               "device_ms": timer.device(run, "dot_moa"),
               **own_kernels(timer, "dot_moa"),
               "plain_ms": timer(plain, 5),
               "library_ms": timer.device(lambda: torch.mm(
                   a, w, out_dtype=torch.float32)),
               "library": "torch.mm(out_dtype=float32)",
               "bound_ms": b_ms, "bound_by": b_by},
              call_key("dot_moa", a, w, block_k=2048,
                       out_dtype=torch.float32))

    # the top-6 combine: strat.sum(weighted, axis=2) flattens (G, tg, 6, d)
    # to (6, tg * d), one cluster of 6 rows (block_n = min(4096, 6))
    for t in (4, 40, 512, train["tokens"]):
        x = randn(6, t * d)
        run = lambda: mr.moa_reduce_cuda(x, block_n=4096)
        plain = lambda: ref.moa_reduce_ref(x, block_n=4096)
        got, want = run(), plain()
        again = run()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("moa_reduce: two calls gave other bits")
        p = mr.plan(6, t * d, 6, torch.bfloat16, 0, x.data_ptr() % 16 == 0)
        b_ms, b_by = bound(2 * x.numel() + 4 * t * d, float(x.numel()),
                           "float32")
        row = check({
            "kernel": "moa_reduce", "case": "bfloat16 block_n=6",
            "where": f"moonshot top-6 combine, {t} tokens",
            "shape": {"n": 6, "f": t * d, "block_n": 6},
            "plan": {"route": p.route, "direct": p.direct, "splits":
                     p.splits, "blocks": p.blocks},
            "max_abs_err": err(got, want),
            "tol": 1e-4 + 1e-5 * float(want.abs().max()),
            "tol_reason": "f32 reassociation inside the cluster: atol 1e-4 "
                          "+ rtol 1e-5 of max|ref|, as tests/test_kernels.py",
            "same_bits": True, "kernel_ms": timer(run),
            "device_ms": timer.device(run, "moa_reduce"),
            **own_kernels(timer, "moa_reduce"),
            "plain_ms": timer(plain, 5),
            "library_ms": timer.device(lambda: torch.sum(
                x, dim=0, dtype=torch.float32)),
            "library": "torch.sum(x, 0) in f32",
            "bound_ms": b_ms, "bound_by": b_by},
            call_key("moa_reduce", x, block_n=4096))
        if t == 4:
            out["moa_reduce"] = row
    return out


def paper_kernel_phase(torch, timer, parent=None):
    """The paper path's kernels against their plain versions: rows of the
    kernels phase; ``parent``: the parent tree's wrappers by kernel
    (``--parent``), timed beside each ``dot_moa`` and reduction row.
    Returns the summary row of each kernel."""
    from repro_torch.kernels import dot_moa as dm
    from repro_torch.kernels import loa_add as la
    from repro_torch.kernels import moa_reduce as mr
    from repro_torch.kernels import ref

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    summary = {}
    parent = parent or {}

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, device=dev, generator=g,
                             dtype=torch.int32)

    def err(got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            return math.inf
        return float((got.double() - want.double()).abs().max())

    exact_why = ("integer arithmetic is exact: int32 sums wrap modulo 2**32 "
                 "in both, the LOA folds in the same order")

    def exact_adder(l, call, fn):
        """The exact adder's time: the library call of an LOA kernel at
        l = 0, where it computes the same function; at l > 0 there is none,
        and it is the paper's exact-adder comparison."""
        if l == 0:
            return {"library_ms": timer.device(fn), "library": call}
        return {"library_ms": None, "exact_adder_ms": timer.device(fn),
                "library": f"none (LOA); exact_adder_ms is {call}, the "
                           f"paper's exact-adder comparison"}

    # ---- dot_moa: every contraction of the paper path --------------------
    # (m, k, n, block_k, approx_bits, operands, where the path launches it).
    # int32 operands: unsigned 8-bit activations and 4-bit weights, as the
    # LOA conv quantizes them; float32: unit normals against k**-0.5
    # normals. block_k is the strategy's: tree min(k, 2048), serial
    # min(chunk, 2048), LOA chunk=256 where it divides k, else k.
    conv3 = (2704, 2304, 384)      # AlexNet conv3 at batch 16: 16*13*13
    cases = [(*conv3, 256, l, "q8x4", "LOA conv, conv3") for l in (0, 2, 4, 6)]
    cases += [(*conv3, 2048, 0, "q8x4", "exact (tree) conv, conv3")]
    cases += [(144, 75, 8, 75, l, "q8x4", "LOA conv, paper example 16x16x3")
              for l in (0, 2, 4, 6)]
    cases += [(64, 512, 64, 256, l, "u3", "strategy sweep, loa")
              for l in (0, 4)]
    cases += [(256, 4096, 256, bk, 0, "f32", "strategy sweep, tree/serial")
              for bk in (2048, 1024, 512, 256)]
    cases += [(48400, 363, 96, bk, 0, "f32", "AlexNet conv1, batch 16")
              for bk in (363, 256)]
    cases += [(*conv3, bk, 0, "f32", "AlexNet conv3, batch 16")
              for bk in (2048, 256)]
    cases += [(12544, 25, 6, 25, 0, "f32", "LeNet-5 conv1, batch 16"),
              (1600, 150, 16, 150, 0, "f32", "LeNet-5 conv2, batch 16")]
    # the strategy sweep's moa_scope loss line: the smoke llama3-8b's
    # projections (d_model 64, one KV head of 16, d_ff 128) over 4 x 64
    # tokens in bf16, under "tree" (block_k = k) and "serial?chunk=16"
    cases += [(256, k, n, bk, 0, "bf16", "strategy sweep, moa_scope loss")
              for k, n in ((64, 64), (64, 16), (64, 128), (128, 64))
              for bk in (k, 16)]
    # edge cases: full-range int32 products that wrap, and 2**20 * 2**6
    # summed 4096 times = 2**38, which wraps to 0
    cases += [(64, 384, 40, 128, 3, "full", "edge: full-range wrap"),
              (2, 4096, 3, 4096, 0, "2**38", "edge: sum wraps to 0")]
    for m, k, n, bk, l, operands, where in cases:
        if operands in ("f32", "bf16"):
            dt = torch.float32 if operands == "f32" else torch.bfloat16
            a = torch.randn((m, k), device=dev, generator=g).to(dt)
            b = (torch.randn((k, n), device=dev, generator=g)
                 * k ** -0.5).to(dt)
        else:
            (alo, ahi), (blo, bhi) = {
                "q8x4": ((0, 256), (0, 16)), "u3": ((0, 8), (0, 8)),
                "full": ((-2 ** 31, 2 ** 31 - 1),) * 2,
                "2**38": ((2 ** 20, 2 ** 20 + 1), (64, 65))}[operands]
            a, b = randint(alo, ahi, m, k), randint(blo, bhi, k, n)
        run = lambda: dm.dot_moa_cuda(a, b, block_k=bk, approx_bits=l)
        plain = lambda: ref.dot_moa_ref(a, b, block_k=bk, approx_bits=l)
        got, want = run(), plain()
        torch.cuda.synchronize()
        if operands == "2**38" and (want.any() or got.any()):
            raise AssertionError("dot_moa int32: 2**38 must wrap to 0")
        name = {"f32": "float32", "bf16": "bfloat16"}.get(operands, "int32")
        b_ms, b_by = bound(a.element_size() * (m * k + k * n)
                           + got.element_size() * m * n, 2.0 * m * k * n,
                           name)
        if operands == "f32":
            tol = 1e-4 + 1e-5 * float(want.abs().max())
            why = ("f32 reassociation inside the K clusters: atol 1e-4 + "
                   "rtol 1e-5 of max|ref|, as tests/test_kernels.py")
            lib = {"library_ms": timer.device(lambda: torch.matmul(a, b)),
                   "library": "torch.matmul, TF32 off"}
        elif operands == "bf16":
            tol = bf16_ulp(float(want.float().abs().max()))
            why = ("1 bf16 ulp at max|ref|: both accumulate in f32 in "
                   "different orders, then round once to bf16")
            lib = {"library_ms": timer.device(lambda: torch.matmul(a, b)),
                   "library": "torch.matmul"}
        else:
            tol, why = 0.0, exact_why
            lib = {"library_ms": None,
                   "library": "none: PyTorch has no int32 matmul on CUDA"}
        check(dot_moa_vs_parent({
            "kernel": "dot_moa", "case": f"{name} l={l}", "where": where,
            "shape": {"m": m, "k": k, "n": n, "block_k": bk},
            "plan": plan_info(dm.plan(m, n, k, min(bk, k), a.dtype)),
            "max_abs_err": err(got, want), "tol": tol,
            "tol_reason": why, "kernel_ms": timer(run),
            "device_ms": timer.device(run, "dot_moa"),
            **own_kernels(timer, "dot_moa"),
            "plain_ms": timer(plain, 5), **lib,
            "bound_ms": b_ms, "bound_by": b_by,
            **beside_parent(timer, parent, "dot_moa", lambda f: f(
                a, b, block_k=bk, approx_bits=l), want, err)}),
            call_key("dot_moa", a, b, block_k=bk, approx_bits=l))

    # ---- moa_reduce / loa_reduce: one launch on the plan's route ----------
    clock_mhz = sm_max_clock_mhz()

    def reduce_row(kernel, x, bn, l=0, case=None, target=None,
                   plain_iters=5):
        """One reduction row: the kernel against its plain version (and,
        under ``--parent``, the parent tree's kernel beside it), the same
        bits on a second call, the plan, and ``chain_ms`` on the ordered
        route; ``target(row)`` gives the row's time target and whether the
        row met it (a miss is printed, not failed)."""
        n, f = x.shape
        if kernel == "moa_reduce":
            kw = {"block_n": bn}
            accum = torch.float32 if x.dtype.is_floating_point \
                else torch.int32
            lib = {"library_ms": timer.device(
                lambda: torch.sum(x, dim=0, dtype=accum)),
                "library": "torch.sum(x, 0) in the accumulator type"}
            run = lambda: mr.moa_reduce_cuda(x, **kw)
            plain = lambda: ref.moa_reduce_ref(x, **kw)
        else:
            kw = {"approx_bits": l, "block_n": bn}
            lib = exact_adder(l, "torch.sum(x, 0) in int32",
                              lambda: torch.sum(x, dim=0, dtype=torch.int32))
            run = lambda: la.loa_reduce_cuda(x, **kw)
            plain = lambda: ref.loa_reduce_ref(x, **kw)
        got, want = run(), plain()
        again = run()
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"{kernel} {case}: two calls gave other "
                                 "bits")
        aligned = x.data_ptr() % 16 == 0
        p = mr.plan(n, f, min(bn, n), x.dtype, l, aligned)
        if x.dtype.is_floating_point:
            tol = 1e-4 + 1e-5 * float(want.abs().max())
            why = ("f32 reassociation inside the clusters: atol 1e-4 + "
                   "rtol 1e-5 of max|ref|, as tests/test_kernels.py")
        else:
            tol, why = 0.0, exact_why
        b_ms, b_by = bound(x.numel() * x.element_size() + f * 4,
                           float(n * f) + (8.0 * f * (p.n_clusters - 1)
                                           if l else 0.0),
                           "float32" if x.dtype.is_floating_point
                           else "int32_alu")
        row = {"kernel": kernel, "case": case,
               "shape": {"n": n, "f": f, "block_n": bn},
               "plan": {"route": p.route, "direct": p.direct, "vec": p.vec,
                        "tile": [p.tile_v, p.lanes], "cols": p.cols,
                        "splits": p.splits, "spc": p.spc,
                        "seg_rows": p.seg_rows, "blocks": p.blocks,
                        "chunk": p.chunk, "smem_kb": p.smem / 1024,
                        "workspace_kb": p.workspace / 1024},
               "max_abs_err": err(got, want), "tol": tol, "tol_reason": why,
               "same_bits": True, "kernel_ms": timer(run),
               "device_ms": timer.device(run, kernel),
               **own_kernels(timer, kernel),
               "plain_ms": timer(plain, plain_iters), **lib,
               "bound_ms": b_ms, "bound_by": b_by}
        if p.route == "ordered":
            cycles = CHAIN_CYCLES["loa" if l else "add"]
            row.update(chain_ms=p.n_clusters * cycles / (clock_mhz * 1e3),
                       chain_steps=p.n_clusters, chain_cycles=cycles,
                       chain_assumes=CHAIN_ASSUMES["loa" if l else "add"],
                       sm_clock_max_mhz=clock_mhz)
        if p.direct:       # A/B: the same call on the partials route
            with partials_route(mr):
                q = mr.plan(n, f, min(bn, n), x.dtype, l, aligned)
                row.update(partials_plan={
                    "splits": q.splits, "spc": q.spc, "blocks": q.blocks,
                    "chunk": q.chunk, "smem_kb": q.smem / 1024},
                    partials_max_abs_err=err(run(), want),
                    partials_device_ms=timer.device(run, kernel))
            if not row["partials_max_abs_err"] <= tol:
                raise AssertionError(f"{kernel} {case}: the partials route's "
                                     f"error {row['partials_max_abs_err']}")
        row.update(beside_parent(timer, parent, kernel, lambda f: f(x, **kw),
                                 want, err))
        if target is not None:
            row["target"], row["target_met"] = target(row)
        return check(row, call_key(kernel, x, **kw))

    def at_most(ms):
        return lambda r: (f"device_ms <= {ms}", r["device_ms"] <= ms)

    def times_library(k):
        return lambda r: (f"device_ms <= {k} x library_ms",
                          r["device_ms"] <= k * r["library_ms"])

    def share_of_bound(share):
        return lambda r: (f"bound_ms / device_ms >= {share}",
                          r["bound_ms"] / r["device_ms"] >= share)

    # Fig. 4's serialized sum (and the tree's one cluster) at each operand
    # type; the ragged, the int32 and the block_n 1 edges; f of 1 and 2 over
    # several splits (the last block's join is wider than the tile); bf16
    # and int8 rows of no 16-byte pitch (one-word loads); the longest f32
    # fold chain on the direct route, and its word-copy and bf16 instances
    # (each timed beside the partials route); clusters of 240 bytes to 8 KB
    # on the partials route; 268 MB, where bytes set the time; the MoE
    # combine of moonshot-v1-16b-a3b (top_k 6, d_model 2048) at a 512-token
    # prefill
    fast = at_most(0.004)
    cases = [(4096, 256, 512, torch.float32, fast),
             (4096, 256, 4096, torch.float32, fast),
             (4096, 256, 512, torch.bfloat16, fast),
             (4096, 256, 512, torch.int32, fast),
             (4096, 256, 512, torch.int8, fast),
             (777, 130, 64, torch.float32, times_library(1)),
             (513, 129, 100, torch.int32, times_library(1)),
             (70000, 4, 1, torch.int32, lambda r: (
                 "device_ms <= 0.02 and <= 2 x library_ms",
                 r["device_ms"] <= min(0.02, 2 * r["library_ms"]))),
             (4096, 8, 512, "wrap", None),
             (8192, 1, 512, torch.int32, None),
             (4096, 2, 4096, torch.float32, None),
             (1000, 7, 10, torch.bfloat16, None),
             (4096, 12, 512, torch.int8, None),
             (70000, 4, 1, torch.float32, lambda r: (
                 "device_ms <= 3 x chain_ms",
                 r["device_ms"] <= 3 * r["chain_ms"])),
             (4096, 3, 1, torch.float32, None),
             (4096, 8, 1, torch.bfloat16, None),
             (70000, 4, 15, torch.float32, None),
             (16384, 32, 4, torch.float32, None),
             (4096, 256, 8, torch.float32, None),
             (16384, 4096, 512, torch.float32, share_of_bound(0.75)),
             (6, 1048576, 6, torch.bfloat16, lambda r: (
                 "device_ms <= 2 x bound_ms",
                 r["device_ms"] <= 2 * r["bound_ms"]))]
    for n, f, bn, dt, target in cases:
        if dt == "wrap":           # 4096 * 2**20 = 2**32 wraps to 0
            x, dt = torch.full((n, f), 2 ** 20, device=dev,
                               dtype=torch.int32), torch.int32
        elif dt.is_floating_point:
            x = torch.randn((n, f), device=dev, generator=g).to(dt)
        else:
            x = randint(-100, 100, n, f).to(dt)
        row = reduce_row("moa_reduce", x, bn,
                         case=f"{str(dt)[6:]} block_n={bn}", target=target,
                         plain_iters=1 if (n, bn) == (70000, 1) else 5)
        del x
        if (n, f, bn, dt) == (4096, 256, 512, torch.float32):
            summary["moa_reduce"] = row    # Fig. 4's serial?chunk=512

    # ---- loa_add: Fig. 5's element-wise LOA ------------------------------
    cases = [(1 << 16, 4, 0), (1 << 16, 0, 0), (1 << 24, 4, 0),
             (5003, 6, 0), ((1 << 16) + 1, 3, 1)]    # odd length; offset view
    for n, l, off in cases:
        xb, yb = randint(0, 256, n + off), randint(0, 256, n + off)
        x, y = xb[off:], yb[off:]
        run = lambda: la.loa_add_cuda(x, y, approx_bits=l)
        plain = lambda: ref.loa_add_ref(x, y, approx_bits=l)
        got, want = run(), plain()
        torch.cuda.synchronize()
        b_ms, b_by = bound(12.0 * n, 8.0 * n, "int32_alu")
        row = check({
            "kernel": "loa_add", "case": f"l={l}" + (" unaligned" if off
                                                      else ""),
            "shape": {"n": n},
            "max_abs_err": err(got, want), "tol": 0.0,
            "tol_reason": exact_why, "kernel_ms": timer(run),
            "device_ms": timer.device(run, "loa_add"),
            "plain_ms": timer(plain, 5),
            **exact_adder(l, "x + y", lambda: x + y),
            "bound_ms": b_ms, "bound_by": b_by},
            call_key("loa_add", x, y, approx_bits=l))
        if (n, l) == (1 << 16, 4):
            summary["loa_add"] = row       # Fig. 5's timing shape

    # ---- loa_reduce: the LOA MOA of conv3's fan-in (Fig. 5's l sweep) -----
    conv3 = at_most(0.015)
    cases = [(2304, 4096, 256, l, conv3) for l in (4, 2, 6)]
    cases += [(2304, 4096, 256, 0, lambda r: (
        "device_ms <= 0.015 and <= library_ms",
        r["device_ms"] <= min(0.015, r["library_ms"]))),
        (1024, 256, 256, 2, None), (4096, 7, 64, 8, at_most(0.008)),
        (16384, 4096, 256, 4, share_of_bound(0.75))]
    for n, f, bn, l, target in cases:
        x = randint(0, 256, n, f)
        row = reduce_row("loa_reduce", x, bn, l, f"l={l} block_n={bn}",
                         target)
        del x
        if (n, f, l) == (2304, 4096, 4):
            summary["loa_reduce"] = row
    return summary


# ---------------------------------------------------------------------------
# phases 3 and 4: the served model
# ---------------------------------------------------------------------------


def kernel_group(name: str) -> str:
    """The group of a CUDA function in a tick's breakdown: one of the
    port's kernels, a library product (cuBLAS: the unembedding), or the
    rest (PyTorch's elementwise, index, sort and copy kernels: the norms,
    RoPE, the MoE's routing, dispatch and gather)."""
    for kernel, k in KERNELS.items():
        if any(sym in name for sym in k.symbols):
            return kernel
    low = name.lower()
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "library gemm"
    return "other"


def profile_served(torch, engine, requests, label: str = "served",
                   extra: dict = None) -> None:
    """Device time by kernel of the ticks of a served run, each tick under
    its own ``torch.profiler``, against the host clock.

    The run serves ``requests`` again through the tick-level API, so every
    decode tick attends over the depths the workload really reaches. Ticks
    fall into two classes: decode only, and admission (one or more
    prefills, then the decode step). Each class prints one line with its
    mean per tick: host time, kernel time, idle share, the twelve heaviest
    kernels, ``paged_attention``'s device time and share, and for decode
    the attended KV lengths (``prompt + generated`` per live slot) and
    live-block buckets. Lines are named ``{label} decode ticks`` (a
    speculative engine's: ``verify ticks``) and ``{label} admission
    ticks``; the decode line of ``label``
    ``decode_long`` is named ``decode_long``. Each line also gives the
    device ms a tick by :func:`kernel_group` (``groups``) and the items of
    ``extra``. The profiler's own launch overhead is inside the host time;
    its setup and read-out are not. CUDA activity only (as the train
    phase's profiled step): the same kernel events, where recording the
    CPU's ops too held most of a profiled run's host time."""
    from torch.profiler import ProfilerActivity, profile

    classes = {}
    engine.start_run()
    for r in requests:
        engine.submit(r)
    results = []
    while not engine.scheduler.done:
        before = {s: inf.metrics.prompt_tokens + len(inf.generated)
                  for s, inf in engine._inflight.items()}
        hw = engine._live_blocks(1) if engine.paged else 0
        admissions = engine._admissions
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            engine.tick(results)
            torch.cuda.synchronize()
            host_ms = (time.monotonic() - t0) * 1e3
        admitted = engine._admissions - admissions
        step = "verify" if engine.drafter is not None else "decode"
        c = classes.setdefault("admission" if admitted else step, {
            "ticks": 0, "host_ms": 0.0, "device_ms": 0.0, "kernels": {},
            "kv_lens": [], "live_blocks": set(), "live_slots": 0,
            "prefills": 0})
        c["ticks"] += 1
        c["host_ms"] += host_ms
        c["prefills"] += admitted
        if not admitted:
            c["kv_lens"] += before.values()
            c["live_blocks"].add(hw)
            c["live_slots"] += len(before)
        # kernel events only: a CPU op's device time repeats its kernels'
        for key, (dms, dn) in device_events(torch, prof).items():
            ms, n = c["kernels"].get(key, (0.0, 0))
            c["kernels"][key] = (ms + dms, n + dn)
            c["device_ms"] += dms
    engine.finish_run(results)
    for what, c in classes.items():
        n = c["ticks"]
        rows = sorted(c["kernels"].items(), key=lambda kv: -kv[1][0])[:12]
        paged = [(ms, cnt) for k, (ms, cnt) in c["kernels"].items()
                 if any(sym in k
                        for sym in KERNELS["paged_attention"].symbols)]
        paged_ms = sum(ms for ms, _ in paged) / n
        name = (label if (label, what) == ("decode_long", "decode")
                else f"{label} {what} ticks")
        groups = collections.Counter()
        for k, (ms, _) in c["kernels"].items():
            groups[kernel_group(k)] += ms / n
        line = {"phase": "profile", "what": name,
                "cuda_graphs": engine._graphs is not None,
                "ticks": n, "prefills": c["prefills"],
                "prefix_hits": engine._prefix_hits,
                "host_ms": c["host_ms"] / n, "device_ms": c["device_ms"] / n,
                "device_idle_share": max(0.0, 1.0 - c["device_ms"]
                                         / c["host_ms"]),
                "paged_ms": paged_ms,
                "paged_calls": sum(cnt for _, cnt in paged) / n,
                "paged_share": paged_ms / (c["device_ms"] / n),
                "groups": dict(groups),
                "top": [{"name": k[:80], "ms": ms / n, "calls": cnt / n}
                        for k, (ms, cnt) in rows], **(extra or {})}
        if what != "admission":
            line.update(kv_len_min=min(c["kv_lens"]),
                        kv_len_max=max(c["kv_lens"]),
                        kv_len_mean=statistics.mean(c["kv_lens"]),
                        live_slots_mean=c["live_slots"] / n,
                        live_blocks=sorted(c["live_blocks"]))
        emit(line)


def profile_prefill(torch, model, params, n_tokens: int = 512) -> None:
    """Device time by kernel of one ``model.prefill`` of an ``n_tokens``
    prompt (random tokens, seed 3) under ``torch.profiler``, after one
    unprofiled call: flash attention's share of a real prefill."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, model.cfg.vocab, (1, n_tokens), device="cuda",
                         generator=g, dtype=torch.int32)

    def run():
        with torch.no_grad():
            return model.prefill(params, {"tokens": toks}, max_len=n_tokens,
                                 prompt_len=n_tokens)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        host_ms = (time.monotonic() - t0) * 1e3
    kernels = device_events(torch, prof)
    device_ms = sum(ms for ms, _ in kernels.values())
    flash = [(ms, n) for key, (ms, n) in kernels.items()
             if any(sym in key for sym in KERNELS["flash_attention"].symbols)]
    flash_ms = sum(ms for ms, _ in flash)
    emit({"phase": "profile", "what": f"prefill {n_tokens} tokens",
          "n_layers": model.cfg.n_layers, "host_ms": host_ms,
          "device_ms": device_ms, "flash_ms": flash_ms,
          "flash_calls": sum(n for _, n in flash),
          "flash_share": flash_ms / device_ms,
          "top": [{"name": k[:80], "ms": ms, "calls": n} for k, (ms, n)
                  in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]]})


def decode_long(torch, model, params, parent=None) -> None:
    """The ``decode_long`` profile line: one engine at ``max_len`` 4096 with
    4 slots serves 4 seeded greedy requests of 3000-4000 prompt tokens and
    8 new tokens each, every tick profiled (so the decode ticks attend over
    3000-4000 tokens a slot). With ``parent`` (``--parent``) the same
    requests are then served by a fresh engine whose paged attention is the
    parent tree's kernel (``decode_long parent``)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine, poisson_workload

    def workload():
        return poisson_workload(n_requests=4, vocab=model.cfg.vocab,
                                rate_rps=1000.0,
                                prompt_len_range=(3000, 4000),
                                gen_len_range=(8, 8), seed=4)

    def serve(label, cuda_graphs):
        engine = ServeEngine(model, params, n_slots=4, max_len=4096,
                             paged=True, block_size=16, device="cuda",
                             cuda_graphs=cuda_graphs)
        _, warm = engine.run([], warmup=True)
        emit({"phase": "serve", "what": f"{label} warmup",
              "warmup_s": warm["compile_s"], "graphs": warm["graphs"]})
        profile_served(torch, engine, workload(), label=label)
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    serve("decode_long", True)
    if parent is not None:
        # eager: the parent's wrapper keeps its own workspaces, which no
        # graph cache of this tree holds
        own = ops.paged_attention_cuda
        ops.paged_attention_cuda = parent
        try:
            serve("decode_long parent", False)
        finally:
            ops.paged_attention_cuda = own


def workspaces(engine=None) -> dict:
    """The kernels' workspaces now held, by (device, stream, owner): the
    address and size of each tensor; given an ``engine``, only those of
    its graph cache's capture stream, which its graphs bind (an eager
    prefill on the current stream may grow that stream's own)."""
    from repro_torch.kernels import _build

    stream = (engine._graphs._stream.cuda_stream
              if engine is not None and engine._graphs is not None else None)
    return {key: tuple((t.data_ptr(), t.numel()) for t in pair)
            for key, pair in _build._WORKSPACE.items()
            if engine is None or key[1] == stream}


def timed_ticks(engine) -> dict:
    """Wrap ``engine.tick`` to keep each tick's host ms (a tick ends in
    the sampling's copy to the host) by class: ``admission`` (one or more
    prefills, then the decode step) or ``decode``."""
    ticks = {"decode": [], "admission": []}
    tick = engine.tick

    def timed(results):
        admissions, steps = engine._admissions, engine._steps
        t0 = time.monotonic()
        tick(results)
        ms = (time.monotonic() - t0) * 1e3
        if engine._admissions > admissions:
            ticks["admission"].append(ms)
        elif engine._steps > steps:
            ticks["decode"].append(ms)

    engine.tick = timed
    return ticks


def serve_once(torch, engine, requests, *, warmup: bool,
               logits: dict = None) -> dict:
    """Serve ``requests`` on ``engine`` (after its warmup, with
    ``warmup``), with each step's logits recorded into ``logits`` as
    :func:`_replay` does when it is given. Returns the results, report,
    launches, tick host ms (:func:`timed_ticks`), the warmup's report and
    whether a workspace its graphs bind grew after the warmup."""
    from repro_torch.kernels import ops

    warm = engine.run([], warmup=True)[1] if warmup else None
    held = workspaces(engine)
    if logits is not None:
        _replay(torch, engine, logits)
    ticks = timed_ticks(engine)
    ops.reset_launch_counts()
    results, report = engine.run(requests)
    return {"results": results, "report": report, "warm": warm,
            "launches": ops.launch_counts(), "ticks": ticks,
            "grew": workspaces(engine) != held}


def eager_vs_captured(torch, make_engine, workload, *, warmup: bool,
                      what: str, served: list) -> None:
    """Serve ``workload()`` twice in this process: by ``make_engine(False)``
    (every tick eager), then by ``make_engine(True)`` (CUDA graphs, captured
    at warmup, or at each bucket's first tick without ``warmup``), every
    step's logits recorded as :func:`_replay` does. Every request arrives
    at 0, so both engines admit in the same order whatever their speed: the
    same batches, live-block buckets and kernel plans. Fails on a token, a
    logit bit or a launch count that differs, on a served kernel launched
    no time (``served``), and, with ``warmup``, on a kernel workspace that
    grew after the captured engine's warmup. Emits one ``graphs`` line. Returns
    both runs (:func:`serve_once`'s) by path."""
    runs, logits = {}, {}
    for path, cuda_graphs in (("eager", False), ("captured", True)):
        engine = make_engine(cuda_graphs)
        logits[path] = {}
        runs[path] = serve_once(
            torch, engine, [dataclasses.replace(r, arrival_s=0.0)
                            for r in workload()],
            warmup=warmup, logits=logits[path])
        del engine
        gc.collect()
    eager, captured = runs["eager"], runs["captured"]
    tokens = [r.uid for r, c in zip(eager["results"], captured["results"])
              if r.tokens.tolist() != c.tokens.tolist()]
    steps = set(logits["eager"]) | set(logits["captured"])
    differ = sorted(k for k in steps if not (
        k in logits["eager"] and k in logits["captured"]
        and torch.equal(logits["eager"][k], logits["captured"][k])))
    missing = {path: [k for k in served if run["launches"][k] == 0]
               for path, run in runs.items()}
    grew = warmup and captured["grew"]
    emit({"phase": "graphs", "what": what, "warmup": warmup,
          "requests": len(eager["results"]), "logit_steps": len(steps),
          "differing_tokens": tokens, "differing_logits": differ[:10],
          "launches": {p: run["launches"] for p, run in runs.items()},
          "workspace_grew": grew,
          "graphs": captured["report"]["graphs"]})
    if tokens or differ or eager["launches"] != captured["launches"] \
            or grew or any(missing.values()):
        raise AssertionError(
            f"{what}: the captured engine differs from the eager one: "
            f"tokens of {tokens}, logits at {differ[:10]}, launches "
            f"{eager['launches']} / {captured['launches']}, workspace grew "
            f"{grew}, kernels launched no time {missing}")
    return runs


def llama3_full(torch):
    """llama3-8b at full width and depth, bf16 weights from the port's
    initializer, seed 0: ``(cfg, model, params, init_s)``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config("llama3-8b"),
                              param_dtype="bfloat16")
    t0 = time.monotonic()
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    return cfg, model, params, time.monotonic() - t0


def llama3_workload(cfg):
    """The served workload of llama3-8b: 8 Poisson requests at 50 req/s,
    prompts of 16-64 tokens, 8-16 new tokens, seed 0."""
    from repro_torch.serve import poisson_workload

    return poisson_workload(n_requests=8, vocab=cfg.vocab, rate_rps=50.0,
                            prompt_len_range=(16, 64),
                            gen_len_range=(8, 16), seed=0)


def serve_phase(torch, llama3, parent=None):
    from repro_torch.serve import ServeEngine

    cfg, model, params, init_s = llama3

    def engine(cuda_graphs):
        return ServeEngine(model, params, n_slots=4, max_len=96, paged=True,
                           block_size=16, device="cuda",
                           cuda_graphs=cuda_graphs)

    def workload():
        return llama3_workload(cfg)

    served = served_kernels(cfg)
    runs = eager_vs_captured(torch, engine, workload, warmup=True,
                             what="serve", served=served)
    SINGLE_DEVICE["llama3-8b"] = {r.uid: r.tokens.tolist()
                                  for r in runs["eager"]["results"]}
    # the served workload as it arrives, timed: eager, then captured
    runs = {}
    for path, cuda_graphs in (("eager", False), ("captured", True)):
        e = engine(cuda_graphs)
        run = runs[path] = serve_once(torch, e, workload(), warmup=True)
        del e
        gc.collect()
        for req, r in zip(workload(), run["results"]):
            if r.tokens.shape != (req.max_new_tokens,) or not (
                    (r.tokens >= 0) & (r.tokens < cfg.vocab)).all():
                raise AssertionError(f"{path} request {r.uid}: bad tokens "
                                     f"{r.tokens}")
        serve_line(torch, cfg, model, run, path=path, init_s=init_s,
                   layout="paged")
        missing = [k for k in served if run["launches"][k] == 0]
        if missing:
            raise AssertionError(f"the {path} served run launched no "
                                 f"{missing}")
    # fresh engines: the first ones' prefix caches hold every prompt of the
    # workload, which would turn the profiled prefills into prefix hits
    for path, cuda_graphs in (("eager", False), ("captured", True)):
        e = engine(cuda_graphs)
        e.run([], warmup=True)
        profile_served(torch, e, workload(), label=f"served {path}")
        del e
        gc.collect()
    torch.cuda.empty_cache()
    profile_prefill(torch, model, params)
    decode_long(torch, model, params, parent)
    return runs["captured"]["launches"]


def serve_line(torch, cfg, model, run, *, path, init_s, **extra) -> dict:
    """The ``serve`` line of one timed served run (:func:`serve_once`)."""
    report = run["report"]
    line = {"phase": "serve", "path": path, "arch": cfg.name,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "param_dtype": cfg.param_dtype,
            "n_params": model.param_count(), "init_s": init_s,
            "warmup_s": run["warm"]["compile_s"],
            "graphs": run["warm"]["graphs"], "device": report["device"],
            "tok_per_s": report["tok_per_s"], "wall_s": report["wall_s"],
            "ttft_ms": report["ttft_ms"],
            "per_token_ms": report["per_token_ms"],
            "tick_host_ms": {what: {"ticks": len(ms),
                                    "mean": statistics.mean(ms),
                                    "min": min(ms), "max": max(ms)}
                             for what, ms in run["ticks"].items() if ms},
            "decode_steps": report["decode_steps"],
            "total_new_tokens": report["total_new_tokens"],
            "slot_occupancy": report["slot_occupancy"],
            "moa_flops_total": report["moa_flops_total"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "paged": report.get("paged"), "launches": run["launches"],
            "tokens": {r.uid: r.tokens.tolist() for r in run["results"]}}
    line.update(extra)
    emit(line)
    return line


#: a greedy divergence between two bf16 runs that take different
#: arithmetic (chunked against one-shot prefill, the kernels against the
#: plain path) passes only at a top-2 logit gap below this (the CPU serve
#: tests' bf16 bound, the parity phase's); speculative and fleet tokens
#: have no allowance: no kernel's row depends on the rows beside it
NEAR_TIE = 0.05
#: the spec phase's drafters and window
SPEC_DRAFTERS = ("ngram?n=3", "oracle", "oracle?accept=0.5")
SPEC_K = 3


def near_ties(torch, model, params, requests, want, got, gap_tol,
              what: str) -> list:
    """Every request whose greedy tokens differ between two runs of
    ``model`` (``want``, ``got``: results by uid): the first differing
    index and, at it, a no-cache forward's top-2 gap (:func:`_greedy_gap`).
    Fails where a gap exceeds ``gap_tol``."""
    out = []
    for req, a, b in zip(requests, want, got):
        if a.uid != b.uid:
            raise AssertionError(f"{what}: results out of order")
        if a.tokens.tolist() == b.tokens.tolist():
            continue
        i = next(j for j, (x, y) in enumerate(zip(a.tokens, b.tokens))
                 if x != y)
        probe = _greedy_gap(torch, (model, model), params, req.prompt,
                            a.tokens[:i])
        out.append({"uid": a.uid, "index": i, **probe})
        if probe["gap"] > gap_tol:
            raise AssertionError(f"{what}: uid {a.uid} diverges at token {i}"
                                 f" with top-2 gap {probe['gap']} > "
                                 f"{gap_tol}")
    return out


@contextlib.contextmanager
def paged_calls_by_T():
    """Count ``paged_attention`` calls by their query rows a slot (T) while
    the block runs: a wrapper in front of the wrapper, so a graph's
    capture is seen and its replays are not."""
    from repro_torch.kernels import ops

    own, seen = ops.paged_attention_cuda, collections.Counter()

    def counted(q, *args, **kw):
        seen[int(q.shape[1])] += 1
        return own(q, *args, **kw)

    ops.paged_attention_cuda = counted
    try:
        yield seen
    finally:
        ops.paged_attention_cuda = own


def _record_verify(engine, ticks: list) -> None:
    """Keep every verify tick's logits (in order) where the engine accepts
    them."""
    accept = engine._accept

    def recorded(logits, *rest):
        ticks.append(logits.clone())
        return accept(logits, *rest)

    engine._accept = recorded


def spec_line(cfg, run, *, layout, drafter, path, arrivals,
              **extra) -> dict:
    """The ``spec`` line of one served speculative run."""
    report, sp = run["report"], run["report"]["spec"]
    graphs = report["graphs"]
    line = {"phase": "spec", "arch": cfg.name, "n_layers": cfg.n_layers,
            "layout": layout, "drafter": drafter, "k": sp["k"],
            "path": path, "arrivals": arrivals,
            "tok_per_s": report["tok_per_s"], "ttft_ms": report["ttft_ms"],
            "per_token_ms": report["per_token_ms"],
            "accept_rate": sp["accept_rate"],
            "tokens_per_slot_step": sp["tokens_per_step"],
            "tokens_per_verify_tick": sp["emitted_tokens"]
            / max(sp["verify_ticks"], 1),
            "verify_ticks": sp["verify_ticks"],
            "accepted_hist": sp["accepted_hist"],
            "draft_steps": sp["draft_steps"],
            "moa_flops_total": report["moa_flops_total"],
            "tick_host_ms": {what: {"ticks": len(ms),
                                    "mean": statistics.mean(ms)}
                             for what, ms in run["ticks"].items() if ms},
            "launches": run["launches"],
            "launches_per_verify_replay": (
                graphs["launches_per_replay"].get("verify")
                if graphs else None),
            "warmup_s": run["warm"]["compile_s"] if run["warm"] else None}
    line.update(extra)
    emit(line)
    return line


def spec_phase(torch, llama3) -> dict:
    """Speculative decoding at full width and depth: llama3-8b (bf16
    weights, seed 0) in 4 slots, k = 3, on its served workload, paged and
    dense-slot, with each drafter of ``SPEC_DRAFTERS``.

    Per layout and drafter: an eager and a captured engine serve the
    workload with every request at 0 (the same batches and live-block
    buckets whatever their speed); the run fails on a token, a bit of any
    verify tick's logits or a launch count that differs, on a paged verify
    replay that does not launch ``paged_attention`` once a layer, at T = k
    + 1 (its capture's calls counted by T), and on greedy tokens that
    differ from the plain (non-speculative) captured engine's but at a
    near-tie (``NEAR_TIE``). Each prints a ``spec`` line; the oracle's
    captured engine then serves the workload as it arrives (a third line,
    whose launches are the spec path's). Per layout the ngram drafter's
    captured verify ticks are profiled, and for the dense-slot layout the
    plain captured engine's decode ticks (the paged one's are the serve
    phase's) (``profile`` lines). Returns the launches of the oracle's
    runs as they arrive, by run name."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine, resolve_drafter

    cfg, model, params, _ = llama3
    L = cfg.n_layers

    def workload(at_zero=False):
        reqs = llama3_workload(cfg)
        return [dataclasses.replace(r, arrival_s=0.0) for r in reqs] \
            if at_zero else reqs

    def engine(paged, drafter, cuda_graphs):
        return ServeEngine(
            model, params, n_slots=4, max_len=96, paged=paged, block_size=16,
            device="cuda", cuda_graphs=cuda_graphs,
            drafter=resolve_drafter(drafter, SPEC_K) if drafter else None)

    def serve(e, requests, ticks=None):
        with paged_calls_by_T() as warm_T:
            warm = e.run([], warmup=True)[1]
        if ticks is not None:
            _record_verify(e, ticks)
        tick_ms = timed_ticks(e)
        ops.reset_launch_counts()
        with paged_calls_by_T() as run_T:
            results, report = e.run(requests)
        return {"results": results, "report": report, "warm": warm,
                "launches": ops.launch_counts(), "ticks": tick_ms,
                "paged_T": {"warmup": dict(warm_T), "run": dict(run_T)}}

    launches = {}
    for paged in (True, False):
        layout = "paged" if paged else "dense-slot"
        e = engine(paged, None, True)
        plain = serve(e, workload(at_zero=True))
        del e
        gc.collect()
        for drafter in SPEC_DRAFTERS:
            runs, ticks = {}, {}
            for path, cuda_graphs in (("eager", False), ("captured", True)):
                e = engine(paged, drafter, cuda_graphs)
                ticks[path] = []
                runs[path] = serve(e, workload(at_zero=True), ticks[path])
                del e
                gc.collect()
            eager, captured = runs["eager"], runs["captured"]
            tokens = [r.uid for r, c in zip(eager["results"],
                                            captured["results"])
                      if r.tokens.tolist() != c.tokens.tolist()]
            differ = [i for i, (a, b) in enumerate(zip(ticks["eager"],
                                                       ticks["captured"]))
                      if not torch.equal(a, b)]
            if len(ticks["eager"]) != len(ticks["captured"]):
                differ.append("tick count")
            per = captured["report"]["graphs"]["launches_per_replay"]
            verify = per.get("verify", {})
            t_seen = captured["paged_T"]["warmup"]
            bad_T = paged and (verify.get("paged_attention") != L
                               or set(t_seen) != {SPEC_K + 1})
            unlike = {path: differing_tokens(plain["results"],
                                             run["results"])
                      for path, run in runs.items()}
            accept = {path: run["report"]["spec"]["accept_rate"]
                      for path, run in runs.items()}
            for path, run in runs.items():
                spec_line(cfg, run, layout=layout, drafter=drafter,
                          path=path, arrivals="all at 0",
                          verify_ticks_logged=len(ticks[path]),
                          paged_calls_by_T=run["paged_T"],
                          differing_from_plain=unlike[path])
            if any(unlike.values()) or (drafter == "oracle" and any(
                    a != 1.0 for a in accept.values())):
                raise AssertionError(
                    f"spec {layout} {drafter}: tokens differ from the plain "
                    f"engine's for {unlike}, accept rates {accept} (the "
                    "oracle must accept every draft)")
            emit({"phase": "graphs", "what": f"spec {layout} {drafter}",
                  "requests": len(eager["results"]),
                  "verify_ticks": len(ticks["eager"]),
                  "differing_tokens": tokens, "differing_ticks": differ[:10],
                  "launches": {p: r["launches"] for p, r in runs.items()},
                  "launches_per_verify_replay": verify,
                  "graphs": captured["report"]["graphs"]})
            if tokens or differ or eager["launches"] != \
                    captured["launches"] or bad_T:
                raise AssertionError(
                    f"spec {layout} {drafter}: the captured engine differs "
                    f"from the eager one: tokens of {tokens}, verify ticks "
                    f"{differ[:10]}, launches {eager['launches']} / "
                    f"{captured['launches']}, a verify replay {verify} (T "
                    f"seen at capture {t_seen})")
            if drafter != "oracle":
                continue
            # the oracle's captured engine on the workload as it arrives:
            # the launches of the spec path
            e = engine(paged, drafter, True)
            run = serve(e, workload())
            del e
            gc.collect()
            spec_line(cfg, run, layout=layout, drafter=drafter,
                      path="captured", arrivals="poisson")
            if run["report"]["spec"]["accept_rate"] != 1.0:
                raise AssertionError(f"spec {layout} oracle as the requests "
                                     "arrive: accept rate "
                                     f"{run['report']['spec']['accept_rate']}")
            launches[f"serve/llama3-8b-spec-{layout}"] = run["launches"]
            if paged and run["launches"]["paged_attention"] == 0:
                raise AssertionError("the paged spec run launched no "
                                     "paged_attention")
        # the verify tick beside the plain decode tick, both captured (the
        # paged plain decode tick is the serve phase's "served captured")
        profiled = [(f"spec {layout} captured ngram", SPEC_DRAFTERS[0])]
        if not paged:
            profiled.append((f"spec {layout} captured plain", None))
        for label, drafter in profiled:
            e = engine(paged, drafter, True)
            e.run([], warmup=True)
            profile_served(torch, e, workload(), label=label,
                           extra={"layout": layout, "drafter": drafter})
            del e
            gc.collect()
        torch.cuda.empty_cache()
    return launches


def differing_tokens(want, got) -> list:
    """The uids whose greedy tokens differ between two runs (results by
    uid, in order)."""
    if [a.uid for a in want] != [b.uid for b in got]:
        raise AssertionError("results out of order")
    return [a.uid for a, b in zip(want, got)
            if a.tokens.tolist() != b.tokens.tolist()]


def spec_parity_phase(torch) -> None:
    """At 2 layers, in float32 and in bfloat16 compute (f32 and bf16
    pools), the oracle accepts every draft and its greedy tokens equal the
    plain engine's exactly, both on the kernels (the captured engine):
    llama3-8b, and moonshot-v1-16b-a3b made dropless (capacity factor 11
    >= 64 / 6), each in both layouts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine, poisson_workload, \
        resolve_drafter

    for arch, compute, upd in (
            (arch, compute, upd)
            for arch, upd in (("llama3-8b", {}),
                              ("moonshot-v1-16b-a3b",
                               {"capacity_factor": 11.0}))
            for compute in ("float32", "bfloat16")):
        cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                  compute_dtype=compute, **upd)
        model = build_model(cfg)
        params = model.init(seed=0, device="cuda")
        for paged in (True, False):
            def workload():
                return poisson_workload(
                    n_requests=6, vocab=cfg.vocab, rate_rps=50.0,
                    prompt_len_range=(16, 64), gen_len_range=(8, 16),
                    seed=1)

            results = {}
            for drafter in (None, "oracle"):
                e = ServeEngine(model, params, n_slots=4, max_len=96,
                                paged=paged, block_size=16, device="cuda",
                                drafter=resolve_drafter(drafter, SPEC_K)
                                if drafter else None)
                results[drafter], report = e.run(
                    [dataclasses.replace(r, arrival_s=0.0)
                     for r in workload()], warmup=True)
                del e
                gc.collect()
            differ = differing_tokens(results[None], results["oracle"])
            accept = report["spec"]["accept_rate"]
            emit({"phase": "parity", "what": "spec", "arch": cfg.name,
                  "n_layers": 2, "compute_dtype": compute,
                  "capacity_factor": cfg.capacity_factor,
                  "layout": "paged" if paged else "dense-slot",
                  "requests": len(results[None]),
                  "accept_rate": accept, "differing_tokens": differ})
            if differ or accept != 1.0:
                raise AssertionError(
                    f"spec parity {cfg.name} {compute} paged={paged}: "
                    f"oracle tokens differ for {differ}, accept {accept}")
        del params, model
        gc.collect()
        torch.cuda.empty_cache()


def cli_phase(torch) -> None:
    """The serve CLI at its default lengths ((64 + 32 + 1) * 2 = 194
    tokens, 200 with a speculative margin) on dense-slot engines, which
    walk their cache in 16-token pages: llama3-8b at 2 layers in bf16, the
    plain engine, the oracle drafter, and 2 replicas. Each must finish,
    and serve at ``max_len`` 208. Then the train CLI: the smoke llama3-8b,
    20 steps, a failure injected at step 7 and survived from a
    checkpoint."""
    import contextlib
    import io

    from repro_torch.launch import serve as cli

    for extra in ([], ["--spec-decode", "--drafter", "oracle"],
                  ["--replicas", "2"]):
        argv = ["--arch", "llama3-8b", "--layers", "2", "--param-dtype",
                "bfloat16", "--requests", "4"] + extra
        out = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        lines = out.getvalue().splitlines()
        max_len = next((int(w.split("=")[1]) for line in lines
                        for w in line.split() if w.startswith("max_len=")),
                       None)
        emit({"phase": "cli", "argv": argv, "max_len": max_len,
              "seconds": time.monotonic() - t0,
              "last": lines[-1] if lines else None})
        if max_len != 208:
            raise AssertionError(f"serve CLI {argv}: max_len {max_len}, "
                                 "not 208")
        gc.collect()
        torch.cuda.empty_cache()
    # the train CLI: the smoke llama3-8b, one injected failure
    import tempfile

    from repro_torch.launch import train as train_cli

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--arch", "llama3-8b", "--smoke", "--steps", "20",
                "--fail-at", "7", "--ckpt-dir", tmp]
        out = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            train_cli.main(argv)
    lines = out.getvalue().splitlines()
    done = next((line for line in lines if line.startswith("[train] done")),
                None)
    emit({"phase": "cli", "argv": argv, "seconds": time.monotonic() - t0,
          "done": done, "last": lines[-1] if lines else None})
    if done is None or "restarts=1 completed=True" not in done:
        raise AssertionError(f"train CLI {argv}: {done}")


def slo_phase(torch, llama3) -> dict:
    """Chunked prefill and SLO scheduling at full width and depth:
    llama3-8b (bf16 weights, seed 0), paged, 4 slots, ``max_len`` 1152,
    captured, on ``bursty_workload``: 4 long requests (1024-token prompts,
    64 new tokens), then 8 burst requests (32-token prompts, 8 new tokens,
    a TTFT deadline 0.25 s after arrival) at 0.05 s. Served three ways:
    FIFO with one-shot prefills, FIFO with 256-token chunks, and
    ``scheduling="slo"`` with 256-token chunks. Each prints an ``slo`` line
    (burst TTFT, deadline-met share, preemptions, spills, chunk ticks,
    tok/s). The schedule runs on the wall clock, so the run holds tokens,
    not the schedule: every request's greedy tokens equal the FIFO one-shot
    run's but at a near-tie (``NEAR_TIE``), and the SLO run preempts at
    least once. Returns the SLO run's launches."""
    from repro_torch.serve import ServeEngine, bursty_workload

    cfg, model, params, _ = llama3

    def workload():
        return bursty_workload(vocab=cfg.vocab, n_long=4, n_burst=8,
                               long_prompt_len=1024, long_gen_len=64,
                               burst_prompt_len=32, burst_gen_len=8,
                               burst_at_s=0.05, burst_deadline_s=0.25,
                               seed=0)

    runs = {}
    for name, chunk, scheduling in (("fifo", None, "fifo"),
                                    ("fifo chunked", 256, "fifo"),
                                    ("slo chunked", 256, "slo")):
        e = ServeEngine(model, params, n_slots=4, max_len=1152, paged=True,
                        block_size=16, device="cuda",
                        prefill_chunk_tokens=chunk, scheduling=scheduling)
        run = runs[name] = serve_once(torch, e, workload(), warmup=True)
        del e
        gc.collect()
        report, sl = run["report"], run["report"]["slo"]
        burst = [r.metrics.ttft_s * 1e3 for r in run["results"] if r.uid >= 4]
        ties = [] if name == "fifo" else near_ties(
            torch, model, params, workload(), runs["fifo"]["results"],
            run["results"], NEAR_TIE, f"slo {name} vs fifo")
        emit({"phase": "slo", "what": name, "arch": cfg.name,
              "n_layers": cfg.n_layers, "scheduling": scheduling,
              "prefill_chunk_tokens": chunk,
              "tok_per_s": report["tok_per_s"], "wall_s": report["wall_s"],
              "burst_ttft_ms": {"p50": statistics.median(burst),
                                "p95": float(sorted(burst)[
                                    math.ceil(0.95 * len(burst)) - 1]),
                                "max": max(burst)},
              "ttft_ms": report["ttft_ms"],
              "deadline_met_share": sl["attainment"],
              "deadline_met": sl["deadline_met"],
              "deadline_requests": sl["deadline_requests"],
              "preemptions": sl["preemptions"], "spills": sl["spills"],
              "revivals": sl["revivals"],
              "chunk_ticks": sl["prefill_chunk_count"],
              "decode_steps": report["decode_steps"],
              "tick_host_ms": {what: {"ticks": len(ms),
                                      "mean": statistics.mean(ms)}
                               for what, ms in run["ticks"].items() if ms},
              "warmup_s": run["warm"]["compile_s"],
              "launches": run["launches"], "near_ties_vs_fifo": ties})
    if runs["slo chunked"]["report"]["slo"]["preemptions"] < 1:
        raise AssertionError("the SLO run preempted nothing")
    missing = [k for k in served_kernels(cfg)
               if runs["slo chunked"]["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the SLO run launched no {missing}")
    return runs["slo chunked"]["launches"]


#: the fleet phase: replicas of a captured paged llama3-8b engine (4 slots
#: each) on the reference CLI's StepClock, the serve phase's request shape
FLEET_REPLICAS = 2
FLEET_REQUESTS = 12
FLEET_DT = 1e-3


def fleet_workload(cfg):
    """12 greedy Poisson requests at 50 req/s, prompts of 16-64 tokens,
    8-16 new tokens, seed 0 (the serve phase's shape)."""
    from repro_torch.serve import poisson_workload

    return poisson_workload(n_requests=FLEET_REQUESTS, vocab=cfg.vocab,
                            rate_rps=50.0, prompt_len_range=(16, 64),
                            gen_len_range=(8, 16), seed=0)


def fleet_phase(torch, llama3) -> dict:
    """The replica fleet at full width and depth: llama3-8b (bf16 weights,
    seed 0), ``FLEET_REPLICAS`` replicas, each a captured paged engine of 4
    slots and a bf16 pool of block 16, on a ``StepClock(FLEET_DT)``,
    serving ``fleet_workload``.

    * A plain engine, a failure-free fleet, and a chaos fleet: the replica
      with the most in-flight decodes is killed at the first router step
      from 8 on where it decodes; the heartbeat monitor detects it and its
      requests are requeued; it is revived once detected (its graphs
      captured anew: ``revive_capture_s``); then a rolling reload of a
      new tree in memory (a copy of the same weights, which every replica
      rebinds to) drains, swaps and rejoins each replica. Fails on a lost
      request, a dropped or unfinished
      reload, or greedy tokens that differ in a bit from the failure-free
      fleet's or the plain engine's.
    * The watcher path at 2 layers: a ``CheckpointManager`` in a temporary
      directory saves the weights at router step 6 and a
      ``CheckpointWatcher`` turns the step into a rolling reload (a full
      width checkpoint is 16 GB of npz). Same checks.
    * ``reload_params`` under graphs at full width: a captured engine that
      served on seed 0's weights, reloaded with seed 1's, must equal a
      fresh captured engine on seed 1's, bit for bit (tokens and every
      step's logits); another engine built on the same seed 0 tree must
      still give the plain engine's tokens.

    Prints a ``fleet`` line and returns the chaos fleet's launches."""
    from repro_torch.checkpoint import CheckpointManager, CheckpointWatcher
    from repro_torch.interop import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine, StepClock
    from repro_torch.serve.router import ReplicaSet

    cfg, model, params, _ = llama3

    def make(m, p, clock):
        return ServeEngine(m, p, n_slots=4, max_len=96, paged=True,
                           block_size=16, device="cuda", clock=clock)

    def fleet(m, p, actions=None, **kw):
        clock = StepClock(FLEET_DT)
        rs = ReplicaSet(lambda: make(m, p, clock),
                        n_replicas=FLEET_REPLICAS, clock=clock, **kw)
        ops.reset_launch_counts()
        t0 = time.monotonic()
        results, report = rs.run(fleet_workload(m.cfg),
                                 actions=actions or {})
        torch.cuda.synchronize()
        host_s = time.monotonic() - t0
        rs.check()
        return rs, results, report, host_s, ops.launch_counts()

    def check(what, report, results, want, reloads=1):
        unlike = differing_tokens(want, results)
        bad = (report["lost_requests"] or report["reload_dropped"]
               or report["reloads_completed"] != reloads or unlike)
        if bad:
            raise AssertionError(
                f"fleet {what}: lost {report['lost_requests']}, reload "
                f"dropped {report['reload_dropped']}, reloads "
                f"{report['reloads_completed']}/{reloads}, tokens differ "
                f"for {unlike}")
        return unlike

    torch.cuda.reset_peak_memory_stats()
    plain, _ = make(model, params, StepClock(FLEET_DT)).run(
        fleet_workload(cfg))
    gc.collect()
    _, base, base_report, base_host_s, _ = fleet(model, params)
    vs_plain = {"failure-free": check("failure-free vs plain", base_report,
                                      base, plain, reloads=0)}
    gc.collect()

    state = {"killed": None, "revived": False, "reload_at": None}

    def chaos(rs):
        if state["killed"] is None and rs._step >= 8:
            rep = max((r for r in rs.replicas if r.alive),
                      key=lambda r: (len(r.uids), -r.rid))
            if rep.engine._inflight:     # it decodes now
                state["killed"] = rep.rid
                rs.kill(rep.rid)
        elif state["killed"] is not None and not state["revived"] \
                and rs.deaths_detected:
            rs.revive(state["killed"])
            state["revived"] = True
            state["reload_at"] = rs._step + 2
        elif state["reload_at"] == rs._step:
            # a new tree of the same values: every replica rebinds to it
            # (one copy for the fleet) and captures its graphs again
            rs.begin_reload(1, tree_map(torch.clone, params))

    actions = {step: chaos for step in range(4000)}
    rs, results, report, host_s, launches = fleet(model, params, actions)
    vs_base = check("chaos vs failure-free", report, results, base)
    vs_plain["chaos"] = check("chaos vs plain", report, results, plain)
    if not (report["kills"] == 1 and report["deaths_detected"] == 1
            and report["requeues"] >= 1 and state["revived"]):
        raise AssertionError(f"fleet chaos: kills {report['kills']}, "
                             f"detected {report['deaths_detected']}, "
                             f"requeues {report['requeues']}, revived "
                             f"{state['revived']}: the kill was not "
                             "exercised on a decoding replica")
    missing = [k for k in served_kernels(cfg) if launches[k] == 0]
    if missing:
        raise AssertionError(f"the fleet launched no {missing}")
    revive_s = rs.replicas[state["killed"]].revive_capture_s
    fleet_mem = torch.cuda.max_memory_allocated() / 1e9
    del rs
    gc.collect()
    torch.cuda.empty_cache()

    # the watcher path at 2 layers, through a checkpoint on disk
    small = build_model(dataclasses.replace(cfg, n_layers=2))
    sp = small.init(seed=0, device="cuda")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=1)
        _, wbase, _, _, _ = fleet(small, sp)
        t0 = time.monotonic()
        wrs, wres, wrep, _, _ = fleet(
            small, sp, {6: lambda _rs: mgr.save(1, sp)},
            watcher=CheckpointWatcher(mgr),
            load_params=lambda step: mgr.restore(sp, step=step)[0])
        watcher_s = time.monotonic() - t0
    check("watcher reload (2 layers)", wrep, wres, wbase)
    versions = [r.param_version for r in wrs.replicas]
    if versions != [1] * FLEET_REPLICAS:
        raise AssertionError(f"fleet watcher reload: versions {versions}")
    del wrs, small, sp
    gc.collect()

    # reload_params under graphs: seed 1's weights into a captured engine
    def at_zero():
        return [dataclasses.replace(r, arrival_s=0.0)
                for r in fleet_workload(cfg)]

    p1 = model.init(seed=1, device="cuda")
    fresh_logits = {}
    fresh = serve_once(torch, make(model, p1, StepClock(FLEET_DT)),
                       at_zero(), warmup=True, logits=fresh_logits)
    gc.collect()
    engine = make(model, params, StepClock(FLEET_DT))
    bystander = make(model, params, StepClock(FLEET_DT))
    serve_once(torch, engine, at_zero(), warmup=True)
    engine.reload_params(p1)
    del p1
    gc.collect()
    got_logits = {}
    got = serve_once(torch, engine, at_zero(), warmup=True,
                     logits=got_logits)
    other = serve_once(torch, bystander, at_zero(), warmup=True)
    reload_mem = torch.cuda.max_memory_allocated() / 1e9
    tokens = differing_tokens(fresh["results"], got["results"])
    steps = set(fresh_logits) | set(got_logits)
    differ = sorted(k for k in steps if not (
        k in fresh_logits and k in got_logits
        and torch.equal(fresh_logits[k], got_logits[k])))
    same_as_seed0 = differing_tokens(plain, other["results"])
    changed = differing_tokens(plain, got["results"])
    drops = engine._graphs.drops
    del engine, bystander
    gc.collect()
    torch.cuda.empty_cache()

    line = {"phase": "fleet", "arch": cfg.name, "n_layers": cfg.n_layers,
            "replicas": FLEET_REPLICAS, "slots_per_replica": 4,
            "requests": FLEET_REQUESTS, "dt": FLEET_DT,
            "kills": report["kills"],
            "deaths_detected": report["deaths_detected"],
            "requeues": report["requeues"],
            "requeued_requests": report["requeued_requests"],
            "requeue_latency_ms": report["requeue_latency_ms"],
            "reloads": report["reloads_completed"],
            "reload_dropped": report["reload_dropped"],
            "router_steps": report["router_steps"],
            "revive_capture_s": revive_s,
            "tok_per_s": report["tok_per_s"],
            "failure_free_tok_per_s": base_report["tok_per_s"],
            "host_s": host_s, "failure_free_host_s": base_host_s,
            "host_tok_per_s": report["total_new_tokens"] / host_s,
            "failure_free_host_tok_per_s":
                base_report["total_new_tokens"] / base_host_s,
            "differing_tokens_vs_failure_free": vs_base,
            "differing_tokens_vs_plain": vs_plain,
            "watcher_reload_2_layers": {
                "reloads": wrep["reloads_completed"],
                "dropped": wrep["reload_dropped"], "versions": versions,
                "seconds": watcher_s},
            "reload_params": {
                "differing_tokens": tokens, "differing_logits": differ[:10],
                "logit_steps": len(steps),
                "bystander_differs_from_seed0": same_as_seed0,
                "seed1_requests_unlike_seed0": len(changed),
                "graph_drops": drops,
                "graphs_after_reload": got["report"]["graphs"]},
            "peak_mem_gb": {"fleet": fleet_mem, "reload": reload_mem},
            "weights_gb": sum(t.numel() * t.element_size() for t in
                              _leaves(params)) / 1e9,
            "replicas_summary": report["replicas"]}
    emit(line)
    if tokens or differ or same_as_seed0 or not changed:
        raise AssertionError(
            f"reload_params: tokens of {tokens} and logits at {differ[:10]} "
            "differ from a fresh engine on the new weights; the bystander "
            f"differs from seed 0's tokens for {same_as_seed0}; seed 1 "
            f"changed {len(changed)} requests")
    return launches


#: the served ticks the audit phase holds to the cost model
AUDIT_PHASES = ("prefill", "paged_decode", "paged_verify",
                "paged_decode_fused", "paged_verify_fused")
#: kernels each audited tick must launch (besides ``dot_moa``)
AUDIT_KERNELS = {"prefill": "flash_attention",
                 "paged_decode_fused": "paged_attention",
                 "paged_verify_fused": "paged_attention"}


def audit_phase(torch, llama3) -> dict:
    """The static cost audit of llama3-8b's served ticks at full width on
    the card (the served model's bf16 parameters, all 32 layers), at
    ``AUDIT_SHAPE``. Per target: the eager body once under the cost
    audit (product FLOPs from the aten trace plus the kernel recorder's
    contract prices; gathered KV bytes), reconciled against
    ``serve_target_cost``; the recorder's calls of each kernel against the
    rise of ``ops.launch_counts()`` over the body; the body once more
    under ``torch.cuda.set_sync_debug_mode("error")``. Then every launch's
    call key is checked against the plain version. Raises on a drift past
    tolerance, an unpriced or missing launch, or a sync."""
    from repro_torch.analysis import cost_audit
    from repro_torch.analysis.targets import AUDIT_SHAPE, build_family_targets
    from repro_torch.kernels import ops

    cfg, model, params, _ = llama3
    smi = nvidia_smi()
    t_phase = time.monotonic()
    targets = build_family_targets("dense", device="cuda", model=model,
                                   params=params, phases=AUDIT_PHASES,
                                   **AUDIT_SHAPE)
    if sorted(cost_audit.target_phase(t.name) for t in targets) != \
            sorted(AUDIT_PHASES):
        raise AssertionError(f"audit: targets {[t.name for t in targets]}")
    failures, lines = [], {}
    with recorded_calls(ops, ("dot_moa", "flash_attention",
                              "paged_attention")) as keys:
        for t in targets:
            phase = cost_audit.target_phase(t.name)
            t0 = time.monotonic()
            before = ops.launch_counts()
            cost = cost_audit.count_target(t)
            torch.cuda.synchronize()
            after = ops.launch_counts()
            launched = {k: after[k] - before[k] for k in after}
            analytic = cost_audit.analytic_cost(cfg, phase, AUDIT_SHAPE)
            drift, dv = cost_audit.reconcile_target(t, cost, analytic)
            args = t.make_args()
            torch.cuda.synchronize()
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.no_grad())
                if t.context is not None:
                    stack.enter_context(t.context())
                torch.cuda.set_sync_debug_mode("error")
                try:
                    t.fn(*args)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            line = {"phase": "audit", "target": t.name, "arch": cfg.name,
                    "layers": cfg.n_layers, "shape": AUDIT_SHAPE,
                    "nvidia_smi": smi,
                    "flops": cost.flops, "analytic_flops": analytic["flops"],
                    "kernel_flops": cost.kernel_flops,
                    "aten_flops": cost.flops - cost.kernel_flops,
                    "kv_gather_bytes": cost.kv_gather_bytes,
                    "analytic_kv_gather_bytes":
                        analytic.get("kv_gather_bytes"),
                    "drift": drift, "flops_rtol": cost_audit.FLOPS_RTOL,
                    "kv_bytes_rtol": cost_audit.KV_BYTES_RTOL,
                    "kernel_calls": cost.kernel_calls, "launches": launched,
                    "pallas_stream_bytes": cost.pallas_stream_bytes,
                    "peak_bytes": cost.peak_bytes,
                    "max_trip_count": cost.max_trip_count,
                    "sync_debug": "error, no sync",
                    "seconds": time.monotonic() - t0}
            emit(line)
            lines[t.name] = line
            failures += [v.format() for v in dv]
            if launched != cost.kernel_calls:
                failures.append(f"{t.name}: launches {launched} but the "
                                f"recorder priced {cost.kernel_calls}")
            want = AUDIT_KERNELS.get(phase)
            if not launched["dot_moa"] or (want and not launched[want]):
                failures.append(f"{t.name}: launches {launched}")
    check_call_keys(torch, sorted(keys), "audit shape")
    emit({"phase": "audit", "what": "summary", "targets": len(targets),
          "call_keys": len(keys), "nvidia_smi": smi,
          "worst_flops_drift": max(abs(l["drift"]["flops"])
                                   for l in lines.values()),
          "seconds": time.monotonic() - t_phase})
    if failures:
        raise AssertionError("audit phase: " + "; ".join(failures))
    return lines


#: llama3-8b's production cells the dryrun phase traces and runs on the
#: card as rank 0 of the 16 × 16 mesh, and the largest predicted peak a
#: card run may have (80 GB cards)
DRYRUN_ARCH = "llama3-8b"
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_PEAK_MAX = 70e9
#: the measured peak over the predicted one must lie within these
DRYRUN_PEAK_RATIO = (0.85, 1.25)


def start_dryrun_traces():
    """Start the dry run's CLI (``python -m repro_torch.launch.dryrun``)
    on the dryrun phase's cells, one after the other in a shell of their
    own (``meta`` tensors, no card: ``CUDA_VISIBLE_DEVICES`` empty),
    beside the phases before it; returns the process, which writes a
    record a cell into a temporary directory. Stopped at exit if
    unread."""
    import atexit
    import shlex
    import tempfile

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(HERE, "src")]
                   + ([os.environ["PYTHONPATH"]]
                      if os.environ.get("PYTHONPATH") else [])))
    out_dir = tempfile.TemporaryDirectory()
    log = tempfile.TemporaryFile(mode="w+")
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           DRYRUN_ARCH, "--mesh", "single", "--out", out_dir.name]
    proc = subprocess.Popen(
        ["sh", "-c", " && ".join(shlex.join(cli + ["--shape", s])
                                 for s in DRYRUN_SHAPES)],
        stdout=log, stderr=subprocess.STDOUT, env=env, text=True)
    proc.out_dir, proc.log = out_dir, log
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def dryrun_traces(proc, timeout_s: float = 600.0) -> dict:
    """The records :func:`start_dryrun_traces` wrote, by shape (raises if
    a cell failed)."""
    try:
        proc.wait(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    proc.log.seek(0)
    text = proc.log.read()
    if proc.returncode != 0:
        raise AssertionError(f"dryrun: the traces failed ({proc.returncode})"
                             f":\n{text[-3000:]}")
    emit({"phase": "dryrun", "what": "traces", "status": text.splitlines()})
    with proc.out_dir:
        return {s: json.load(open(os.path.join(
            proc.out_dir.name, f"{DRYRUN_ARCH}__{s}__single.json")))
            for s in DRYRUN_SHAPES}


def dryrun_call_keys() -> list:
    """The ``call_key`` of every launch the dryrun phase's card runs make
    (rank 0 of llama3-8b's cells on 16 × 16, bf16 compute): ``dot_moa`` at
    the shard shapes (q 2 heads, k and v every KV head, o and down
    row-parallel with f32 partials, gate and up 1/16 of ``ff``) at the
    decode's 8 rows and the prefill's and train step's 65 536; the flash
    kernel at the prefill's 2 × 32 768 tokens of 2 q heads and their KV
    head; the paged kernel's head-offset read at the decode's shard shape
    (8 slots, the dense cache's 8 KV heads of which one is read, 2048
    pages of 16): rank 0's (head 0) and the last rank's (head 7)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config

    cfg = get_config(DRYRUN_ARCH)
    M, D = 16, 16
    bf = "torch.bfloat16"
    d, hd = cfg.d_model, cfg.head_dim
    q, kv, ff = cfg.n_heads * hd // M, cfg.n_kv_heads * hd, cfg.d_ff // M
    decode = SHAPES["decode_32k"]
    prefill = SHAPES["prefill_32k"]
    keys = []
    for m in (decode.global_batch // D,
              prefill.global_batch // D * prefill.seq_len):
        for k, n, out in ((d, q, None), (d, kv, None), (d, ff, None),
                          (q, d, "float32"), (ff, d, "float32")):
            keys.append(("dot_moa", bf, m, k, n, min(2048, k), 0)
                        + ((out,) if out else ()))
    S = prefill.seq_len
    keys.append(("flash_attention", bf, prefill.global_batch // D, S,
                 cfg.n_heads // M, hd, S, 1, True))
    keys += [("paged_attention", bf, decode.global_batch // D, 1,
              cfg.n_heads // M, hd, bf, 16, cfg.n_kv_heads,
              decode.seq_len // 16, bf, first, 1) for first in (0, 7)]
    return keys


def dryrun_phase(torch, proc) -> dict:
    """The multi-pod dry run (``repro_torch.launch.dryrun``) of llama3-8b's
    three cells on the 16 × 16 mesh, read from :func:`start_dryrun_traces`,
    and rank 0 of each run for real on the card over a fake group of 256
    ranks (its collectives move nothing; the values are not the point):
    parameters drawn whole at full depth from seed 0 and cut to the rank's
    shards, then its rows of a batch from the same generator (decode: a
    zero cache at its last position). Each cell whose predicted peak is
    under ``DRYRUN_PEAK_MAX`` runs once under the same trace (kernel calls
    by entry point, product FLOPs, launches); the serving cells once more,
    timed alone with CUDA events (``step_device_ms``, held to the
    roofline). The train step is not run again (its ~900 000 eager ops
    would take the phase past its minute on a slow host): its line gives
    the CUDA-event span of its traced run, the trace's host cost inside
    it (``traced_step_wall_ms``, not held to the roofline);
    the card's peak above the cell's start is held to the predicted one
    (``DRYRUN_PEAK_RATIO``), the calls, launches and FLOPs to the trace's
    exactly. A ``dryrun`` line a cell; its launches by run."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    smi = nvidia_smi()
    t_phase = time.monotonic()
    traces = dryrun_traces(proc)
    waited = time.monotonic() - t_phase
    failures, runs = [], {}
    gc.collect()
    torch.cuda.empty_cache()
    with recorded_calls(ops, ("dot_moa", "flash_attention",
                              "paged_attention")) as keys:
        for name in DRYRUN_SHAPES:
            rec, shape = traces[name], SHAPES[name]
            cfg = dryrun.serving_config(get_config(DRYRUN_ARCH), shape)
            roof = rec["roofline"]
            line = {"phase": "dryrun", "arch": DRYRUN_ARCH, "cell": name,
                    "mesh": rec["mesh"], "rank": rec["rank"],
                    "nvidia_smi": smi, "trace_s": rec["trace_s"],
                    "predicted_peak_gb": rec["memory"]["peak_bytes"] / 1e9,
                    "traced_kernel_calls": rec["cost_traced"]["kernel_calls"],
                    "traced_product_flops":
                        rec["cost_traced"]["product_flops"],
                    "traced_flops": rec["cost_traced"]["flops_per_device"],
                    "analytic_flops": rec["cost_analytic"]["flops_per_device"],
                    "collectives": rec["collectives_census"],
                    "roofline_ms": 1e3 * (roof["compute_s"]
                                          + roof["memory_s"]),
                    "roofline": roof}
            if rec["memory"]["peak_bytes"] >= DRYRUN_PEAK_MAX:
                line["card"] = (f"not run: the predicted peak is over "
                                f"{DRYRUN_PEAK_MAX / 1e9:.0f} GB")
                emit(line)
                continue
            t0 = time.monotonic()
            with fake_world(256, 0):
                mesh = make_production_mesh(device="cuda")
                base = torch.cuda.memory_allocated()
                gen = torch.Generator(device="cuda").manual_seed(0)
                cell = dryrun.build_cell(cfg, shape, mesh, device="cuda",
                                         generator=gen)
                gc.collect()
                torch.cuda.synchronize()
                init_s = time.monotonic() - t0
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launch_counts()
                train = shape.phase == "train"
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                count = dryrun.trace_step(cell.fn, cell.args, grad=train,
                                          memory=False)
                end.record()
                torch.cuda.synchronize()
                launches = ops.launch_counts()
                peak = torch.cuda.max_memory_allocated() - base
                if not train:      # a second run, timed alone
                    if shape.phase == "decode":
                        cell.args[1]["pos"].fill_(shape.seq_len - 1)
                    with torch.no_grad():
                        start.record()
                        out = cell.fn(*cell.args)
                        end.record()
                        del out
                    torch.cuda.synchronize()
                step_ms = start.elapsed_time(end)
                del cell
            gc.collect()
            torch.cuda.empty_cache()
            runs[f"dryrun/{DRYRUN_ARCH}-{name}"] = launches
            ratio = peak / rec["memory"]["peak_bytes"]
            line.update({
                "card_kernel_calls": count.kernel_calls,
                "launches": {k: v for k, v in launches.items() if v},
                "card_product_flops": count.product_flops,
                "card_flops": count.flops,
                "measured_peak_gb": peak / 1e9, "peak_ratio": ratio,
                "peak_ratio_bounds": list(DRYRUN_PEAK_RATIO),
                **({"traced_step_wall_ms": step_ms} if train else {
                    "step_device_ms": step_ms,
                    "step_over_roofline": step_ms / line["roofline_ms"]}),
                "init_s": init_s, "seconds": time.monotonic() - t0})
            emit(line)
            if count.kernel_calls != rec["cost_traced"]["kernel_calls"] \
                    or line["launches"] != count.kernel_calls:
                failures.append(f"{name}: card calls {count.kernel_calls}, "
                                f"launches {line['launches']}, traced "
                                f"{rec['cost_traced']['kernel_calls']}")
            if count.product_flops != rec["cost_traced"]["product_flops"] \
                    or count.flops != rec["cost_traced"]["flops_per_device"]:
                failures.append(f"{name}: card FLOPs {count.product_flops} / "
                                f"{count.flops}, traced "
                                f"{rec['cost_traced']['product_flops']} / "
                                f"{rec['cost_traced']['flops_per_device']}")
            if not DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1]:
                failures.append(f"{name}: measured peak {peak / 1e9:.3f} GB "
                                f"over predicted "
                                f"{rec['memory']['peak_bytes'] / 1e9:.3f} GB "
                                f"is {ratio:.3f}")
    check_call_keys(torch, sorted(keys), "dryrun shard shape")
    emit({"phase": "dryrun", "what": "summary", "nvidia_smi": smi,
          "cells": len(DRYRUN_SHAPES), "run_on_card": len(runs),
          "call_keys": len(keys),
          "traces_s": sum(r["trace_s"] for r in traces.values()),
          "waited_for_traces_s": waited,
          "seconds": time.monotonic() - t_phase})
    if failures:
        raise AssertionError("dryrun phase: " + "; ".join(failures))
    return runs


def _leaves(tree):
    from repro_torch.interop import tree_leaves

    return [t for _, t in tree_leaves(tree)]


def rows_phase(torch) -> None:
    """``scripts/row_invariance.py`` at 2 layers of llama3-8b (bf16): one
    slot's decode step against row 0 of a verify over the same tokens, op
    by op (paged, dense-slot, and the drafter's dense-slot decode against
    the paged verify), and each op alone at m = 1..16 and T = 1 against
    T = 4; then mamba2-370m's prefill of 1024 tokens in one shot against
    256-token chunks, op by op and whole (``chunk`` lines). Fails on any
    op whose row differs in a bit."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "row_invariance", os.path.join(HERE, "scripts", "row_invariance.py"))
    rows = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rows)
    rows.emit = emit              # its lines go to the --log file too
    bad = rows.check(n_layers=2, device="cuda")
    bad += rows.chunk_rows(device="cuda")
    if bad:
        raise AssertionError(f"a row's result depends on the rows beside "
                             f"it: {bad}")


def moe_serve_phase(torch):
    """moonshot-v1-16b-a3b at full width and depth (bf16 weights from the
    port's initializer, seed 0; the real capacity factor 1.25, so each
    prompt is prefilled at its exact length), served in the dense-slot and
    the paged layout: per layout the bit-for-bit check of the captured
    engine against the eager one (every request at 0), the Poisson
    workload eager and captured (``serve`` lines; a captured decode tick
    must launch 8 ``dot_moa`` a layer, the experts' batched, one
    ``moa_reduce`` and, paged, one ``paged_attention``), and the captured
    engine's ticks profiled against the decode tick's weight floor (every
    weight a tick reads, once, at the HBM rate). Returns the captured
    runs' launches by run (``serve/moonshot-dense-slot`` and
    ``serve/moonshot-paged``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine, poisson_workload

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                              param_dtype="bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    # a decode tick reads every layer weight (all 64 experts run on their
    # capacity buffers) and the unembedding, once
    emb = params["embed"]
    floor_bytes = sum(t.numel() * t.element_size() for t in
                      model.parameters()) \
        - emb["table"].numel() * emb["table"].element_size()
    floor_ms = floor_bytes / HBM_BPS * 1e3
    L = cfg.n_layers
    emit({"phase": "serve", "what": "moonshot init", "arch": cfg.name,
          "n_layers": L, "n_params": model.param_count(), "init_s": init_s,
          "param_gb": sum(t.numel() * t.element_size()
                          for t in model.parameters()) / 1e9,
          "decode_weight_bytes": floor_bytes,
          "decode_weight_floor_ms": floor_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    def workload():
        return poisson_workload(n_requests=8, vocab=cfg.vocab, rate_rps=50.0,
                                prompt_len_range=(16, 64),
                                gen_len_range=(8, 16), seed=0)

    launches = {}
    for paged in (False, True):
        layout = "paged" if paged else "dense-slot"
        served = served_kernels(cfg)

        def engine(cuda_graphs):
            return ServeEngine(model, params, n_slots=4, max_len=96,
                               paged=paged, block_size=16, device="cuda",
                               cuda_graphs=cuda_graphs)

        eager_vs_captured(torch, engine, workload, warmup=True,
                          what=f"serve moonshot {layout}", served=served)
        want = {"dot_moa": 8 * L, "moa_reduce": L, "paged_attention": L}
        for path, cuda_graphs in (("eager", False), ("captured", True)):
            e = engine(cuda_graphs)
            run = serve_once(torch, e, workload(), warmup=True)
            del e
            gc.collect()
            for req, r in zip(workload(), run["results"]):
                if r.tokens.shape != (req.max_new_tokens,) or not (
                        (r.tokens >= 0) & (r.tokens < cfg.vocab)).all():
                    raise AssertionError(f"moonshot {layout} {path} request "
                                         f"{r.uid}: bad tokens {r.tokens}")
            serve_line(torch, cfg, model, run, path=path, init_s=init_s,
                       layout=layout, decode_weight_floor_ms=floor_ms)
            missing = [k for k in served if run["launches"][k] == 0]
            if missing:
                raise AssertionError(f"moonshot {layout} {path} launched no "
                                     f"{missing}")
            if cuda_graphs:
                per = run["report"]["graphs"]["launches_per_replay"]
                if per.get("decode") != want:
                    raise AssertionError(f"moonshot {layout}: a captured "
                                         f"decode tick launches "
                                         f"{per.get('decode')}, not {want}")
                launches[f"serve/moonshot-{layout}"] = run["launches"]
        e = engine(True)
        e.run([], warmup=True)
        profile_served(torch, e, workload(),
                       label=f"moonshot {layout} captured",
                       extra={"decode_weight_floor_ms": floor_ms,
                              "layout": layout})
        del e
        gc.collect()
    emit({"phase": "serve", "what": "moonshot memory",
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def unembed_phase(torch, timer) -> dict:
    """zamba2-1.2b's decode unembedding alone (4 rows against its untied
    32000 x 2048 bf16 table, f32 logits: one cuBLAS product) on random
    operands of those shapes, timed with the kernels phase's timer (late in
    the run the profiler's sessions lose events): device ms, the CUDA
    functions seen, and the bound of the bytes it must move. Fails below
    the bound. One ``kernels`` line; returns it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.layers.embedding import unembed

    cfg = get_config("zamba2-1.2b")
    g = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn((cfg.vocab, cfg.d_model), device="cuda",
                        generator=g).to(torch.bfloat16)
    h = torch.randn((4, 1, cfg.d_model), device="cuda",
                    generator=g).to(torch.bfloat16)
    b_ms, b_by = bound(table.numel() * 2 + h.numel() * 2 + 4 * cfg.vocab * 4,
                       2.0 * 4 * cfg.d_model * cfg.vocab, "bfloat16")
    row = {"phase": "kernels", "case": "zamba2 unembedding",
           "shape": {"m": 4, "k": cfg.d_model, "n": cfg.vocab},
           "device_ms": timer.device(lambda: unembed(
               {"table": table}, h, compute_dtype=torch.bfloat16)),
           "device_kernels": timer.kernels,
           "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    if row["device_ms"] < b_ms:
        raise AssertionError(f"zamba2's unembedding: {row['device_ms']} ms "
                             f"device below its bound {b_ms} ms")
    return row


# ---------------------------------------------------------------------------
# the SSM and hybrid families: zamba2-1.2b and mamba2-370m
# ---------------------------------------------------------------------------

#: zamba2-1.2b's chunked prefill: two prompts of this many tokens, in
#: chunks of ``HYBRID_CHUNK`` (its ssd_chunk, and 16 pages of 16 tokens)
HYBRID_PROMPT = 1024
HYBRID_CHUNK = 256


def _state_bytes(cache, key: str, n_slots: int) -> int:
    """Bytes of the per-slot recurrent state of ``n_slots`` slots."""
    return sum(t.numel() * t.element_size() for t in cache[key].values()) \
        * n_slots // next(iter(cache[key].values())).shape[1]


def long_prompts(cfg, n: int, seed: int, new_tokens: int = 8):
    """``n`` greedy requests of ``HYBRID_PROMPT`` random tokens at 0."""
    import numpy as np
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=tuple(int(t) for t in rng.integers(
        0, cfg.vocab, HYBRID_PROMPT)), max_new_tokens=new_tokens)
        for i in range(n)]


def chunked_vs_one_shot(torch, model, params, *, paged: bool, what: str,
                        exact: bool) -> dict:
    """Two ``HYBRID_PROMPT``-token prompts served in ``HYBRID_CHUNK``-token
    chunks and in one shot by captured engines (2 slots): greedy tokens
    must agree, a divergence passing only at a top-2 gap below
    ``NEAR_TIE`` (``exact``: every step's logits equal bit for bit, the
    first token's among them: the SSM's scan runs chunk by chunk in both,
    and ``scripts/row_invariance.py``'s ``chunk`` lines hold each op's
    rows alike at 256 and 1024 rows). The line also says whether the
    first token's logits are equal bit for bit and by how much they
    differ. One ``chunked`` line."""
    from repro_torch.serve import ServeEngine

    max_len = HYBRID_PROMPT + 32
    runs, first = {}, {}
    for label, chunk in (("one-shot", None), ("chunked", HYBRID_CHUNK)):
        e = ServeEngine(model, params, n_slots=2, max_len=max_len,
                        paged=paged, block_size=16, device="cuda",
                        prefill_chunk_tokens=chunk)
        logits = first[label] = {}
        _replay(torch, e, logits)
        t0 = time.monotonic()
        runs[label] = e.run(long_prompts(model.cfg, 2, seed=5),
                            warmup=True)
        runs[label] += (time.monotonic() - t0,)
        del e
        gc.collect()
    (one, _, one_s), (chk, rep, chk_s) = runs["one-shot"], runs["chunked"]
    steps0 = [(r.uid, 0) for r in one]
    logits_equal = all(torch.equal(first["one-shot"][k], first["chunked"][k])
                       for k in steps0)
    logits_diff = max(float((first["one-shot"][k] - first["chunked"][k])
                            .abs().max()) for k in steps0)
    div = near_ties(torch, model, params, long_prompts(model.cfg, 2, seed=5),
                    one, chk, 0.0 if exact else NEAR_TIE, what)
    line = {"phase": "chunked", "what": what, "arch": model.cfg.name,
            "layout": "paged" if paged else "dense-slot",
            "prompt_tokens": HYBRID_PROMPT, "chunk": HYBRID_CHUNK,
            "chunks": [r.metrics.prefill_chunks for r in chk],
            "chunk_ticks": rep["slo"]["prefill_chunk_count"]
            if "slo" in rep else None,
            "first_logits_equal": logits_equal,
            "first_logits_max_diff": logits_diff, "divergences": div,
            "near_tie": 0.0 if exact else NEAR_TIE,
            "one_shot_s": one_s, "chunked_s": chk_s}
    emit(line)
    if max(line["chunks"]) != HYBRID_PROMPT // HYBRID_CHUNK:
        raise AssertionError(f"{what}: chunks {line['chunks']}")
    if exact and (set(first["one-shot"]) != set(first["chunked"]) or not all(
            torch.equal(z, first["chunked"][k])
            for k, z in first["one-shot"].items())):
        raise AssertionError(f"{what}: the chunked run's logits differ from "
                             f"the one-shot run's (first token's by "
                             f"{logits_diff})")
    return line


def preempt_revive(torch, engine_fn, workload, state_key: str,
                   what: str) -> None:
    """One preemption of a decoding request on a captured engine and its
    revival: the spilled state, and the revived slot's state before its
    next step, must equal the preempted slot's bit for bit, and every
    token the unpreempted run's. One ``slo`` line."""
    want, _ = engine_fn().run(workload())
    e = engine_fn()
    e.start_run(warmup=True)
    for r in workload():
        e.submit(r)
    results = []
    for _ in range(4):
        e.tick(results)
    slot = max(e._inflight)
    uid = e._inflight[slot].request.uid
    before = {n: t[:, slot].clone() for n, t in e.cache[state_key].items()}
    e.preempt(slot)
    snap = e._spilled[uid]["snap"][state_key]
    spilled_ok = all(torch.equal(snap[n][:, 0], t) for n, t in before.items())
    revived, orig = [], e._revive

    def revive(s, req):
        orig(s, req)
        revived.append({"slot": s, "state_equal": all(
            torch.equal(e.cache[state_key][n][:, s], t)
            for n, t in before.items())})

    e._revive = revive
    while not e.scheduler.done:
        e.tick(results)
    got, rep = e.finish_run(results)
    differ = differing_tokens(want, got)
    emit({"phase": "slo", "what": what, "preempted_uid": uid,
          "spilled_state_equal": spilled_ok, "revived": revived,
          "differing_tokens": differ,
          "preemptions": e._preemptions, "revivals": e._revivals})
    if not (spilled_ok and revived and all(r["state_equal"] for r in revived)
            and not differ):
        raise AssertionError(f"{what}: spill {spilled_ok}, revive {revived},"
                             f" tokens differ for {differ}")


def hybrid_phase(torch, unembed_row: dict) -> dict:
    """zamba2-1.2b, then mamba2-370m (:func:`zamba2_phase`, beside its
    unembedding's row from :func:`unembed_phase`, and
    :func:`mamba2_phase`): the captured runs' launches by run
    (``serve/zamba2-paged``, ``serve/zamba2-dense-slot``,
    ``serve/mamba2-dense-slot``)."""
    launches = zamba2_phase(torch, unembed_row)
    launches.update(mamba2_phase(torch))
    return launches


def zamba2_phase(torch, unembed_row: dict) -> dict:
    """zamba2-1.2b at full width and depth (38 Mamba-2 layers, 6
    applications of the shared block, bf16 weights from the port's
    initializer, seed 0), its unembedding's time (``unembed_row``) beside
    the decode tick's: returns the captured runs' launches by run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine, resolve_drafter

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("zamba2-1.2b"),
                              param_dtype="bfloat16")
    t0 = time.monotonic()
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_apps = cfg.n_layers // cfg.attn_every

    def size(tree):
        return sum(t.numel() * t.element_size() for t in _leaves(tree))

    # a decode tick reads every weight once (the embedding table only
    # through its 4 gathered rows), the shared block once an application,
    # and each slot's recurrent state once and writes it once
    shared = size(params["shared_attn"]) + size(params["shared_mlp"])
    cache = model.init_cache(4, 16, device="cuda")
    state = _state_bytes(cache, "ssm", 4)
    del cache
    weights = size(params) - params["embed"]["table"].numel() * 2
    floor_bytes = weights + (n_apps - 1) * shared + 2 * state
    floor_ms = floor_bytes / HBM_BPS * 1e3
    unembed_ms = unembed_row["device_ms"]
    unembed_bound = unembed_row["bound_ms"]
    emit({"phase": "serve", "what": "zamba2 init", "arch": cfg.name,
          "n_layers": cfg.n_layers, "applications": n_apps,
          "n_params": model.param_count(), "init_s": init_s,
          "param_gb": size(params) / 1e9, "shared_block_bytes": shared,
          "state_bytes_4_slots": state, "decode_weight_bytes": floor_bytes,
          "decode_weight_floor_ms": floor_ms, "unembed_device_ms": unembed_ms,
          "unembed_bound_ms": unembed_bound,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    def workload():
        return llama3_workload(cfg)

    served = served_kernels(cfg)
    want = {"dot_moa": 7 * n_apps, "paged_attention": n_apps}
    launches = {}
    for paged in (True, False):
        layout = "paged" if paged else "dense-slot"

        def engine(cuda_graphs=None, drafter=None):
            return ServeEngine(model, params, n_slots=4, max_len=96,
                               paged=paged, block_size=16, device="cuda",
                               cuda_graphs=cuda_graphs,
                               drafter=resolve_drafter(drafter, SPEC_K)
                               if drafter else None)

        runs = eager_vs_captured(torch, engine, workload, warmup=True,
                                 what=f"serve zamba2 {layout}", served=served)
        if paged:
            SINGLE_DEVICE["zamba2-1.2b"] = {
                r.uid: r.tokens.tolist() for r in runs["eager"]["results"]}
        plain = runs["captured"]["results"]
        per = runs["captured"]["report"]["graphs"]["launches_per_replay"]
        if per.get("decode") != want:
            raise AssertionError(f"zamba2 {layout}: a captured decode tick "
                                 f"launches {per.get('decode')}, not {want}")
        e = engine(True)
        run = serve_once(torch, e, workload(), warmup=True)
        del e
        gc.collect()
        for req, r in zip(workload(), run["results"]):
            if r.tokens.shape != (req.max_new_tokens,) or not (
                    (r.tokens >= 0) & (r.tokens < cfg.vocab)).all():
                raise AssertionError(f"zamba2 {layout}: request {r.uid}: "
                                     f"bad tokens {r.tokens}")
        serve_line(torch, cfg, model, run, path="captured", init_s=init_s,
                   layout=layout, decode_weight_floor_ms=floor_ms)
        launches[f"serve/zamba2-{layout}"] = run["launches"]
        for drafter in ("oracle", "ngram?n=3"):
            e = engine(True, drafter)
            spec = serve_once(torch, e, [dataclasses.replace(
                r, arrival_s=0.0) for r in workload()], warmup=True)
            del e
            gc.collect()
            differ = differing_tokens(plain, spec["results"])
            rep = spec["report"]
            emit({"phase": "spec", "what": "zamba2", "layout": layout,
                  "drafter": drafter, "k": SPEC_K, "path": "captured",
                  "accept_rate": rep["spec"]["accept_rate"],
                  "tokens_per_step": rep["spec"]["tokens_per_step"],
                  "accepted_hist": rep["spec"]["accepted_hist"],
                  "tok_per_s": rep["tok_per_s"],
                  "launches_per_replay":
                      rep["graphs"]["launches_per_replay"],
                  "differing_tokens": differ})
            if differ or (drafter == "oracle"
                          and rep["spec"]["accept_rate"] != 1.0):
                raise AssertionError(
                    f"zamba2 spec {layout} {drafter}: tokens differ from the "
                    f"plain engine's for {differ}, accept "
                    f"{rep['spec']['accept_rate']}")
        if paged:
            e = engine(True)
            e.run([], warmup=True)
            profile_served(torch, e, workload(),
                           label="zamba2 paged captured",
                           extra={"decode_weight_floor_ms": floor_ms,
                                  "unembed_device_ms": unembed_ms,
                                  "unembed_bound_ms": unembed_bound,
                                  "layout": layout})
            del e
            gc.collect()
            preempt_revive(torch, lambda: engine(True), lambda: [
                dataclasses.replace(r, arrival_s=0.0)
                for r in workload()[:3]], "ssm", "zamba2 paged preempt")
    chunked_vs_one_shot(torch, model, params, paged=True,
                        what="zamba2 chunked", exact=False)
    emit({"phase": "serve", "what": "zamba2 memory",
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def mamba2_phase(torch) -> dict:
    """mamba2-370m at full width (48 layers, bf16 weights from seed 0): no
    K/V, so dense-slot only, and none of the kernels runs. Eager / captured
    bit for bit on llama3's workload, and chunked equal to one-shot (no
    divergence allowed). Returns ``{"serve/mamba2-dense-slot":
    launches}``, all zero."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("mamba2-370m"),
                              param_dtype="bfloat16")
    t0 = time.monotonic()
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "serve", "what": "mamba2 init", "arch": cfg.name,
          "n_layers": cfg.n_layers, "n_params": model.param_count(),
          "init_s": time.monotonic() - t0})

    def mamba_engine(cuda_graphs=None):
        return ServeEngine(model, params, n_slots=4, max_len=96,
                           device="cuda", cuda_graphs=cuda_graphs)

    runs = eager_vs_captured(torch, mamba_engine,
                             lambda: llama3_workload(cfg), warmup=True,
                             what="serve mamba2 dense-slot", served=[])
    got = runs["captured"]["launches"]
    if any(got.values()):
        raise AssertionError(f"mamba2 launched kernels: {got}")
    serve_line(torch, cfg, model, runs["captured"], path="captured",
               init_s=0.0, layout="dense-slot", arrivals="all at 0")
    chunked_vs_one_shot(torch, model, params, paged=False,
                        what="mamba2 chunked", exact=True)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve/mamba2-dense-slot": got}


def _greedy_gap(torch, models, params, prompt, generated) -> dict:
    """At a divergence: the top-2 logit gap of the plain path's next-token
    logits after ``prompt + generated`` (full causal forward, no KV cache),
    and the largest difference between the kernel path's and the plain
    path's logits of that forward (``models``: plain, kernel)."""
    toks = torch.tensor([list(prompt) + list(generated)], device="cuda")
    with torch.no_grad():
        plain, kernel = (m.forward(params, {"tokens": toks})[0, -1].float()
                         for m in models)
    top = torch.topk(plain, 2).values
    return {"gap": float(top[0] - top[1]),
            "forward_logit_diff": float((kernel - plain).abs().max())}


def _replay(torch, engine, logits_by_step, forced=None) -> None:
    """Wrap ``engine``'s sampling (the first token in ``_seed``, each decode
    step's in ``_sample``): record every request's next-token logits by
    ``(uid, step)`` and, with ``forced`` (``{uid: tokens}``), hand the
    engine those tokens instead of its own choice (teacher forcing)."""
    seed, sample = engine._seed, engine._sample

    def _seed(slot, req, logits, *rest):
        logits_by_step[(req.uid, 0)] = logits[0, -1].float().clone()
        if forced is not None:     # one finite logit: greedy takes it
            logits = torch.full_like(logits, -math.inf)
            logits[0, -1, int(forced[req.uid][0])] = 0.0
        return seed(slot, req, logits, *rest)

    def _sample(logits, temps, greedy):
        toks = sample(logits, temps, greedy)
        for slot, inf in engine._inflight.items():
            step = len(inf.generated)
            logits_by_step[(inf.request.uid, step)] = \
                logits[slot].float().clone()
            if forced is not None:
                toks[slot] = forced[inf.request.uid][step]
        return toks

    engine._seed, engine._sample = _seed, _sample


def _int8_step_bound(torch, cfg, model, params, requests, tokens) -> dict:
    """How far one int8 pool entry moving by one quantum can move any logit,
    to first order, at each step of each request.

    One quantum is ``q = max|x| / 127`` of the entry's (position, head)
    row; ``q_max`` is the largest over the run (K and V of both layers, from
    a no-cache forward of the plain path over prompt + tokens). The final
    norm turns a residual move ``dr`` at a position of rms ``rms`` into
    ``dz_i = u_i . (g * (dr - n (n . dr) / d)) / rms`` (``n`` the normed
    residual, ``|n| = sqrt(d)``, ``u_i`` the unembedding row of logit i,
    ``g`` the final-norm scale), so ``|dz_i| <= (|u_i . (g * dr)| + |z_i|
    |dr| / sqrt(d)) / rms``. ``G = n_heads / n_kv_heads`` query heads read
    one KV entry, each with weight ``p <= 1``:

    * a V entry moves each head's output by ``p q`` along one dimension c,
      which ``wo`` turns into ``dr = q sum_h p_h wo[h D + c]``: ``|dz_i| <=
      G q (m_v + z_max w_row / sqrt(d)) / rms``, with ``m_v`` the largest
      ``|u_i . (g * wo[row])|`` over every row of ``wo`` and every logit
      and ``w_row`` the largest row norm of ``wo``;
    * a K entry moves one score by ``|q_c| q / sqrt(D) <= a_max q /
      sqrt(D)``, and the head's output by ``p (1 - p) |ds| |v_j - o| <=
      k q`` with ``k = a_max v_max / (2 sqrt(D))`` (``|v_j - o| <= 2
      (1 - p) v_max``; ``a_max`` the largest |query entry|, ``v_max`` the
      largest value-row norm): ``|dz_i| <= G q k (m_k + z_max sigma /
      sqrt(d)) / rms``, with ``m_k`` the largest ``|wo_h (g * u_i)|`` over
      heads and logits and ``sigma`` the largest spectral norm of a head's
      block ``wo_h``;
    * an entry of layer 0 reaches the final norm through layer 1, whose
      residual connections carry ``dr`` unchanged and whose attention and
      MLP (projections at std fan_in**-0.5 after an RMSNorm) add responses
      taken as no larger than ``dr`` and, like the rows of ``wo`` at this
      initialization, uncorrelated with the unembedding: a factor 3.

    ``m_v``, ``m_k``, ``w_row`` and ``sigma`` come from the weights,
    ``q_max``, ``a_max`` and ``v_max`` from the run, ``z_max`` and ``rms``
    from each step. Returns the parts and each request's ``rms`` by
    step; :func:`_step_bound` puts them together."""
    from repro_torch.models import moe_transformer as M
    from repro_torch.models import transformer as T

    G, D, d = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    g = params["final_norm"]["scale"].float()
    wo = params["layers"]["attn"]["wo"].float().reshape(-1, d)  # (L·H·D, d)
    emb = params["embed"]
    u = emb.get("unembed", emb["table"]).float()                # (V, d)
    m_v = m_k = 0.0
    for i in range(0, u.shape[0], 16384):
        proj = (wo * g) @ u[i:i + 16384].t()                    # (L·H·D, n)
        m_v = max(m_v, float(proj.abs().max()))
        m_k = max(m_k, float(proj.reshape(-1, D, proj.shape[1]).norm(
            dim=1).max()))
        del proj
    parts = {"G": G, "D": D, "d": d, "m_v": m_v, "m_k": m_k,
             "w_row": float(wo.norm(dim=-1).max()),
             "sigma": float(torch.linalg.matrix_norm(
                 wo.reshape(-1, D, d), ord=2).max()),
             "layer_factor": 3}
    got, rms = {}, {}
    q_max = a_max = v_max = 0.0
    qkv, norm = T._layer_qkv, T.rms_norm

    def layer_qkv(c, lyr, h, positions):
        out = qkv(c, lyr, h, positions)
        got.setdefault("qkv", []).append(out)
        return out

    def rms_norm(p, x, **kw):
        if p is params["final_norm"]:
            got["final"] = x
        return norm(p, x, **kw)

    T._layer_qkv, T.rms_norm, M.rms_norm = layer_qkv, rms_norm, rms_norm
    try:
        for req in requests:
            got.clear()
            seq = list(req.prompt) + tokens[req.uid][:-1].tolist()
            with torch.no_grad():
                model.forward(params, {"tokens": torch.tensor(
                    [seq], device=wo.device)})
            r = got["final"][0, req.prompt_len - 1:].float()
            rms[req.uid] = r.pow(2).mean(-1).sqrt().tolist()
            for qh, k, v in got["qkv"]:
                a_max = max(a_max, float(qh.abs().max()))
                v_max = max(v_max, float(v.float().norm(dim=-1).max()))
                q_max = max(q_max, float(k.abs().amax(-1).max()) / 127,
                            float(v.abs().amax(-1).max()) / 127)
    finally:
        T._layer_qkv, T.rms_norm, M.rms_norm = qkv, norm, norm
    parts.update(q_max=q_max, a_max=a_max, v_max=v_max,
                 k=a_max * v_max / (2 * math.sqrt(D)))
    return {"parts": parts, "rms": rms}


def _step_bound(parts: dict, z_max: float, rms: float) -> float:
    """The one-quantum bound of :func:`_int8_step_bound` at one step."""
    p = parts
    root = math.sqrt(p["d"])
    v_path = p["m_v"] + z_max * p["w_row"] / root
    k_path = p["k"] * (p["m_k"] + z_max * p["sigma"] / root)
    return p["layer_factor"] * p["G"] * p["q_max"] * max(v_path, k_path) / rms


def _teacher_forced(torch, plain, kernel, bound) -> dict:
    """Compare the plain path's and the teacher-forced kernel path's
    next-token logits at every request's every step: fail where the
    largest difference exceeds the one-quantum bound, or where the greedy
    tokens differ at a top-2 gap over twice that difference."""
    if set(plain) != set(kernel):
        raise AssertionError(f"teacher-forced steps differ: "
                             f"{sorted(set(plain) ^ set(kernel))}")
    worst, flips, bad, least = None, [], [], math.inf
    for (uid, step), zp in sorted(plain.items()):
        zk = kernel[(uid, step)]
        diff = float((zk - zp).abs().max())
        lim = _step_bound(bound["parts"], float(zp.abs().max()),
                          bound["rms"][uid][step])
        top = torch.topk(zp, 2)
        gap = float(top.values[0] - top.values[1])
        row = {"uid": uid, "step": step, "diff": diff, "bound": lim,
               "gap": gap}
        least = min(least, lim)
        if worst is None or diff / lim > worst["diff"] / worst["bound"]:
            worst = row
        if int(zk.argmax()) != int(top.indices[0]):
            flips.append(row)
            if gap > 2 * diff:
                bad.append(row)
        if diff > lim:
            bad.append(row)
    return {"steps": len(plain), "worst": worst, "greedy_flips": flips,
            "failed": bad, "bound_min": least}


def parity_phase(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serve import (ServeEngine, poisson_workload,
                                   shared_prefix_workload)

    #: pool -> (compute type, KV cache type, near-tie bound). f32 and
    #: bf16 pools run free and a divergence passes only if the plain
    #: path's top-2 logits are closer than the bound. float32: kernel and
    #: plain differ by f32 reassociation (~1e-5 relative after 2 layers)
    #: and the logits are O(1). bfloat16: each projection's output may
    #: round one bf16 ulp apart (the kernels phase's bound), and a few ulps
    #: of the hidden state through the unembedding move a logit by ~0.01 --
    #: the CPU tests' 0.05 bound. (Under float32 compute the reference
    #: keeps a non-int8 pool in the compute type, so the bf16 pool needs
    #: bf16 compute.) int8: the two paths quantize K and V from f32 values
    #: that differ by reassociation, so an entry near a rounding boundary
    #: lands one quantum apart and a free run can split at any near-tie;
    #: the decision is the teacher-forced comparison against the one-step
    #: bound of ``_int8_step_bound`` (the free runs' divergences are still
    #: printed).
    pools = {"f32": ("float32", "bfloat16", 1e-3),
             "int8": ("float32", "int8", None),
             "bf16": ("bfloat16", "bfloat16", 0.05)}
    for pool, (compute, kv, gap_tol) in pools.items():
        cfg = dataclasses.replace(
            get_config("llama3-8b"), n_layers=2, compute_dtype=compute,
            kv_cache_dtype=kv)
        params = build_model(cfg).init(seed=0, device="cuda")
        plain_cfg = dataclasses.replace(cfg, moa="serial?backend=torch&"
                                        "chunk=4096", attn_backend="torch")
        for wl in ("poisson", "shared_prefix"):
            def workload():
                if wl == "poisson":
                    return poisson_workload(
                        n_requests=6, vocab=cfg.vocab, rate_rps=50.0,
                        prompt_len_range=(16, 64), gen_len_range=(8, 16),
                        seed=1)
                return shared_prefix_workload(
                    n_requests=6, vocab=cfg.vocab, rate_rps=50.0,
                    n_prefixes=2, prefix_len=32, suffix_len_range=(1, 16),
                    gen_len_range=(8, 16), seed=2)

            def engine(c, cuda_graphs=None, paged=True):
                return ServeEngine(build_model(c), params, n_slots=4,
                                   max_len=96, paged=paged, block_size=16,
                                   device="cuda", cuda_graphs=cuda_graphs)

            def serve(path, c, logits=None, forced=None):
                # the plain path runs eagerly; the kernel path is captured,
                # each bucket at its first tick (no warmup)
                eng = engine(c, False if path == "torch" else None)
                if logits is not None:
                    _replay(torch, eng, logits, forced)
                ops.reset_launch_counts()
                out = eng.run(workload())
                counts = ops.launch_counts()
                served = [counts[k] for k in served_kernels(cfg)]
                if (path == "kernel") != all(served) or (
                        path == "torch" and any(counts.values())):
                    raise AssertionError(f"{path} path launches: {counts}")
                return out

            plain_logits = {} if gap_tol is None else None
            if pool != "bf16":   # the kernel path eager, then captured
                eager_vs_captured(torch, lambda g: engine(cfg, g), workload,
                                  warmup=False, what=f"parity {pool}/{wl}",
                                  served=served_kernels(cfg))
            runs = {"torch": serve("torch", plain_cfg, plain_logits),
                    "kernel": serve("kernel", cfg)}
            divergences = []
            for req, a, b in zip(workload(), runs["torch"][0],
                                 runs["kernel"][0]):
                if a.tokens.tolist() == b.tokens.tolist():
                    continue
                i = next(j for j, (x, y) in enumerate(zip(a.tokens, b.tokens))
                         if x != y)
                probe = _greedy_gap(torch, (build_model(plain_cfg),
                                            build_model(cfg)), params,
                                    req.prompt, a.tokens[:i])
                gap = probe["gap"]
                divergences.append({"uid": a.uid, "index": i, **probe})
                if gap_tol is not None and gap > gap_tol:
                    raise AssertionError(
                        f"parity {pool}/{wl}: uid {a.uid} diverges at token "
                        f"{i} with top-2 gap {gap} > {gap_tol} ({probe})")
            line = {"phase": "parity", "pool": pool, "workload": wl,
                    "n_layers": 2, "compute_dtype": compute,
                    "requests": len(runs["torch"][0]),
                    "identical": not divergences, "divergences": divergences,
                    "gap_tol": gap_tol,
                    "prefix_hits": runs["kernel"][1]["paged"]["prefix_hits"]}
            if gap_tol is None:
                tokens = {r.uid: r.tokens for r in runs["torch"][0]}
                kernel_logits = {}
                serve("kernel", cfg, kernel_logits, forced=tokens)
                bound = _int8_step_bound(torch, cfg, build_model(plain_cfg),
                                         params, workload(), tokens)
                tf = _teacher_forced(torch, plain_logits, kernel_logits,
                                     bound)
                line["teacher_forced"] = {
                    "steps": tf["steps"], "worst": tf["worst"],
                    "greedy_flips": tf["greedy_flips"],
                    "bound_min": tf["bound_min"],
                    "bound_parts": bound["parts"],
                    "rms_min": min(min(r) for r in bound["rms"].values())}
                emit(line)
                if tf["failed"]:
                    raise AssertionError(f"parity {pool}/{wl}: teacher-forced"
                                         f" logits out of bound at "
                                         f"{tf['failed'][:5]}")
            else:
                emit(line)
            if (pool, wl) == ("f32", "poisson"):
                layouts(torch, cfg, params, engine(cfg, paged=False),
                        runs["kernel"][0], workload(), gap_tol)
        del params
        torch.cuda.empty_cache()


def layouts(torch, cfg, params, dense, paged_results, requests,
            gap_tol) -> None:
    """llama3 at 2 layers on the kernels, the dense-slot engine against the
    paged one on the same workload: tokens equal, a divergence only at a
    near-tie of the top-2 logits (``gap_tol``, the f32 pool's)."""
    from repro_torch.models.api import build_model

    results, report = dense.run(requests)
    divergences = near_ties(torch, build_model(cfg), params, requests,
                            paged_results, results, gap_tol,
                            "dense-slot vs paged")
    emit({"phase": "parity", "what": "layouts", "arch": cfg.name,
          "n_layers": cfg.n_layers, "compute_dtype": cfg.compute_dtype,
          "requests": len(results), "identical": not divergences,
          "divergences": divergences, "gap_tol": gap_tol,
          "dense_launches": report["graphs"]["launches_per_replay"]})


def zamba2_parity_phase(torch) -> None:
    """zamba2-1.2b at full width and 6 layers (one application of the
    shared block, no tail), f32 compute, the kernel path (captured) against
    the plain path (eager: the serial PyTorch MOA, ``attn_backend="torch"``)
    in both layouts on the serve phase's Poisson workload. The Mamba-2
    layers are plain PyTorch on both paths, so the two differ only where
    the shared block runs ``dot_moa`` (its seven projections at k = 2048
    and 8192), flash attention (D 64) and paged attention. Greedy tokens
    must agree but at a near-tie (the f32 pool's bound); then the kernel
    path is fed the plain path's tokens (teacher forcing) and every step's
    logits must agree within ``LOGIT_TOL``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=6,
                              compute_dtype="float32")
    plain_cfg = dataclasses.replace(cfg, moa="serial?backend=torch&"
                                    "chunk=4096", attn_backend="torch")
    params = build_model(cfg).init(seed=0, device="cuda")
    gap_tol = 1e-3                           # the f32 pool's near-tie
    for paged in (True, False):
        layout = "paged" if paged else "dense-slot"

        def serve(c, logits, forced=None):
            kernel = c is cfg
            eng = ServeEngine(build_model(c), params, n_slots=4, max_len=96,
                              paged=paged, block_size=16, device="cuda",
                              cuda_graphs=None if kernel else False)
            _replay(torch, eng, logits, forced)
            ops.reset_launch_counts()
            out, _ = eng.run(llama3_workload(cfg))
            counts = ops.launch_counts()
            if (kernel and not all(counts[k] for k in served_kernels(cfg))
                    ) or (not kernel and any(counts.values())):
                raise AssertionError(f"zamba2 parity {layout}: "
                                     f"{'kernel' if kernel else 'plain'} "
                                     f"path launches {counts}")
            return out

        plain_logits, free_logits, forced_logits = {}, {}, {}
        plain = serve(plain_cfg, plain_logits)
        free = serve(cfg, free_logits)
        divergences = near_ties(torch, build_model(cfg), params,
                                llama3_workload(cfg), plain, free, gap_tol,
                                f"zamba2 parity {layout}")
        serve(cfg, forced_logits, {r.uid: r.tokens for r in plain})
        if set(plain_logits) != set(forced_logits):
            raise AssertionError(f"zamba2 parity {layout}: teacher-forced "
                                 f"steps differ")
        worst = max(float((forced_logits[k] - z).abs().max())
                    for k, z in plain_logits.items())
        emit({"phase": "parity", "what": "zamba2", "layout": layout,
              "arch": cfg.name, "n_layers": cfg.n_layers,
              "applications": cfg.n_layers // cfg.attn_every,
              "compute_dtype": cfg.compute_dtype,
              "requests": len(plain), "identical": not divergences,
              "divergences": divergences, "gap_tol": gap_tol,
              "logit_steps": len(plain_logits), "max_logit_diff": worst,
              "logit_tol": LOGIT_TOL,
              "max_abs_logit": max(float(z.abs().max())
                                   for z in plain_logits.values())})
        if not worst <= LOGIT_TOL:
            raise AssertionError(f"zamba2 parity {layout}: teacher-forced "
                                 f"logits {worst} apart > {LOGIT_TOL}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


#: the MoE parity's bounds. ROUTE_GAP: where the kernel path's own expert
#: choice differs from the plain path's (f32), the plain path's router
#: probabilities at the first differing choice must lie closer than this;
#: the two compute the router logits with f32 sums in other orders over K
#: = 2048 (about 1e-6 relative), so a probability moves by 1e-6 at most,
#: and 1e-4 leaves a hundredfold margin. LOGIT_TOL: every step's
#: next-token logits (O(1)) differ by f32 reassociation through 2 layers,
#: bounded as the f32 pool's near-tie (``parity_phase``).
ROUTE_GAP = 1e-4
LOGIT_TOL = 1e-3


def _routing(torch, moe_mod, ticks, forced=None):
    """Record every ``route`` call of the MoE layer as ``(tick, expert
    ids, keep, probs)`` on the host (the call's own choice); ``ticks`` is a
    one-item list holding the engine tick in progress. ``forced`` (an
    earlier run's log): each call instead returns that run's expert ids at
    the same call, with gates from this call's own probabilities and the
    capacity ranks recomputed (teacher-forced routing). Returns the log and
    an undo."""
    log, route = [], moe_mod.route
    F = torch.nn.functional

    def recorded(*args, **kw):
        r = route(*args, **kw)
        log.append((ticks[0], r.expert_ids.cpu(), r.keep.cpu(),
                    r.probs.detach().cpu()))
        if forced is None:
            return r
        ids = forced[len(log) - 1][1].to(r.expert_ids.device)
        if ids.shape != r.expert_ids.shape:
            raise AssertionError(f"routing call {len(log) - 1}: shapes "
                                 f"{tuple(ids.shape)} and "
                                 f"{tuple(r.expert_ids.shape)}")
        gates = torch.gather(r.probs, -1, ids)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        G, tg, k = ids.shape
        onehot = F.one_hot(ids.reshape(G, tg * k), r.probs.shape[-1])
        slot = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
        return moe_mod.Routing(r.probs, gates, ids, slot, slot < r.capacity,
                               r.capacity)

    moe_mod.route = recorded
    return log, lambda: setattr(moe_mod, "route", route)


def _routing_differences(plain, kernel) -> list:
    """Every token whose expert ids differ between two routing logs of the
    same calls: ``{call, tick, group, token, gap}``, ``gap`` the plain
    path's sorted-probability gap at the first differing choice."""
    if len(plain) != len(kernel):
        raise AssertionError(f"routing calls differ in number: {len(plain)} "
                             f"and {len(kernel)}")
    out = []
    for i, ((tick, ip, _, pp), (_, ik, _, _)) in enumerate(
            zip(plain, kernel)):
        if ip.shape != ik.shape:
            raise AssertionError(f"routing call {i}: shapes {ip.shape} and "
                                 f"{ik.shape}")
        for gi, t in (ip != ik).any(-1).nonzero().tolist():
            j = int((ip[gi, t] != ik[gi, t]).nonzero()[0])
            srt = pp[gi, t].sort(descending=True).values
            out.append({"call": i, "tick": tick, "group": gi, "token": t,
                        "gap": float(srt[j] - srt[j + 1])})
    return out


def moe_parity_phase(torch):
    """moonshot at full width and 2 layers, f32 compute, kernel path
    against plain path (both eager), dense-slot and paged, on an f32 and
    an int8 pool: the plain path serves a workload (every request at 0)
    greedily; the kernel path is fed its tokens and its expert choices
    (teacher forcing of tokens and routing), so both run the same ticks
    through the same experts, and every step's logits are compared: within
    ``LOGIT_TOL`` (the f32 pool) or within the move one int8 quantum of the
    pool can cause (:func:`_int8_step_bound`, as llama3's int8 parity; the
    int8 pool). Every routing call of both is logged with the kernel path's
    own choice: on the f32 pool each token whose own choice differs must
    sit at a near-tie of the plain path's router probabilities
    (``ROUTE_GAP``); on the int8 pool the two paths quantize K and V from
    f32 values that differ by reassociation, an entry may land one quantum
    apart and move a router's input as it moves the logits, so the
    differing choices are printed and the logits' bound decides. The
    capacity factor is the real 1.25, so idle slots compete for capacity
    with live ones."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.layers import moe as moe_mod
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine, poisson_workload

    base = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                               n_layers=2, compute_dtype="float32")
    params = build_model(base).init(seed=0, device="cuda")

    def workload():
        return [dataclasses.replace(r, arrival_s=0.0) for r in
                poisson_workload(n_requests=6, vocab=base.vocab,
                                 rate_rps=50.0, prompt_len_range=(16, 64),
                                 gen_len_range=(8, 16), seed=1)]

    for pool, paged in ((p, g) for p in ("f32", "int8")
                        for g in (False, True)):
        layout = "paged" if paged else "dense-slot"
        cfg = dataclasses.replace(
            base, kv_cache_dtype="int8" if pool == "int8" else "bfloat16")
        plain_cfg = dataclasses.replace(cfg, moa="serial?backend=torch&"
                                        "chunk=4096", attn_backend="torch")
        runs = {}
        for path, c in (("torch", plain_cfg), ("kernel", cfg)):
            # both eager: a graph's replay runs no Python, so its routing
            # could not be logged or forced (captured = eager bit for bit
            # is the serve phase's check)
            eng = ServeEngine(build_model(c), params, n_slots=4, max_len=96,
                              paged=paged, block_size=16, device="cuda",
                              cuda_graphs=False)
            logits, ticks = {}, [0]
            forced = None if path == "torch" else {
                r.uid: r.tokens for r in runs["torch"]["results"]}
            _replay(torch, eng, logits, forced)
            tick = eng.tick

            def counted(results, tick=tick, ticks=ticks):
                tick(results)
                ticks[0] += 1

            eng.tick = counted
            log, undo = _routing(torch, moe_mod, ticks, None if forced is None
                                 else runs["torch"]["log"])
            ops.reset_launch_counts()
            try:
                results, _ = eng.run(workload())
            finally:
                undo()
            counts = ops.launch_counts()
            want = served_kernels(cfg)
            if (path == "kernel" and not all(counts[k] for k in want)) or (
                    path == "torch" and any(counts.values())):
                raise AssertionError(f"moe parity {layout} {path} "
                                     f"launches: {counts}")
            runs[path] = {"results": results, "logits": logits, "log": log}
            del eng
        plain, kern = runs["torch"], runs["kernel"]
        if set(plain["logits"]) != set(kern["logits"]):
            raise AssertionError(f"moe parity {pool} {layout}: teacher-"
                                 "forced steps differ")
        differ = _routing_differences(plain["log"], kern["log"])
        away = [d for d in differ if d["gap"] >= ROUTE_GAP]
        bound = None
        if pool == "int8":
            bound = _int8_step_bound(
                torch, cfg, build_model(plain_cfg), params, workload(),
                {r.uid: r.tokens for r in plain["results"]})
        worst, over = 0.0, []
        for key, zp in plain["logits"].items():
            d = float((kern["logits"][key] - zp).abs().max())
            lim = LOGIT_TOL if bound is None else _step_bound(
                bound["parts"], float(zp.abs().max()),
                bound["rms"][key[0]][key[1]])
            if d > lim:
                over.append({"uid": key[0], "step": key[1], "diff": d,
                             "bound": lim})
            worst = max(worst, d)
        drops = sum(int((~keep).sum()) for _, _, keep, _ in plain["log"])
        line = {"phase": "parity", "what": "moe", "layout": layout,
                "pool": pool, "kv_cache_dtype": cfg.kv_cache_dtype,
                "arch": cfg.name, "n_layers": 2, "compute_dtype": "float32",
                "requests": len(plain["results"]),
                "routing_calls": len(plain["log"]),
                "dropped_choices": drops,
                "routing": "teacher-forced",
                "own_choices_differ": len(differ),
                "own_choice_differences": differ[:5],
                "route_gap": ROUTE_GAP if bound is None else None,
                "logit_steps_compared": len(plain["logits"]),
                "max_logit_diff": worst,
                "logit_tol": LOGIT_TOL if bound is None else "one quantum",
                "out_of_bound": over[:5]}
        if bound is not None:
            line["bound_parts"] = bound["parts"]
        emit(line)
        if bound is None and away:
            raise AssertionError(f"moe parity {pool} {layout}: the kernel "
                                 f"path's routing differs away from a "
                                 f"near-tie: {away[:5]}")
        if over or not plain["logits"]:
            raise AssertionError(f"moe parity {pool} {layout}: logits out "
                                 f"of bound at {over[:5]} "
                                 f"({len(plain['logits'])} steps compared)")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: the paper path
# ---------------------------------------------------------------------------


def paper_phase(torch):
    """``paper_repro.run_all`` on the card, checked; returns its launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch import paper_repro
    from repro_torch.paper.timing import parse_derived

    t0 = time.monotonic()
    ops.reset_launch_counts()
    with recorded_calls(ops, path_kernels("paper")) as calls:
        out = paper_repro.run_all("cuda", batch=16, verbose=False)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    seconds = time.monotonic() - t0
    # every launch of the run, at its type, shapes and options, must be one
    # that a kernels-phase row held against its plain version
    unchecked = sorted(calls - CHECKED)
    if unchecked:
        raise AssertionError(f"the paper run launched kernels at {unchecked}"
                             f", which no kernels-phase row checked")
    for name, us, derived in out["benchmarks"]:
        d = parse_derived(derived)
        emit({"phase": "paper", "what": name, "us_per_call": us,
              "derived": derived})
        for key, want in PAPER_DERIVED.get(name, {}).items():
            if d[key] != want:
                raise AssertionError(f"{name}: {key}={d[key]}, the "
                                     f"reference example gives {want}")
        if name == "fig5_loa":
            mred8 = float(d["mred8bit_max"].split("(")[0])
            if not mred8 < 0.10:
                raise AssertionError(f"fig5: MRED(8-bit) {mred8} >= 0.10")
        if name == "fig4_serialization" and d["route"] != "kernel":
            raise AssertionError(f"fig4 ran on the {d['route']} route")
        if name == "moa_strategies":
            # the moa_scope loss line: one model's loss under "tree" and
            # "serial?chunk=16", the same bf16 operands summed in f32 in
            # other groupings, each product rounded once to bf16: the
            # losses (~5.6) move far less than TRAIN_LOSS_TOL
            if not float(d["loss_delta"]) < TRAIN_LOSS_TOL:
                raise AssertionError(f"moa_strategies: loss_delta "
                                     f"{d['loss_delta']}")
            # the exact strategies' f32 products against float64, K = 4096
            # unit-normal products: a random walk of K roundings at
            # ulp(|partial| < 256) = 2**-16 gives sqrt(K) * 2**-17 = 4.9e-4;
            # the limit is 4 times that (a dropped product moves an entry
            # by ~1)
            limit = 4 * math.sqrt(4096) * 2.0 ** -17
            if not float(d["strategy_max_err"]) < limit:
                raise AssertionError(f"moa_strategies: strategy_max_err "
                                     f"{d['strategy_max_err']} >= {limit}")
    for row in out["loa_conv"]:
        emit(dict({"phase": "paper", "what": "loa_conv"}, **row))
        # exact at l = 0 on both routes, and on the kernel route wherever K
        # is one cluster (no LOA fold: the paper example's K = 75)
        if not row["bit_exact_vs_plain"] or (
                row["l"] == 0 and any(row["mred"].values())) or (
                row["loa_folds"] == 0 and row["mred"]["kernel"]):
            raise AssertionError(f"loa_conv {row['shape']} l={row['l']}: "
                                 f"{row}")
    for row in out["cnn"]:
        emit(dict({"phase": "paper", "what": "cnn"}, **row))
        if row["route"] != "kernel":
            raise AssertionError(f"cnn {row['net']} ran on {row['route']}")
    emit({"phase": "paper", "what": "launches", "launches": launches,
          "distinct_calls_checked": len(calls), "seconds": seconds})
    missing = [k for k in path_kernels("paper") if launches[k] == 0]
    if missing:
        raise AssertionError(f"the paper run launched no {missing}")
    return launches


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

#: the train phase's full-width runs: arch, depth, batch, sequence, steps.
#: The depth is cut so that the reference's train state fits one card: f32
#: master weights, two f32 AdamW moments and f32 gradients are 16 bytes a
#: parameter (llama3-8b's 8.03 B at 32 layers would take ~128 GB)
TRAIN_RUNS = {"llama3-8b": dict(layers=4, batch=8, seq=512, steps=10),
              "moonshot-v1-16b-a3b": dict(layers=2, batch=4, seq=256,
                                          steps=3),
              # the families phase: full depth where the state fits (hubert
              # 0.99 B parameters, ~16 GB; zamba2 1.2 B; mamba2 0.37 B),
              # llava cut to 2 layers (2.08 B: ~33 GB) on 2 x (2304
              # patches + 256 text tokens)
              "hubert-xlarge": dict(layers=48, batch=8, seq=512, steps=10),
              "llava-next-34b": dict(layers=2, batch=2, seq=2560, steps=3),
              # zamba2's routes drift apart through 38 Mamba-2 layers
              # at a random init: its kernel route is also held to the
              # noise floor (``floor``, :func:`train_kernel_vs_plain`)
              "zamba2-1.2b": dict(layers=38, batch=8, seq=512, steps=10,
                                  floor=True),
              "mamba2-370m": dict(layers=48, batch=8, seq=512, steps=10)}
#: the families phase's served runs, ``m`` of their projections: hubert's
#: encode of 4 x 1000 frames; llava's prefill of 2 x (2304 patches + 64
#: text tokens) and its decode steps (2 rows)
HUBERT_ENCODE = dict(batch=4, frames=1000)
LLAVA_SERVE = dict(batch=2, patches=2304, text=64, decode=16)
FAMILY_SERVED_M = {
    "hubert-xlarge": (HUBERT_ENCODE["batch"] * HUBERT_ENCODE["frames"],),
    "llava-next-34b": (LLAVA_SERVE["batch"] * (LLAVA_SERVE["patches"]
                                              + LLAVA_SERVE["text"]),
                       LLAVA_SERVE["batch"])}
#: one step's loss, ``dot_moa`` against the plain route (``backend=torch``)
#: from the same state and batch: both take the same bf16 operands and
#: round each product once to bf16 after f32 sums in other orders (1 bf16
#: ulp, relative 2**-8, apart at most per product), so activations drift
#: by a few bf16 ulps through the layers; a loss near ln(vocab) ~ 12 moves
#: far less than 1e-2
TRAIN_LOSS_TOL = 1e-2
#: the worst parameter leaf's relative gradient error ``|g_k - g_p| /
#: |g_p|`` (Frobenius norms) between the two routes: each gradient is a
#: sum over 4096 tokens of products of activations that differ by a few
#: bf16 ulps (2**-8 each), so the sums agree to about 1e-2
TRAIN_GRAD_REL_TOL = 5e-2
#: each MoE routing call's router probabilities, kernel route against the
#: plain route (relative error, Frobenius): each logit is a sum over
#: d_model of activations that drift by a few bf16 ulps, as each
#: gradient's sum is, and a probability's relative change is its logit's
#: change (less the mean change), logits of order 1 at init (normed
#: activations against 1/sqrt(d_model) weights): about 1e-2 apart
TRAIN_ROUTE_REL_TOL = 5e-2
#: the noise-floor witness of a run whose routes drift far apart through
#: its depth (``floor`` in ``TRAIN_RUNS``): the plain route again with each
#: product's K summed in chunks of this many operands (the plain route's
#: 4096): the same bf16 operands, each product's f32 sum in another order
#: and rounded once to bf16, as the kernel's are, so that its gradients'
#: distance from the plain route's is the arch's bf16 noise floor
TRAIN_FLOOR_CHUNK = 512
#: such a run's kernel route: its worst leaf's relative gradient error
#: against the plain route, at most this many times the witness's worst
#: leaf's. Rounding alone reads about the floor (both are sums in other
#: orders of the same products: zamba2 at full depth on an H100, 1.05x);
#: a product that misses a 64-wide K tile reads 12x. A fault of rounding
#: size (K slices each rounded to bf16, ~2x a right kernel's error a
#: product) drowns in 38 layers of drift: the kernels rows catch it,
#: product by product
TRAIN_FLOOR_RATIO = 2.0
#: the quickstart's learn check: 60 smoke steps must lose more than this
LEARN_DROP = 0.2


def projections(arch: str, m: int) -> list:
    """``(m, k, n)`` of every unbatched ``dot_moa`` projection of
    ``arch``'s layers at ``m`` tokens: q, k, v and o, and the MLP's (gate,
    up and down of a SwiGLU, in and out of the encoder's GELU MLP; the
    hybrid's shared block); none for the SSM family (its projections are
    plain products), the MoE's experts and router apart
    (:func:`train_moe_shapes`)."""
    from repro_torch.configs.registry import get_config

    cfg, d = get_config(arch), get_config(arch).d_model
    if cfg.family == "ssm":
        return []
    hd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {(m, d, hd), (m, d, kvd), (m, hd, d)}
    if cfg.family != "moe":
        shapes |= {(m, d, cfg.d_ff), (m, cfg.d_ff, d)}
    return sorted(shapes)


def train_projections(arch: str) -> list:
    """:func:`projections` of a train step of ``arch`` (``TRAIN_RUNS``),
    ``m`` its batch's tokens (a VLM's patches among them)."""
    run = TRAIN_RUNS[arch]
    return projections(arch, run["batch"] * run["seq"])


def train_moe_shapes(arch: str) -> dict:
    """An MoE train step's kernel shapes (``TRAIN_RUNS``): ``tokens`` (the
    router's rows and the top-k combine's columns over ``d_model``) and
    ``rows`` (each expert's rows in the batched projections: the groups'
    capacity, as ``layers/moe.py`` splits the tokens and sizes it)."""
    from repro_torch.configs.registry import get_config

    cfg, run = get_config(arch), TRAIN_RUNS[arch]
    T = run["batch"] * run["seq"]
    G = max(T // 4096, 1)              # moe_forward's group_size
    while T % G:
        G -= 1
    C = max(int(T // G * cfg.top_k / cfg.n_experts * cfg.capacity_factor),
            1)
    return {"tokens": T, "rows": G * C}


def train_emit(row: dict) -> None:
    """A ``train`` line, after the card's name and power limit."""
    print(nvidia_smi(), flush=True)
    emit(dict({"phase": "train"}, **row))


def _cuda_batch(data, step: int) -> dict:
    return {k: v.cuda() for k, v in data.batch_for_step(step).items()}


def _grad_errors(torch, got, want) -> dict:
    """``|got - want| / |want|`` (Frobenius) per gradient leaf."""
    from repro_torch.interop import tree_leaves

    w = dict(tree_leaves(want))
    return {path: float(torch.linalg.vector_norm((g - w[path]).double())
                        / max(float(torch.linalg.vector_norm(
                            w[path].double())), 1e-30))
            for path, g in tree_leaves(got)}


def _route_drift(torch, plain, kernel, differ) -> dict:
    """Two routing logs of the same calls (:func:`_routing`), ``differ``
    their :func:`_routing_differences`: each call's relative error of the
    kernel route's router probabilities ``q`` against the plain route's
    ``p`` (Frobenius), the largest ``|q - p|``, and the choices whose gap
    exceeds the near-tie the drift allows at their token, ``2 max_e |q_e -
    p_e|``: where the plain route ranks ``a`` at the first differing place
    and the kernel route ``c`` (so ``q_c >= q_a``, and ``p_c`` is at most
    the next probability), ``gap <= p_a - p_c <= (p_a - q_a) + (q_c -
    p_c)``."""
    rel, worst, over = [], 0.0, []
    for (_, _, _, p), (_, _, _, q) in zip(plain, kernel):
        d = q.double() - p.double()
        rel.append(float(d.norm() / p.double().norm()))
        worst = max(worst, float(d.abs().max()))
    for x in differ:
        p, q = (log[x["call"]][3][x["group"], x["token"]].double()
                for log in (plain, kernel))
        tie = 2 * float((q - p).abs().max())
        if x["gap"] > tie:
            over.append(dict(x, near_tie=tie))
    return {"prob_rel_errs": rel, "prob_max_abs_diff": worst,
            "prob_rel_tol": TRAIN_ROUTE_REL_TOL,
            "gap_bound": 2 * worst, "past_near_tie": over[:5],
            "ok": max(rel) <= TRAIN_ROUTE_REL_TOL and not over}


def _plain_cfg(cfg):
    """``cfg`` on the plain route: the MOA backend ``torch`` and the plain
    attention."""
    spec = cfg.moa + ("&" if "?" in cfg.moa else "?") + "backend=torch"
    return dataclasses.replace(cfg, moa=spec, attn_backend="torch")


def train_kernel_vs_plain(torch, cfg, params, batch, *,
                          floor: bool = False) -> dict:
    """One step's loss and gradients at ``params`` on ``batch``: the
    ``dot_moa`` route (``auto``: the kernel on the card, through its
    ``autograd.Function``) against the plain route (``backend=torch``: f32
    products of the same operands). An MoE's kernel route is
    teacher-forced on the plain route's expert choices (``_routing``; at a
    random init the router's probabilities over 64 experts lie close
    together, and bf16 activations a few ulps apart pick other experts for
    some tokens): the number of tokens whose own choice differed is
    reported, and each routing call is held to :func:`_route_drift`. Fails
    over ``TRAIN_LOSS_TOL``, ``TRAIN_GRAD_REL_TOL`` or
    ``TRAIN_ROUTE_REL_TOL``, or on an own choice that differs past its
    near-tie. With ``floor``, the noise floor's witness too (the plain
    route at ``TRAIN_FLOOR_CHUNK``): it fails as well where the kernel
    route's worst leaf exceeds ``TRAIN_FLOOR_RATIO`` times the witness's.
    """
    from repro_torch.launch import steps
    from repro_torch.layers import moe as moe_mod
    from repro_torch.models.api import build_model

    plain_cfg = _plain_cfg(cfg)
    moe = cfg.family == "moe"
    if moe:
        plain_log, undo = _routing(torch, moe_mod, [0])
    try:
        g_p, m_p = steps.loss_and_grads(build_model(plain_cfg), params,
                                        batch)
    finally:
        if moe:
            undo()
    if moe:
        kernel_log, undo = _routing(torch, moe_mod, [0], forced=plain_log)
    try:
        g_k, m_k = steps.loss_and_grads(build_model(cfg), params, batch)
    finally:
        if moe:
            undo()
    routing = {}
    if moe:
        diffs = _routing_differences(plain_log, kernel_log)
        routing = {"routing_calls": len(plain_log),
                   "own_choice_differences": len(diffs),
                   "max_gap": max((d["gap"] for d in diffs), default=None),
                   **_route_drift(torch, plain_log, kernel_log, diffs)}
    errs = _grad_errors(torch, g_k, g_p)
    worst = max(errs, key=errs.get)
    not_finite = _not_finite(torch, g_k)
    witness = {}
    if floor:
        spec = plain_cfg.moa.replace("chunk=4096",
                                     f"chunk={TRAIN_FLOOR_CHUNK}")
        if spec == plain_cfg.moa:
            raise AssertionError(f"{cfg.name}: no chunk=4096 in {spec!r}")
        del g_k
        g_w, m_w = steps.loss_and_grads(
            build_model(dataclasses.replace(plain_cfg, moa=spec)), params,
            batch)
        floor_errs = _grad_errors(torch, g_w, g_p)
        floor_worst = max(floor_errs, key=floor_errs.get)
        witness = {
            "floor_moa": spec,
            "floor_loss_diff": abs(float(m_w["loss"])
                                   - float(m_p["loss"])),
            "floor_worst_leaf": floor_worst,
            "floor_worst_grad_rel_err": floor_errs[floor_worst],
            "floor_ratio": errs[worst] / max(floor_errs[floor_worst],
                                             1e-30),
            "floor_ratio_tol": TRAIN_FLOOR_RATIO,
            "floor_grad_rel_errs": floor_errs}
        del g_w
    row = {"what": f"{cfg.name} kernel vs plain",
           **routing,
           "plain_moa": plain_cfg.moa, "loss_kernel": float(m_k["loss"]),
           "loss_plain": float(m_p["loss"]),
           "loss_diff": abs(float(m_k["loss"]) - float(m_p["loss"])),
           "loss_tol": TRAIN_LOSS_TOL, "worst_leaf": worst,
           "worst_grad_rel_err": errs[worst],
           "grad_rel_tol": TRAIN_GRAD_REL_TOL,
           "grad_leaves_not_finite": not_finite
           + _not_finite(torch, g_p),
           "grad_rel_errs": errs, **witness}
    train_emit(row)
    if not (row["loss_diff"] <= TRAIN_LOSS_TOL
            and errs[worst] <= TRAIN_GRAD_REL_TOL
            and not row["grad_leaves_not_finite"]
            and routing.get("ok", True)
            and witness.get("floor_ratio", 0.0) <= TRAIN_FLOOR_RATIO):
        raise AssertionError(f"train {cfg.name}: kernel vs plain loss "
                             f"{row['loss_diff']}, {worst} {errs[worst]}, "
                             f"routing {routing}, noise floor "
                             f"{witness.get('floor_worst_grad_rel_err')}")
    return row


def _not_finite(torch, tree) -> list:
    """The leaves (by path) of ``tree`` holding a NaN or an infinity."""
    from repro_torch.interop import tree_leaves

    return [path for path, t in tree_leaves(tree)
            if not bool(torch.isfinite(t).all())]


def _states_equal(torch, a, b) -> list:
    """The leaves (by path) in which two train states differ in a bit."""
    from repro_torch.interop import tree_leaves

    wb = dict(tree_leaves(b))
    return [path for path, t in tree_leaves(a)
            if not torch.equal(t.detach(), wb[path].detach().to(t.device))]


#: the card's memory (bytes) left to spare beside a second train state and
#: its run's working memory, for the first state to stay on the card
KEEP_MARGIN = 8 << 30


def _keep_state(torch, state) -> tuple:
    """The determinism check's first end state, and where it is kept: on
    the card (the same tensors) where a second state and the first run's
    working memory fit beside it with ``KEEP_MARGIN`` to spare, else in
    pinned host memory. A pageable copy there and back held most of the
    check's time (llama3-8b at 4 layers, a 24.6 GB state: 20 s, 4.4 s of
    it the 6 steps)."""
    from repro_torch.interop import tree_leaves, tree_map

    held = sum(t.numel() * t.element_size() for _, t in tree_leaves(state))
    work = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    if torch.cuda.mem_get_info()[0] - held - work > KEEP_MARGIN:
        return state, "cuda"

    def pinned(t):
        return torch.empty_like(t, device="cpu",
                                pin_memory=True).copy_(t.detach())

    return tree_map(pinned, state), "pinned host"


def _profiled_step(torch, model, state, batch, hyper) -> tuple:
    """One train step in two ``torch.profiler`` sessions, the gradients
    and then the optimizer: device ms by group (``dot_moa``, ``library
    gemm`` (cuBLAS), ``other``; ``optimizer`` is the second session's
    whole), launches and host ms. CUDA activity only: recording the CPU's
    ops too gives the same device ms and takes three times the host time
    (zamba2 on an H100: 20.9 s against 6.5 s a profiled step)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps

    groups, calls = collections.Counter(), collections.Counter()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        grads, metrics = steps.loss_and_grads(model, state["params"], batch)
        torch.cuda.synchronize()
    for key, (ms, n) in device_events(torch, prof).items():
        groups[kernel_group(key)] += ms
        calls[kernel_group(key)] += n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, metrics = steps.apply_gradients(state, grads, metrics,
                                               hyper=hyper)
        torch.cuda.synchronize()
    host_ms = (time.monotonic() - t0) * 1e3
    for ms, n in device_events(torch, prof).values():
        groups["optimizer"] += ms
        calls["optimizer"] += n
    return state, {"groups_ms": dict(groups), "kernels": dict(calls),
                   "device_ms": sum(groups.values()),
                   "host_ms_profiled": host_ms}


def train_flops(torch, cfg, params, batch: int, seq: int) -> float:
    """Model FLOPs of a train step: 6 for each multiplying parameter and
    token it multiplies (the embedding's gather, the encoder's position
    and mask tables and the norms multiply nothing; the hybrid's shared
    block counts once an application; a VLM's unembedding multiplies its
    text tokens, its projector its patches; attention's score products and
    the SSD scan are not counted)."""
    def size(tree):
        return sum(t.numel() for t in _leaves(tree))

    emb = params["embed"]
    per_token = size(params["layers"])
    if cfg.family == "hybrid":
        per_token += (cfg.n_layers // cfg.attn_every) * (
            size(params["shared_attn"]) + size(params["shared_mlp"]))
    tokens, text = batch * seq, batch * (seq - cfg.n_patches)
    flops = per_token * tokens + emb.get("unembed", emb["table"]).numel() \
        * text
    if cfg.family == "vlm":
        flops += size(params["mm_projector"]) * batch * cfg.n_patches
    return 6.0 * flops


def train_full_width(torch, arch: str) -> dict:
    """``arch`` at full width, its depth cut where ``TRAIN_RUNS`` says: the
    reference's train state (f32 master weights from the port's
    initializer, seed 0; f32 AdamW moments; bf16 compute, remat "full")
    on ``SyntheticLMData`` (seed 0; the encoder's frames, the VLM's
    patches). Kernel against plain on the first batch (a family that runs
    no kernel, the SSM: its gradients, every one finite); the same 3 steps
    twice from one init, bit for bit (losses and every leaf of the state:
    the first run's end state stays on the card where two states fit,
    else in pinned host memory, :func:`_keep_state`); then the counted
    run: ``steps`` steps, each timed on the host clock between
    synchronisations, every loss finite, every kernel launch at a type,
    shapes and options a kernels-phase row checked (the SSM: none
    launched); then, but for the MoE, one profiled step by group. Returns
    the counted run's launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.api import build_model

    run = TRAIN_RUNS[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=run["layers"])
    hyper = steps.TrainHyper(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    data = SyntheticLMData(
        vocab=cfg.vocab, seq_len=run["seq"], global_batch=run["batch"],
        seed=0, family="encoder" if cfg.family == "encoder" else "lm",
        d_model=cfg.d_model, n_patches=cfg.n_patches)
    batches = [_cuda_batch(data, s) for s in range(run["steps"] + 4)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def fresh():
        # a model of its own each time: a model keeps the parameters it
        # drew registered (their storage is the state's), and they must be
        # freed with that state
        return steps.init_train_state(build_model(cfg), hyper=hyper,
                                      seed=0, device="cuda")

    t0 = time.monotonic()
    state = fresh()
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    train_emit({"what": f"{arch} init", "family": cfg.family,
                "n_layers": cfg.n_layers, "n_params": n_params,
                "state_gb": torch.cuda.memory_allocated() / 1e9,
                "init_s": init_s, "param_dtype": cfg.param_dtype,
                "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
                "moa": cfg.moa, "batch": run["batch"], "seq": run["seq"]})
    model = build_model(cfg)
    if cfg.family == "ssm":
        grads, metrics = steps.loss_and_grads(model, state["params"],
                                              batches[0])
        bad = _not_finite(torch, grads)
        train_emit({"what": f"{arch} gradients", "loss":
                    float(metrics["loss"]), "leaves": len(_leaves(grads)),
                    "grad_leaves_not_finite": bad})
        del grads
        if bad or not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"train {arch}: gradients not finite in "
                                 f"{bad}")
    else:
        train_kernel_vs_plain(torch, cfg, state["params"], batches[0],
                              floor=run.get("floor", False))
    step_fn = steps.build_train_step(model, hyper=hyper)
    # determinism: the same 3 steps from the same init, twice
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        if i:
            state = fresh()
        got = []
        for s in range(3):
            state, m = step_fn(state, batches[s])
            got.append(float(m["loss"]))
        losses.append(got)
        if not i:
            first, kept = _keep_state(torch, state)
            del state
            gc.collect()
            torch.cuda.empty_cache()
    differ = _states_equal(torch, state, first)
    del first
    gc.collect()
    train_emit({"what": f"{arch} determinism", "steps": 3, "losses": losses,
                "losses_equal": losses[0] == losses[1],
                "first_state_kept_on": kept,
                "state_leaves_differing": differ})
    if losses[0] != losses[1] or differ:
        raise AssertionError(f"train {arch}: two runs of 3 steps differ: "
                             f"losses {losses}, leaves {differ}")
    start = 3
    # the counted run
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    wall, losses = [], []
    with recorded_calls(ops, ["dot_moa", "moa_reduce"]) as calls:
        for s in range(start, start + run["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batches[s])
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = run["batch"] * run["seq"]
    flops = train_flops(torch, cfg, state["params"], run["batch"],
                        run["seq"])
    step_ms = statistics.median(wall)
    row = {"what": f"{arch} steps",
           "n_layers": cfg.n_layers, "batch": run["batch"], "seq": run["seq"],
           "steps": run["steps"], "losses": losses,
           "step_ms": wall, "step_ms_median": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "model_tflop_per_step": flops / 1e12,
           "model_tflop_per_s": flops / step_ms / 1e9,
           "peak_share_989": flops / step_ms / 1e9 / 989.0,
           "launches": launches,
           "launches_per_step": {k: v / run["steps"]
                                 for k, v in launches.items()},
           "distinct_calls": len(calls),
           "unchecked_calls": sorted(calls - CHECKED),
           "peak_mem_gb": peak_gb}
    if cfg.family != "moe":
        state, prof = _profiled_step(torch, model, state,
                                     batches[start + run["steps"]], hyper)
        row["profiled_step"] = prof
    train_emit(row)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {arch}: a loss is not finite: {losses}")
    want = {"moe": ["dot_moa", "moa_reduce"], "ssm": []}.get(cfg.family,
                                                             ["dot_moa"])
    missing = [k for k in want if launches[k] == 0]
    extra = [k for k, n in launches.items() if n and k not in want]
    if missing or extra:
        raise AssertionError(f"train {arch}: the counted run launched no "
                             f"{missing}, or launched {extra}")
    if row["unchecked_calls"]:
        raise AssertionError(f"train {arch}: the counted run launched "
                             f"kernels at {row['unchecked_calls']}, which no "
                             "kernels-phase row checked")
    del state, model, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _smoke_loop(ckpt_dir, fails, *, steps=20, warmup=2, seq_len=32,
                save_every=5, log_every=1):
    """The quickstart's smoke llama3-8b (batch 8, lr 5e-3) on a
    ``TrainLoop`` on the card, failing at the steps ``fails``."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.launch.steps import TrainHyper
    from repro_torch.launch.train import TrainLoop
    from repro_torch.runtime import FailureInjector

    return TrainLoop(smoke_config(get_config("llama3-8b")), steps=steps,
                     global_batch=8, seq_len=seq_len, ckpt_dir=ckpt_dir,
                     save_every=save_every, log_every=log_every,
                     hyper=TrainHyper(peak_lr=5e-3, warmup_steps=warmup,
                                      total_steps=steps),
                     injector=FailureInjector(fails), device="cuda",
                     async_save=False)


def train_phase(torch) -> dict:
    """Training on the card (every served model freed first): llama3-8b
    and moonshot at full width (``train_full_width``); a smoke
    ``TrainLoop`` with two injected failures against the failure-free run,
    bit for bit (every step's loss and every leaf of the final state); the
    quickstart's 60 smoke steps must lose more than ``LEARN_DROP``.
    Returns the counted runs' launches by run."""
    import io
    import tempfile

    runs = {"train/llama3-8b": train_full_width(torch, "llama3-8b"),
            "train/moonshot": train_full_width(torch, "moonshot-v1-16b-a3b")}
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(out):
        t0 = time.monotonic()
        base = _smoke_loop(os.path.join(tmp, "a"), [])
        want, _ = base.run()
        faulty = _smoke_loop(os.path.join(tmp, "b"), [7, 13])
        got, result = faulty.run(max_restarts=2)
        restart_s = time.monotonic() - t0
    clean = {m["step"]: m["loss"] for m in base.metrics_history}
    resumed = {m["step"]: m["loss"] for m in faulty.metrics_history}
    differ = _states_equal(torch, want, got)
    train_emit({"what": "restart", "restarts": result.restarts,
                "completed": result.completed, "failures": result.failures,
                "losses_equal": clean == resumed,
                "state_leaves_differing": differ, "seconds": restart_s})
    if not (result.completed and result.restarts == 2 and clean == resumed
            and not differ):
        raise AssertionError(f"train restart: {result}, losses equal "
                             f"{clean == resumed}, leaves {differ}")
    with contextlib.redirect_stdout(out):
        t0 = time.monotonic()
        loop = _smoke_loop(None, [], steps=60, warmup=5, seq_len=64,
                           log_every=10)
        loop.run_segment(0, None)
    losses = [m["loss"] for m in loop.metrics_history]
    train_emit({"what": "learn", "steps": 60, "losses": losses,
                "drop": losses[0] - losses[-1], "min_drop": LEARN_DROP,
                "seconds": time.monotonic() - t0})
    if not losses[0] - losses[-1] > LEARN_DROP:
        raise AssertionError(f"train learn: {losses}")
    return runs


# ---------------------------------------------------------------------------
# phase 7: the encoder and VLM families, and the SSM / hybrid gradients
# ---------------------------------------------------------------------------

#: the served runs' bf16 logits, kernel route against plain route: the
#: relative (Frobenius) difference of a call's logits. Each of a layer's
#: seven products rounds once to bf16 on both routes after f32 sums in
#: other orders, so each product's output differs by up to 1 bf16 ulp
#: (2**-8 relative); the residual stream sums the layers' outputs, so the
#: hidden state drifts like a random walk of those roundings, sqrt(48 or 60
#: layers x 7) x 2**-8 / sqrt(7) ~ 3e-2 relative to a layer's output at
#: most, and the logits (a product of it) by as much
FAMILY_LOGIT_REL_TOL = 5e-2


def _rel(torch, got, want) -> float:
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def _argmax_near_ties(torch, got, want) -> dict:
    """Rows of two logit tensors ``(..., V)`` whose argmax differs, and
    those whose plain-route (``want``) top-2 gap exceeds twice the row's
    largest difference: two vectors that differ by at most ``d`` anywhere
    can rank their top two apart only where those lie within ``2 d``."""
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    differ = (g.argmax(-1) != w.argmax(-1)).nonzero().flatten().tolist()
    top = torch.topk(w, 2, dim=-1).values
    gap = (top[:, 0] - top[:, 1])
    bound = 2 * (g - w).abs().amax(-1)
    past = [i for i in differ if float(gap[i]) > float(bound[i])]
    return {"rows": g.shape[0], "argmax_agree": 1 - len(differ) / g.shape[0],
            "argmax_differ": len(differ), "past_near_tie": past[:5]}


def hubert_encode(torch) -> dict:
    """hubert-xlarge at full width and depth (48 layers, bf16 weights from
    the port's initializer, seed 0) encodes 4 x 1000 frames (0.02 x normal
    frame embeddings, 35 % masked, seed 0) through ``Model.prefill``: the
    counted run on the kernel route (``dot_moa`` for every projection, the
    flash kernel bidirectional at head_dim 80), then the same call on the
    plain route. The logits must be finite and of shape (4, 1000, 504),
    within ``FAMILY_LOGIT_REL_TOL`` of the plain route's, and every frame
    whose argmax differs must sit at a near-tie; every launch at a call
    key a kernels row checked; the plain route launches nothing. Returns
    the counted run's launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config("hubert-xlarge"),
                              param_dtype="bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, plain = build_model(cfg), build_model(_plain_cfg(cfg))
    t0 = time.monotonic()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    B, T = HUBERT_ENCODE["batch"], HUBERT_ENCODE["frames"]
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"frames": 0.02 * torch.randn((B, T, cfg.d_model), device="cuda",
                                          generator=g),
             "mask": torch.rand((B, T), device="cuda", generator=g) < 0.35}

    def encode(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = m.prefill(params, batch, max_len=T)
        torch.cuda.synchronize()
        return logits, cache, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        encode(model)                     # plans and workspaces
        ops.reset_launch_counts()
        with recorded_calls(ops, ["dot_moa", "flash_attention"]) as calls:
            got, cache, ms = encode(model)
        launches = ops.launch_counts()
        ops.reset_launch_counts()
        want, _, plain_ms = encode(plain)
        plain_launches = ops.launch_counts()
    flops = 2.0 * sum(t.numel() for t in _leaves(params["layers"])) * B * T \
        + 2.0 * params["embed"]["unembed"].numel() * B * T
    row = {"phase": "families", "what": "hubert-xlarge encode",
           "n_layers": cfg.n_layers, "n_params": model.param_count(),
           "init_s": init_s, "batch": B, "frames": T,
           "shape": list(got.shape), "pos": int(cache["pos"]),
           "encode_ms": ms, "plain_ms": plain_ms,
           "model_tflop": flops / 1e12,
           "model_tflop_per_s": flops / ms / 1e9,
           "max_logit_diff": float((got - want).abs().max()),
           "max_abs_logit": float(want.abs().max()),
           "logit_rel_err": _rel(torch, got, want),
           "logit_rel_tol": FAMILY_LOGIT_REL_TOL,
           **_argmax_near_ties(torch, got, want),
           "launches": launches, "plain_launches": plain_launches,
           "unchecked_calls": sorted(calls - CHECKED),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(nvidia_smi(), flush=True)
    emit(row)
    ok = (list(got.shape) == [B, T, cfg.vocab] and row["pos"] == T
          and bool(torch.isfinite(got).all())
          and row["logit_rel_err"] <= FAMILY_LOGIT_REL_TOL
          and not row["past_near_tie"] and not row["unchecked_calls"]
          and launches["dot_moa"] and launches["flash_attention"]
          and not any(plain_launches.values()))
    if not ok:
        raise AssertionError(f"hubert encode: {row}")
    del params, model, plain, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _llava_batch(torch, cfg, seed: int) -> dict:
    """``LLAVA_SERVE``'s prompts: 0.02 x normal patch embeddings and
    uniform text tokens, drawn on the card from ``seed``."""
    B, P, S = (LLAVA_SERVE[k] for k in ("batch", "patches", "text"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"patches": 0.02 * torch.randn((B, P, cfg.d_model), device="cuda",
                                          generator=g),
            "tokens": torch.randint(0, cfg.vocab, (B, S), device="cuda",
                                    generator=g, dtype=torch.int32)}


def vlm_generate(torch, model, params, batch, steps: int, forced=None):
    """``Model.prefill`` of ``batch`` (patches ahead of the text) into a
    dense-slot cache of whole 16-token pages, then ``steps`` greedy
    ``decode_step`` calls (``forced (B, steps)``: feed those tokens
    instead). Returns the greedy tokens ``(B, steps + 1)``, the next-token
    logits of every call ``(B, steps + 1, V)`` in f32, and the host ms of
    the prefill and of each decode step (each ending in a
    synchronisation)."""
    B, S = batch["tokens"].shape
    n = batch["patches"].shape[1] + S
    max_len = -(-(n + steps) // 16) * 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_len=max_len)
    torch.cuda.synchronize()
    times = [(time.perf_counter() - t0) * 1e3]
    if int(cache["pos"]) != n:
        raise AssertionError(f"vlm prefill: cursor {cache['pos']} != {n}")
    cache["pos"] = torch.tensor(n, dtype=torch.int32, device="cuda")
    out = [logits[:, -1].float()]
    for s in range(steps):
        nxt = out[-1].argmax(-1) if forced is None else forced[:, s]
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache,
                                          nxt[:, None].to(torch.int32))
        out.append(logits[:, -1].float())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    logits = torch.stack(out, 1)
    return logits.argmax(-1), logits, times


def _first_divergence(torch, got_toks, want_toks, got, want) -> list:
    """Per row, the first step whose greedy token differs between two
    runs, with the plain run's top-2 gap there and both runs' largest
    logit difference at that step (both read the same tokens up to it)."""
    out = []
    for b in range(want_toks.shape[0]):
        differ = (got_toks[b] != want_toks[b]).nonzero().flatten()
        if len(differ):
            i = int(differ[0])
            top = torch.topk(want[b, i], 2).values
            out.append({"row": b, "step": i, "gap": float(top[0] - top[1]),
                        "logit_diff": float((got[b, i] - want[b, i])
                                            .abs().max())})
    return out


def llava_parity(torch) -> None:
    """llava-next-34b at full width and 2 layers, f32 compute and weights:
    ``vlm_generate`` on the kernel route against the plain route. Greedy
    tokens must agree but at a near-tie (``LOGIT_TOL``, the f32 pool's
    bound); then the kernel route fed the plain route's tokens (teacher
    forcing), every call's logits within ``LOGIT_TOL``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config("llava-next-34b"), n_layers=2,
                              compute_dtype="float32")
    model, plain = build_model(cfg), build_model(_plain_cfg(cfg))
    params = model.init(seed=0, device="cuda")
    batch = _llava_batch(torch, cfg, 1)
    steps = LLAVA_SERVE["decode"]
    with torch.no_grad():
        want_toks, want, _ = vlm_generate(torch, plain, params, batch, steps)
        got_toks, got, _ = vlm_generate(torch, model, params, batch, steps)
        _, forced, _ = vlm_generate(torch, model, params, batch, steps,
                                    forced=want_toks)
    div = _first_divergence(torch, got_toks, want_toks, got, want)
    worst = float((forced - want).abs().max())
    row = {"phase": "parity", "what": "llava", "arch": cfg.name,
           "n_layers": cfg.n_layers, "compute_dtype": cfg.compute_dtype,
           "prompts": want_toks.shape[0], "steps": steps,
           "identical": not div, "divergences": div, "gap_tol": LOGIT_TOL,
           "max_logit_diff": worst, "logit_tol": LOGIT_TOL,
           "max_abs_logit": float(want.abs().max())}
    emit(row)
    if worst > LOGIT_TOL or any(d["gap"] > LOGIT_TOL for d in div):
        raise AssertionError(f"llava parity: {row}")
    del params, model, plain
    gc.collect()
    torch.cuda.empty_cache()


def llava_serve(torch) -> dict:
    """llava-next-34b at full width and depth (60 layers, 34.4 B
    parameters, bf16 weights from the port's initializer, seed 0): 2
    prompts of 2304 patches and 64 text tokens prefilled and decoded for
    16 greedy steps through ``Model.prefill`` / ``decode_step`` (the
    engine serves no VLM). The counted run on the kernel route, then the
    same run again (its times; every token and logit must equal the
    counted run's bit for bit), then the plain route: every call's logits
    up to a row's first divergence within ``FAMILY_LOGIT_REL_TOL`` of the
    plain route's, and a divergence only at a near-tie (a top-2 gap within
    twice the logits' difference there). Every launch at a call key a
    kernels row checked. A ``families`` line with the init, prefill and
    decode times, the decode tick's weight floor and the peak memory.
    Returns the counted run's launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config("llava-next-34b"),
                              param_dtype="bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, plain = build_model(cfg), build_model(_plain_cfg(cfg))
    t0 = time.monotonic()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    batch = _llava_batch(torch, cfg, 0)
    steps = LLAVA_SERVE["decode"]
    with torch.no_grad():
        ops.reset_launch_counts()
        with recorded_calls(ops, ["dot_moa", "flash_attention",
                                  "paged_attention"]) as calls:
            toks, logits, _ = vlm_generate(torch, model, params, batch, steps)
        launches = ops.launch_counts()
        again_toks, again, times = vlm_generate(torch, model, params, batch,
                                                steps)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ops.reset_launch_counts()
        want_toks, want, plain_times = vlm_generate(torch, plain, params,
                                                    batch, steps)
        plain_launches = ops.launch_counts()
    div = _first_divergence(torch, toks, want_toks, logits, want)
    # each call's logits while both runs have read the same tokens
    same = [min([d["step"] for d in div if d["row"] == b] + [steps])
            for b in range(toks.shape[0])]
    rel = max(_rel(torch, logits[b, :n + 1], want[b, :n + 1])
              for b, n in enumerate(same))
    emb = params["embed"]
    layer_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(params["layers"]))
    floor_bytes = layer_bytes + emb["unembed"].numel() * 2
    tokens = batch["patches"].shape[1] + batch["tokens"].shape[1]
    prefill_flops = 2.0 * sum(t.numel() for t in _leaves(params["layers"])) \
        * toks.shape[0] * tokens
    row = {"phase": "families", "what": "llava-next-34b serve",
           "n_layers": cfg.n_layers, "n_params": model.param_count(),
           "init_s": init_s, "weights_gb": weights_gb,
           "prompts": toks.shape[0], "patches": LLAVA_SERVE["patches"],
           "text": LLAVA_SERVE["text"], "decode_steps": steps,
           "prefill_ms": times[0], "plain_prefill_ms": plain_times[0],
           "prefill_tflop": prefill_flops / 1e12,
           "prefill_tflop_per_s": prefill_flops / times[0] / 1e9,
           "decode_ms": times[1:],
           "decode_ms_median": statistics.median(times[1:]),
           "plain_decode_ms_median": statistics.median(plain_times[1:]),
           "decode_weight_bytes": floor_bytes,
           "decode_weight_floor_ms": floor_bytes / HBM_BPS * 1e3,
           "rerun_equal": bool(torch.equal(again, logits)
                               and torch.equal(again_toks, toks)),
           "tokens": toks.tolist(), "identical": not div,
           "divergences": div, "logit_rel_err": rel,
           "logit_rel_tol": FAMILY_LOGIT_REL_TOL,
           "max_abs_logit": float(want.abs().max()),
           "launches": launches, "plain_launches": plain_launches,
           "unchecked_calls": sorted(calls - CHECKED),
           "peak_mem_gb": peak_gb}
    print(nvidia_smi(), flush=True)
    emit(row)
    ok = (bool(torch.isfinite(logits).all()) and row["rerun_equal"]
          and rel <= FAMILY_LOGIT_REL_TOL
          and all(d["gap"] <= 2 * d["logit_diff"] for d in div)
          and not row["unchecked_calls"]
          and all(launches[k] for k in ("dot_moa", "flash_attention",
                                        "paged_attention"))
          and not any(plain_launches.values()))
    if not ok:
        raise AssertionError(f"llava serve: {row}")
    del params, model, plain
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def families_phase(torch) -> dict:
    """The encoder and VLM families and the SSM and hybrid gradients, every
    earlier model freed: hubert-xlarge's encode (:func:`hubert_encode`)
    and training; llava-next-34b's parity at 2 layers
    (:func:`llava_parity`), its full-depth serve (:func:`llava_serve`) and
    training at 2 layers; zamba2-1.2b's and mamba2-370m's training at full
    depth (:func:`train_full_width`). Returns the counted runs' launches
    by run."""
    runs = {"encode/hubert-xlarge": hubert_encode(torch),
            "train/hubert-xlarge": train_full_width(torch, "hubert-xlarge")}
    llava_parity(torch)
    runs["vlm/llava-next-34b"] = llava_serve(torch)
    for arch in ("llava-next-34b", "zamba2-1.2b", "mamba2-370m"):
        runs[f"train/{arch}"] = train_full_width(torch, arch)
    return runs


# ---------------------------------------------------------------------------
# the mesh phase: the served models on a device mesh
# ---------------------------------------------------------------------------

#: the single-device engines' eager tokens with every request at 0 (the
#: serve phase's llama3-8b and the hybrid phase's paged zamba2-1.2b), by
#: arch: what the mesh phase's runs are held to
SINGLE_DEVICE = {}
#: a mesh rank's collectives fail after this many seconds; the spawn
#: fails if its ranks have not finished after MESH_JOIN_S
MESH_TIMEOUT_S = 300.0
MESH_JOIN_S = 900.0
#: the mesh runs' engines: the serve phase's (4 slots, max_len 96, 16-token
#: pages, its 8 requests every one at 0), eager
MESH_ENGINE = dict(n_slots=4, max_len=96, paged=True, block_size=16)


def mesh_workload(cfg) -> list:
    return [dataclasses.replace(r, arrival_s=0.0)
            for r in llama3_workload(cfg)]


def _bucket(p: int) -> int:
    return 1 << (p - 1).bit_length()


def mesh_call_keys() -> list:
    """The ``call_key`` of every kernel launch the mesh phase's counted
    runs make, from their configurations: the shard shapes of llama3-8b at
    TP2 (bf16; and f32 at 2 layers), its full shapes at 2 slots a rank
    (DP2) and in the (1, 1) captured run, moonshot-v1-16b-a3b at EP2 (32
    experts a rank, exact-length prefills) and zamba2-1.2b at 2 slots a
    rank (its shared block; exact-length prefills)."""
    from repro_torch.configs.registry import get_config

    bf, f32 = "torch.bfloat16", "torch.float32"
    lens = [r.prompt_len for r in mesh_workload(get_config("llama3-8b"))]
    buckets = sorted({_bucket(p) for p in lens})
    width = MESH_ENGINE["max_len"] // MESH_ENGINE["block_size"]
    keys = []

    def dot(dt, m, k, n, out=None, batch=()):
        key = ("dot_moa", dt, m, k, n, min(2048, k), 0, *batch)
        keys.append(key + ((out,) if out else ()))

    def paged(dt, B, T, H, D, Hk):
        keys.append(("paged_attention", dt, B, T, H, D, dt, 16, Hk, width,
                     dt))

    # llama3-8b TP2: q 16 heads, k/v 4, o and down row-parallel (f32 out);
    # decode 4, verify and the oracle's teacher forcing 16, prefill buckets
    for dt, ms in ((bf, [4, 16] + buckets), (f32, [4] + buckets)):
        out = "float32" if dt == bf else None
        for m in ms:
            dot(dt, m, 4096, 2048)
            dot(dt, m, 4096, 512)
            dot(dt, m, 2048, 4096, out)
            dot(dt, m, 4096, 7168)
            dot(dt, m, 7168, 4096, out)
        for s in buckets:
            keys.append(("flash_attention", dt, 1, s, 16, 128, s, 4, True))
        for T in ((1, 4) if dt == bf else (1,)):
            paged(dt, 4, T, 16, 128, 4)
    # llama3-8b's full shapes: DP2 (2 slots a rank), the (1, 1) captured
    # run (4 slots) and both's prefill buckets
    for m in [2, 4] + buckets:
        for k, n in ((4096, 4096), (4096, 1024), (4096, 14336),
                     (14336, 4096)):
            dot(bf, m, k, n)
    for s in buckets:
        keys.append(("flash_attention", bf, 1, s, 32, 128, s, 8, True))
    for B in (2, 4):
        paged(bf, B, 1, 32, 128, 8)
    # moonshot EP2: attention 8 q / 8 kv heads a rank at each exact
    # prompt length and decode; the replicated router; 32 experts a rank
    # at each prefill's capacity and decode's; the top-6 combine
    for m in lens + [4]:
        dot(bf, m, 2048, 1024)
        dot(bf, m, 1024, 2048, "float32")
        dot(bf, m, 2048, 64, "float32")
        cap = max(int(m * 6 / 64 * 1.25), 1)
        dot(bf, cap, 2048, 1408, batch=(32,))
        dot(bf, cap, 1408, 2048, batch=(32,))
        keys.append(("moa_reduce", bf, 6, m * 2048, 6, True))
    for s in lens:
        keys.append(("flash_attention", bf, 1, s, 8, 128, s, 8, True))
    paged(bf, 4, 1, 8, 128, 8)
    # zamba2-1.2b DP2: the shared block at 2 slots a rank and at each
    # exact prompt length; its attention H32/32 head_dim 64
    for m in lens + [2]:
        for k, n in ((2048, 2048), (2048, 8192), (8192, 2048)):
            dot(bf, m, k, n)
    for s in lens:
        keys.append(("flash_attention", bf, 1, s, 32, 64, s, 32, True))
    paged(bf, 2, 1, 32, 64, 32)
    return sorted(set(keys))


def check_call_keys(torch, keys, where: str, timer=None) -> None:
    """Each ``call_key`` of ``keys`` that no kernels row checked: the
    kernel against its plain version on random operands of the key's
    shapes and options, within the tolerance its kernels rows state
    (``dot_moa``: 1 bf16 ulp of max|ref| for a bf16 result, f32 relative
    1e-5; flash and paged attention: 1 bf16 ulp, f32 1e-5; ``moa_reduce``:
    1e-4 + 1e-5 max|ref|); one ``kernels`` row each. With ``timer`` (the
    kernels phase's) each ``dot_moa`` and ``moa_reduce`` row also carries
    the kernel's, the plain version's and the library call's times and the
    bound, as the kernels phase's own rows do."""
    from repro_torch.kernels import dot_moa as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moa_reduce as mr
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(11)
    dts = {"torch.bfloat16": torch.bfloat16, "torch.float32": torch.float32}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(dtype)

    def err(got, want):
        return float((got.double() - want.double()).abs().max())

    def tol_for(dt, want):
        if dt == torch.bfloat16:
            return bf16_ulp(float(want.float().abs().max()))
        return 1e-5 * max(1.0, float(want.abs().max()))

    for key in keys:
        if key in CHECKED:
            continue
        kernel, dt = key[0], dts[key[1]]
        if kernel == "dot_moa":
            _, _, m, k, n, bk, l, *rest = key
            out = getattr(torch, rest.pop()) \
                if rest and isinstance(rest[-1], str) else None
            a = randn(*rest, m, k, dtype=dt)
            b = randn(*rest, k, n, scale=k ** -0.5, dtype=dt)
            plain = ref.dot_moa_batched_ref if rest else ref.dot_moa_ref
            got = dm.dot_moa_cuda(a, b, block_k=bk, approx_bits=l,
                                  out_dtype=out)
            want = plain(a, b, block_k=bk, approx_bits=l, out_dtype=out)
            tol = tol_for(got.dtype, want)
            shape = {"batch": rest, "m": m, "k": k, "n": n, "block_k": bk,
                     "out": str(got.dtype)[6:]}
            again = call_key("dot_moa", a, b, block_k=bk, approx_bits=l,
                             out_dtype=out)
            n_b = math.prod(rest) if rest else 1
            timing = dict(
                run=lambda: dm.dot_moa_cuda(a, b, block_k=bk, approx_bits=l,
                                            out_dtype=out),
                plain=lambda: plain(a, b, block_k=bk, approx_bits=l,
                                    out_dtype=out),
                library=(lambda: torch.bmm(a, b)) if rest else (
                    (lambda: torch.mm(a, b, out_dtype=out)) if out
                    else (lambda: torch.matmul(a, b))),
                library_name="torch.bmm" if rest else (
                    "torch.mm(out_dtype=float32)" if out else "torch.matmul"),
                bound=bound(n_b * ((m * k + k * n) * a.element_size()
                                   + m * n * got.element_size()),
                            2.0 * n_b * m * k * n, "bfloat16"))
        elif kernel == "flash_attention":
            _, _, B, Sq, H, D, Skv, Hk, causal = key
            q = randn(B, Sq, H, D, dtype=dt)
            k, v = randn(B, Skv, Hk, D, dtype=dt), randn(B, Skv, Hk, D,
                                                         dtype=dt)
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           q_chunk=256, kv_chunk=512)
            tol = tol_for(dt, want)
            shape = {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "Hk": Hk, "D": D}
            again = call_key("flash_attention", q, k, v, causal=causal)
        elif kernel == "paged_attention":
            _, _, B, T, H, D, _, bs, Hk, width, _, *kv = key
            heads = dict(zip(("kv_start", "kv_count"), kv))
            n_phys = 1 + B * width
            starts = torch.randint(0, width * bs - T + 1, (B,), device=dev,
                                   generator=g, dtype=torch.int32)
            tables = torch.zeros((B, width), dtype=torch.int32, device=dev)
            for i, s in enumerate(starts.tolist()):
                live = (s + T - 1) // bs + 1
                tables[i, :live] = 1 + i * width + torch.arange(live,
                                                                device=dev)
            q = randn(B, T, H, D, dtype=dt)
            kp, vp = randn(n_phys, bs, Hk, D, dtype=dt), \
                randn(n_phys, bs, Hk, D, dtype=dt)
            got = pa.paged_attention_cuda(q, kp, vp, tables, starts,
                                          dequant_dtype=dt, **heads)
            want = ref.paged_attention_ref(q, kp, vp, tables, starts,
                                           dequant_dtype=dt, **heads)
            tol = tol_for(dt, want)
            shape = {"B": B, "T": T, "H": H, "Hk": Hk, "D": D, "bs": bs,
                     "n_blocks": width, "start": starts.tolist(), **heads}
            again = call_key("paged_attention", q, kp, vp, tables, starts,
                             dequant_dtype=dt, **heads)
        elif kernel == "moa_reduce":
            _, _, n, f, bn, aligned = key
            x = randn(n * f + 8, dtype=dt)
            x = (x[:n * f] if aligned else x[1:n * f + 1]).view(n, f)
            got = mr.moa_reduce_cuda(x, block_n=bn)
            want = ref.moa_reduce_ref(x, block_n=bn)
            tol = 1e-4 + 1e-5 * float(want.abs().max())
            shape = {"n": n, "f": f, "block_n": bn, "aligned": aligned}
            again = call_key("moa_reduce", x, block_n=bn)
            timing = dict(
                run=lambda: mr.moa_reduce_cuda(x, block_n=bn),
                plain=lambda: ref.moa_reduce_ref(x, block_n=bn),
                library=lambda: torch.sum(x, dim=0, dtype=torch.float32),
                library_name="torch.sum(x, 0) in f32",
                bound=bound(x.numel() * x.element_size()
                            + f * got.element_size(), float(x.numel()),
                            "float32"))
        else:
            raise KeyError(kernel)
        torch.cuda.synchronize()
        if again != key:
            raise AssertionError(f"{where}: operands for {key} make the "
                                 f"call key {again}")
        row = {"kernel": kernel, "case": f"{key[1][6:]} {where}",
               "shape": shape, "max_abs_err": err(got, want), "tol": tol,
               "tol_reason": "the kernels rows' rule for this type"}
        if timer is not None and kernel in ("dot_moa", "moa_reduce"):
            t = timing
            row.update({"kernel_ms": timer(t["run"]),
                        "device_ms": timer.device(t["run"], kernel),
                        **own_kernels(timer, kernel),
                        "plain_ms": timer(t["plain"], 2),
                        "library_ms": timer.device(t["library"]),
                        "library": t["library_name"],
                        "bound_ms": t["bound"][0],
                        "bound_by": t["bound"][1]})
        check(row, key)


def _mesh_replay(torch, engine, logits_by_step, forced=None) -> None:
    """:func:`_replay` for a mesh engine of unsplit slots: each step's
    whole-vocabulary logits (gathered over ``model``), and with
    ``forced`` each request's tokens teacher-forced."""
    from repro_torch.parallel import collectives

    if engine._n_rows != engine.n_slots:
        raise AssertionError("a replay reads every slot's logits")
    seed, sample = engine._seed, engine._sample

    def _seed(slot, req, logits, *rest):
        whole = collectives.vocab_gather(logits)
        logits_by_step[(req.uid, 0)] = whole[0, -1].float().clone()
        if forced is not None:     # one finite logit: greedy takes it
            tok = int(forced[req.uid][0])
            rng = collectives.split("vocab") or (0, whole.shape[-1])
            logits = torch.full_like(logits, -math.inf)
            if rng[0] <= tok < rng[1]:
                logits[0, -1, tok - rng[0]] = 0.0
        return seed(slot, req, logits, *rest)

    def _sample(logits, temps, greedy):
        whole = collectives.vocab_gather(logits)
        toks = sample(logits, temps, greedy)
        for slot, inf in engine._inflight.items():
            step = len(inf.generated)
            logits_by_step[(inf.request.uid, step)] = \
                whole[slot].float().clone()
            if forced is not None:
                toks[slot] = forced[inf.request.uid][step]
        return toks

    engine._seed, engine._sample = _seed, _sample


def _mesh_run(torch, engine, requests, checked, *, warmup=True,
              ticks=None) -> dict:
    """Serve ``requests`` on a mesh engine, counted (after a warmup run
    with ``warmup``): results, tokens, launches, the launches' call keys
    that no kernels row checked, collective calls in all and a tick, and
    this rank's peak memory. ``ticks``: a one-item list the tick count is
    kept in (the routing log reads it)."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import collectives

    if warmup:
        engine.run([], warmup=True)
    ticks = ticks if ticks is not None else [0]
    tick = engine.tick

    def counted(results):
        tick(results)
        ticks[0] += 1

    engine.tick = counted
    ops.reset_launch_counts()
    collectives.reset_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    with recorded_calls(ops, list(KERNELS)) as calls:
        t0 = time.monotonic()
        results, report = engine.run(requests)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    coll = collectives.counts()
    return {"results": results,
            "tokens": {r.uid: r.tokens.tolist() for r in results},
            "launches": ops.launch_counts(),
            "unchecked_calls": sorted(calls - checked),
            "collectives": coll, "ticks": ticks[0],
            "collectives_per_tick": {k: v / max(ticks[0], 1)
                                     for k, v in coll.items()},
            "wall_s": wall, "mesh": report["mesh"],
            "peak_before_gb": peak,
            "accept_rate": (report.get("spec") or {}).get("accept_rate"),
            "graphs": report["graphs"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _mesh_gaps(torch, engine, requests, want, got) -> list:
    """Each request whose tokens differ: the first differing index and the
    top-2 gap there of the mesh model's next-token logits after the
    prompt and the tokens both runs share (a no-cache forward on the
    shards, the whole vocabulary gathered)."""
    from repro_torch.parallel import collectives

    out = []
    for req in requests:
        a, b = want[req.uid], got[req.uid]
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        toks = torch.tensor([list(req.prompt) + list(a[:i])], device="cuda")
        with torch.no_grad(), engine._mesh_context():
            z = collectives.vocab_gather(engine.model.forward(
                engine.params, {"tokens": toks}))[0, -1].float()
        top = torch.topk(z, 2).values
        out.append({"uid": req.uid, "index": i,
                    "gap": float(top[0] - top[1])})
    return out


def _mesh_llama3(torch, tp, dp, want, checked) -> dict:
    """llama3-8b at full width and depth (bf16 weights, seed 0): DP2 on
    the full tree (nothing splits, nothing is copied), then TP2 (each
    rank's pieces copied out, the full tree freed), plain and with the
    oracle drafter."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine, resolve_drafter

    cfg = dataclasses.replace(get_config("llama3-8b"),
                              param_dtype="bfloat16")
    requests = mesh_workload(cfg)
    mem = {}

    def held(stage):
        gc.collect()
        mem[stage] = torch.cuda.memory_allocated() / 1e9

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    held("full tree")
    e = ServeEngine(model, params, device="cuda", cuda_graphs=False,
                    mesh=dp, **MESH_ENGINE)
    out = {"llama3-8b-dp2": _mesh_run(torch, e, requests, checked)}
    del e
    held("dp2 freed")
    e = ServeEngine(model, params, device="cuda", cuda_graphs=False,
                    mesh=tp, **MESH_ENGINE)
    held("tp2 built")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    held("full tree freed")
    run = out["llama3-8b-tp2"] = _mesh_run(torch, e, requests, checked)
    run["held_gb"] = mem
    run["near_ties"] = _mesh_gaps(torch, e, requests, want, run["tokens"])
    local = e.params
    del e
    gc.collect()
    e = ServeEngine(build_model(cfg), local, device="cuda",
                    cuda_graphs=False, mesh=tp,
                    drafter=resolve_drafter("oracle", SPEC_K), **MESH_ENGINE)
    run = out["llama3-8b-tp2-oracle"] = _mesh_run(torch, e, requests,
                                                  checked)
    run["near_ties"] = _mesh_gaps(torch, e, requests, want, run["tokens"])
    del e, local
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_llama3_f32(torch, tp, checked) -> dict:
    """llama3-8b at full width, 2 layers, f32 compute: the single-device
    engine, then TP2, each step's logits recorded; tokens must be
    identical and the logits within 1e-4 of each step's largest."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2,
                              compute_dtype="float32")
    requests = mesh_workload(cfg)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    one, logits = {}, {}
    e = ServeEngine(model, params, device="cuda", cuda_graphs=False,
                    **MESH_ENGINE)
    _replay(torch, e, one)
    e.run([], warmup=True)
    results, _ = e.run(requests)
    want = {r.uid: r.tokens.tolist() for r in results}
    del e
    e = ServeEngine(model, params, device="cuda", cuda_graphs=False,
                    mesh=tp, **MESH_ENGINE)
    del params, model
    e.run([], warmup=True)
    _mesh_replay(torch, e, logits)
    run = _mesh_run(torch, e, requests, checked, warmup=False)
    worst = 0.0
    for key, z in one.items():
        if key in logits:
            worst = max(worst, float((logits[key] - z).abs().max()
                                     / z.abs().max()))
    run.update({"want": want, "max_logit_rel_diff": worst,
                "steps": len(one), "steps_seen": len(set(one) & set(logits))})
    del e
    gc.collect()
    torch.cuda.empty_cache()
    return {"llama3-8b-f32-tp2": run}


def _route_off_ties(plain, mine, differ) -> list:
    """The routing differences (:func:`_routing_differences`) whose gap is
    over twice the largest router-probability difference of that token
    between the two runs."""
    out = []
    for d in differ:
        pp = plain[d["call"]][3][d["group"], d["token"]]
        pm = mine[d["call"]][3][d["group"], d["token"]]
        lim = 2 * float((pm - pp).abs().max())
        if d["gap"] > lim:
            out.append(dict(d, limit=lim))
    return out


def _mesh_moonshot(torch, tp, checked) -> dict:
    """moonshot-v1-16b-a3b at full width, 4 layers (bf16, capacity factor
    1.25: exact-length prefills): the single-device engine logs its
    tokens, logits and every routing call; EP2 (experts and heads over
    ``model``) is fed those tokens and expert choices, and logs its own
    choices and logits."""
    from repro_torch.configs.registry import get_config
    from repro_torch.layers import moe as moe_mod
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=4,
                              param_dtype="bfloat16")
    requests = mesh_workload(cfg)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    e = ServeEngine(model, params, device="cuda", cuda_graphs=False,
                    **MESH_ENGINE)
    one, ticks = {}, [0]
    _replay(torch, e, one)
    tick = e.tick

    def counted(results):
        tick(results)
        ticks[0] += 1

    e.tick = counted
    log, undo = _routing(torch, moe_mod, ticks)
    try:
        results, _ = e.run(requests)
    finally:
        undo()
    want = {r.uid: r.tokens for r in results}
    del e
    e = ServeEngine(model, params, device="cuda", cuda_graphs=False,
                    mesh=tp, **MESH_ENGINE)
    del params, model
    logits, mticks = {}, [0]
    _mesh_replay(torch, e, logits, forced=want)
    mlog, undo = _routing(torch, moe_mod, mticks, log)
    try:
        run = _mesh_run(torch, e, requests, checked, warmup=False,
                        ticks=mticks)
    finally:
        undo()
    differ = _routing_differences(log, mlog)
    worst = max(float((logits[k] - z).abs().max() / z.abs().max())
                for k, z in one.items())
    run.update({"routing_calls": len(log), "own_choices_differ":
                len(differ), "own_choice_differences": differ[:5],
                "off_near_tie": _route_off_ties(log, mlog, differ)[:5],
                "max_logit_rel_diff": worst, "steps": len(one),
                "steps_seen": len(set(one) & set(logits))})
    del e
    gc.collect()
    torch.cuda.empty_cache()
    return {"moonshot-ep2": run}


def _mesh_zamba2(torch, dp, want, checked) -> dict:
    """zamba2-1.2b at full width and depth (bf16, seed 0) under its serve
    rules (nothing over ``model``): DP2 on the full tree."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("zamba2-1.2b"),
                              param_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    e = ServeEngine(model, params, device="cuda", cuda_graphs=False,
                    mesh=dp, **MESH_ENGINE)
    run = _mesh_run(torch, e, mesh_workload(cfg), checked)
    del e, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"zamba2-dp2": run}


def mesh_rank(rank: int, want: dict, checked: set) -> dict:
    """One of the mesh phase's two ranks on the one card (a gloo group
    carrying CUDA tensors): both meshes, (1, 2) and (2, 1), over the same
    two ranks, and every run of the phase. Returns each run's record
    (:func:`_mesh_run`) without its results."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.join(HERE, "src"))
    tp, dp = make_mesh((1, 2), device="cuda"), make_mesh((2, 1),
                                                         device="cuda")
    carries = gloo_carries_cuda(torch, rank)
    if carries["all_reduce"] is not True or carries["broadcast"] is not True:
        raise AssertionError(f"gloo does not carry the mesh's collectives "
                             f"(sum all-reduce, broadcast) for CUDA tensors "
                             f"here: {carries}")
    out = {"carries": carries}
    out.update(_mesh_llama3(torch, tp, dp, want["llama3-8b"], checked))
    out.update(_mesh_llama3_f32(torch, tp, checked))
    out.update(_mesh_moonshot(torch, tp, checked))
    out.update(_mesh_zamba2(torch, dp, want["zamba2-1.2b"], checked))
    for name, run in out.items():
        if name != "carries":
            run.pop("results")
    return out


def gloo_carries_cuda(torch, rank: int) -> dict:
    """Which of the collectives the mesh could use a gloo group carries
    for CUDA tensors on this install: each tried on a small tensor, and
    its result checked, or the error it raised kept."""
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device="cuda")
    out = {}

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return float(y[0]) == 3.0

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        return float(y[0]) == 1.0

    def all_gather():
        ys = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(ys, x)
        return [float(y[0]) for y in ys] == [1.0, 2.0]

    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather", all_gather)):
        try:
            out[name] = bool(fn())
        except Exception as e:       # noqa: BLE001 — the finding itself
            out[name] = f"{type(e).__name__}: {str(e)[:160]}"
    return out


def mesh_captured(torch) -> dict:
    """A (1, 1) mesh over NCCL in this process: llama3-8b at full width
    and 2 layers (bf16), paged, captured, against the single-device
    captured engine: tokens and every step's logits bit for bit."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import free_port, make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2,
                              param_dtype="bfloat16")
    requests = mesh_workload(cfg)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    one = {}
    e = ServeEngine(model, params, device="cuda", cuda_graphs=True,
                    **MESH_ENGINE)
    _replay(torch, e, one)
    e.run([], warmup=True)
    want = {r.uid: r.tokens.tolist() for r in e.run(requests)[0]}
    del e
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_mesh((1, 1), device="cuda")
        e = ServeEngine(model, params, device="cuda", cuda_graphs=True,
                        mesh=mesh, **MESH_ENGINE)
        logits = {}
        e.run([], warmup=True)
        _mesh_replay(torch, e, logits)
        run = _mesh_run(torch, e, requests, CHECKED, warmup=False)
        del e
    finally:
        dist.destroy_process_group()
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    run.pop("results")
    run["differing_logits"] = sorted(
        k for k in set(one) | set(logits)
        if k not in one or k not in logits
        or not torch.equal(one[k], logits[k]))[:10]
    run["want"] = want
    return run


def mesh_phase(torch) -> dict:
    """The served models on a device mesh (module docstring): which
    collectives gloo carries for CUDA tensors, the (1, 1) NCCL captured
    run in this process, then the two gloo ranks on the one card. Fails on
    a failed rank, a run off its bar, or a launch no kernels row checked.
    Returns the counted runs' launches by run (both ranks' summed)."""
    from repro_torch.launch.mesh import run_ranks

    smi = nvidia_smi()
    cap = mesh_captured(torch)
    bad = cap["tokens"] != cap["want"] or cap["differing_logits"] \
        or cap["unchecked_calls"]
    emit({"phase": "mesh", "what": "llama3-8b captured", "mesh": "1x1",
          "backend": "nccl", "ranks": 1, "path": "captured", "n_layers": 2,
          "nvidia_smi": smi, "tokens_equal": cap["tokens"] == cap["want"],
          "differing_logits": cap["differing_logits"],
          "launches": cap["launches"], "unchecked_calls":
              cap["unchecked_calls"],
          "collectives_per_tick": cap["collectives_per_tick"],
          "peak_mem_gb": cap["peak_mem_gb"]})
    if bad:
        raise AssertionError("the (1, 1) NCCL captured engine differs from "
                             "the single-device captured engine")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ranks = run_ranks(2, mesh_rank, SINGLE_DEVICE, set(CHECKED),
                      backend="gloo", timeout_s=MESH_TIMEOUT_S,
                      join_timeout_s=MESH_JOIN_S, threads=0)
    spawn_s = time.monotonic() - t0
    emit({"phase": "mesh", "what": "gloo collectives on CUDA tensors",
          "nvidia_smi": smi, "carries": ranks[0].pop("carries"),
          "rank1": ranks[1].pop("carries"),
          "built_on": "all_reduce (sum) and broadcast (all_gather as each "
                      "rank's piece broadcast from it; CPU tensors)"})
    runs, failures = {}, []
    want = {"llama3-8b-dp2": SINGLE_DEVICE["llama3-8b"],
            "llama3-8b-tp2": SINGLE_DEVICE["llama3-8b"],
            "llama3-8b-tp2-oracle": SINGLE_DEVICE["llama3-8b"],
            "zamba2-dp2": SINGLE_DEVICE["zamba2-1.2b"]}
    shapes = {"llama3-8b-dp2": "2x1", "llama3-8b-tp2": "1x2",
              "llama3-8b-tp2-oracle": "1x2", "llama3-8b-f32-tp2": "1x2",
              "moonshot-ep2": "1x2", "zamba2-dp2": "2x1"}
    for name, r0 in ranks[0].items():
        per_rank = [r[name] for r in ranks]
        line = {"phase": "mesh", "what": name, "mesh": shapes[name],
                "backend": "gloo", "ranks": 2, "path": "eager",
                "nvidia_smi": smi, "mesh_report": r0["mesh"],
                "spawn_s": spawn_s,
                "wall_s": [r["wall_s"] for r in per_rank],
                "peak_mem_gb": [r["peak_mem_gb"] for r in per_rank],
                "peak_before_gb": [r["peak_before_gb"] for r in per_rank],
                "held_gb": r0.get("held_gb"),
                "launches": [r["launches"] for r in per_rank],
                "unchecked_calls": sorted(
                    {k for r in per_rank for k in r["unchecked_calls"]}),
                "collectives": r0["collectives"], "ticks": r0["ticks"],
                "collectives_per_tick": r0["collectives_per_tick"]}
        same = all(r["tokens"] == r0["tokens"] for r in per_rank)
        if name in want:
            ref = {int(k): v for k, v in want[name].items()}
            differ = sorted(u for u in ref if ref[u] != r0["tokens"][u])
            line["differing_tokens"] = differ
            if "near_ties" in r0:
                line["near_ties"] = r0["near_ties"]
                off = [d for d in r0["near_ties"] if d["gap"] > NEAR_TIE]
                if off:
                    failures.append(f"{name}: divergences off a near-tie "
                                    f"{off}")
            elif differ:
                failures.append(f"{name}: tokens of {differ} differ from "
                                "the single-device engine's")
        if name == "llama3-8b-f32-tp2":
            differ = sorted(u for u in r0["want"]
                            if r0["want"][u] != r0["tokens"][u])
            line.update({"differing_tokens": differ,
                         "max_logit_rel_diff": r0["max_logit_rel_diff"],
                         "steps": r0["steps"],
                         "steps_seen": r0["steps_seen"]})
            if differ or r0["max_logit_rel_diff"] > 1e-4 \
                    or r0["steps_seen"] != r0["steps"]:
                failures.append(f"{name}: tokens {differ}, logits "
                                f"{r0['max_logit_rel_diff']}")
        if name == "llama3-8b-tp2-oracle":
            line["accept_rate"] = r0["accept_rate"]
        if name == "moonshot-ep2":
            for k in ("routing_calls", "own_choices_differ",
                      "own_choice_differences", "off_near_tie",
                      "max_logit_rel_diff", "steps", "steps_seen"):
                line[k] = r0[k]
            line["routing"] = "teacher-forced"
            if r0["off_near_tie"] or r0["steps_seen"] != r0["steps"]:
                failures.append(f"{name}: expert choices off a near-tie "
                                f"{r0['off_near_tie']}")
        if not same:
            failures.append(f"{name}: the ranks' tokens differ")
        arch = name.split("-tp2")[0].split("-dp2")[0].split("-ep2")[0]
        served = ["dot_moa", "flash_attention", "paged_attention"] + (
            ["moa_reduce"] if arch == "moonshot" else [])
        idle = [k for k in served
                if not sum(r["launches"][k] for r in per_rank)]
        if idle:
            failures.append(f"{name}: launched no {idle}")
        if line["unchecked_calls"]:
            failures.append(f"{name}: launches no kernels row checked "
                            f"{line['unchecked_calls'][:5]}")
        emit(line)
        runs[f"mesh/{name}"] = {
            k: sum(r["launches"][k] for r in per_rank)
            for k in r0["launches"]}
    if failures:
        raise AssertionError("mesh phase: " + "; ".join(failures))
    return {"mesh/llama3-8b-tp2": runs["mesh/llama3-8b-tp2"],
            "mesh/llama3-8b-dp2": runs["mesh/llama3-8b-dp2"],
            "mesh/moonshot-ep2": runs["mesh/moonshot-ep2"],
            "mesh/zamba2-dp2": runs["mesh/zamba2-dp2"]}


# ---------------------------------------------------------------------------
# training on a device mesh
# ---------------------------------------------------------------------------

#: the mesh_train phase's runs: arch, depth, global batch and sequence (the
#: train phase's and families phase's cells), the mesh (data, model). Two
#: gloo ranks share the one card: FSDP moves every parameter through the
#: host each step, so these hold results, not speed; llama3-8b is cut from
#: the train phase's 4 layers to 2 so that the phase stays near 150 s
#: (``PERF.md`` §6)
MESH_TRAIN_RUNS = {
    "llama3-8b-fsdp2": dict(arch="llama3-8b", layers=2, batch=8, seq=512,
                            shape=(2, 1)),
    "llama3-8b-tp2": dict(arch="llama3-8b", layers=2, batch=8, seq=512,
                          shape=(1, 2)),
    "moonshot-ep2": dict(arch="moonshot-v1-16b-a3b", layers=2, batch=4,
                         seq=256, shape=(1, 2)),
    "zamba2-fsdp2": dict(arch="zamba2-1.2b", layers=38, batch=8, seq=512,
                         shape=(2, 1)),
}
#: the counted steps of each mesh run (the bars read the first; an FSDP2
#: step is ~10 s of host traffic through gloo)
MESH_TRAIN_STEPS = 2
#: the (1, 1) NCCL mesh's run: llama3-8b at 2 layers, 8 x 512, 2 steps
MESH_TRAIN_NCCL = dict(arch="llama3-8b", layers=2, batch=8, seq=512,
                       steps=2)
MESH_TRAIN_SPEED = ("not a speed result: two ranks share one card over "
                    "gloo, which stages every collective through the host")


def _mesh_train_cfg(run: dict):
    from repro_torch.configs.registry import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps

    cfg = dataclasses.replace(get_config(run["arch"]),
                              n_layers=run["layers"])
    data = SyntheticLMData(
        vocab=cfg.vocab, seq_len=run["seq"], global_batch=run["batch"],
        seed=0, family="encoder" if cfg.family == "encoder" else "lm",
        d_model=cfg.d_model, n_patches=cfg.n_patches)
    return cfg, data, steps.TrainHyper(peak_lr=3e-4, warmup_steps=2,
                                       total_steps=100)


def mesh_train_call_keys() -> list:
    """The ``call_key`` of every kernel launch of the mesh_train phase's
    mesh runs (bf16; the one-device runs' are the train and families
    phases'): llama3-8b on FSDP2 (4 x 512 tokens a rank, whole weights),
    on TP2 (8 x 512, half the heads and ``ff``: ``wo`` and ``w_down``
    row-parallel with f32 partials), moonshot-v1-16b-a3b on EP2 (1024
    tokens, 8 heads and 32 experts a rank, the replicated router, the
    top-6 combine), zamba2-1.2b's shared block on FSDP2 (2048 tokens)."""
    bf = "torch.bfloat16"
    keys = []

    def dot(m, k, n, out=None, batch=()):
        key = ("dot_moa", bf, m, k, n, min(2048, k), 0, *batch)
        keys.append(key + ((out,) if out else ()))

    for k, n in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)):
        dot(2048, k, n)
    for k, n, out in ((4096, 2048, None), (4096, 512, None),
                      (2048, 4096, "float32"), (4096, 7168, None),
                      (7168, 4096, "float32")):
        dot(4096, k, n, out)
    dot(1024, 2048, 1024)
    dot(1024, 1024, 2048, "float32")
    dot(1024, 2048, 64, "float32")
    cap = max(int(1024 * 6 / 64 * 1.25), 1)
    dot(cap, 2048, 1408, batch=(32,))
    dot(cap, 1408, 2048, batch=(32,))
    keys.append(("moa_reduce", bf, 6, 1024 * 2048, 6, True))
    for k, n in ((2048, 2048), (2048, 8192), (8192, 2048)):
        dot(2048, k, n)
    return sorted(set(keys))


def mesh_train_one_device(torch, run: dict, out_dir: str) -> dict:
    """The one-device step of ``run`` on the card (the train phase's: its
    state from seed 0, the kernel route, an MoE's routing recorded): the
    loss, and every gradient leaf written to ``out_dir`` (one ``.npy`` a
    leaf, for the ranks to read their slices of); the state then freed."""
    import numpy as np

    from repro_torch.interop import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.layers import moe as moe_mod
    from repro_torch.models.api import build_model

    cfg, data, hyper = _mesh_train_cfg(run)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = steps.init_train_state(build_model(cfg), hyper=hyper, seed=0,
                                   device="cuda")
    moe = cfg.family == "moe"
    if moe:
        log, undo = _routing(torch, moe_mod, [0])
    try:
        grads, metrics = steps.loss_and_grads(
            build_model(cfg), state["params"], _cuda_batch(data, 0))
        torch.cuda.synchronize()
    finally:
        if moe:
            undo()
    step_s = time.monotonic() - t0
    os.makedirs(out_dir, exist_ok=True)
    for path, g in tree_leaves(grads):
        np.save(os.path.join(out_dir, path + ".npy"),
                g.detach().float().cpu().numpy())
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": float(metrics["loss"]), "dir": out_dir, "peak_gb": peak,
            "seconds": step_s,
            "routing": [(t, ids.numpy(), keep.numpy(), probs.numpy())
                        for t, ids, keep, probs in log] if moe else None}


def _mesh_train_run(torch, rank: int, mesh, run: dict, want: dict,
                    checked: set) -> dict:
    """One run of ``MESH_TRAIN_RUNS`` on this rank: the state placed by
    the train step's specs (every rank draws the whole from seed 0 and
    keeps its shards), then ``MESH_TRAIN_STEPS`` counted steps of the
    train step: the gradients the first applied (an MoE teacher-forced by
    the one-device run's choices) held against the one-device run's slices
    (each leaf's squared error and squared norm on this rank's piece);
    losses, wall ms a step, collective calls by kind, launches and their
    unchecked call keys, peak memory."""
    import numpy as np

    from repro_torch.interop import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.layers import moe as moe_mod
    from repro_torch.models.api import build_model
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import local_slices

    cfg, data, hyper = _mesh_train_cfg(run)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    step = steps.build_train_step(model, hyper=hyper, mesh=mesh,
                                  return_grads=True)
    pl = step.placement
    t0 = time.monotonic()
    state = steps.init_train_state(model, hyper=hyper, seed=0,
                                   device="cuda", placement=pl)
    gc.collect()
    torch.cuda.empty_cache()
    init_s = time.monotonic() - t0

    def batch(s):
        return {k: v.cuda() for k, v in steps.local_batch(
            data.batch_for_step(s), pl).items()}

    def compare(grads) -> dict:
        specs = dict(tree_leaves(pl.param_specs))
        errs = {}
        for path, g in tree_leaves(grads):
            full = np.load(os.path.join(want["dir"], path + ".npy"),
                           mmap_mode="r")
            piece = torch.from_numpy(np.array(full[local_slices(
                full.shape, specs[path], mesh, pl.coords)])).cuda()
            d = g.detach().float() - piece
            split = any(e is not None and pl.sizes[e] > 1
                        for e in specs[path])
            errs[path] = (float(torch.sum(d * d, dtype=torch.float64)),
                          float(torch.sum(piece * piece,
                                          dtype=torch.float64)), split)
        return errs

    moe = cfg.family == "moe"
    plain = [(t, torch.from_numpy(ids), torch.from_numpy(keep),
              torch.from_numpy(probs))
             for t, ids, keep, probs in want["routing"] or ()]
    ops.reset_launch_counts()
    collectives.reset_counts()
    wall, losses, routing = [], [], {}
    with recorded_calls(ops, ["dot_moa", "moa_reduce"]) as calls:
        for s in range(MESH_TRAIN_STEPS):
            b = batch(s)
            if s == 0 and moe:
                log, undo = _routing(torch, moe_mod, [0], forced=plain)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                state, m, grads = step(state, b)
                torch.cuda.synchronize()
            finally:
                if s == 0 and moe:
                    undo()
            wall.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            if s == 0:
                errs, not_finite = compare(grads), _not_finite(torch, grads)
                if moe:
                    diffs = _routing_differences(plain, log)
                    routing = {"routing_calls": len(log),
                               "own_choice_differences": len(diffs),
                               **_route_drift(torch, plain, log, diffs)}
            del grads
    coll = collectives.counts()
    out = {"loss": losses[0], "errs": errs, "not_finite": not_finite,
           "losses": losses, "step_ms": wall, "init_s": init_s,
           "collectives_per_step": {k: v / MESH_TRAIN_STEPS
                                    for k, v in coll.items()},
           "launches": ops.launch_counts(),
           "unchecked_calls": sorted(calls - checked),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "split": {"data": pl.sizes["data"], **{
               k: getattr(pl.shard, k) for k in (
                   "heads", "kv_heads", "ff", "experts", "vocab")}},
           "local_params": sum(t.numel() for _, t in tree_leaves(
               state["params"])), **routing}
    del state, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_train_ckpt(torch, rank: int, meshes: dict, root: str) -> dict:
    """A smoke llama3-8b (f32; two KV heads and a vocabulary of 256, so
    that both split) trained 4 steps on (1, 2) with checkpoints, its
    newest restored onto (2, 1): each rank's slices of every leaf against
    the saved leaves, bit for bit."""
    import io

    import numpy as np

    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.interop import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.launch.train import TrainLoop
    from repro_torch.parallel.sharding import local_slices

    cfg = dataclasses.replace(smoke_config(get_config("llama3-8b")),
                              param_dtype="float32", compute_dtype="float32",
                              vocab=256, n_kv_heads=2)
    with contextlib.redirect_stdout(io.StringIO()):
        loop = TrainLoop(cfg, steps=4, global_batch=4, seq_len=32,
                         ckpt_dir=root, save_every=2, device="cuda",
                         mesh_shape=(1, 2), async_save=False,
                         hyper=steps.TrainHyper(peak_lr=5e-3,
                                                warmup_steps=2,
                                                total_steps=4))
        loop.run()
    newest = loop.manager.latest_step()
    npz = np.load(os.path.join(root, f"step_{newest}", "shard_0.npz"))
    saved = {k.replace("\x1f", "/"): npz[k] for k in npz.files}
    dp = meshes[(2, 1)]
    pl = steps.train_placement(loop.model, dp)
    template = loop._template()
    specs = steps.state_specs(template, pl)
    got, _ = loop.manager.restore(template, step=newest, device="cuda",
                                  mesh=dp, specs=specs)
    spec = dict(tree_leaves(specs))
    coords = pl.coords
    differ = [path for path, t in tree_leaves(got)
              if not np.array_equal(t.cpu().numpy(), saved[
                  path.replace(".", "/")][local_slices(
                      saved[path.replace(".", "/")].shape, spec[path], dp,
                      coords)])]
    return {"step": newest, "leaves": len(spec), "differ": differ,
            "on_cuda": all(t.is_cuda for _, t in tree_leaves(got))}


def mesh_train_rank(rank: int, jobs: dict, checked: set, root: str) -> dict:
    """One of the mesh_train phase's two ranks on the one card (a gloo
    group carrying CUDA tensors): every run of ``jobs`` (label: the run
    and the one-device results it is held to) on its mesh, then the
    checkpoint written on (1, 2) and restored onto (2, 1)."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.join(HERE, "src"))
    meshes = {shape: make_mesh(shape, device="cuda")
              for shape in ((2, 1), (1, 2))}
    out = {}
    for label, (run, want) in jobs.items():
        t0 = time.monotonic()
        out[label] = _mesh_train_run(torch, rank, meshes[run["shape"]], run,
                                     want, checked)
        print(f"mesh_train rank {rank}: {label} in "
              f"{time.monotonic() - t0:.1f} s, steps "
              f"{[round(t) for t in out[label]['step_ms']]} ms",
              file=sys.stderr, flush=True)
    out["ckpt"] = _mesh_train_ckpt(torch, rank, meshes,
                                   os.path.join(root, "ckpt"))
    return out


def mesh_train_nccl(torch) -> dict:
    """A (1, 1) mesh over NCCL in this process: llama3-8b at 2 layers,
    the one-device train step's state and the mesh step's, each from seed
    0 over ``MESH_TRAIN_NCCL["steps"]`` steps, compared leaf by leaf and
    loss by loss, bit for bit."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import free_port, make_mesh
    from repro_torch.models.api import build_model

    run = MESH_TRAIN_NCCL
    cfg, data, hyper = _mesh_train_cfg(run)
    batches = [_cuda_batch(data, s) for s in range(run["steps"])]
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    one = steps.init_train_state(build_model(cfg), hyper=hyper, seed=0,
                                 device="cuda")
    step = steps.build_train_step(model, hyper=hyper)
    want = []
    for b in batches:
        one, m = step(one, b)
        want.append(float(m["loss"]))
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_mesh((1, 1), device="cuda")
        step = steps.build_train_step(model, hyper=hyper, mesh=mesh)
        state = steps.init_train_state(model, hyper=hyper, seed=0,
                                       device="cuda",
                                       placement=step.placement)
        got = []
        for b in batches:
            state, m = step(state, b)
            got.append(float(m["loss"]))
        differ = _states_equal(torch, state, one)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state
    finally:
        dist.destroy_process_group()
    del one, model, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": got, "want": want, "state_leaves_differing": differ,
            "peak_mem_gb": peak}


def _beside_ranks(torch, ranks_fn, phases) -> tuple:
    """``ranks_fn()`` (a blocking ``run_ranks`` call, whose ranks are
    processes of their own) on a thread while ``phases`` run here one
    after another; returns its result and its seconds. A phase that fails
    fails at once: the ranks are daemon processes, ended at exit."""
    import threading

    box = {}

    def target():
        t0 = time.monotonic()
        try:
            box["ranks"] = ranks_fn()
        except BaseException as e:     # re-raised on the caller's thread
            box["error"] = e
        box["seconds"] = time.monotonic() - t0

    thread = threading.Thread(target=target, name="ranks", daemon=True)
    thread.start()
    for phase in phases:
        phase(torch)
    thread.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"], box["seconds"]


def mesh_train_phase(torch, beside=()) -> dict:
    """Training on a device mesh (module docstring): the (1, 1) NCCL mesh
    bit for bit; then each run's one-device step on the card (freed), and
    the two gloo ranks that hold the mesh runs to them, and the
    checkpoint across meshes, while this process runs the phases
    ``beside``. Fails on a failed rank, a run off its bar, a gradient not
    finite, or a launch no kernels row checked. Returns the counted runs'
    launches by run (both ranks' summed)."""
    import tempfile

    from repro_torch.launch.mesh import run_ranks

    smi = nvidia_smi()
    t0 = time.monotonic()
    nccl = mesh_train_nccl(torch)
    bad = nccl["losses"] != nccl["want"] or nccl["state_leaves_differing"]
    emit({"phase": "mesh_train", "what": "llama3-8b (1, 1) nccl",
          "mesh": "1x1", "backend": "nccl", "ranks": 1,
          "n_layers": MESH_TRAIN_NCCL["layers"], "nvidia_smi": smi,
          "steps": MESH_TRAIN_NCCL["steps"], "losses": nccl["losses"],
          "one_device_losses": nccl["want"],
          "state_leaves_differing": nccl["state_leaves_differing"][:10],
          "peak_mem_gb": nccl["peak_mem_gb"],
          "seconds": time.monotonic() - t0})
    if bad:
        raise AssertionError("mesh_train: the (1, 1) NCCL mesh's steps "
                             "differ from the one-device steps")
    failures, runs = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        wants, jobs = {}, {}
        for label, run in MESH_TRAIN_RUNS.items():
            key = (run["arch"], run["layers"], run["batch"], run["seq"])
            if key not in wants:
                wants[key] = mesh_train_one_device(
                    torch, run, os.path.join(tmp, label))
            jobs[label] = (run, wants[key])
        gc.collect()
        torch.cuda.empty_cache()
        checked = set(CHECKED)
        ranks, spawn_s = _beside_ranks(torch, lambda: run_ranks(
            2, mesh_train_rank, jobs, checked, tmp, backend="gloo",
            timeout_s=MESH_TIMEOUT_S, join_timeout_s=MESH_JOIN_S,
            threads=0), beside)
    for label, run in MESH_TRAIN_RUNS.items():
        want = jobs[label][1]
        per_rank = [r[label] for r in ranks]
        r0 = per_rank[0]
        errs = {}
        for path, (d2, w2, split) in r0["errs"].items():
            if split:
                d2 += per_rank[1]["errs"][path][0]
                w2 += per_rank[1]["errs"][path][1]
            errs[path] = math.sqrt(d2) / max(math.sqrt(w2), 1e-30)
        worst = max(errs, key=errs.get)
        line = {"phase": "mesh_train", "what": label, "arch": run["arch"],
                "mesh": "x".join(map(str, run["shape"])), "backend": "gloo",
                "ranks": 2, "n_layers": run["layers"], "batch": run["batch"],
                "seq": run["seq"], "nvidia_smi": smi,
                "speed": MESH_TRAIN_SPEED, "spawn_s": spawn_s,
                "one_device_loss": want["loss"], "loss": r0["loss"],
                "loss_diff": abs(r0["loss"] - want["loss"]),
                "loss_tol": TRAIN_LOSS_TOL, "worst_leaf": worst,
                "worst_grad_rel_err": errs[worst],
                "grad_rel_tol": TRAIN_GRAD_REL_TOL,
                "grad_leaves_not_finite": sorted(
                    {p for r in per_rank for p in r["not_finite"]}),
                "losses": r0["losses"],
                "losses_equal_on_ranks": all(r["losses"] == r0["losses"]
                                             for r in per_rank),
                "step_ms": [r["step_ms"] for r in per_rank],
                "step_ms_median": statistics.median(r0["step_ms"]),
                "init_s": [r["init_s"] for r in per_rank],
                "collectives_per_step": r0["collectives_per_step"],
                "peak_mem_gb": [r["peak_mem_gb"] for r in per_rank],
                "one_device_peak_gb": want["peak_gb"],
                "local_params": [r["local_params"] for r in per_rank],
                "split": r0["split"],
                "launches": [r["launches"] for r in per_rank],
                "unchecked_calls": sorted(
                    {k for r in per_rank for k in r["unchecked_calls"]}),
                "grad_rel_errs": errs}
        if "routing_calls" in r0:
            line.update({k: [r[k] for r in per_rank] for k in (
                "routing_calls", "own_choice_differences", "prob_rel_errs",
                "prob_max_abs_diff", "past_near_tie")})
            line["routing"] = "teacher-forced"
        emit(line)
        if line["loss_diff"] > TRAIN_LOSS_TOL \
                or errs[worst] > TRAIN_GRAD_REL_TOL:
            failures.append(f"{label}: loss {line['loss_diff']}, {worst} "
                            f"{errs[worst]}")
        if line["grad_leaves_not_finite"] or not all(
                math.isfinite(x) for x in r0["losses"]):
            failures.append(f"{label}: not finite")
        if not line["losses_equal_on_ranks"]:
            failures.append(f"{label}: the ranks' losses differ")
        if any(not r.get("ok", True) for r in per_rank):
            failures.append(f"{label}: expert choices past a near-tie "
                            f"{[r['past_near_tie'] for r in per_rank]}")
        launched = {k: sum(r["launches"][k] for r in per_rank)
                    for k in r0["launches"]}
        wanted = ["dot_moa"] + (["moa_reduce"] if run["arch"].startswith(
            "moonshot") else [])
        if any(not launched[k] for k in wanted) or any(
                n and k not in wanted for k, n in launched.items()):
            failures.append(f"{label}: launches {launched}")
        if line["unchecked_calls"]:
            failures.append(f"{label}: launches no kernels row checked "
                            f"{line['unchecked_calls'][:5]}")
        runs[f"train-mesh/{label}"] = launched
    ck = [r["ckpt"] for r in ranks]
    emit({"phase": "mesh_train", "what": "checkpoint (1, 2) -> (2, 1)",
          "nvidia_smi": smi, "step": ck[0]["step"], "leaves": ck[0]["leaves"],
          "differ": [c["differ"] for c in ck],
          "on_cuda": [c["on_cuda"] for c in ck]})
    if any(c["differ"] or not c["on_cuda"] for c in ck):
        failures.append("checkpoint: restored slices differ from the saved "
                        "leaves")
    if failures:
        raise AssertionError("mesh_train phase: " + "; ".join(failures))
    return runs


# ---------------------------------------------------------------------------


def main() -> int:
    global _LOG
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log", default="",
                    help="also append every JSON line to this file")
    ap.add_argument("--parent", default="",
                    help="a checkout of the parent tree: its dot_moa, "
                         "paged-attention and reduction kernels are built "
                         "and timed beside each unbatched dot_moa, paged and "
                         "reduction row, and its paged kernel in a second "
                         "decode_long line")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs on the "
              "GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels import _build, ops
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    if set(KERNELS) != set(ops.launch_counts()):
        raise AssertionError(f"KERNELS names {sorted(KERNELS)}, the port "
                             f"counts {sorted(ops.launch_counts())}")
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        _LOG = open(args.log, "a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    built = _build.build()
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kernels": {name: {"seconds": b["seconds"], "cached": b["cached"],
                             "ptxas": ptxas_report(b["log"])}
                      for name, b in built.items()}})

    # the dry run's traces need no card: they run beside the phases
    traces = start_dryrun_traces()
    parent = {}
    if args.parent:
        t0 = time.monotonic()
        parent, pbuilt = parent_kernels(args.parent)
        emit({"phase": "build", "parent": args.parent,
              "seconds": time.monotonic() - t0,
              "ptxas": {name: ptxas_report(b["log"])
                        for name, b in pbuilt.items()}})

    timer = Timer(torch)
    rows_phase(torch)
    rows = kernel_phase(torch, timer, parent)
    rows.update(paper_kernel_phase(torch, timer, parent))
    rows.update(moe_kernel_phase(torch, timer))
    check_call_keys(torch, mesh_call_keys(), "mesh shard shape")
    check_call_keys(torch, mesh_train_call_keys(), "mesh train shard shape",
                    timer)
    check_call_keys(torch, dryrun_call_keys(), "dryrun shard shape")
    unembed = unembed_phase(torch, timer)
    emit({"phase": "kernels", "kernel": "dot_moa", "case": "host path",
          "iters": 1000, **host_path(torch)})
    # the main path's runs, each with the launches its counts gave: the
    # captured serve runs (llama3-8b paged, moonshot in both layouts) and
    # the paper path
    llama3 = llama3_full(torch)
    runs = {"serve/llama3-8b": serve_phase(torch, llama3,
                                           parent.get("paged_attention"))}
    runs.update(spec_phase(torch, llama3))
    runs["serve/llama3-8b-slo"] = slo_phase(torch, llama3)
    runs["serve/llama3-8b-fleet"] = fleet_phase(torch, llama3)
    audit_phase(torch, llama3)
    del llama3
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(moe_serve_phase(torch))
    runs.update(hybrid_phase(torch, unembed))
    runs.update(train_phase(torch))
    runs.update(families_phase(torch))
    runs.update(mesh_phase(torch))
    # the parity phases run beside the mesh_train ranks
    runs.update(mesh_train_phase(torch, beside=(
        parity_phase, zamba2_parity_phase, moe_parity_phase,
        spec_parity_phase)))
    cli_phase(torch)
    runs.update(dryrun_phase(torch, traces))
    runs["paper"] = paper_phase(torch)

    # each kernel's launches are those of the runs of its first path (the
    # served runs; dot_moa and moa_reduce also run on the paper path),
    # each run's beside them
    summary = []
    for name, k in KERNELS.items():
        row = rows[name]
        by_run = {r: c.get(name, 0) for r, c in runs.items()
                  if r.split("/")[0] in k.paths}
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{k.source}.cu",
            "replaces": k.replaces,
            "launches": sum(n for r, n in by_run.items()
                            if r.split("/")[0] == k.paths[0]),
            "launches_by_path": by_run,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "case": row["case"]})
        verify = rows.get(f"{name} verify")
        if verify is not None:     # the served T = k + 1 instance
            summary[-1]["verify"] = {
                key: verify[key] for key in (
                    "shape", "case", "max_abs_err", "kernel_ms",
                    "device_ms", "plain_ms", "bound_ms", "bound_by")}
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    if _LOG is not None:
        _LOG.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
