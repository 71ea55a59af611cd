#!/usr/bin/env python3
"""Does a row's result depend on the rows beside it?

    python3 scripts/row_invariance.py [--layers 2] [--smoke --device cpu]

The port's speculative engine scores a slot's next token in a verify call
of ``n_slots * (k + 1)`` rows, while the plain engine scores it in a decode
call of ``n_slots`` rows; the oracle drafter rolls out on a dense-slot cache
while a paged target verifies. Greedy tokens agree bit for bit only if no
op's row depends on how many rows share the call. This script checks that
on llama3-8b at full width (``--layers`` deep, bf16 weights from seed 0,
4 slots, bs 16, max_len 96):

* ``trace`` lines: one slot's ops, in call order, for a decode step and
  for row 0 of a verify over the same committed tokens (paged against
  paged, dense-slot against dense-slot, and the drafter's dense-slot
  decode against the paged verify); ``first_differing_op`` names the
  first op whose output row differs in a bit.
* ``op`` lines: each op alone on the same input rows at m = 1, 2, 4, 8, 16
  (the projections at every served weight shape, RMSNorm, the
  unembedding) and each attention row at T = 1 against T = 4 (paged,
  dense-slot, and dense-slot against paged): ``bit_equal`` and the largest
  difference.

Every line is JSON; the last is ``{"phase": "rows", "ok": ...,
"differing": [...]}``, and the exit code is 1 where an op or a trace
differs. ``chip_smoke.py`` runs :func:`check` as its ``rows`` phase. It
imports nothing of JAX. On the CPU (``--device cpu``) it runs the plain
versions (where the CPU's own unembedding product need not be
row-invariant: it is not the card's).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402

N_SLOTS, MAX_LEN, BS, T = 4, 96, 16, 4
CURSORS = (20, 33, 45, 57)
ROWS = (1, 2, 4, 8, 16)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def differ(a: torch.Tensor, b: torch.Tensor) -> dict:
    a, b = a.float(), b.float()
    return {"bit_equal": bool(torch.equal(a, b)),
            "max_abs_diff": float((a - b).abs().max()) if a.numel() else 0.0}


class Recorder:
    """Wraps the model's ops and records each call's output, in order."""

    def __init__(self):
        self.calls = []
        self.on = False
        self._undo = []

    def wrap(self, module, name: str, label: str = None, pick=None):
        fn = getattr(module, name)
        label = label or name

        def recorded(*args, **kw):
            out = fn(*args, **kw)
            if self.on:
                self.calls.append((label, out if pick is None
                                   else pick(out)))
            return out

        setattr(module, name, recorded)
        self._undo.append((module, name, fn))

    def restore(self):
        for module, name, fn in reversed(self._undo):
            setattr(module, name, fn)

    def run(self, fn):
        self.calls, self.on = [], True
        try:
            with torch.no_grad():
                fn()
        finally:
            self.on = False
        return self.calls


def recorder():
    from repro_torch.layers import attention, linear, mlp
    from repro_torch.models import transformer

    rec = Recorder()
    rec.wrap(transformer, "embed")
    rec.wrap(transformer, "rms_norm")
    rec.wrap(linear, "project", "project")      # q/k/v/o (looked up late)
    rec.wrap(mlp, "project", "project")         # gate/up/down
    rec.wrap(mlp, "silu_f32")
    rec.wrap(attention, "apply_rope", "rope")
    rec.wrap(attention, "full_attention", "attention")
    rec.wrap(attention, "_paged_attention_fused", "attention")
    rec.wrap(transformer, "unembed")
    return rec


def caches(model, params, device):
    """The same K/V history in a dense-slot cache and a paged pool (slot b's
    page j is physical page 1 + 6 b + j), slots at ``CURSORS``."""
    g = torch.Generator(device="cpu").manual_seed(7)
    dense = model.init_cache(N_SLOTS, MAX_LEN, device=device)
    pages = MAX_LEN // BS
    paged = model.init_paged_cache(N_SLOTS, 1 + N_SLOTS * pages, BS, pages,
                                   device=device)
    for name, buf in dense["layers"].items():
        vals = 0.5 * torch.randn(buf.shape, generator=g)
        for b, c in enumerate(CURSORS):
            vals[:, b, c:] = 0
        buf.copy_(vals.to(buf.dtype))
        pool = paged["layers"][name]
        L = buf.shape[0]
        pool[:, 1:] = buf.reshape(L, N_SLOTS * pages, BS, *buf.shape[3:])
    dense["pos"] = torch.tensor(CURSORS, dtype=torch.int32, device=device)
    paged["pos"] = dense["pos"].clone()
    paged["block_tables"].copy_(
        1 + torch.arange(N_SLOTS * pages, dtype=torch.int32,
                         device=device).reshape(N_SLOTS, pages))
    return dense, paged


def clone(tree):
    from repro_torch.interop import tree_map

    return tree_map(torch.clone, tree)


def trace(model, params, dense, paged, tokens, device) -> list:
    """``trace`` lines: decode rows against verify row 0, op by op."""
    rec = recorder()
    live = MAX_LEN // BS
    steps = {
        "paged decode": lambda: model.paged_decode_step(
            params, clone(paged), tokens[:, :1], live_blocks=live),
        "paged verify": lambda: model.paged_verify_step(
            params, clone(paged), tokens, live_blocks=live),
        "dense decode": lambda: model.decode_step(params, clone(dense),
                                                  tokens[:, :1]),
        "dense verify": lambda: model.verify_step(params, clone(dense),
                                                  tokens),
    }
    try:
        calls = {name: rec.run(fn) for name, fn in steps.items()}
    finally:
        rec.restore()
    bad = []
    for a, b in (("paged decode", "paged verify"),
                 ("dense decode", "dense verify"),
                 ("dense decode", "paged verify")):
        ops, first = [], None
        if len(calls[a]) != len(calls[b]):
            raise AssertionError(f"{a} made {len(calls[a])} op calls, {b} "
                                 f"{len(calls[b])}")
        for i, ((na, xa), (nb, xb)) in enumerate(zip(calls[a], calls[b])):
            if na != nb:
                raise AssertionError(f"op {i}: {a} ran {na}, {b} ran {nb}")
            d = differ(xa[:, 0], xb[:, 0])
            ops.append(dict(op=na, index=i, **d))
            if first is None and not d["bit_equal"]:
                first = f"{na} (call {i})"
        line = {"phase": "trace", "compare": f"{a} vs {b}",
                "n_layers": model.cfg.n_layers, "ops": len(ops),
                "first_differing_op": first,
                "differing_ops": [f"{o['op']}#{o['index']}" for o in ops
                                  if not o["bit_equal"]],
                "logits": ops[-1]}
        emit(line)
        if first is not None:
            bad.append(line["compare"])
    return bad


def op_rows(model, params, device) -> list:
    """``op`` lines: each op at m rows against the same rows of m = 16."""
    from repro_torch.layers import attention
    from repro_torch.layers.common import rms_norm
    from repro_torch.layers.embedding import unembed
    from repro_torch.layers.linear import project
    from repro_torch.models.transformer import layer

    cfg = model.cfg
    g = torch.Generator(device="cpu").manual_seed(3)
    lyr = layer(params["layers"], 0)
    strat = cfg.moa_for("attention")
    cases = {
        "rms_norm": (cfg.d_model, lambda x: rms_norm(lyr["attn_norm"], x)),
        "unembed": (cfg.d_model, lambda x: unembed(
            params["embed"], x, compute_dtype=cfg.cdtype)),
    }
    for name, w in (("wq", lyr["attn"]["wq"]), ("wk", lyr["attn"]["wk"]),
                    ("wo", lyr["attn"]["wo"]),
                    ("w_gate", lyr["mlp"]["w_gate"]),
                    ("w_down", lyr["mlp"]["w_down"])):
        cases[f"project {name} {tuple(w.shape)}"] = (
            w.shape[0], lambda x, w=w: project(
                {"w": w}, x, strategy=strat, compute_dtype=cfg.cdtype))
    bad = []
    with torch.no_grad():
        for name, (d_in, fn) in cases.items():
            x = torch.randn((16, 1, d_in), generator=g).to(cfg.cdtype)
            full = fn(x.to(device))
            for m in ROWS[:-1]:
                d = differ(fn(x[:m].to(device)), full[:m])
                emit(dict(phase="op", op=name, m=m, against=16, **d))
                if not d["bit_equal"]:
                    bad.append(f"{name} m={m}")
        # attention: row t of a T = 4 call against a T = 1 call at start + t
        dense, paged = caches(model, params, device)
        H, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kv = {k: v[0] for k, v in dense["layers"].items()}
        pool = {k: v[0] for k, v in paged["layers"].items()}
        tables = paged["block_tables"]
        pos = dense["pos"]
        q = torch.randn((N_SLOTS, T, H, D), generator=g).to(
            cfg.cdtype).to(device)
        pos_q = pos[:, None] + torch.arange(T, device=device)[None]

        def paged_att(qq, start):
            return attention._paged_attention_fused(
                qq, pool, tables, start, compute_dtype=cfg.cdtype)

        def dense_att(qq, start):      # the route the engine takes
            if qq.is_cuda:
                return attention.dense_attention(
                    qq, kv, start, compute_dtype=cfg.cdtype)
            tq = qq.shape[1]
            p = start[:, None] + torch.arange(tq, device=device)[None]
            return attention.full_attention(qq, kv["k"], kv["v"],
                                            causal=True, positions_q=p)

        rows = {"paged": paged_att, "dense-slot": dense_att}
        full = {n: f(q, pos) for n, f in rows.items()}
        for n, f in rows.items():
            for t in range(T):
                one = f(q[:, t:t + 1].contiguous(), pos_q[:, t].contiguous())
                d = differ(one[:, 0], full[n][:, t])
                emit(dict(phase="op", op=f"attention {n}", T=1,
                          against=f"row {t} of T={T}", **d))
                if not d["bit_equal"]:
                    bad.append(f"attention {n} t={t}")
        for t in range(T):
            d = differ(full["dense-slot"][:, t], full["paged"][:, t])
            emit(dict(phase="op", op="attention dense-slot vs paged",
                      T=T, row=t, **d))
            if not d["bit_equal"]:
                bad.append(f"attention dense-slot vs paged t={t}")
    return bad


def chunk_rows(*, device: str = "cuda", arch: str = "mamba2-370m",
               n_layers: int = 48, prompt: int = 1024, smoke: bool = False
               ) -> list:
    """``chunk`` lines: the SSM's prefill of ``prompt`` tokens in one shot
    against the same tokens in chunks of ``ssd_chunk`` (``prefill_chunk``
    continuing from the carried state), op by op on the same inputs (the
    RMSNorm, the in projection, the causal conv continued from its
    history, the SSD scan continued from its state, the gated norm, the out
    projection), then one whole Mamba-2 mixer and the whole prefill's
    last-position logits. Each chunk's rows against the same rows of the
    one-shot call. Returns the ops that differ in a bit."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.layers import ssd
    from repro_torch.layers.common import rms_norm
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import layer

    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg)
    cfg = dataclasses.replace(cfg, n_layers=n_layers, param_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    L, cd = cfg.ssd_chunk, cfg.cdtype
    if prompt % L:
        raise ValueError(f"prompt {prompt} is not a multiple of {L}")
    mixer = layer(params["layers"], 0)["mixer"]
    g = torch.Generator(device="cpu").manual_seed(11)

    def rand(*shape, dtype=cd, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(dtype).to(device)

    d, di = cfg.d_model, cfg.d_inner
    H, P, N = di // cfg.headdim, cfg.headdim, cfg.d_state
    bad = []

    def compare(op, full, pieces):
        """``full`` (one shot) against ``pieces`` (one a chunk, in order),
        each a tensor or a tuple of them, split along dim 1."""
        full = full if isinstance(full, tuple) else (full,)
        pieces = [p if isinstance(p, tuple) else (p,) for p in pieces]
        for j, f in enumerate(full):
            joined = torch.cat([p[j] for p in pieces], dim=1)
            dd = differ(joined, f)
            emit(dict(phase="chunk", arch=cfg.name, op=op, output=j,
                      rows=prompt, against=L, **dd))
            if not dd["bit_equal"]:
                bad.append(f"{op}[{j}]")

    n = prompt // L
    cut = [slice(i * L, (i + 1) * L) for i in range(n)]
    with torch.no_grad():
        x = rand(1, prompt, d)
        norm = layer(params["layers"], 0)["norm"]
        compare("rms_norm", rms_norm(norm, x),
                [rms_norm(norm, x[:, c]) for c in cut])
        w_in = mixer["in_proj"].to(cd)
        compare("in_proj", x @ w_in, [x[:, c] @ w_in for c in cut])
        conv_in = rand(1, prompt, mixer["conv_w"].shape[1])
        w, b = mixer["conv_w"].to(cd), mixer["conv_b"].to(cd)
        k1 = w.shape[0] - 1
        compare("conv", ssd._causal_depthwise_conv(conv_in, w, b),
                [ssd._causal_depthwise_conv(
                    conv_in[:, c], w, b,
                    hist=None if i == 0 else conv_in[:, c.start - k1:c.start])
                 for i, c in enumerate(cut)])
        xs, bs, cs = (rand(1, prompt, H, P), rand(1, prompt, H, N),
                      rand(1, prompt, H, N))
        a = -torch.rand((1, prompt, H), generator=g).to(device) * 0.1
        y, h = ssd.ssd_chunked(xs, a, bs, cs, chunk=L)
        ys, hs, state = [], [], None
        for c in cut:
            yi, state = ssd.ssd_chunked(xs[:, c], a[:, c], bs[:, c],
                                        cs[:, c], chunk=L, h0=state)
            ys.append(yi)
        compare("ssd y", y, ys)
        dd = differ(state, h)
        emit(dict(phase="chunk", arch=cfg.name, op="ssd h_last",
                  rows=prompt, against=L, **dd))
        if not dd["bit_equal"]:
            bad.append("ssd h_last")
        yg = rand(1, prompt, di)
        compare("gate_norm", rms_norm(mixer["gate_norm"], yg),
                [rms_norm(mixer["gate_norm"], yg[:, c]) for c in cut])
        w_out = mixer["out_proj"].to(cd)
        compare("out_proj", yg @ w_out, [yg[:, c] @ w_out for c in cut])
        # one whole mixer: the composition of the above
        kw = dict(d_state=N, headdim=P, n_groups=cfg.n_groups,
                  expand=cfg.expand, ssd_chunk=L, compute_dtype=cd)
        full_y, _ = ssd.mamba2_forward(mixer, x, **kw)
        st = {"h": torch.zeros((1, H, P, N), device=device),
              "conv": torch.zeros((1, k1, w.shape[1]), dtype=torch.bfloat16,
                                  device=device)}
        parts = []
        for c in cut:
            yi, hi = ssd.mamba2_forward(mixer, x[:, c], initial_state=st,
                                        **kw)
            tail = ssd.conv_tail(mixer, x[:, c], d_inner=di,
                                 n_groups=cfg.n_groups, d_state=N,
                                 compute_dtype=cd)
            st = {"h": hi, "conv": torch.cat(
                [st["conv"], tail.to(torch.bfloat16)], dim=1)[:, -k1:]}
            parts.append(yi)
        compare("mamba2_forward", full_y, parts)
        # the whole prefill: last-position logits
        tokens = torch.randint(0, cfg.vocab, (1, prompt), generator=g,
                               dtype=torch.int32).to(device)
        one, _ = model.prefill(params, {"tokens": tokens}, max_len=prompt)
        state = model.init_cache(1, prompt, device=device)
        for c in cut:
            logits, state = model.prefill_chunk(
                params, {"tokens": tokens[:, c]}, state=state)
        dd = differ(logits, one)
        emit(dict(phase="chunk", arch=cfg.name, op="prefill logits",
                  n_layers=cfg.n_layers, rows=prompt, against=L, **dd))
        if not dd["bit_equal"]:
            bad.append("prefill logits")
    return bad


def check(*, n_layers: int = 2, device: str = "cuda",
          smoke: bool = False) -> list:
    """Build the model, print the ``trace`` and ``op`` lines and the
    summary; returns what differs (empty: every row is invariant)."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models.api import build_model

    cfg = get_config("llama3-8b")
    if smoke:
        cfg = smoke_config(cfg)
    cfg = dataclasses.replace(cfg, n_layers=n_layers,
                              param_dtype="bfloat16")
    if device == "cuda":
        from repro_torch.kernels import _build

        _build.build()
        torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    g = torch.Generator(device="cpu").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (N_SLOTS, T), generator=g,
                           dtype=torch.int32).to(device)
    dense, paged = caches(model, params, device)
    bad = trace(model, params, dense, paged, tokens, device)
    bad += op_rows(model, params, device)
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    emit({"phase": "rows", "ok": not bad, "device": name,
          "n_layers": cfg.n_layers, "compute_dtype": cfg.compute_dtype,
          "differing": bad})
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (a CPU rehearsal)")
    ap.add_argument("--chunks", action="store_true",
                    help="only the chunk lines: mamba2-370m's prefill in one "
                         "shot against ssd_chunk-token chunks")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("row_invariance: no CUDA device", file=sys.stderr)
        return 2
    if args.chunks:
        bad = chunk_rows(device=args.device, smoke=args.smoke,
                         n_layers=args.layers,
                         prompt=32 if args.smoke else 1024)
    else:
        bad = check(n_layers=args.layers, device=args.device,
                    smoke=args.smoke)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
