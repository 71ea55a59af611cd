"""Graph-level serve-path auditor — the counterpart of
``repro/analysis/jaxpr_audit.py``.

The reference traces each serve callable to a jaxpr and walks it. The
port runs each target eagerly at smoke size under a ``TorchDispatchMode``
(:class:`OpTrace`) that sees every aten op the body executes, with the
innermost ``src/repro_torch`` frame that issued it, and checks:

* **no-host-transfer** — no ``.item()`` (``_local_scalar_dense``), no copy
  to another device and no op whose output shape depends on the data
  (``nonzero``, boolean indexing, ``unique``, ...) inside a tick body:
  each is a device sync a tick on the card;
* **donation-honored** — the port's cache is written in place: every leaf
  of a donated argument (KV and recurrent state) keeps its storage (a
  rebound leaf is a copy the engine never sees), and no op outputs a
  tensor of a KV leaf's whole shape on storage that no leaf of the cache
  holds after the call (a functional copy of the cache);
* **f32-upcast-allowlist** — a bf16/f16 operand widened to f32 (a cast, a
  copy into f32, or an op that promotes it) only at the sites of
  :data:`UPCAST_ALLOWLIST`, each with its reason;
* **kv-constraint-coverage** — on a mesh, every KV leaf's placement spec
  equals the reference's ``serve_rules_for`` table (the port places
  leaves, where the reference constrains values);
* **determinism** — no RNG op on a deterministic target; on the ssm and
  hybrid families no collective over the ``model`` axis (observed at
  :mod:`repro_torch.parallel.collectives`'s entry points) and no spec
  that names it.

A kernel entry point (:mod:`repro_torch.kernels.ops`) is opaque on the
card, so the ops of its plain version, which the CPU runs instead, are
left out (the recorder's ``inside``): the CPU audit sees what the card's
would.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Violation
from repro_torch.interop import tree_leaves
from repro_torch.kernels import ops
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import activate

__all__ = ["AuditTarget", "OpTrace", "audit_target", "audit_targets",
           "op_site", "run_target", "UPCAST_ALLOWLIST"]

#: ops that read device data back to the host
HOST_READ_OPS = {"_local_scalar_dense", "equal", "is_nonzero"}

#: ops whose output shape depends on the data (a sync to size the output)
DATA_SHAPE_OPS = {"nonzero", "masked_select", "_unique2", "unique_dim",
                  "unique_consecutive", "argwhere", "bincount"}

#: random-number ops: none may run on a deterministic target
RNG_OPS = {"rand", "randn", "randint", "randperm", "rand_like", "randn_like",
           "randint_like", "bernoulli", "bernoulli_", "multinomial",
           "normal", "normal_", "uniform_", "exponential_", "geometric_",
           "cauchy_", "log_normal_", "random_", "poisson", "native_dropout"}

_SMALL_FLOATS = (torch.bfloat16, torch.float16)

#: the sites allowed to widen a bf16/f16 operand to f32 on a serve path:
#: ``(file, function or None for the whole file, reason)``
UPCAST_ALLOWLIST: Tuple[Tuple[str, Optional[str], str], ...] = (
    ("src/repro_torch/layers/numerics.py", None,
     "the accumulate-wide helpers (f32_upcast, silu_f32, softplus_f32, "
     "sum_f32): the named f32 sites the reference allowlists"),
    ("src/repro_torch/layers/attention.py", None,
     "scores, softmax and the int8 KV (de)quantization in f32, as the "
     "reference's attention.py (allowlisted there)"),
    ("src/repro_torch/kernels/ref.py", "matmul_accum",
     "the reference's preferred_element_type=f32 product: PyTorch has no "
     "bf16 x bf16 -> f32 matmul on the CPU, so the operands widen where "
     "XLA widens them inside the dot"),
    ("src/repro_torch/kernels/ref.py", "flash_attention_ref",
     "the plain chunked flash attention, the reference's jnp "
     "flash_attention of layers/attention.py (allowlisted there), which "
     "lives beside the kernel's other plain versions"),
    ("src/repro_torch/layers/embedding.py", "unembed",
     "the f32 logits product (the reference's preferred_element_type=f32 "
     "einsum); a bf16 product on CUDA is one mm with f32 output, which "
     "widens nothing, but the CPU has no such product"),
)

#: products: a bf16 product with an f32 output accumulates wide (the
#: reference's ``preferred_element_type=f32``), which widens no operand
PRODUCT_OPS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot", "convolution",
               "_convolution"}

#: frames of the auditors themselves, skipped when attributing an op
_AUDIT_FILES = ("analysis/graph_audit.py", "analysis/cost_audit.py")


@dataclasses.dataclass(frozen=True)
class AuditTarget:
    """One serve-path callable and how to run it as the engine does.

    ``make_args`` returns fresh operands (the body mutates its cache in
    place, so each run takes its own); ``donate`` indexes the arguments
    the body must update in place, ``kv_key`` and ``state_key`` the keys
    of a donated cache whose leaves are K/V and recurrent state. On a mesh, ``mesh``,
    ``rules`` and ``shard`` are the context the engine activates,
    ``specs`` every parameter and cache leaf's placement spec (``params.``
    / ``cache.`` paths) and ``kv_specs`` the reference table's spec for
    each KV leaf. ``context``: a context manager factory entered around
    the call (a fixture's process group)."""

    name: str
    family: str
    fn: Callable
    make_args: Callable[[], tuple]
    donate: Tuple[int, ...] = ()
    kv_key: Optional[str] = None
    state_key: Optional[str] = None
    deterministic: bool = True
    mesh: Any = None
    rules: Any = None
    shard: Any = None
    specs: Optional[Mapping[str, tuple]] = None
    kv_specs: Tuple[Tuple[str, tuple], ...] = ()
    context: Optional[Callable[[], Any]] = None


def op_site() -> Tuple[str, int, str]:
    """``(file, line, function)`` of the innermost ``src/repro_torch``
    frame of the caller's stack, the auditors' own frames skipped."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        i = name.find("/src/repro_torch/")
        rel = name[i + 1:] if i >= 0 else (
            "src/repro_torch/" + name.split("/repro_torch/", 1)[1]
            if "/repro_torch/" in name else "")
        if rel and not rel.endswith(_AUDIT_FILES):
            return rel, f.f_lineno, f.f_code.co_name
        f = f.f_back
    return "", 0, ""


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in _tensors(item)]
    return []


class OpTrace(TorchDispatchMode):
    """Calls ``on_op(name, args, kwargs, out)`` after every aten op the
    block runs outside a recorded kernel call (``recorder.inside``)."""

    def __init__(self, on_op, recorder: ops.KernelRecorder):
        super().__init__()
        self.on_op, self.recorder = on_op, recorder

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.recorder.inside:
            self.on_op(func.overloadpacket.__name__, args, kwargs, out)
        return out


def kv_leaves(target: AuditTarget, args, *,
              state: bool = True) -> List[torch.Tensor]:
    """The K/V leaves (and with ``state`` the recurrent state leaves) of
    the target's donated caches."""
    keys = [target.kv_key] + ([target.state_key] if state else [])
    out = []
    for i in target.donate:
        cache = args[i]
        for key in filter(None, keys):
            if isinstance(cache, dict) and key in cache:
                out.extend(t for _, t in tree_leaves(cache[key])
                           if isinstance(t, torch.Tensor))
    return out


def run_target(target: AuditTarget, on_op, *, on_collective=None,
               args=None, recorder=None):
    """Run ``target`` once under an :class:`OpTrace` and a kernel recorder
    (its mesh context active, its ``context`` entered); returns ``(args,
    output, recorder)``."""
    args = target.make_args() if args is None else args
    rec = recorder if recorder is not None else ops.KernelRecorder()
    with contextlib.ExitStack() as stack:
        if target.context is not None:
            stack.enter_context(target.context())
        if target.mesh is not None:
            stack.enter_context(activate(target.mesh, target.rules,
                                         target.shard))
        if on_collective is not None:
            stack.enter_context(collectives.observing(on_collective))
        stack.enter_context(torch.no_grad())
        stack.enter_context(ops.recording(rec))
        stack.enter_context(OpTrace(on_op, rec))
        out = target.fn(*args)
    return args, out, rec


def _mentions_model(spec) -> bool:
    for e in spec or ():
        axes = e if isinstance(e, tuple) else (e,)
        if "model" in axes:
            return True
    return False


def _upcast_allowed(file: str, func: str) -> bool:
    return any(file == f and (fn is None or fn == func)
               for f, fn, _ in UPCAST_ALLOWLIST)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def audit_target(target: AuditTarget) -> List[Violation]:
    """Run every graph rule against one serve callable."""
    out: List[Violation] = []
    reproducible = target.family in ("ssm", "hybrid")
    args = target.make_args()
    kv_shapes = {tuple(t.shape) for t in kv_leaves(target, args,
                                                   state=False)}
    copies: List[Tuple[int, Tuple[str, int, str], str]] = []
    donated = {i: {p: t.data_ptr() for p, t in tree_leaves(args[i])
                   if isinstance(t, torch.Tensor)}
               for i in target.donate}

    def flag(rule, message, prov, site=None):
        file, line, func = site or op_site()
        out.append(Violation(rule=rule, target=target.name, file=file,
                             line=line, message=message,
                             provenance=f"{prov} in {func}" if func
                             else prov))

    def on_op(name, a, kw, result):
        if name in HOST_READ_OPS:
            flag("no-host-transfer", f"{name}: a host read of device data "
                 "inside a tick body (a device sync a tick)", name)
        elif name in DATA_SHAPE_OPS or (
                name == "repeat_interleave" and isinstance(a[0], torch.Tensor)
                and isinstance(a[1] if len(a) > 1 else kw.get("repeats"),
                               torch.Tensor)):
            flag("no-host-transfer", f"{name}: an output shape that depends "
                 "on the data (a device sync to size it)", name)
        elif name in ("index", "index_put", "index_put_") and any(
                t.dtype == torch.bool for t in _tensors(a[1])):
            flag("no-host-transfer", f"{name} with a boolean mask: an output "
                 "or write set that depends on the data", name)
        elif name == "_to_copy" and kw.get("device") is not None and \
                torch.device(kw["device"]) != a[0].device:
            flag("no-host-transfer", f"copy from {a[0].device} to "
                 f"{kw['device']} inside a tick body", name)
        elif name == "copy_" and a[0].device != a[1].device:
            flag("no-host-transfer", f"copy from {a[1].device} to "
                 f"{a[0].device} inside a tick body", name)
        if name in RNG_OPS and target.deterministic:
            flag("determinism", f"random-number op {name} on a "
                 "deterministic serve path", name)
        results = _tensors(result)
        if name not in PRODUCT_OPS and any(
                t.dtype in _SMALL_FLOATS for t in _tensors((a, kw))) and any(
                t.dtype == torch.float32 for t in results):
            file, line, fn = op_site()
            if not _upcast_allowed(file, fn):
                flag("f32-upcast-allowlist", f"{name}: bf16/f16 -> float32 "
                     "outside the allowlisted accumulation sites",
                     name, (file, line, fn))
        for t in results:
            if tuple(t.shape) in kv_shapes:
                copies.append((_storage(t), op_site(), name))

    def on_collective(kind, axis, nbytes):
        if reproducible and axis == "model":
            flag("determinism", f"model-axis collective {kind} on a "
                 "bitwise-reproducible family", kind)

    run_target(target, on_op, on_collective=on_collective, args=args)

    # a tensor of a KV leaf's shape on storage no leaf of the cache holds
    # after the call is a copy of the leaf, not the leaf written in place
    own = {_storage(t) for i in target.donate
           for _, t in tree_leaves(args[i]) if isinstance(t, torch.Tensor)}
    for ptr, site, name in copies:
        if ptr not in own:
            flag("donation-honored", f"{name} outputs a copy of a whole KV "
                 "leaf: the cache is copied, not written in place", name,
                 site)

    for i, before in donated.items():
        after = {p: t.data_ptr() for p, t in tree_leaves(args[i])
                 if isinstance(t, torch.Tensor)}
        moved = sorted(p for p, ptr in before.items() if after.get(p) != ptr)
        if moved:
            out.append(Violation(
                rule="donation-honored", target=target.name, file="", line=0,
                message=(f"donated leaves rebound to new storage: "
                         f"{moved[:4]} — the engine's cache is not the one "
                         "the body wrote"),
                provenance=f"donate={target.donate}"))

    if target.specs is not None:
        if reproducible:
            bad = sorted(p for p, s in target.specs.items()
                         if _mentions_model(s))
            if bad:
                out.append(Violation(
                    rule="determinism", target=target.name, file="", line=0,
                    message=(f"model-axis specs {bad[:4]} on a "
                             "bitwise-reproducible family"),
                    provenance="placement"))
        for path, want in target.kv_specs:
            got = target.specs.get(path)
            if got is None:
                out.append(Violation(
                    rule="kv-constraint-coverage", target=target.name,
                    file="", line=0, provenance=path,
                    message=(f"KV leaf {path} has no placement spec — its "
                             "layout on the mesh is unpinned")))
            elif tuple(got) != tuple(want):
                out.append(Violation(
                    rule="kv-constraint-coverage", target=target.name,
                    file="", line=0, provenance=path,
                    message=(f"KV leaf {path} placed {tuple(got)}, the "
                             f"serve_rules_for table gives {tuple(want)}")))
    return out


def audit_targets(targets) -> List[Violation]:
    out: List[Violation] = []
    for t in targets:
        out.extend(audit_target(t))
    return out
