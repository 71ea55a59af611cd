"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so

A library of ``PARTS`` (``dot_moa``: its kernels for each operand type,
and its entry point) compiles as that many objects, ``-DDOT_MOA_PART=k``
each, which are then linked into the library: its kernels are most of the
build, and the parts compile at once.

The file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads what is there. :func:`build` starts one
``nvcc`` per missing library or part, all at once, and waits for all of
them. Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

__all__ = ["KERNELS", "BUILD_DIR", "DTYPE_CODES", "build", "load_function",
           "load_all", "check_device", "raise_on_error", "workspace",
           "stream_workspaces"]

KERNELS = ("dot_moa", "flash_attention", "paged_attention", "moa_reduce",
           "loa_add")
_CSRC = Path(__file__).resolve().parent / "csrc"
#: ``<repo>/build/repro_torch_kernels`` (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: libraries built in parts: ``{name: number of parts}`` (the source's
#: ``<NAME>_PART`` macro selects one; see csrc/dot_moa.cu)
PARTS = {"dot_moa": 6}

#: dtype codes of the C entry points (``enum DType`` in csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.int32: 3}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels "
                       "are built from source at first use")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(str(PARTS.get(name, 1)).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _commands(name: str, out: Path) -> list:
    """The ``nvcc`` commands that build library ``name`` into ``out``, in
    two stages: the ones that run at once (one, or one a part, each
    writing an object), then the link (none for a library in one part)."""
    src = str(_CSRC / f"{name}.cu")
    n = PARTS.get(name, 1)
    if n == 1:
        return [[[_nvcc(), *NVCC_FLAGS, f"-I{_CSRC}", "-o", str(out), src]],
                []]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [Path(f"{out}.{k}.o") for k in range(n)]
    macro = f"-D{name.upper()}_PART"
    return [[[_nvcc(), *flags, f"-I{_CSRC}", f"{macro}={k}", "-c", "-o",
              str(obj), src] for k, obj in enumerate(objs)],
            [[_nvcc(), "-shared", "-o", str(out), *map(str, objs)]]]


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` each (a library of ``PARTS`` one a part, then a link), all in
    parallel. Returns ``{name: {"path", "seconds", "cached", "log"}}``
    (``seconds`` from the start to the library's last step, ``log`` holds
    nvcc's output, with ptxas's register and spill report). Raises with
    the log if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    t0 = time.monotonic()
    for name in names:
        path = _library_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "cached": True,
                         "log": ""}
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        first, link = _commands(name, tmp)
        procs = []
        for cmd in first:
            log = tempfile.TemporaryFile(mode="w+")
            procs.append((subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT,
                                           text=True), log))
        running[name] = (procs, link, tmp, path)
    failed = []
    while running:
        for name, (procs, link, tmp, path) in list(running.items()):
            if any(p.poll() is None for p, _ in procs):
                continue
            del running[name]
            logs = []
            for p, f in procs:
                f.seek(0)
                logs.append(f.read())
                f.close()
            ok = all(p.returncode == 0 for p, _ in procs)
            for cmd in link if ok else ():
                r = subprocess.run(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                logs.append(r.stdout)
                ok = r.returncode == 0
            log = "".join(logs)
            out[name] = {"path": str(path), "seconds": time.monotonic() - t0,
                         "cached": False, "log": log}
            for obj in tmp.parent.glob(tmp.name + ".*.o"):
                obj.unlink()
            if not ok:
                codes = [p.returncode for p, _ in procs]
                failed.append(f"--- {name} (nvcc exits {codes})\n{log}")
                continue
            os.replace(tmp, path)   # atomic: a reader never sees half a file
        if running:
            time.sleep(0.2)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def _load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(_library_path(name)))
    return lib


def load_all() -> None:
    """Build every library not built yet (in parallel) and load them all,
    so that no kernel's first call builds or loads one."""
    build([name for name in KERNELS if name not in _LIBS])
    for name in KERNELS:
        _load(name)


def load_function(name: str, symbol: str, argtypes: Sequence):
    """The C entry point ``symbol`` of library ``name`` (built if needed),
    with ``argtypes`` set and an ``int`` (cudaError_t) return."""
    if name not in _LIBS:
        build([name])
    lib = _load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _capability(index: int):
    return torch.cuda.get_device_capability(index)


def check_device(t: torch.Tensor, what: str) -> None:
    """The kernels are built for ``sm_90a``: any other card raises (there is
    no fallback to the plain version on a CUDA tensor). The capability is
    read once per device."""
    if not t.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs CUDA tensors")
    cap = _capability(t.device.index)
    if cap != (9, 0):
        raise RuntimeError(
            f"{what}: the kernel is built for sm_90a (Hopper); this card "
            f"is sm_{cap[0]}{cap[1]} ({torch.cuda.get_device_name(t.device)})")


def raise_on_error(rc: int, what: str) -> None:
    """A C entry point returns ``cudaGetLastError()`` after its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc}")


#: scratch and int32 tickets per (device, stream, owner), grown to the
#: largest call: the calls of one stream run in order, and every call leaves
#: the tickets it used at zero, so one pair serves every kernel whose last
#: block finishes the launch (``paged_attention``, ``moa_reduce``,
#: ``loa_reduce``; owner ``"shared"``), and ``dot_moa``'s split partials
#: have a scratch of their own (owner ``"dot_moa"``)
_WORKSPACE: Dict[tuple, tuple] = {}


def workspace(index: int, stream: int, nbytes: int, tickets: int = 0, *,
              owner: str = "shared"):
    """``(scratch, tickets)`` for ``stream`` on device ``index``: at least
    ``nbytes`` of scratch and ``tickets`` int32 tickets, zeroed when they
    are allocated. Allocates only where a call needs more than the pair
    holds, and never while the stream is being captured into a CUDA graph:
    the graph would bind a buffer from its own pool, and an earlier graph
    would keep the address of the buffer it replaced. A graph's owner sizes
    the pair by running the body eagerly on the capture stream first."""
    key = (index, stream, owner)
    ws, tk = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() * 4 < nbytes or tk.numel() < tickets:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"kernel workspace ({owner}) would grow to {nbytes} bytes "
                f"and {tickets} tickets during CUDA graph capture; run the "
                "body eagerly on the capture stream before capturing it")
        dev = torch.device("cuda", index)
        if ws is None or ws.numel() * 4 < nbytes:
            ws = torch.empty(-(-nbytes // 4), dtype=torch.int32, device=dev)
        if tk is None or tk.numel() < tickets:
            tk = torch.zeros(tickets, dtype=torch.int32, device=dev)
        _WORKSPACE[key] = ws, tk
    return ws, tk


def stream_workspaces(index: int, stream: int) -> list:
    """Every workspace tensor now held for ``stream`` on device ``index``.
    A CUDA graph captured on that stream binds their addresses, so its
    owner keeps these references for the graph's life: a later growth
    replaces the entry here, and the old buffer stays out of the
    allocator while the graph may still write to it."""
    return [t for (i, s, _), pair in _WORKSPACE.items()
            if (i, s) == (index, stream) for t in pair]
