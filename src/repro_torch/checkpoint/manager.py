"""Sharded, atomic, async checkpointing of tensor trees (the port of
``repro/checkpoint/manager.py``), in the reference's on-disk format:

* ``step_<n>/shard_<i>.npz`` holds the leaves shard ``i`` owns (leaf-level
  round robin over the sorted keys), ``step_<n>/manifest_<i>.json`` their
  keys, logical dtypes and the caller's metadata; a key is the leaf's path
  in the nested dict, its parts joined by ``/`` (dict keys in sorted
  order, as ``jax.tree_util`` flattens a dict), and ``/`` becomes ``\\x1f``
  inside the npz;
* dtypes numpy cannot hold (bfloat16) are stored bit for bit as the
  unsigned integer of their width, the logical name in the manifest;
* **Atomicity**: arrays and then the manifest are written under ``.tmp``
  names, fsynced and renamed; the manifest rename commits the step, so a
  crash mid-save leaves only ignorable ``.tmp`` files;
* **Async**: ``save_async`` copies the tree to host memory at once and
  writes on a worker thread; a failure is raised on the next call;
* **Retention**: the newest ``keep`` committed steps stay.

So the JAX package restores what the port saves and the other way round,
bf16 included. ``restore(template, step=None, device=...)`` rebuilds the
template's tree as tensors on ``device``, each leaf cast to the template
leaf's dtype.

**On a mesh** (``mesh=`` a ``DeviceMesh`` of this rank, ``specs=`` the
tree's specs): ``save`` assembles each leaf whole from the ranks' pieces,
one leaf at a time, and the lead rank (coordinate 0 on every axis) writes
the files a one-device run would; ``restore`` gives each rank its own
slices, each mapped from the stored (uncompressed) member and read alone —
the counterpart of the reference's ``shardings=``, so a checkpoint restores
onto another mesh than the one that wrote it (the elastic re-plan).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import struct
import threading
import zipfile
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.interop import tree_get, tree_paths
from repro_torch.parallel.collectives import gather_whole
from repro_torch.parallel.sharding import local_slices

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")

#: dtypes npz holds natively; anything else (bfloat16) is stored bit for
#: bit as an unsigned integer of its width, its logical name in the manifest
_NATIVE_DTYPES = {
    "float16", "float32", "float64", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "bool",
}
#: logical dtype names of the manifest that torch holds but numpy does not
_BITS_DTYPES = {"bfloat16": (torch.bfloat16, np.uint16)}


def _unflatten(template, leaves: Dict[str, Any],
               prefix: Tuple[str, ...] = ()):
    """The template's structure with each leaf taken from ``leaves``."""
    if isinstance(template, Mapping):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, prefix + (str(i),))
                              for i, v in enumerate(template))
    return leaves["/".join(prefix)]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array npz can hold, and its logical dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        for name, (dt, bits) in _BITS_DTYPES.items():
            if t.dtype == dt:
                return t.contiguous().view(torch.int16).numpy().view(
                    bits).copy(), name
        arr = t.numpy().copy()
    else:
        arr = np.array(leaf)
    if arr.dtype.name not in _NATIVE_DTYPES:   # e.g. ml_dtypes' bfloat16
        bits = {1: np.uint8, 2: np.uint16, 4: np.uint32}[arr.dtype.itemsize]
        return arr.view(bits), arr.dtype.name
    return arr, arr.dtype.name


def _to_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    """The tensor a stored array holds (bit-stored dtypes reinterpreted),
    of the stored shape (a 0-d leaf stays 0-d: ``np.ascontiguousarray``
    alone would make it 1-d)."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if logical in _BITS_DTYPES:
        dt, _ = _BITS_DTYPES[logical]
        return torch.from_numpy(arr.view(np.int16).copy()).view(dt)
    if logical not in _NATIVE_DTYPES:
        raise TypeError(f"checkpoint dtype {logical!r} has no tensor type")
    return torch.from_numpy(arr.copy())


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 shard_id: int = 0, n_shards: int = 1):
        self.directory = directory
        self.keep = keep
        self.shard_id = shard_id
        self.n_shards = n_shards
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, *, metadata: Optional[dict] = None,
             mesh=None, specs=None):
        """Write ``tree`` as ``step``; on a mesh (``tree`` this rank's
        pieces under ``specs``) every rank takes part in assembling the
        leaves and the lead rank writes them."""
        self.wait()
        self._raise_pending()
        snap = self._snapshot(tree, mesh, specs)
        if snap is not None:
            self._save_blocking(step, snap, metadata or {})

    def save_async(self, step: int, tree, *, metadata: Optional[dict] = None,
                   mesh=None, specs=None):
        """Snapshot now (host memory; on a mesh the leaves assembled on
        every rank), write in the background (the lead rank's)."""
        self.wait()
        self._raise_pending()
        snap = self._snapshot(tree, mesh, specs)
        if snap is None:
            return
        meta = dict(metadata or {})

        def worker():
            try:
                self._save_blocking(step, snap, meta)
            except BaseException as e:  # surfaced on the next wait / save
                self._async_error = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _raise_pending(self):
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _snapshot(self, tree, mesh=None, specs=None
                  ) -> Optional[Dict[str, Tuple[np.ndarray, str]]]:
        """The leaves this shard writes, on the host; on a mesh each leaf
        assembled whole (every rank), kept by the lead rank alone (the
        others get ``None``)."""
        flat = tree_paths(tree)
        lead = mesh is None or all(c == 0 for c in mesh.get_coordinate())
        out = {}
        for i, (key, leaf) in enumerate(sorted(flat.items())):
            if i % self.n_shards != self.shard_id:
                continue  # another host owns this leaf
            if mesh is not None:
                spec = tree_get(specs, key.split("/"))
                leaf = gather_whole(leaf.detach(), spec, mesh)
            if lead:
                out[key] = _to_host(leaf)
        return out if lead else None

    def _save_blocking(self, step: int, snap: Dict[str, Tuple[np.ndarray,
                                                              str]],
                       metadata: dict):
        """Per-shard atomic commit into a shared step directory: arrays
        under a ``.tmp`` name, ``os.replace``d into place, then the
        manifest, whose rename is this shard's commit point."""
        final = os.path.join(self.directory, f"step_{step}")
        os.makedirs(final, exist_ok=True)
        arrays_path = os.path.join(final, f"shard_{self.shard_id}.npz")
        with open(arrays_path + ".tmp", "wb") as f:
            np.savez(f, **{k.replace("/", "\x1f"): v
                           for k, (v, _) in snap.items()})
            f.flush()
            os.fsync(f.fileno())
        os.replace(arrays_path + ".tmp", arrays_path)
        manifest = {
            "step": step,
            "n_shards": self.n_shards,
            "keys": sorted(snap.keys()),
            "dtypes": {k: d for k, (_, d) in snap.items()},
            "metadata": metadata,
        }
        mpath = os.path.join(final, f"manifest_{self.shard_id}.json")
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mpath + ".tmp", mpath)
        self._gc()

    def _gc(self):
        steps = self.available_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def available_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(
                    self.directory, name, f"manifest_{self.shard_id}.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, template, *, step: Optional[int] = None,
                device=None, mesh=None, specs=None):
        """Restore into the structure of ``template`` (a nested dict of
        tensors or arrays): each leaf a tensor of the template leaf's dtype
        on ``device`` (default: the template leaf's device, else the CPU).
        On a mesh (``mesh`` a ``DeviceMesh`` of this rank, ``specs`` the
        template's specs; ``template`` of the whole shapes) each leaf is
        this rank's slices of it, read alone from the file. Returns
        ``(tree, metadata)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        ckpt_dir = os.path.join(self.directory, f"step_{step}")
        arrays: Dict[str, Any] = {}
        logical: Dict[str, str] = {}
        metadata = {}
        for shard in range(self.n_shards):
            shard_path = os.path.join(ckpt_dir, f"shard_{shard}.npz")
            try:
                # eager member reads: a truncated zip member fails only when
                # decompressed, so force it here where the error can name
                # the file; a mesh maps each member and reads its slices
                if mesh is not None:
                    npz = _mapped_members(shard_path)
                else:
                    npz = np.load(shard_path)
                    npz = {k: npz[k] for k in npz.files}
            except FileNotFoundError:
                raise
            except Exception as e:
                raise RuntimeError(
                    f"checkpoint step_{step} shard {shard} is corrupt or "
                    f"truncated ({shard_path}): {e}") from e
            try:
                with open(os.path.join(ckpt_dir,
                                       f"manifest_{shard}.json")) as f:
                    manifest = json.load(f)
            except FileNotFoundError:
                raise
            except Exception as e:
                raise RuntimeError(
                    f"checkpoint step_{step} shard {shard} manifest is "
                    f"corrupt ({ckpt_dir}): {e}") from e
            metadata = manifest["metadata"] | metadata
            dtypes = manifest.get("dtypes", {})
            for k, arr in npz.items():
                key = k.replace("\x1f", "/")
                arrays[key] = arr
                logical[key] = dtypes.get(key, arr.dtype.name)

        flat_template = tree_paths(template)
        missing = set(flat_template) - set(arrays)
        if missing:
            raise KeyError(f"checkpoint step_{step} missing keys: "
                           f"{sorted(missing)[:5]}...")
        coords = None if mesh is None else dict(
            zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        restored = {}
        for key, tmpl in flat_template.items():
            arr = arrays[key]
            if mesh is not None:
                spec = tree_get(specs, key.split("/"))
                arr = arr[local_slices(arr.shape, spec, mesh, coords)]
            t = _to_tensor(arr, logical[key])
            if isinstance(tmpl, torch.Tensor):
                t = t.to(dtype=tmpl.dtype)
                target = device if device is not None else tmpl.device
                if target is not None and torch.device(target).type \
                        == "meta":
                    target = "cpu"
            else:
                target = device if device is not None else "cpu"
            restored[key] = t.to(target)
        return _unflatten(template, restored), metadata


def _mapped_members(path: str) -> Dict[str, np.ndarray]:
    """``{member name: array}`` of an ``np.savez`` file, each member's
    array mapped from the file (its pages read only where sliced); a member
    that is compressed, or truncated, fails here."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"member {info.filename} is compressed")
            f.seek(info.header_offset)
            head = f.read(30)
            name_len, extra_len = struct.unpack("<HH", head[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            offset = f.tell()
            n = int(np.prod(shape)) * dtype.itemsize
            if offset + n > size:
                raise ValueError(f"member {info.filename} is truncated")
            name = info.filename[:-4] if info.filename.endswith(".npy") \
                else info.filename
            if n == 0 or not shape:
                out[name] = np.frombuffer(f.read(n), dtype=dtype).reshape(
                    shape)
            else:
                out[name] = np.memmap(path, dtype=dtype, mode="r",
                                      offset=offset, shape=shape,
                                      order="F" if fortran else "C")
    return out
