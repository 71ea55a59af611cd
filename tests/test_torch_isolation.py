"""The port stands alone: no JAX, nothing of ``repro``, no drift to the CPU.

* Every module of ``repro_torch``, and ``chip_smoke.py``, imports in a
  process where ``import jax`` fails, and leaves no module named ``repro``
  or ``repro.*`` loaded (``repro_torch`` itself starts with "repro": the
  names are matched exactly).
* No source file of the port imports ``jax`` or ``repro``.
* The entry points run on the GPU unless the caller asks for the CPU: with
  no GPU they raise. A ``kernel`` backend on a CPU tensor raises too.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_SCRIPT = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None              # any `import jax` now raises
sys.path.insert(0, "src")
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "repro" or m.startswith("repro.") or m == "jax"
                     or m.startswith("jax.")))
print(len(names), leaked)
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.strip().split(" ", 1)
    assert int(n) >= 30 and leaked == "[]", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro(\.|\s+import\b))", re.M)


def test_no_source_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = [str(f.relative_to(ROOT)) for f in files
           if _FORBIDDEN.search(f.read_text())]
    assert bad == []


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _smoke():
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models.api import build_model

    return build_model(smoke_config(get_config("llama3-8b")))


def test_entry_points_need_a_gpu_unless_told_cpu(no_gpu):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.serve import ServeEngine

    model = _smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init()
    params = model.init(device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, n_slots=2, max_len=32, paged=True)
    ServeEngine(model, params, n_slots=2, max_len=32, paged=True,
                device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "llama3-8b", "--smoke", "--paged"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "llama3-8b", "--smoke", "--steps", "2"])


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Without a GPU, and alone in a directory, ``chip_smoke.py`` exits
    non-zero and prints no result."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")    # hide any GPU
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_kernel_backend_on_cpu_tensors_raises():
    from repro_torch.layers.attention import resolve_attn_backend
    from repro_torch.moa import resolve

    a, b = torch.ones((2, 64)), torch.ones((64, 8))
    with pytest.raises(ValueError, match="CUDA"):
        resolve("serial?backend=kernel&chunk=32").dot(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        resolve("tree?backend=kernel").dot(a, b)
    with pytest.raises(ValueError, match="kernel"):
        resolve_attn_backend("kernel", "cpu")
    # auto and torch take the plain versions on the CPU
    assert resolve_attn_backend("auto", "cpu") == "torch"
    torch.testing.assert_close(resolve("serial?chunk=32").dot(a, b),
                               a @ b)
