"""The kernels' build (``repro_torch.kernels._build``) on the CPU, with a
stand-in for ``nvcc`` that writes the file it is asked for: a library of
``PARTS`` compiles one object a part, all at once, then links them; the
others compile in one step; a failed part fails its library alone, and
leaves neither the library nor its objects behind."""

import os
import stat
from pathlib import Path

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo "nvcc $*"
case " $* " in *" -DDOT_MOA_PART=3 "*) [ -n "$FAIL_PART_3" ] && exit 2;; esac
case " $* " in *" -Xptxas "*)
  echo "ptxas info    : Compiling entry function 'k' for 'sm_90a'";; esac
echo built > "$out"
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path / "build"


def test_commands_split_dot_moa(fake):
    """``dot_moa``: one ``-c`` compile a part with its ``DOT_MOA_PART``,
    then one link of the objects; another library: one command."""
    out = Path("/x/dot_moa.tmp")
    first, link = _build._commands("dot_moa", out)
    assert len(first) == _build.PARTS["dot_moa"] == 6
    for k, cmd in enumerate(first):
        assert f"-DDOT_MOA_PART={k}" in cmd and "-c" in cmd
        assert "-shared" not in cmd
        assert cmd[cmd.index("-o") + 1] == f"{out}.{k}.o"
    assert link == [[link[0][0], "-shared", "-o", str(out),
                     *(f"{out}.{k}.o" for k in range(6))]]
    first, link = _build._commands("flash_attention", out)
    assert len(first) == 1 and link == []
    assert "-shared" in first[0] and "-c" not in first[0]


def test_build_links_parts_and_caches(fake):
    built = _build.build()
    assert set(built) == set(_build.KERNELS)
    for name, b in built.items():
        assert not b["cached"] and Path(b["path"]).read_text() == "built\n"
        n = _build.PARTS.get(name, 1)
        assert b["log"].count("nvcc ") == n + (n > 1)
        assert b["log"].count("Compiling entry function") == n
    assert sorted(os.listdir(fake)) == sorted(
        Path(b["path"]).name for b in built.values())
    assert all(b["cached"] for b in _build.build().values())


def test_failed_part_fails_its_library(fake, monkeypatch):
    monkeypatch.setenv("FAIL_PART_3", "1")
    with pytest.raises(RuntimeError, match=r"dot_moa \(nvcc exits "
                                           r"\[0, 0, 0, 2, 0, 0\]\)"):
        _build.build()
    left = sorted(os.listdir(fake))
    assert len(left) == len(_build.KERNELS) - 1
    assert not any(name.startswith("dot_moa") for name in left)
