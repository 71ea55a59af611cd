"""The port's engine on a device mesh (gloo ranks on the CPU) against the
port's engine on one device: llama3-8b's smoke config, f32.

Each mesh shape's whole matrix runs in one spawn of ranks
(``torch_mesh_ranks.matrix``): both cache layouts, plain and oracle
speculative decoding, a chunked prefill; the teacher-forced logits; the
parameter and cache specs and the rank's split; the cache across a decode
step; a 3-slot engine on ``data`` = 2 (its slot axis replicated); a
reload of other weights. The smoke config's one KV head is uneven over
every model axis (the K/V projections replicate) and its vocabulary of
257 does not split; a second config (``n_kv_heads=2``, ``vocab=256``)
splits the KV heads and the vocabulary, so their sharded paths run too.
Every rank group has a 60 s collective timeout and each spawn a join
timeout, so a diverging rank fails its test instead of hanging the run.
"""

import os
import subprocess
import sys

import pytest

import torch_mesh_ranks as ranks
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.api import build_model
from repro_torch.serve import ServeEngine

ARCH = "llama3-8b"
EVEN = dict(n_kv_heads=2, vocab=256)


@pytest.fixture(scope="module")
def two_ranks():
    """The smoke config on (1, 2) and (2, 1) and the even widths on
    (1, 2), in one spawn of two ranks."""
    return run_ranks(2, ranks.matrix, ARCH, {
        "smoke": ({}, [(1, 2), (2, 1)]), "even": (EVEN, [(1, 2)])},
        join_timeout_s=ranks.JOIN_S)


def test_tp_and_dp_meshes(two_ranks):
    """(1, 2) and (2, 1): tokens, logits, specs, rows."""
    got = two_ranks
    want = ranks.single_device(ARCH, {})
    for shape in ((1, 2), (2, 1)):
        ranks.check_matrix(got, want, ("smoke", shape))
    tp, dp = got[1][("smoke", (1, 2))], got[1][("smoke", (2, 1))]
    assert tp["split"]["heads"] and tp["split"]["ff"]
    assert tp["split"]["vocab"] is None          # 257 does not split
    assert "model" in tp["rule_specs"]["layers.attn.wq"]
    assert "model" in tp["rule_specs"]["layers.mlp.w_gate"]
    # one KV head: the flattened wk divides, its head does not
    assert "model" in tp["rule_specs"]["layers.attn.wk"]
    assert "model" not in tp["param_specs"]["layers.attn.wk"]
    assert tp["cache_specs"]["layers.k"] == (None, "data", None, None, None)
    assert tp["local_shapes"]["layers.attn.wq"] == (2, 64, 32)
    assert tp["local_shapes"]["layers.mlp.w_down"] == (2, 64, 64)
    assert tp["rows"] == (0, 2)
    assert not any(v for k, v in dp["split"].items()
                   if k not in ("group", "size", "rank"))
    assert dp["cache_specs"]["pos"] == ("data",)
    assert dp["rows"] == (1, 2)                  # rank 1: data 1
    assert got[0][("smoke", (2, 1))]["rows"] == (0, 1)
    # three slots over data = 2: the slot axis replicates
    assert dp["three_slots"][1:] == ((None,), (0, 3))


def test_four_way_tp():
    """(1, 4): one q head a rank beside the one replicated KV head."""
    got = run_ranks(4, ranks.matrix, ARCH, {"smoke": ({}, [(1, 4)])},
                    join_timeout_s=ranks.JOIN_S)
    ranks.check_matrix(got, ranks.single_device(ARCH, {}),
                       ("smoke", (1, 4)))
    assert got[3][("smoke", (1, 4))]["local_shapes"]["layers.attn.wq"] \
        == (2, 64, 16)


def test_even_widths_split_kv_heads_and_vocab(two_ranks):
    """``n_kv_heads=2``, ``vocab=256`` on (1, 2): the KV heads (the
    cache's too) and the vocabulary split."""
    ranks.check_matrix(two_ranks, ranks.single_device(ARCH, EVEN),
                       ("even", (1, 2)))
    tp = two_ranks[1][("even", (1, 2))]
    assert tp["split"]["vocab"] == (128, 256) and tp["split"]["heads"]
    assert "model" in tp["param_specs"]["layers.attn.wk"]
    assert tp["cache_specs"]["layers.k"] == (None, "data", None, "model",
                                             None)
    assert tp["local_shapes"]["embed.table"] == (128, 64)
    assert tp["local_shapes"]["layers.attn.wk"] == (2, 64, 16)


def test_cli_mesh_equals_one_device(capfd):
    """``--mesh 1x2 --device cpu`` prints the same tokens as one device,
    and the mesh line."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
            "--prompt-len", "12", "--gen-len", "4", "--dt", "1e-3",
            "--paged"]
    serve_cli.main(argv)
    plain = capfd.readouterr().out
    serve_cli.main(argv + ["--mesh", "1x2"])
    meshed = capfd.readouterr().out

    def toks(out):
        return [line for line in out.splitlines()
                if line.startswith("[serve] tokens:")]

    assert toks(plain) and toks(meshed) == toks(plain)
    assert "[serve] mesh: (data=1, model=2) over 2 devices, family rules " \
        "for 'dense'" in meshed


def test_refusals_need_no_card():
    """``--replicas`` with ``--mesh`` and a bad mesh spec exit non-zero;
    the engine refuses SLO scheduling and a draft model on a mesh, and
    CUDA graphs there off a capturable group."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu"]
    with pytest.raises(SystemExit, match="single-engine mode"):
        serve_cli.main(base + ["--mesh", "1x2", "--replicas", "2"])
    for bad in ("2x0", "axb", "2"):
        with pytest.raises(SystemExit, match="bad mesh spec"):
            serve_cli.main(base + ["--mesh", bad])
    with pytest.raises(SystemExit, match="gloo"):
        serve_cli.main(base + ["--mesh", "1x2", "--dist-backend", "nccl"])
    cfg = ranks.config(ARCH)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    from repro_torch.serve import DraftModelDrafter

    with pytest.raises(ValueError, match="item 19"):
        ServeEngine(model, params, n_slots=2, max_len=32, device="cpu",
                    mesh=object(), scheduling="slo")
    with pytest.raises(ValueError, match="draft model"):
        ServeEngine(model, params, n_slots=2, max_len=32, device="cpu",
                    mesh=object(),
                    drafter=DraftModelDrafter(model, params, 2))


def test_cuda_mesh_refusals(monkeypatch):
    """On the card (stood in for): more ranks than cards over NCCL, and a
    gloo mesh without ``--eager``, are refused before any rank starts."""
    import torch

    monkeypatch.setattr(serve_cli, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    base = ["--arch", ARCH, "--smoke", "--mesh", "1x2"]
    with pytest.raises(SystemExit, match="NCCL refuses two ranks"):
        serve_cli.main(base)
    with pytest.raises(SystemExit, match="add --eager"):
        serve_cli.main(base + ["--dist-backend", "gloo"])


def test_graphs_on_gloo_mesh_raise(monkeypatch):
    """``cuda_graphs=True`` on a gloo mesh raises, naming the backend
    (the graph API stood in for by a double that claims the device)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, make_mesh
    from repro_torch.serve import graphs

    class Claims:
        def supports(self, device):
            return True

    monkeypatch.setattr(graphs, "API", Claims())
    model = build_model(ranks.config(ARCH))
    params = model.init(seed=0, device="cpu")
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=30))
    try:
        mesh = make_mesh((1, 1), device="cpu")
        with pytest.raises(ValueError, match="'gloo'"):
            ServeEngine(model, params, n_slots=2, max_len=32, device="cpu",
                        mesh=mesh, cuda_graphs=True)
    finally:
        dist.destroy_process_group()


def test_rank_failure_fails_fast():
    """A rank that raises fails ``run_ranks`` with its traceback, the
    others stopped (they would block in a collective)."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks(2, ranks.fail_on_rank_one, timeout_s=20,
                  join_timeout_s=60)


def test_cuda_mesh_refused_without_gpu():
    """No GPU: the CLI's CUDA mesh fails as every CUDA entry point does."""
    env = dict(os.environ, PYTHONPATH="src", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--mesh", "1x2"], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
