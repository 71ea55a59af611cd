"""The port's static batch path (``repro_torch.launch.serve.serve_batch``
and ``--static``) on the CPU.

* Greedy ``serve_batch`` tokens equal the port's own ``ServeEngine``'s on
  the same prompts, for the four decode families (dense and MoE: padded
  bucket prefill; SSM and hybrid: exact-length prefill), as
  ``tests/test_serving.py`` holds the reference's engine to its
  ``serve_batch``.
* In f32 they equal the reference's ``serve_batch`` on the same
  parameters (moved across by :mod:`repro_torch.interop`), token for
  token.
* ``--static`` runs end to end on the CLI.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.launch.serve import serve_batch as j_serve_batch
from repro.models.api import build_model as jbuild
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.serve import serve_batch
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import Request, Sampler, ServeEngine

ARCHS = ["llama3-8b", "moonshot-v1-16b-a3b", "mamba2-370m", "zamba2-1.2b"]
B, P, G = 3, 16, 6


def _prompts(vocab, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (B, P), generator=g, dtype=torch.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_static_greedy(arch):
    model = tbuild(tsmoke(tget(arch)))
    params = model.init(seed=0, device="cpu")
    toks = _prompts(model.cfg.vocab)
    want, stats = serve_batch(model, params, {"tokens": toks}, gen_len=G,
                              max_len=P + G + 1)
    assert want.shape == (B, G) and want.dtype == torch.int32
    assert stats["decode_tok_per_s"] > 0 and stats["per_token_ms"] > 0
    engine = ServeEngine(model, params, n_slots=B, max_len=P + G + 1,
                         clock=lambda: 0.0, device="cpu")
    results, report = engine.run([
        Request(uid=i, prompt=tuple(int(t) for t in row), max_new_tokens=G)
        for i, row in enumerate(toks)])
    got = np.stack([r.tokens for r in results])
    np.testing.assert_array_equal(want.numpy(), got)
    assert report["n_requests"] == B


@pytest.mark.parametrize("arch", ["llama3-8b"])
def test_static_matches_reference_f32(arch):
    """Token for token against the reference's ``serve_batch`` in f32 on
    one parameter tree (one arch: the reference's compile is the cost)."""
    jcfg = dataclasses.replace(jsmoke(jget(arch)), compute_dtype="float32")
    tcfg = dataclasses.replace(tsmoke(tget(arch)), compute_dtype="float32")
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu"))
    toks = _prompts(tcfg.vocab, seed=1)
    want, _ = j_serve_batch(jm, jp, {"tokens": jax.numpy.asarray(
        toks.numpy())}, gen_len=G, max_len=P + G + 1)
    got, _ = serve_batch(tm, tp, {"tokens": toks}, gen_len=G,
                         max_len=P + G + 1)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_sampled_static_needs_a_generator_and_is_seeded():
    model = tbuild(tsmoke(tget("llama3-8b")))
    params = model.init(seed=0, device="cpu")
    toks = {"tokens": _prompts(model.cfg.vocab)}
    with pytest.raises(ValueError, match="Generator"):
        serve_batch(model, params, toks, gen_len=2, max_len=P + 3,
                    sampler=Sampler(0.8))

    def run(seed):
        return serve_batch(model, params, toks, gen_len=4, max_len=P + 5,
                           sampler=Sampler(0.8),
                           rng=torch.Generator().manual_seed(seed))[0]

    assert torch.equal(run(3), run(3))


def test_static_cli_smoke(capsys):
    serve_cli.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                    "--static", "--batch", "2", "--prompt-len", "12",
                    "--gen-len", "5"])
    out = capsys.readouterr().out
    assert "[serve] arch=llama3-8b-smoke" in out and "batch=2" in out
    assert "ms/tok" in out and "tok/s" in out
    sample = out.split("[serve] sample: ")[1].splitlines()[0]
    assert len(eval(sample)) == 5
    with pytest.raises(SystemExit, match="patch batch"):
        serve_cli.main(["--arch", "llava-next-34b", "--smoke", "--device",
                        "cpu", "--static"])
