"""The port's request pricing (``repro_torch.launch.costing``) against
``repro.launch.costing``, on the CPU.

Both are arithmetic on the same config, so the numbers must be equal (no
tolerance): ``forward_flops`` by component, ``request_decode_cost`` and
``kv_bytes_per_token``, for the dense and MoE families (full-size and
smoke configs) under ``tree``, ``serial`` and ``loa``, and every other
family's branch of ``forward_flops``. The engine's report is held to the
reference engine's in ``tests/test_torch_serve.py`` and
``tests/test_torch_dense_slots.py``; here once more for the MoE.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.launch import costing as jcost
from repro.models.api import build_model as jbuild
from repro.serve import ServeEngine as JEngine
from repro.serve import poisson_workload as j_poisson
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.launch import costing as tcost
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import ServeEngine
from repro_torch.serve import poisson_workload as t_poisson

ARCHS = ["llama3-8b", "moonshot-v1-16b-a3b", "mamba2-370m", "zamba2-1.2b",
         "hubert-xlarge", "llava-next-34b"]
SPECS = ["tree", "serial?chunk=512", "loa?approx_bits=4"]


def _pair(arch, smoke=False, **updates):
    j, t = jget(arch), tget(arch)
    if smoke:
        j, t = jsmoke(j), tsmoke(t)
    return (dataclasses.replace(j, **updates),
            dataclasses.replace(t, **updates))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("decode", [False, True])
def test_forward_flops_equal(arch, decode):
    j, t = _pair(arch)
    for tokens, s_attn in ((1.0, 37.0), (512.0, 512.0)):
        want = jcost.forward_flops(j, tokens=tokens, s_attn=s_attn,
                                   decode=decode)
        got = tcost.forward_flops(t, tokens=tokens, s_attn=s_attn,
                                  decode=decode)
        assert got == want


@pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("smoke", [False, True])
def test_request_decode_cost_equal(arch, spec, smoke):
    j, t = _pair(arch, smoke, moa=spec)
    for prompt, new in ((12, 1), (12, 7), (300, 40)):
        assert tcost.request_decode_cost(t, prompt_tokens=prompt,
                                         new_tokens=new) == \
            jcost.request_decode_cost(j, prompt_tokens=prompt,
                                      new_tokens=new)
    # the LOA's ~6 ops an add price above the exact strategies
    if spec.startswith("loa"):
        exact = dataclasses.replace(t, moa="tree")
        assert tcost.request_decode_cost(t, prompt_tokens=12, new_tokens=7) \
            > tcost.request_decode_cost(exact, prompt_tokens=12,
                                        new_tokens=7)


@pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b",
                                  "zamba2-1.2b", "mamba2-370m"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_kv_bytes_per_token_equal(arch, kv):
    j, t = _pair(arch, True, kv_cache_dtype=kv)
    assert tcost.kv_bytes_per_token(t) == jcost.kv_bytes_per_token(j)
    if t.family in ("dense", "moe"):
        assert tcost.kv_bytes_per_token(t) == \
            tbuild(t).cache_spec().kv_bytes_per_token


def test_moe_engine_prices_requests_as_the_reference():
    """The MoE smoke served under LOA-priced costs: each request's
    ``moa_flops`` and the report's total equal the reference engine's."""
    upd = dict(compute_dtype="float32",
               moa_overrides={"moe": "loa?approx_bits=4"})
    j, t = _pair("moonshot-v1-16b-a3b", True, compute_dtype="float32")
    jm = jbuild(j)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(t)
    tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu"))
    kw = dict(n_slots=2, max_len=32, clock=lambda: 0.0)

    def reqs(fn):
        return fn(n_requests=3, vocab=t.vocab, rate_rps=50.0,
                  prompt_len_range=(4, 10), gen_len_range=(2, 6), seed=2)

    want, want_rep = JEngine(jm, jp, **kw).run(reqs(j_poisson))
    got, rep = ServeEngine(tm, tp, device="cpu", **kw).run(reqs(t_poisson))
    assert rep["moa_flops_total"] == want_rep["moa_flops_total"] > 0
    for a, b in zip(want, got):
        assert b.metrics.moa_flops == a.metrics.moa_flops
    # priced under another site strategy, the same requests cost more
    loa = dataclasses.replace(t, **upd)
    assert sum(tcost.request_decode_cost(
        loa, prompt_tokens=r.metrics.prompt_tokens,
        new_tokens=r.metrics.new_tokens) for r in got) \
        > rep["moa_flops_total"]
