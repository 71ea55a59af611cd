"""The port's encoder (hubert-xlarge) and VLM (llava-next-34b) families
against the JAX reference, on the CPU.

Both packages build each family's smoke config at
``compute_dtype="float32"``; the reference's parameters (``PRNGKey(0)``)
cross into the port with :mod:`repro_torch.interop`, and the inputs are
made with numpy from a seed. The reference runs its jnp paths (its encode
is ``Model.prefill``, its gradients ``jax.value_and_grad`` of
``Model.loss``, each compiled once a module); the port's kernels run their
plain versions on CPU tensors.

Tolerances, and why: logits and cache rows within ``ATOL`` = 1e-4 (f32
sums in the two frameworks' matmul orders through 2 layers, logits of
order 1, as ``test_torch_model.py``); the loss within 1e-5 and every
gradient leaf within 1e-5 of its largest entry (``test_torch_train.py``'s
limits: f32 forward and backward through 2 layers, measured about 1e-6);
the GELU MLP alone within 1e-5 (one layer; XLA's and PyTorch's ``tanh``
may differ in the last place). The kernels' plans at the two families'
shapes are checked here too; the kernels themselves run on the card only.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.launch import steps as jsteps
from repro.layers import mlp as jmlp
from repro.models.api import build_model as jbuild
from repro_torch import interop
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import plan as flash_plan
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import TrainLoop
from repro_torch.layers import mlp as tmlp
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import ServeEngine
from test_torch_flash_plan import _pallas, emulate_wgmma
from test_torch_spec_bf16 import _row_layout, paged_replay

ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
ARCHS = ("hubert-xlarge", "llava-next-34b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (tiny tensors; a pool a
    process only contends with the other test workers')."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **upd):
    return (dataclasses.replace(jsmoke(jget(arch)), compute_dtype="float32",
                                **upd),
            dataclasses.replace(tsmoke(tget(arch)), compute_dtype="float32",
                                **upd))


def _batch(arch, B=2, S=24, seed=0):
    """A train batch of numpy arrays: the encoder's frames, mask and
    targets, or the VLM's patches, tokens and labels."""
    rs = np.random.default_rng(seed)
    if arch == "hubert-xlarge":
        return {"frames": rs.standard_normal((B, S, 64)).astype(np.float32),
                "mask": rs.random((B, S)) < 0.35,
                "targets": rs.integers(0, 257, (B, S), dtype=np.int32)}
    toks = rs.integers(0, 257, (B, S - 8 + 1), dtype=np.int32)
    return {"patches": rs.standard_normal((B, 8, 64)).astype(np.float32),
            "tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def _t(tree):
    return interop.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Both packages on one smoke config, the reference's parameters in
    both, and the reference's loss and gradients of ``_batch`` (one
    compile)."""
    arch = request.param
    jcfg, tcfg = _configs(arch)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    tp = tm.load_params(interop.from_numpy(np_params, device="cpu"))
    batch = _batch(arch)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, _j(batch))
    return dict(arch=arch, jm=jm, jp=jp, tm=tm, tp=tp, np_params=np_params,
                batch=batch, jmet={k: float(v) for k, v in jmet.items()},
                jgrads=jax.tree.map(np.asarray, jg))


# ---------------------------------------------------------------------------
# the GELU MLP, parameters and the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", [None, "serial?chunk=32", "tree"])
def test_gelu_mlp_matches_reference(strategy):
    rs = np.random.default_rng(1)
    p = {"w_in": rs.standard_normal((64, 128)).astype(np.float32) * 0.125,
         "b_in": rs.standard_normal(128).astype(np.float32) * 0.1,
         "w_out": rs.standard_normal((128, 64)).astype(np.float32) * 0.09,
         "b_out": rs.standard_normal(64).astype(np.float32) * 0.1}
    x = rs.standard_normal((3, 5, 64)).astype(np.float32) * 2.0
    want = np.asarray(jmlp.gelu_mlp(_j(p), jnp.asarray(x), strategy=strategy,
                                    compute_dtype=jnp.float32))
    got = tmlp.gelu_mlp(_t(p), torch.from_numpy(x), strategy=strategy,
                        compute_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # tanh's GELU, not erf's: they differ by ~1e-4 at |x| ~ 2
    erf = torch.nn.functional.gelu(torch.from_numpy(x[0, 0, :4]))
    tanh = torch.nn.functional.gelu(torch.from_numpy(x[0, 0, :4]),
                                    approximate="tanh")
    np.testing.assert_allclose(np.asarray(jax.nn.gelu(x[0, 0, :4])),
                               tanh.numpy(), rtol=0, atol=1e-6)
    assert not torch.equal(erf, tanh)


def test_param_tree_and_bridge(pair):
    """The port's own initializer builds the reference's tree (the
    encoder's ``pos_embed`` and ``mask_embed``, the VLM's
    ``mm_projector.w``, the GELU MLP's biases); the bridge carries every
    leaf both ways bit for bit, in f32 and bf16, and registers the
    top-level leaves as parameters."""
    want = {p: tuple(a.shape) for p, a in
            interop.tree_leaves(pair["np_params"])}
    own = tbuild(pair["tm"].cfg).init(seed=0, device="cpu")
    assert {p: tuple(t.shape) for p, t in interop.tree_leaves(own)} == want
    names = {n for n, _ in pair["tm"].named_parameters()}
    assert names == set(want)
    extra = ({"pos_embed", "mask_embed", "layers.mlp.b_in"}
             if pair["arch"] == "hubert-xlarge" else {"mm_projector.w"})
    assert extra <= names
    bf16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        pair["np_params"])
    for tree in (pair["np_params"], bf16):
        back = interop.to_numpy(interop.from_numpy(tree, device="cpu"))
        for (p1, a), (p2, b) in zip(interop.tree_leaves(tree),
                                    interop.tree_leaves(back)):
            assert p1 == p2 and a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


def test_forward_logits(pair):
    want = np.asarray(pair["jm"].forward(pair["jp"], _j(pair["batch"])))
    got = pair["tm"].forward(pair["tp"], _t(pair["batch"]))
    assert got.shape == want.shape and got.dtype == torch.float32
    if pair["arch"] == "llava-next-34b":     # the text positions only
        assert got.shape[1] == pair["batch"]["tokens"].shape[1]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_loss_and_metrics(pair):
    _, tmet = pair["tm"].loss(pair["tp"], _t(pair["batch"]))
    assert set(tmet) == set(pair["jmet"])
    for k, want in pair["jmet"].items():
        np.testing.assert_allclose(float(tmet[k]), want, rtol=0,
                                   atol=LOSS_ATOL, err_msg=k)
    if pair["arch"] == "hubert-xlarge":      # the masked frames only
        assert float(tmet["tokens"]) == pair["batch"]["mask"].sum()


def test_every_gradient_leaf(pair):
    tm = pair["tm"]
    state = tsteps.init_train_state(
        tm, hyper=tsteps.TrainHyper(),
        params=interop.from_numpy(pair["np_params"], device="cpu"))
    grads, _ = tsteps.loss_and_grads(tm, state["params"], _t(pair["batch"]))
    want = dict(interop.tree_leaves(pair["jgrads"]))
    got = dict(interop.tree_leaves(grads))
    assert set(got) == set(want)
    for path, g in got.items():
        ref_ = want[path]
        assert g.shape == ref_.shape and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), ref_, rtol=0,
                                   atol=GRAD_RTOL * np.abs(ref_).max(),
                                   err_msg=path)
    if pair["arch"] == "hubert-xlarge":
        # the encoder never reads the token table: its gradient is zero
        assert not got["embed.table"].any()
        assert got["pos_embed"][:24].any() and not got["pos_embed"][24:].any()


def _bits(tree):
    return {k: np.ascontiguousarray(np.asarray(v)).view(np.uint8).tobytes()
            for k, v in interop.tree_paths(tree).items()}


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-34b"])
def test_checkpoints_cross_both_ways(arch, tmp_path):
    """The reference's train state (the encoder's ``pos_embed`` and
    ``mask_embed``, the VLM's ``mm_projector``), saved by its manager,
    restores into ``TrainLoop.restore_state`` bit for bit and trains on;
    the port's state after that step restores in the reference's
    manager bit for bit."""
    jm = jbuild(jsmoke(jget(arch)))
    hyper = jsteps.TrainHyper(peak_lr=5e-3, warmup_steps=2,
                               total_steps=10)
    jstate = jax.jit(lambda key: jsteps.init_train_state(
        jm, key, hyper=hyper))(jax.random.PRNGKey(0))
    JManager(str(tmp_path)).save(0, jstate)
    loop = TrainLoop(tsmoke(tget(arch)), steps=2, global_batch=2,
                     seq_len=24, device="cpu", ckpt_dir=str(tmp_path),
                     hyper=tsteps.TrainHyper(peak_lr=5e-3, warmup_steps=2,
                                             total_steps=10), async_save=False)
    state = loop.restore_state(0)
    assert _bits(interop.to_numpy(state)) == _bits(jax.tree.map(np.asarray,
                                                                jstate))
    state = loop.run_segment(1, state)           # saves step 1 at its end
    restored, _ = JManager(str(tmp_path)).restore(
        jax.eval_shape(lambda: jstate), step=1)
    assert _bits(jax.tree.map(np.asarray, restored)) == \
        _bits(interop.to_numpy(state))
    assert int(restored["step"]) == 1


# ---------------------------------------------------------------------------
# the encoder's encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["hubert-xlarge"])
def test_encode_is_the_bidirectional_forward(arch):
    """``Model.prefill`` of the encoder: the logits at every frame and the
    cursor ``T``, as the reference's; the attention is bidirectional (a
    later frame changes an earlier frame's logits) and position-coded by
    ``pos_embed`` alone (no RoPE)."""
    jcfg, tcfg = _configs(arch)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu"))
    b = _batch(arch, B=2, S=20, seed=3)
    b = {"frames": b["frames"], "mask": b["mask"]}
    jl, jc = jm.prefill(jp, _j(b), max_len=20)
    tl, tc = tm.prefill(tp, _t(b), max_len=20)
    assert tl.shape == (2, 20, 257)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert set(tc) == {"pos"} and int(tc["pos"]) == int(jc["pos"]) == 20
    b2 = dict(b, frames=b["frames"].copy())
    b2["frames"][:, -1] += 1.0
    tl2, _ = tm.prefill(tp, _t(b2), max_len=20)
    assert (tl2[:, 0] - tl[:, 0]).abs().max() > 1e-6
    assert tm.cfg.is_causal is False and jm.cfg.is_causal is False


# ---------------------------------------------------------------------------
# the VLM's prefill and decode
# ---------------------------------------------------------------------------


def test_vlm_prefill_and_decode():
    """Prefill with the patch batch (every cache leaf; the cursor ``P +
    S_text``), then 4 greedy decode steps (the reference's tokens fed to
    both), each step's logits and the cache after the last."""
    jcfg, tcfg = _configs("llava-next-34b")
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.load_params(interop.from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu"))
    b = _batch("llava-next-34b", B=2, S=20, seed=4)
    b = {"patches": b["patches"], "tokens": b["tokens"]}
    P, S_text, max_len = 8, b["tokens"].shape[1], 32
    jl, jc = jm.prefill(jp, _j(b), max_len=max_len)
    tl, tc = tm.prefill(tp, _t(b), max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert int(tc["pos"]) == int(jc["pos"]) == P + S_text
    for name in ("k", "v"):
        want = np.asarray(jc["layers"][name])
        got = tc["layers"][name].numpy()
        assert got.shape == want.shape == (2, 2, max_len, 1, 16)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    tc["pos"] = torch.tensor(tc["pos"], dtype=torch.int32)
    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(4):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert int(tc["pos"]) == int(jc["pos"]) == P + S_text + 4
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["layers"][name].numpy(),
                                   np.asarray(jc["layers"][name]), rtol=0,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# the reference's refusals, cache specs and shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,match", [
    ("hubert-xlarge", "encoder-only arch has no decode step"),
    ("llava-next-34b", "vlm serving is not supported")])
def test_engine_refuses(arch, match):
    tm = tbuild(tsmoke(tget(arch)))
    tp = tm.init(seed=0, device="cpu")
    with pytest.raises(ValueError, match=match):
        ServeEngine(tm, tp, n_slots=2, max_len=32, device="cpu")


@pytest.mark.parametrize("arch,exc,match", [
    ("hubert-xlarge", SystemExit, "encoder-only arch has no decode step"),
    ("llava-next-34b", ValueError, "vlm serving is not supported")])
def test_serve_cli_refuses(arch, exc, match):
    with pytest.raises(exc, match=match):
        serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "2", "--prompt-len", "8",
                        "--gen-len", "2"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_variants_refused(arch):
    """No padded, suffix, chunked or speculative prefill for either
    family, as the reference's flags say."""
    jm, tm = jbuild(jsmoke(jget(arch))), tbuild(tsmoke(tget(arch)))
    for flag in ("supports_padded_prefill", "supports_spec_decode",
                 "supports_chunked_prefill"):
        assert getattr(tm, flag) is getattr(jm, flag) is False, flag
    tp = tm.init(seed=0, device="cpu")
    toks = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    if arch == "llava-next-34b":
        b = dict(toks, patches=torch.zeros((1, 8, 64)))
        with pytest.raises(ValueError, match="cannot prefill padded"):
            tm.prefill(tp, b, max_len=32, prompt_len=12)
    with pytest.raises(ValueError, match="cannot skip prefix prefill"):
        tm.prefill_suffix(tp, toks, prefix={}, prompt_len=8)
    with pytest.raises(ValueError, match="carried-state prefill chunk"):
        tm.prefill_chunk(tp, toks, state={})
    with pytest.raises(ValueError, match="no exact multi-token verify"):
        tm.verify_step(tp, {}, toks["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec(arch):
    jm, tm = jbuild(jget(arch)), tbuild(tget(arch))
    assert dataclasses.asdict(tm.cache_spec()) == \
        dataclasses.asdict(jm.cache_spec())
    if arch == "hubert-xlarge":
        assert tm.cache_spec().kv_bytes_per_token == 0
        assert not tm.cache_spec().pageable
    else:                               # 60 layers x 2 x 8 x 128 x bf16
        assert tm.cache_spec().kv_bytes_per_token == 60 * 2 * 8 * 128 * 2


# ---------------------------------------------------------------------------
# the kernels' plans at the two families' shapes
# ---------------------------------------------------------------------------


def test_flash_plan_at_the_families_shapes():
    # hubert's encode: 4 x 1000 frames, H16/16, head_dim 80, no mask: two
    # swizzle atoms a tile, every KV tile walked by every query tile
    p = flash_plan(4, 1000, 1000, 16, 16, 80, torch.bfloat16, False)
    assert (p.body, p.grid) == ("wgmma", (64, 16))
    assert p.kv_tiles == (16,) * 16 and p.q_tiles == tuple(range(16))
    assert p.smem == 2 * 64 * 128 * 5 + 1024
    assert 2 * (p.smem + 1024) <= 228 * 1024
    # llava's prefill: 2 x (2304 patches + 64 text), H56/8, causal; the
    # last tile holds 2368 - 36 * 64 = 64 rows
    p = flash_plan(2, 2368, 2368, 56, 8, 128, torch.bfloat16, True)
    assert p.grid == (112, 37)
    assert p.q_tiles == tuple(range(36, -1, -1))
    assert p.kv_tiles == tuple(range(1, 38))


def _bf16(rs, *shape):
    return torch.from_numpy(rs.standard_normal(shape, np.float32)).bfloat16()


@pytest.mark.parametrize("H,Hk,D,causal,s", [(2, 2, 80, False, 100),
                                             (7, 1, 128, True, 100),
                                             (7, 1, 128, True, 37)])
def test_flash_arithmetic_at_the_families_heads(H, Hk, D, causal, s):
    """The bf16 body's order of arithmetic (``test_torch_flash_plan``'s
    emulation) against the reference's Pallas kernel in interpret mode at
    hubert's head_dim 80 without a mask and llava's group of 7, within
    one bf16 ulp of ``max|ref|``."""
    rs = np.random.default_rng(H * 100 + D + s)
    q, k, v = _bf16(rs, 1, s, H, D), _bf16(rs, 1, s, Hk, D), \
        _bf16(rs, 1, s, Hk, D)
    want = _pallas(q, k, v, causal)
    got = emulate_wgmma(q, k, v, causal).float().numpy()
    tol = 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)
    assert np.abs(got - want).max() <= tol


def test_paged_plan_at_llavas_decode():
    """llava's decode (B2, T1, H56/8 = G 7, D128, 16-token pages over a
    2384-token dense-slot row): R = 7 rows make two 4-row tiles, the
    second not full; the row layout and split are those of T = 2..4."""
    p = pa.plan(2, 1, 56, 8, 128, 16, 149, torch.bfloat16)
    assert p.rows == 4 and p.row_tiles == 2
    for T in (2, 3, 4):
        assert _row_layout(pa.plan(2, T, 56, 8, 128, 16, 149,
                                   torch.bfloat16)) == _row_layout(p)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_paged_rows_at_group_seven(dt):
    """A G = 7 instance of the paged kernel's arithmetic (the replay of
    ``test_torch_spec_bf16``): each slot's rows are the same whatever the
    other slot holds or where its cursor is, row t of a T = 3 call is a
    one-query call at ``start + t``, and all lie within the kernel rows'
    tolerance of the plain version."""
    B, H, Hk, D, bs, n = 2, 7, 1, 16, 4, 6
    g = torch.Generator().manual_seed(11)
    q = torch.randn(B, 3, H, D, generator=g).to(dt)
    kp = torch.randn(1 + B * n, bs, Hk, D, generator=g).to(dt)
    vp = torch.randn(1 + B * n, bs, Hk, D, generator=g).to(dt)
    tables = (1 + torch.arange(B * n, dtype=torch.int32)).reshape(B, n)
    start = torch.tensor([5, 17], dtype=torch.int32)
    full = paged_replay(q, kp, vp, tables, start, dt)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[1 + n:], vp2[1 + n:] = 0.5, -0.5        # slot 1's pages
    other = paged_replay(q, kp2, vp2, tables, torch.tensor([5, 9]), dt)
    assert torch.equal(other[0], full[0])
    for t in range(3):
        one = paged_replay(q[:, t:t + 1].contiguous(), kp, vp, tables,
                           start + t, dt)
        assert torch.equal(one[:, 0], full[:, t]), t
    want = ref.paged_attention_ref(q, kp, vp, tables, start,
                                   dequant_dtype=dt)
    tol = (1e-5 if dt == torch.float32 else
           2.0 ** (math.floor(math.log2(float(want.float().abs().max())))
                   - 7))
    assert float((full.float() - want.float()).abs().max()) <= tol
