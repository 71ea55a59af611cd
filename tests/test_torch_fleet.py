"""The port's replica fleet (``repro_torch.serve.{replica,router}``) and
``ServeEngine.reload_params`` against the JAX reference, on the CPU.

They mirror ``tests/test_replica_serving.py`` on the port's classes, on the
deterministic :class:`StepClock`:

* the chaos op stream's invariants (R1-R4 of ``ReplicaSet.check`` and HRW
  affinity stability after every op, hypothesis);
* a kill of the busiest replica mid-decode: the requeued requests' greedy
  tokens equal an unkilled single engine's, and the reference's, bit for
  bit (llama3 and moonshot smoke, dense-slot and paged);
* the fleet report: deterministic JSON, and equal to the reference's field
  for field on the same clock, workload and failure schedule;
* a watcher-driven rolling reload that drops nothing and skips no version;
* the lifecycle guards and HRW moving only the dead replica's keys;
* ``reload_params``: a reloaded engine equals a fresh one on the new
  weights, an engine sharing the old tree is unchanged, a mismatched tree
  raises as the reference's does.

Both packages run the smoke configs in float32 compute, so the port's
tokens equal the reference's exactly (as ``tests/test_torch_serve.py``
holds f32 tokens); the parameters are the reference's ``PRNGKey(0)`` ones
moved through :mod:`repro_torch.interop`. Reports are host arithmetic on
the same clock: equal, no tolerance.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import CheckpointWatcher as JWatcher
from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.models.api import build_model as jbuild
from repro.runtime.failures import FailureInjector as JInjector
from repro.serve import ReplicaSet as JReplicaSet
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import StepClock as JClock
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager, CheckpointWatcher
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.models.api import build_model as tbuild
from repro_torch.runtime import FailureInjector, SimulatedFailure
from repro_torch.serve import Request, ServeEngine, StepClock, \
    resolve_drafter
from repro_torch.serve.replica import DEAD, DRAINING, HEALTHY, Replica
from repro_torch.serve.router import ReplicaSet

_MAX_LEN = 48
_N_SLOTS = 2
_BUILT = {}


def _pair(arch="llama3-8b"):
    """The reference's f32 smoke model and ``PRNGKey(0)`` parameters, and
    the port's model on the same parameters (module-cached)."""
    if arch not in _BUILT:
        jm = jbuild(dataclasses.replace(jsmoke(jget(arch)),
                                        compute_dtype="float32"))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tbuild(dataclasses.replace(tsmoke(tget(arch)),
                                        compute_dtype="float32"))
        tp = tm.load_params(interop.from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
        _BUILT[arch] = jm, jp, tm, tp
    return _BUILT[arch]


def _engine_kw(paged):
    return dict(paged=True, block_size=8, n_blocks=24) if paged else {}


def _factory(model, params, clock, *, paged=False):
    def build():
        return ServeEngine(model, params, n_slots=_N_SLOTS, max_len=_MAX_LEN,
                           clock=clock, device="cpu", **_engine_kw(paged))
    return build


def _jfactory(model, params, clock, *, paged=False):
    def build():
        return JEngine(model, params, n_slots=_N_SLOTS, max_len=_MAX_LEN,
                       clock=clock, **_engine_kw(paged))
    return build


def _fleet(arch="llama3-8b", *, n=3, paged=False, dt=1e-3, **kw):
    _, _, model, params = _pair(arch)
    clock = StepClock(dt)
    rs = ReplicaSet(_factory(model, params, clock, paged=paged),
                    n_replicas=n, clock=clock, **kw)
    return rs, params


def _jfleet(arch="llama3-8b", *, n=3, paged=False, dt=1e-3, **kw):
    model, params, _, _ = _pair(arch)
    clock = JClock(dt)
    return JReplicaSet(_jfactory(model, params, clock, paged=paged),
                       n_replicas=n, clock=clock, **kw), params


def _workload(n=6, prompt_len=6, gen=4, spacing_s=2e-3, cls=Request):
    """The reference test's workload: prompts cycle over two shared
    prefixes, so routing is non-trivial."""
    reqs = []
    for uid in range(n):
        prefix = (uid % 2 + 1,) * 4
        prompt = prefix + tuple(2 + (uid + i) % 5
                                for i in range(prompt_len - 4))
        reqs.append(cls(uid=uid, prompt=prompt, max_new_tokens=gen,
                        arrival_s=uid * spacing_s))
    return reqs


def _drain(rs, limit=4000):
    for rid in range(len(rs.replicas)):
        if not rs.replicas[rid].alive:
            rs.revive(rid)
    steps = 0
    while rs.outstanding or rs.reloading:
        rs.step()
        steps += 1
        assert steps < limit, f"fleet failed to drain ({rs.outstanding} left)"
    return rs.finish()


def _tokens(results):
    return {r.uid: tuple(np.asarray(r.tokens).tolist()) for r in results}


def _busiest(rs):
    return max((r for r in rs.replicas if r.alive),
               key=lambda r: (len(r.uids), -r.rid)).rid


# ---------------------------------------------------------------------------
# hypothesis: op-stream invariants
# ---------------------------------------------------------------------------

_CHAOS_OPS = st.lists(
    st.one_of(
        st.tuples(st.just("submit"), st.integers(0, 3), st.integers(1, 4)),
        st.tuples(st.just("kill"), st.integers(0, 2)),
        st.tuples(st.just("revive"), st.integers(0, 2)),
        st.tuples(st.just("reload")),
        st.tuples(st.just("step"), st.integers(1, 3)),
    ),
    min_size=1, max_size=12)

_PROBE_PROMPTS = [(1, 1, 1, 1, 5, 6), (2, 2, 2, 2, 5, 6),
                  (3, 4, 5, 6, 7, 8), (9, 9, 2, 3, 4, 5)]


class TestChaosOpStream:
    @given(ops=_CHAOS_OPS)
    @settings(max_examples=10, deadline=None)
    def test_invariants_under_random_ops(self, ops):
        """R1-R4 and affinity stability hold through any interleaving of
        the chaos vocabulary; the fleet drains with every request
        completed once."""
        rs, params = _fleet()
        uid = version = 0
        for op in ops:
            accepting_old = {r.rid for r in rs.replicas if r.accepting}
            routes_old = {p: rs.route(p) for p in _PROBE_PROMPTS}
            if op[0] == "submit":
                _, pi, gen = op
                prefix = (pi % 2 + 1,) * 4
                rs.submit(Request(uid=uid, prompt=prefix + (pi + 2, 7),
                                  max_new_tokens=gen, arrival_s=0.0))
                uid += 1
            elif op[0] == "kill":
                rs.kill(op[1])
            elif op[0] == "revive":
                rs.revive(op[1])
            elif op[0] == "reload":
                version += 1
                rs.begin_reload(version, params)
            else:
                for _ in range(op[1]):
                    rs.step()
            rs.check()
            accepting_new = {r.rid for r in rs.replicas if r.accepting}
            for p in _PROBE_PROMPTS:
                new_rid, old_rid = rs.route(p), routes_old[p]
                if new_rid == old_rid:
                    continue
                assert (old_rid is None or old_rid not in accepting_new
                        or (new_rid is not None
                            and new_rid in accepting_new - accepting_old)), \
                    f"key {p} moved {old_rid}->{new_rid} with both accepting"
            if accepting_new == accepting_old:
                assert {p: rs.route(p) for p in _PROBE_PROMPTS} == routes_old
        results, report = _drain(rs)
        rs.check()
        assert report["lost_requests"] == 0
        assert {r.uid for r in results} == set(range(uid))
        assert report["completed"] == uid
        assert report["reload_dropped"] == 0

    @given(kill_first=st.booleans(), n_requests=st.integers(1, 5))
    @settings(max_examples=5, deadline=None)
    def test_requests_survive_total_fleet_loss(self, kill_first, n_requests):
        rs, _ = _fleet(n=2)
        for req in _workload(n_requests, spacing_s=0.0):
            rs.submit(req)
        if not kill_first:
            rs.step()
        rs.kill(0)
        rs.kill(1)
        rs.check()
        assert rs.route(_PROBE_PROMPTS[0]) is None
        with pytest.raises(SimulatedFailure):
            rs.run(max_steps=10)
        results, report = _drain(rs)
        assert report["lost_requests"] == 0
        assert len(results) == n_requests


# ---------------------------------------------------------------------------
# kill-mid-decode parity, against the reference
# ---------------------------------------------------------------------------


def _kill_busiest(killed):
    def act(fleet):
        rid = _busiest(fleet)
        fleet.kill(rid)
        killed.append(rid)
    return act


class TestKillMidDecodeParity:
    @pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b"])
    @pytest.mark.parametrize("paged", [False, True],
                             ids=["dense-kv", "paged-kv"])
    def test_requeued_tokens_bit_identical(self, arch, paged):
        """Crash the replica with the most in-flight decodes: the requeued
        requests restart from their prompts elsewhere, and every greedy
        token equals an unkilled single engine's, the reference's
        single engine's, and the reference's fleet's; the fleet reports
        are equal field for field."""
        jm, jp, tm, tp = _pair(arch)
        baseline, _ = _factory(tm, tp, StepClock(1e-3), paged=paged)().run(
            _workload(8, gen=8))
        jbase, _ = _jfactory(jm, jp, JClock(1e-3), paged=paged)().run(
            _workload(8, gen=8, cls=JRequest))

        rs, _ = _fleet(arch, paged=paged)
        killed = []
        results, report = rs.run(_workload(8, gen=8),
                                 actions={5: _kill_busiest(killed)})
        rs.check()
        assert killed and report["kills"] == 1
        assert report["requeues"] >= 1, \
            "kill hit an idle replica; parity was not exercised"
        assert report["deaths_detected"] == 1
        assert report["lost_requests"] == 0
        assert _tokens(results) == _tokens(baseline) == _tokens(jbase)

        jrs, _ = _jfleet(arch, paged=paged)
        jkilled = []
        jresults, jreport = jrs.run(_workload(8, gen=8, cls=JRequest),
                                    actions={5: _kill_busiest(jkilled)})
        assert jkilled == killed
        assert _tokens(jresults) == _tokens(results)
        assert json.dumps(report, sort_keys=True) == \
            json.dumps(jreport, sort_keys=True)
        assert [r.metrics.moa_flops for r in results] == \
            [r.metrics.moa_flops for r in jresults]

    def test_requeue_latency_measured(self):
        rs, _ = _fleet(miss_limit=2)
        _, report = rs.run(_workload(8, gen=8),
                           actions={5: lambda f: f.kill(_busiest(f))})
        assert report["requeued_requests"] >= 1
        assert report["requeue_latency_ms"]["p50"] > 0.0


# ---------------------------------------------------------------------------
# determinism, and the report against the reference's
# ---------------------------------------------------------------------------


def _chaos_once(run_dir, reference=False):
    """A kill at router step 6, a checkpoint saved at 10 (a watcher-driven
    rolling reload) and a revival at 14, on a 3-replica fleet."""
    jm, jp, tm, tp = _pair()
    if reference:
        mgr = JManager(str(run_dir), keep=2)
        clock = JClock(1e-3)
        rs = JReplicaSet(
            _jfactory(jm, jp, clock), n_replicas=3, clock=clock,
            failure_injectors={1: JInjector(fail_at_steps=[6])},
            watcher=JWatcher(mgr),
            load_params=lambda step: mgr.restore(jp)[0])
        params, workload = jp, _workload(8, cls=JRequest)
    else:
        mgr = CheckpointManager(str(run_dir), keep=2)
        clock = StepClock(1e-3)
        rs = ReplicaSet(
            _factory(tm, tp, clock), n_replicas=3, clock=clock,
            failure_injectors={1: FailureInjector(fail_at_steps=[6])},
            watcher=CheckpointWatcher(mgr),
            load_params=lambda step: mgr.restore(tp)[0])
        params, workload = tp, _workload(8)
    actions = {10: lambda f: mgr.save(1, params),
               14: lambda f: f.revive(1)}
    results, report = rs.run(workload, actions=actions)
    rs.check()
    return _tokens(results), json.dumps(report, sort_keys=True)


class TestFleetDeterminism:
    def test_identical_triples_give_identical_metrics_json(self, tmp_path):
        toks_a, json_a = _chaos_once(tmp_path / "a")
        toks_b, json_b = _chaos_once(tmp_path / "b")
        assert toks_a == toks_b
        assert json_a == json_b
        report = json.loads(json_a)
        assert report["kills"] == 1 and report["reloads_completed"] == 1

    def test_report_equals_the_reference(self, tmp_path):
        """The same clock, workload, failure schedule, reload and revival:
        the port's tokens and fleet report JSON equal the reference's."""
        toks, port = _chaos_once(tmp_path / "t")
        jtoks, ref = _chaos_once(tmp_path / "j", reference=True)
        assert toks == jtoks
        assert json.loads(port) == json.loads(ref)
        assert port == ref

    def test_different_failure_schedule_changes_metrics(self):
        def once(fail_step):
            rs, _ = _fleet(failure_injectors={
                1: FailureInjector(fail_at_steps=[fail_step])})
            return rs.run(_workload(6))[1]
        early, late = once(2), once(9)
        assert json.dumps(early, sort_keys=True) != \
            json.dumps(late, sort_keys=True)
        assert early["lost_requests"] == late["lost_requests"] == 0
        assert early["completed"] == late["completed"] == 6


# ---------------------------------------------------------------------------
# rolling reload
# ---------------------------------------------------------------------------


class TestRollingReload:
    def test_watcher_reload_drops_nothing(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        _, _, model, params = _pair()
        clock = StepClock(1e-3)
        rs = ReplicaSet(_factory(model, params, clock), n_replicas=3,
                        clock=clock, watcher=CheckpointWatcher(mgr),
                        load_params=lambda step: mgr.restore(params)[0])
        results, report = rs.run(
            _workload(8), actions={6: lambda f: mgr.save(1, params)})
        rs.check()
        assert report["reloads_completed"] == 1
        assert report["reload_dropped"] == 0
        assert report["lost_requests"] == 0
        assert len(results) == 8
        assert [r.param_version for r in rs.replicas] == [1, 1, 1]
        assert all(r.reloads == 1 for r in rs.replicas)

    def test_reload_versions_never_skipped(self):
        rs, params = _fleet()
        rs.begin_reload(1, params)
        rs.begin_reload(2, params)
        steps = 0
        while rs.reloading:
            rs.step()
            rs.check()
            steps += 1
            assert steps < 100
        assert rs.reloads_completed == 2
        assert [r.param_version for r in rs.replicas] == [2, 2, 2]

    def test_dead_replica_skipped_then_stale_after_revive(self):
        rs, params = _fleet()
        rs.kill(1)
        rs.begin_reload(1, params)
        steps = 0
        while rs.reloading:
            rs.step()
            steps += 1
            assert steps < 100
        rs.revive(1)
        assert [r.param_version for r in rs.replicas] == [1, 0, 1]


# ---------------------------------------------------------------------------
# reload_params
# ---------------------------------------------------------------------------


def _seeded(model, seed):
    return model.init(seed=seed, device="cpu")


def _run_logged(engine, requests):
    """Serve ``requests`` (all at 0), logging every decode step's
    logits."""
    logged = []
    decode = engine._decode

    def recorded(hw, toks):
        out = decode(hw, toks)
        logged.append(out.clone())
        return out

    engine._decode = recorded
    results, _ = engine.run(requests)
    return _tokens(results), logged


class TestReloadParams:
    @pytest.mark.parametrize("paged", [False, True],
                             ids=["dense-kv", "paged-kv"])
    def test_reloaded_engine_equals_fresh_engine(self, paged):
        """An engine built on seed 0's weights and reloaded with seed 1's
        serves exactly as a fresh engine built on seed 1's (tokens and
        every step's logits); an engine sharing seed 0's tree is
        unchanged, and so is the tree. A reload reads the new tree and
        writes none: a second reload back to seed 0 serves seed 0's
        tokens, and seed 1's tree is left as it was."""
        _, _, model, _ = _pair()
        p0, p1 = _seeded(model, 0), _seeded(model, 1)
        kept = interop.tree_map(torch.clone, p0)
        clock = lambda: 0.0  # noqa: E731
        make = lambda p: ServeEngine(  # noqa: E731
            model, p, n_slots=_N_SLOTS, max_len=_MAX_LEN, clock=clock,
            device="cpu", **_engine_kw(paged))
        reloaded, bystander = make(p0), make(p0)
        reloaded.reload_params(p1)
        fresh = make(p1)
        workload = lambda: _workload(5, gen=6, spacing_s=0.0)  # noqa: E731
        toks, logits = _run_logged(reloaded, workload())
        want_toks, want_logits = _run_logged(fresh, workload())
        assert toks == want_toks
        assert len(logits) == len(want_logits) > 0
        assert all(torch.equal(a, b) for a, b in zip(logits, want_logits))
        # the reload rebinds: the engine reads seed 1's tree, and the
        # tree it shared with the bystander is intact
        assert reloaded.params is p1
        for (_, a), (_, b) in zip(interop.tree_leaves(p0),
                                  interop.tree_leaves(kept)):
            assert torch.equal(a, b)
        base_toks, _ = _run_logged(make(kept), workload())
        assert _run_logged(bystander, workload())[0] == base_toks
        assert toks != base_toks
        # a second reload rebinds again and writes nothing of seed 1's
        seed1 = interop.tree_map(torch.clone, p1)
        reloaded.reload_params(kept)
        assert reloaded.params is kept
        assert _run_logged(reloaded, workload())[0] == base_toks
        for (_, a), (_, b) in zip(interop.tree_leaves(p1),
                                  interop.tree_leaves(seed1)):
            assert torch.equal(a, b)

    def test_rejects_mismatched_tree(self):
        """Structure, shape and dtype are checked, with the reference's
        errors."""
        _, _, model, params = _pair()
        engine = ServeEngine(model, params, n_slots=_N_SLOTS,
                             max_len=_MAX_LEN, clock=StepClock(1e-3),
                             device="cpu")
        with pytest.raises(ValueError, match="structure differs"):
            engine.reload_params({"not": "the right tree"})
        bad = interop.tree_map(torch.clone, params)
        bad["final_norm"]["scale"] = torch.ones(3)
        with pytest.raises(ValueError, match="changed layout"):
            engine.reload_params(bad)
        bad = interop.tree_map(torch.clone, params)
        bad["final_norm"]["scale"] = bad["final_norm"]["scale"].double()
        with pytest.raises(ValueError, match="a reload may not change"):
            engine.reload_params(bad)

    def test_oracle_drafter_follows_the_reload(self):
        """The oracle drafts with the engine's weights: after a reload it
        drafts with the new ones, so it still accepts every draft."""
        _, _, model, _ = _pair()
        p0, p1 = _seeded(model, 0), _seeded(model, 1)
        engine = ServeEngine(model, p0, n_slots=_N_SLOTS, max_len=_MAX_LEN,
                             clock=lambda: 0.0, device="cpu",
                             drafter=resolve_drafter("oracle", 3))
        engine.reload_params(p1)
        assert engine.drafter.params is engine.params
        results, report = engine.run(_workload(4, gen=6, spacing_s=0.0))
        assert report["spec"]["accept_rate"] == 1.0
        plain, _ = ServeEngine(model, p1, n_slots=_N_SLOTS, max_len=_MAX_LEN,
                               clock=lambda: 0.0, device="cpu").run(
            _workload(4, gen=6, spacing_s=0.0))
        assert _tokens(results) == _tokens(plain)


# ---------------------------------------------------------------------------
# lifecycle and routing
# ---------------------------------------------------------------------------


class TestReplicaLifecycle:
    def test_state_transitions_guarded(self):
        rs, params = _fleet(n=2)
        rep = rs.replicas[0]
        assert rep.state == HEALTHY and rep.accepting
        rep.begin_drain()
        assert rep.state == DRAINING and not rep.accepting and rep.alive
        with pytest.raises(RuntimeError):
            rep.begin_drain()
        rep.reload(params, 1)
        assert rep.state == HEALTHY and rep.param_version == 1
        with pytest.raises(RuntimeError):
            rep.reload(params, 2)
        rep.kill()
        assert rep.state == DEAD and not rep.alive
        with pytest.raises(RuntimeError):
            rep.submit(_workload(1)[0])
        with pytest.raises(RuntimeError):
            rep.tick()
        rep.revive()
        assert rep.state == HEALTHY and rep.revivals == 1
        assert rep.revive_capture_s == 0.0      # the CPU never captures

    def test_reload_refused_while_owning_requests(self):
        rs, params = _fleet(n=1)
        rep = rs.replicas[0]
        rep.submit(_workload(1)[0])
        rep.begin_drain()
        with pytest.raises(RuntimeError, match="mix weight versions"):
            rep.reload(params, 1)

    def test_kill_and_revive_idempotent(self):
        rs, _ = _fleet(n=2)
        assert rs.kill(0) and not rs.kill(0)
        assert rs.revive(0) and not rs.revive(0)

    def test_spec_decode_rejected(self):
        _, _, model, params = _pair()
        clock = StepClock(1e-3)

        def build():
            return ServeEngine(model, params, n_slots=_N_SLOTS,
                               max_len=_MAX_LEN, clock=clock, device="cpu",
                               drafter=resolve_drafter("ngram?n=3", 3))
        with pytest.raises(ValueError, match="speculative"):
            Replica(0, build)

    def test_hrw_moves_only_dead_replicas_keys(self):
        """Killing one replica re-homes exactly the keys it owned, and
        every route equals the reference router's."""
        rs, _ = _fleet()
        jrs, _ = _jfleet()
        keys = [(a, b, c, d, 5, 6) for a in (1, 2) for b in (1, 3)
                for c in (2, 4) for d in (1, 5)]
        before = {k: rs.route(k) for k in keys}
        assert before == {k: jrs.route(k) for k in keys}
        assert len(set(before.values())) > 1, "probe keys all co-located"
        victim = rs.replicas[1].rid
        rs.kill(victim)
        jrs.kill(victim)
        after = {k: rs.route(k) for k in keys}
        assert after == {k: jrs.route(k) for k in keys}
        for k in keys:
            if before[k] != victim:
                assert after[k] == before[k]
            else:
                assert after[k] != victim
        rs.revive(victim)
        assert {k: rs.route(k) for k in keys} == before

    def test_duplicate_uid_rejected(self):
        rs, _ = _fleet(n=2)
        req = _workload(1)[0]
        rs.submit(req)
        with pytest.raises(ValueError, match="duplicate"):
            rs.submit(req)


def test_fleet_cli_on_the_cpu(capsys):
    """``launch/serve.py --replicas``: the reference's printed lines, and
    the same numbers as the reference CLI gives for these arguments."""
    from repro_torch.launch import serve as cli

    cli.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
              "--replicas", "3", "--kill", "6:1", "--reload-at", "10",
              "--requests", "6", "--gen-len", "8"])
    out = capsys.readouterr().out
    assert "[serve] chaos: kills=1 (schedule 6:1), deaths detected=1" in out
    assert "[serve] reload: completed=1 dropped=0" in out
    assert "greedy tokens bit-identical to failure-free baseline" in out
    with pytest.raises(SystemExit, match="out of range"):
        cli.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                  "--replicas", "2", "--kill", "3:5"])
    with pytest.raises(SystemExit, match="single-engine"):
        cli.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                  "--replicas", "2", "--spec-decode"])
