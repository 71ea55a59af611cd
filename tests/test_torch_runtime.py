"""The port's fleet runtime (``repro_torch.runtime``) and checkpoints
(``repro_torch.checkpoint``) against the JAX reference, on the CPU.

They mirror ``tests/test_runtime.py`` (the heartbeat monitor, the failure
injector, the checkpoint manager and watcher, fleet sizing; not the
training supervisor, which is not ported) on the port's classes, and hold
each against the reference's on the same inputs. Checkpoints cross between
the packages both ways: the reference saves and the port restores the same
bits (bf16 included), and the other way round. Everything here is host
logic or bit-exact storage: no tolerance.
"""

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.runtime.elastic import plan_mesh_shape as j_mesh
from repro.runtime.elastic import plan_replicas as j_replicas
from repro.runtime.heartbeat import HeartbeatMonitor as JMonitor
from repro_torch.checkpoint import CheckpointManager, CheckpointWatcher
from repro_torch.runtime import (FailureInjector, HeartbeatMonitor,
                                 SimulatedFailure, StragglerReport,
                                 plan_mesh_shape, plan_replicas)


class TestHeartbeatMonitor:
    def test_uniform_durations_never_flag(self):
        mon = HeartbeatMonitor(n_workers=4)
        for step in range(20):
            for w in range(4):
                assert mon.beat(w, step, 1.0) is None
        assert mon.reports == []

    def test_warmup_never_flags(self):
        mon = HeartbeatMonitor(n_workers=4)
        for w in range(4):
            assert mon.beat(w, 0, 100.0 if w == 3 else 1.0) is None

    def test_straggler_flagged(self):
        mon = HeartbeatMonitor(n_workers=4)
        for step in range(4):
            for w in range(4):
                mon.beat(w, step, 1.0 + 0.01 * w)
        report = mon.beat(3, 4, 10.0)
        assert isinstance(report, StragglerReport)
        assert report.worker == 3 and report.step == 4
        assert report.duration > report.threshold >= 2.0 * report.median
        assert mon.reports == [report]

    def test_threshold_scales_with_jitter(self):
        mon = HeartbeatMonitor(n_workers=2, factor=2.0, z=6.0)
        for step, d in enumerate([1.0, 3.0] * 8):
            mon.beat(step % 2, step // 2, d)
        assert mon.beat(0, 9, 5.0) is None

    def test_dead_workers(self):
        mon = HeartbeatMonitor(n_workers=3, miss_limit=3)
        for step in range(6):
            mon.beat(0, step, 1.0)
            mon.beat(1, step, 1.0)
            if step < 2:
                mon.beat(2, step, 1.0)
        assert mon.dead_workers(current_step=5) == [2]
        assert mon.dead_workers(current_step=2) == []

    def test_window_bounds_history(self):
        mon = HeartbeatMonitor(n_workers=1, window=8)
        for step in range(100):
            mon.beat(0, step, 1.0)
        assert len(mon._history[0]) == 8

    def test_reports_equal_the_reference(self):
        """A seeded stream of beats, with stragglers and silent workers:
        the same reports and the same dead workers at every step."""
        rs = np.random.default_rng(4)
        port, ref = HeartbeatMonitor(5, window=16), JMonitor(5, window=16)
        for step in range(60):
            for w in range(5):
                if w == 4 and step > 40:
                    continue                     # falls silent
                d = float(rs.lognormal(0.0, 0.3))
                if rs.random() < 0.05:
                    d *= 8.0
                a, b = port.beat(w, step, d), ref.beat(w, step, d)
                assert (a is None) == (b is None)
                if a is not None:
                    assert (a.worker, a.step, a.duration, a.median,
                            a.threshold) == (b.worker, b.step, b.duration,
                                             b.median, b.threshold)
            assert port.dead_workers(step) == ref.dead_workers(step)
        assert len(port.reports) == len(ref.reports) > 0


class TestFailureInjector:
    def test_fires_once_per_scheduled_step(self):
        inj = FailureInjector(fail_at_steps=[2, 5], kind="preemption")
        survived, step = [], 0
        while step < 8:
            try:
                inj.maybe_fail(step)
            except SimulatedFailure as e:
                assert "preemption" in str(e) and f"step {step}" in str(e)
                continue
            survived.append(step)
            step += 1
        assert survived == list(range(8))
        assert inj.fired == [2, 5]

    def test_unscheduled_steps_pass(self):
        inj = FailureInjector()
        for step in range(10):
            inj.maybe_fail(step)
        assert inj.fired == []

    def test_is_runtime_error(self):
        with pytest.raises(RuntimeError):
            FailureInjector([0]).maybe_fail(0)


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------


def _tree(k=0):
    return {"params": {"w": torch.arange(6, dtype=torch.float32) + k,
                       "b": torch.ones((2,), dtype=torch.bfloat16) * k},
            "step": torch.tensor(k, dtype=torch.int32)}


def _jtree(k=0):
    return {"params": {"w": jnp.arange(6, dtype=jnp.float32) + k,
                       "b": jnp.ones((2,), jnp.bfloat16) * k},
            "step": jnp.asarray(k, jnp.int32)}


class TestCheckpointManager:
    def test_save_restore_roundtrip(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(3, _tree(3), metadata={"loss": 1.5})
        restored, meta = m.restore(_tree())
        assert meta == {"loss": 1.5}
        assert torch.equal(restored["params"]["w"], _tree(3)["params"]["w"])
        assert restored["params"]["b"].dtype == torch.bfloat16
        assert torch.equal(restored["params"]["b"], _tree(3)["params"]["b"])
        assert restored["step"].dtype == torch.int32

    def test_restore_by_step(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        for s in (2, 7):
            m.save(s, _tree(s))
        old, _ = m.restore(_tree(), step=2)
        assert int(old["step"]) == 2
        latest, _ = m.restore(_tree())
        assert int(latest["step"]) == 7

    def test_retention_keeps_newest_n(self, tmp_path):
        m = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 5, 9, 12):
            m.save(s, _tree(s))
        assert m.available_steps() == [9, 12]
        assert m.latest_step() == 12
        assert sorted(os.listdir(tmp_path)) == ["step_12", "step_9"]

    def test_async_save_then_wait(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save_async(4, _tree(4))
        m.wait()
        restored, _ = m.restore(_tree())
        assert int(restored["step"]) == 4

    def test_async_failure_surfaces_on_next_call(self, tmp_path,
                                                 monkeypatch):
        m = CheckpointManager(str(tmp_path))

        def boom(*a, **kw):
            raise OSError("disk gone")

        monkeypatch.setattr("repro_torch.checkpoint.manager.np.savez", boom)
        m.save_async(1, _tree(1))
        m.wait()
        monkeypatch.undo()
        with pytest.raises(RuntimeError, match="async checkpoint save"):
            m.save(2, _tree(2))
        m.save(3, _tree(3))
        assert m.available_steps() == [3]

    def test_no_checkpoints_raises_filenotfound(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(tmp_path)).restore(_tree())

    def test_missing_template_key_raises(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(0, {"a": torch.ones(3)})
        with pytest.raises(KeyError, match="missing keys"):
            m.restore({"a": torch.ones(3), "b": torch.ones(2)})

    def test_truncated_shard_names_file(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(5, _tree(5))
        shard = tmp_path / "step_5" / "shard_0.npz"
        shard.write_bytes(shard.read_bytes()[:40])
        with pytest.raises(RuntimeError,
                           match="corrupt or truncated") as exc:
            m.restore(_tree())
        assert "step_5" in str(exc.value) and "shard_0.npz" in str(exc.value)

    def test_corrupt_manifest_names_step(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(6, _tree(6))
        (tmp_path / "step_6" / "manifest_0.json").write_text("{not json")
        with pytest.raises(RuntimeError, match="manifest is corrupt"):
            m.restore(_tree())

    def test_unfinished_write_is_invisible(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(1, _tree(1))
        os.makedirs(tmp_path / "step_2")
        (tmp_path / "step_2" / "shard_0.npz.tmp").write_bytes(b"partial")
        assert m.available_steps() == [1]
        restored, _ = m.restore(_tree())
        assert int(restored["step"]) == 1

    def test_sharded_save_restores_every_leaf(self, tmp_path):
        """Two shards write disjoint leaves into one step; a restore reads
        them all."""
        for shard in (0, 1):
            CheckpointManager(str(tmp_path), shard_id=shard,
                              n_shards=2).save(4, _tree(4))
        restored, _ = CheckpointManager(str(tmp_path), n_shards=2).restore(
            _tree())
        for key in ("w", "b"):
            assert torch.equal(restored["params"][key],
                               _tree(4)["params"][key])


class TestCheckpointCrossesPackages:
    """One on-disk format: the same keys, logical dtypes and bits."""

    def test_reference_saves_port_restores(self, tmp_path):
        rs = np.random.default_rng(0)
        w = rs.standard_normal((3, 5)).astype(np.float32)
        b = rs.standard_normal((7,)).astype(ml_dtypes.bfloat16)
        tree = {"layers": {"attn": {"wq": jnp.asarray(w)}},
                "embed": {"table": jnp.asarray(b)},
                "n": jnp.asarray(np.arange(4, dtype=np.int32))}
        JManager(str(tmp_path)).save(2, tree, metadata={"v": 2})
        template = {"layers": {"attn": {"wq": torch.zeros(3, 5)}},
                    "embed": {"table": torch.zeros(7, dtype=torch.bfloat16)},
                    "n": torch.zeros(4, dtype=torch.int32)}
        got, meta = CheckpointManager(str(tmp_path)).restore(template)
        assert meta == {"v": 2}
        assert np.array_equal(got["layers"]["attn"]["wq"].numpy(), w)
        assert got["embed"]["table"].dtype == torch.bfloat16
        assert np.array_equal(
            got["embed"]["table"].view(torch.int16).numpy(),
            b.view(np.int16))
        assert np.array_equal(got["n"].numpy(), np.arange(4))

    def test_port_saves_reference_restores(self, tmp_path):
        g = torch.Generator().manual_seed(1)
        tree = {"layers": {"mlp": {"w_up": torch.randn(4, 6, generator=g)}},
                "embed": {"table": torch.randn(9, generator=g).to(
                    torch.bfloat16)},
                "step": torch.tensor(11, dtype=torch.int32)}
        CheckpointManager(str(tmp_path)).save(5, tree, metadata={"a": 1})
        template = {"layers": {"mlp": {"w_up": jnp.zeros((4, 6))}},
                    "embed": {"table": jnp.zeros((9,), jnp.bfloat16)},
                    "step": jnp.asarray(0, jnp.int32)}
        got, meta = JManager(str(tmp_path)).restore(template)
        assert meta == {"a": 1}
        assert np.array_equal(np.asarray(got["layers"]["mlp"]["w_up"]),
                              tree["layers"]["mlp"]["w_up"].numpy())
        table = np.asarray(got["embed"]["table"])
        assert table.dtype == ml_dtypes.bfloat16
        assert np.array_equal(table.view(np.int16),
                              tree["embed"]["table"].view(torch.int16)
                              .numpy())
        assert int(got["step"]) == 11

    def test_same_files_and_manifest(self, tmp_path):
        """Both packages write the same manifest (keys, dtypes) and the
        same npz members for one tree."""
        import json

        JManager(str(tmp_path / "j")).save(1, _jtree(1))
        CheckpointManager(str(tmp_path / "t")).save(1, _tree(1))
        mj, mt = ({k: v for k, v in json.load(open(
            tmp_path / d / "step_1" / "manifest_0.json")).items()}
            for d in ("j", "t"))
        assert mj == mt
        zj = np.load(tmp_path / "j" / "step_1" / "shard_0.npz")
        zt = np.load(tmp_path / "t" / "step_1" / "shard_0.npz")
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype
            assert np.array_equal(zj[k], zt[k])


class TestCheckpointWatcher:
    def test_reports_each_new_step_once(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        w = CheckpointWatcher(m)
        assert w.poll() is None
        m.save(3, _tree(3))
        assert w.poll() == 3
        assert w.poll() is None
        m.save(8, _tree(8))
        assert w.poll() == 8

    def test_gc_shrinkage_never_rereports(self, tmp_path):
        m = CheckpointManager(str(tmp_path), keep=1)
        w = CheckpointWatcher(m)
        m.save(4, _tree(4))
        assert w.poll() == 4
        m.save(9, _tree(9))
        assert w.poll() == 9
        assert m.available_steps() == [9]
        assert w.poll() is None

    def test_start_step_suppresses_history(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save(5, _tree(5))
        w = CheckpointWatcher(m, start_step=5)
        assert w.poll() is None
        m.save(6, _tree(6))
        assert w.poll() == 6


# ---------------------------------------------------------------------------
# elastic sizing
# ---------------------------------------------------------------------------


class TestPlanReplicas:
    def test_floor_division_of_devices(self):
        assert plan_replicas(8) == 8
        assert plan_replicas(8, devices_per_replica=2) == 4
        assert plan_replicas(7, devices_per_replica=2) == 3

    def test_min_replicas_floor(self):
        assert plan_replicas(1, devices_per_replica=4) == 1
        assert plan_replicas(2, devices_per_replica=4, min_replicas=2) == 2

    def test_rejects_bad_arguments(self):
        with pytest.raises(ValueError):
            plan_replicas(0)
        with pytest.raises(ValueError):
            plan_replicas(4, devices_per_replica=0)
        with pytest.raises(ValueError):
            plan_replicas(4, min_replicas=0)

    @pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 12, 16, 30, 64])
    def test_equal_the_reference(self, n):
        for per in (1, 2, 3, 4):
            assert plan_replicas(n, devices_per_replica=per) == \
                j_replicas(n, devices_per_replica=per)
        for mp in (1, 2, 4, 8, 16):
            assert plan_mesh_shape(n, model_parallel=mp) == \
                j_mesh(n, model_parallel=mp)
