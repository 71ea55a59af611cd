"""Fleet runtime of the port — :mod:`repro.runtime` without the training
supervisor: failure injection, heartbeats and straggler flags, and replica
and mesh sizing. Host logic only; it imports nothing of JAX."""

from repro_torch.runtime.elastic import plan_mesh_shape, plan_replicas
from repro_torch.runtime.failures import FailureInjector, SimulatedFailure
from repro_torch.runtime.heartbeat import HeartbeatMonitor, StragglerReport

__all__ = ["FailureInjector", "HeartbeatMonitor", "SimulatedFailure",
           "StragglerReport", "plan_mesh_shape", "plan_replicas"]
