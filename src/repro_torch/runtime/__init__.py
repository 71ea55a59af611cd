"""Fleet runtime of the port — :mod:`repro.runtime`: failure injection,
heartbeats and straggler flags, replica and mesh sizing, and the training
restart supervisor. Host logic only; it imports nothing of JAX."""

from repro_torch.runtime.elastic import plan_mesh_shape, plan_replicas
from repro_torch.runtime.failures import FailureInjector, SimulatedFailure
from repro_torch.runtime.heartbeat import HeartbeatMonitor, StragglerReport
from repro_torch.runtime.supervisor import RunResult, Supervisor

__all__ = ["FailureInjector", "HeartbeatMonitor", "RunResult",
           "SimulatedFailure", "StragglerReport", "Supervisor",
           "plan_mesh_shape", "plan_replicas"]
