"""Serving fleet: one logical serving surface over N supervised engine
replicas (counterpart of ``trlx_tpu/fleet``).

- :class:`~trlx_tpu_torch.fleet.router.FleetRouter` — prefix-cache-aware +
  tenant-affinity routing, cross-replica re-route on replica death
  (exactly-once terminal accounting), graceful decommission;
- :class:`~trlx_tpu_torch.fleet.autoscaler.FleetAutoscaler` — gauge-driven
  scale-up/scale-down with hysteresis;
- :class:`~trlx_tpu_torch.fleet.ledger.FleetLedger` — fleet-wide per-tenant /
  per-class SLO accounting into the ``fleet/*`` gauge namespace;
- :func:`~trlx_tpu_torch.fleet.scenario.run_fleet_scenario` — the
  deterministic fleet chaos harness.

Every replica is its own :class:`~trlx_tpu_torch.serving.ServingEngine` with
its own trunk and KV pools on the device; a retired replica (drained or
killed) drops both.
"""

from trlx_tpu_torch.fleet.autoscaler import FleetAutoscaler
from trlx_tpu_torch.fleet.ledger import FleetLedger
from trlx_tpu_torch.fleet.router import (
    ACTIVE,
    DEAD,
    DRAINING,
    UID_STRIDE,
    FleetRouter,
    ReplicaHandle,
    fleet_factory,
)
from trlx_tpu_torch.fleet.scenario import FleetScenarioReport, run_fleet_scenario

__all__ = [
    "ACTIVE",
    "DEAD",
    "DRAINING",
    "UID_STRIDE",
    "FleetAutoscaler",
    "FleetLedger",
    "FleetRouter",
    "FleetScenarioReport",
    "ReplicaHandle",
    "fleet_factory",
    "run_fleet_scenario",
]
