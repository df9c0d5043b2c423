"""Continuous-batching serving engine over paged KV block pools
(counterpart of ``trlx_tpu/serving``).

- :mod:`allocator` — ref-counted paged block allocator with a prefix cache
- :mod:`scheduler` — request queue, decode slots, finish detection
- :mod:`engine` — the device loop: bucketed prefill + fixed-shape paged
  decode / verify step
- :mod:`client` — GenerationClient: rollout drop-in + submit/stream/cancel
- :mod:`policy` — fault-tolerance policy + typed request/engine outcomes
- :mod:`supervisor` — ServingSupervisor: supervised engine restarts with
  request replay under a bounded budget
- :mod:`tenancy` — TenantRegistry: SLO classes, KV-block quotas, fair-share
  preemption
- :mod:`scenario` — deterministic multi-tenant chaos scenario harness
- :mod:`island` — GenerationIsland: the engine as the generation island of
  the Sebulba split (round gate, atomic swaps, idle-bubble ledgers)

Serving across engines (the router, autoscaler and SLO ledger) is
:mod:`trlx_tpu_torch.fleet`.
"""

from trlx_tpu_torch.serving.allocator import PagedBlockAllocator, SeqBlocks
from trlx_tpu_torch.serving.client import GenerationClient
from trlx_tpu_torch.serving.engine import ServingEngine
from trlx_tpu_torch.serving.island import GenerationIsland
from trlx_tpu_torch.serving.policy import (
    EngineDrainingError,
    EngineStoppedError,
    EngineWedgedError,
    RequestExpiredError,
    RequestShedError,
    RequestTooLarge,
    ServingResiliencePolicy,
)
from trlx_tpu_torch.serving.scenario import ScenarioReport, TenantTraffic, run_scenario
from trlx_tpu_torch.serving.scheduler import InflightScheduler, Request
from trlx_tpu_torch.serving.supervisor import ServingRestartBudgetExceeded, ServingSupervisor
from trlx_tpu_torch.serving.tenancy import DEFAULT_TENANT, TenantRegistry, TenantSpec, jain_fairness, select_victim

__all__ = [
    "DEFAULT_TENANT",
    "EngineDrainingError",
    "EngineStoppedError",
    "EngineWedgedError",
    "GenerationClient",
    "GenerationIsland",
    "InflightScheduler",
    "PagedBlockAllocator",
    "Request",
    "RequestExpiredError",
    "RequestShedError",
    "RequestTooLarge",
    "ScenarioReport",
    "SeqBlocks",
    "ServingEngine",
    "ServingResiliencePolicy",
    "ServingRestartBudgetExceeded",
    "ServingSupervisor",
    "TenantRegistry",
    "TenantSpec",
    "TenantTraffic",
    "jain_fairness",
    "run_scenario",
    "select_victim",
]
