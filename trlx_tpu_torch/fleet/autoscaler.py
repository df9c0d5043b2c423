"""FleetAutoscaler: gauge-driven replica scaling with hysteresis (counterpart
of ``trlx_tpu/fleet/autoscaler.py``).

The router makes N replicas one serving surface; the autoscaler decides what
N should be. It is deliberately *gauge-driven*: its only inputs are the
per-replica gauges the engines already export
(``serving/replica/<seat>/pending_depth``, ``.../live_slots``) — the
same numbers an operator's dashboard shows — so a scaling decision is always
explainable from the observability surface, and the obs pipeline itself gets
exercised by the control loop (a replica whose gauges stop updating reads as
idle and is drained, which is the correct response to a zombie).

Scaling policy (docs/serving.md "Fleet serving"):

- **Up**: fleet pending depth per active slot above
  ``scale_up_pending_per_slot`` for ``breach_rounds`` consecutive
  observations → :meth:`FleetRouter.add_replica`. Pending-per-slot is the
  pressure signal the shedding watermarks key off, one level up: queue
  growth the existing replicas cannot absorb.
- **Down**: zero pending AND mean slot occupancy below
  ``scale_down_occupancy`` for ``breach_rounds`` consecutive observations →
  :meth:`FleetRouter.begin_decommission` of the least-loaded active replica
  (graceful: its queued + live work finishes where it was accepted).
- **Hysteresis**: both directions require ``breach_rounds`` consecutive
  breaches (one hot round never scales), and every action starts a
  ``cooldown_rounds`` refractory window in which no further action fires —
  oscillating load cannot flap the fleet (the no-flap test's contract).
- **Windowing**: each round's fleet aggregates are appended to a
  :class:`~trlx_tpu_torch.obs.timeseries.SeriesStore` and the decision reads the
  newest ``window_rounds`` points with *conservative* reductions — min over
  the window for the scale-up pressure signal, max for the scale-down
  signals — so one spiky sample inside the window can neither trigger an
  expansion nor hide sustained idleness. ``window_rounds=1`` (the default)
  degenerates to the instantaneous reads and reproduces the pre-windowing
  behavior bit-for-bit.

``observe()`` is called once per fleet round, after
:meth:`FleetRouter.export_gauges`, on the driving thread.
"""

from typing import List, Optional, Tuple

from trlx_tpu_torch.fleet.router import FleetRouter
from trlx_tpu_torch.obs.timeseries import SeriesStore
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)

#: series keys the autoscaler maintains, one point per observe() round
PRESSURE_KEY = "fleet/series/pending_per_slot"
PENDING_KEY = "fleet/series/pending_depth"
OCCUPANCY_KEY = "fleet/series/occupancy"


class FleetAutoscaler:
    def __init__(
        self,
        router: FleetRouter,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        scale_up_pending_per_slot: float = 1.0,
        scale_down_occupancy: float = 0.25,
        breach_rounds: int = 3,
        cooldown_rounds: int = 8,
        window_rounds: int = 1,
        series: Optional[SeriesStore] = None,
    ):
        if not (1 <= min_replicas <= max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}"
            )
        if breach_rounds < 1 or cooldown_rounds < 0:
            raise ValueError(
                f"breach_rounds must be >= 1 (got {breach_rounds}), "
                f"cooldown_rounds >= 0 (got {cooldown_rounds})"
            )
        if window_rounds < 1:
            raise ValueError(f"window_rounds must be >= 1, got {window_rounds}")
        self.router = router
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_pending_per_slot = float(scale_up_pending_per_slot)
        self.scale_down_occupancy = float(scale_down_occupancy)
        self.breach_rounds = int(breach_rounds)
        self.cooldown_rounds = int(cooldown_rounds)
        self.window_rounds = int(window_rounds)
        # retention only needs to cover the decision window (plus slack for
        # post-hoc inspection); an external store may be shared with exporters
        self.series = (
            series
            if series is not None
            else SeriesStore(capacity=max(64, 4 * self.window_rounds))
        )
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        self._round = 0
        #: (round, action) history of every scaling action
        self.events: List[Tuple[int, str]] = []

    def observe(self) -> None:
        """One control-loop tick: read the per-replica gauges, update the
        breach streaks, maybe act. Single-driver (the fleet round loop)."""
        self._round += 1
        actives = self.router._active_handles()
        if not actives:
            return
        pending = 0.0
        live = 0.0
        slots = 0
        for h in actives:
            prefix = f"serving/replica/{h.seat}/"
            pending += gauges.get(prefix + "pending_depth")
            live += gauges.get(prefix + "live_slots")
            slots += h.supervisor.num_slots
        # per-round occupancy from the live_slots gauge, not the lifetime-mean
        # slot_occupancy: scale-down must see idleness now, not averaged
        # over the busy history
        self.series.append(PRESSURE_KEY, pending / max(1, slots))
        self.series.append(PENDING_KEY, pending)
        self.series.append(OCCUPANCY_KEY, live / max(1, slots))
        # conservative windowed reads: every point in the window must show
        # pressure before a round counts toward scale-up (min), and every
        # point must show idleness before one counts toward scale-down (max).
        # window_rounds=1 → these are exactly the instantaneous values.
        w = self.window_rounds
        pressure = self.series.reduce(PRESSURE_KEY, "min", w)
        pending = self.series.reduce(PENDING_KEY, "max", w)
        mean_occupancy = self.series.reduce(OCCUPANCY_KEY, "max", w)
        if self._cooldown > 0:
            self._cooldown -= 1
            # streaks reset during cooldown: the refractory window demands
            # fresh consecutive evidence before the next action
            self._up_streak = 0
            self._down_streak = 0
            return
        if pressure > self.scale_up_pending_per_slot:
            self._up_streak += 1
            self._down_streak = 0
        elif pending == 0.0 and mean_occupancy < self.scale_down_occupancy:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0
        if self._up_streak >= self.breach_rounds and len(actives) < self.max_replicas:
            logger.info(
                f"fleet autoscale up: pending/slot {pressure:.2f} > "
                f"{self.scale_up_pending_per_slot} for {self._up_streak} rounds"
            )
            self.router.add_replica()
            self.router.ledger.note_scale_up()
            self.events.append((self._round, "up"))
            self._cooldown = self.cooldown_rounds
            self._up_streak = 0
        elif self._down_streak >= self.breach_rounds and len(actives) > self.min_replicas:
            victim = max(actives, key=lambda h: (-h.load, h.seat))
            logger.info(
                f"fleet autoscale drain: idle (occupancy {mean_occupancy:.2f} < "
                f"{self.scale_down_occupancy}) for {self._down_streak} rounds — "
                f"draining seat {victim.seat}"
            )
            self.router.begin_decommission(victim)
            self.events.append((self._round, "drain"))
            self._cooldown = self.cooldown_rounds
            self._down_streak = 0
