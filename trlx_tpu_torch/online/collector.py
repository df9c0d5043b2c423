"""PreferenceCollector: harvest labeled completion groups from live traffic
(counterpart of ``trlx_tpu/online/collector.py``).

The serving engine serves requests anyway; the collector turns that exhaust
into GRPO training data. It observes terminal
:class:`~trlx_tpu_torch.serving.scheduler.Request`\\ s (an engine's
``scheduler.pop_finished()`` stream, exactly once per uid),
filters to *learn-eligible* traffic (a fleet router stamps
``req.learn_eligible``; unstamped requests fall back to "finished
successfully"), groups completions by prompt, and — when a group reaches
``group_size`` — scores it and feeds the bounded
:class:`~trlx_tpu_torch.online.buffer.OnlineExperienceBuffer`, stamped with the
serving policy version for staleness admission downstream.

Three label sources (``train.online.label_type``):

- **reward**: ``reward_fn(prompt_tokens, completions) -> scores`` — direct
  scalar scoring (a scripted reward, a reward model);
- **preference**: ``preference_fn(prompt, completion_a, completion_b) ->
  p(a beats b)`` — round-robin pairwise comparisons reduced to per-
  completion mean win rates (the GRPO group baseline only needs relative
  order, so win rate is a sufficient score);
- **environment**: episode returns from
  :meth:`collect_environment`'s interaction loops.

**Exactly-once.** Each uid is harvested at most once (a ``_seen`` set).
The seeded regression ``TRLX_ONLINE_SEED_REGRESSION=double_harvest``
disables the dedup so the exactly-once test must fail under it. Each
harvested uid journals a ``store`` flight event
(:mod:`trlx_tpu_torch.obs.flight`; a no-op unless observability is on),
which closes the flight's ``store_wait`` tail.

Gauges: ``online/labels_harvested``, ``online/groups_ready``,
``online/pending_completions``, ``online/duplicates_dropped``.
"""

import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from trlx_tpu_torch.obs.flight import flight
from trlx_tpu_torch.online.buffer import LabeledGroup, OnlineExperienceBuffer
from trlx_tpu_torch.online.environment import Environment, run_environment_rollout
from trlx_tpu_torch.serving.scheduler import FINISH_EOS, FINISH_LENGTH, FINISH_STOP, Request
from trlx_tpu_torch.utils.metrics import gauges

#: finish reasons eligible for harvest when the router did not stamp
#: ``learn_eligible`` (matches the fleet ledger's success set)
_HARVESTABLE = (FINISH_EOS, FINISH_STOP, FINISH_LENGTH)

_SEED_ENV = "TRLX_ONLINE_SEED_REGRESSION"
_SEED_MODES = ("double_harvest",)


def _seed_regression() -> Optional[str]:
    mode = os.environ.get(_SEED_ENV)
    if mode and mode not in _SEED_MODES:
        raise ValueError(
            f"{_SEED_ENV}={mode!r} is not a known seeded regression "
            f"(expected one of {_SEED_MODES})"
        )
    return mode or None


class PreferenceCollector:
    """Group completions from terminal requests into labeled experience.

    :param buffer: destination for full scored groups.
    :param group_size: completions per group (must match the GRPO method's).
    :param reward_fn: ``fn(prompt_tokens, completions) -> [G] scores``.
    :param preference_fn: ``fn(prompt, a, b) -> p(a beats b)`` pairwise
        judge; exactly one of reward_fn / preference_fn must be given for
        request harvesting (environment episodes carry their own returns).

    Thread-safety: ``observe`` may run on the engine's driving thread while
    the learner reads gauges — one lock covers the pending tables.
    """

    def __init__(
        self,
        buffer: OnlineExperienceBuffer,
        group_size: int = 4,
        reward_fn: Optional[Callable[..., Sequence[float]]] = None,
        preference_fn: Optional[Callable[..., float]] = None,
    ):
        if group_size < 2:
            raise ValueError(f"group_size must be >= 2, got {group_size}")
        self.buffer = buffer
        self.group_size = int(group_size)
        self.reward_fn = reward_fn
        self.preference_fn = preference_fn
        self._seed_regression = _seed_regression()
        self._lock = threading.Lock()
        self._seen: set = set()
        # prompt key -> list of (uid, completion tokens)
        self._pending: Dict[Tuple[int, ...], List[Tuple[int, List[int]]]] = {}
        self._pending_version: Dict[Tuple[int, ...], int] = {}
        self._harvested = 0
        self._duplicates = 0
        self._groups_ready = 0

    # ------------------------------------------------------------ harvesting

    def _eligible(self, req: Request) -> bool:
        stamped = getattr(req, "learn_eligible", None)
        if stamped is not None:
            return bool(stamped)
        return req.finish_reason in _HARVESTABLE and bool(req.generated)

    def observe(self, req: Request, policy_version: int = 0) -> bool:
        """Consider one terminal request for harvest; returns True when its
        completion was banked (exactly once per uid)."""
        if not self._eligible(req):
            return False
        ready = False
        members: List[Tuple[int, List[int]]] = []
        version = 0
        with self._lock:
            if req.uid in self._seen and self._seed_regression != "double_harvest":
                self._duplicates += 1
                duplicates = self._duplicates
            else:
                duplicates = None
                self._seen.add(req.uid)
                key = tuple(map(int, req.prompt))
                self._pending.setdefault(key, []).append(
                    (req.uid, list(map(int, req.generated)))
                )
                # a group is scored against the *newest* version that fed
                # it — staleness admission must not under-count the lag
                self._pending_version[key] = max(
                    self._pending_version.get(key, 0), int(policy_version)
                )
                self._harvested += 1
                harvested = self._harvested
                ready = len(self._pending[key]) >= self.group_size
                if ready:
                    members = self._pending.pop(key)[: self.group_size]
                    version = self._pending_version.pop(key)
                pending_total = sum(len(v) for v in self._pending.values())
        # gauge/flight exports outside the collector lock (flat lock order)
        if duplicates is not None:
            gauges.set("online/duplicates_dropped", float(duplicates))
            return False
        flight.record(req.uid, "store")
        gauges.set("online/labels_harvested", float(harvested))
        gauges.set("online/pending_completions", float(pending_total))
        if ready:
            self._bank_group(list(key), members, version)
        return True

    def harvest(self, source: Any, policy_version: Optional[int] = None) -> int:
        """Sweep a router/engine's finished requests through :meth:`observe`.

        ``source`` is anything with ``.scheduler.pop_finished()`` (the
        port's ``ServingEngine``) or a plain ``{uid: Request}`` dict. The
        policy version defaults to the source's ``serving_version``, and to
        0 for a source without one (the port's engine). Returns the number
        harvested."""
        if policy_version is None:
            policy_version = int(getattr(source, "serving_version", 0) or 0)
        if isinstance(source, dict):
            finished = source
        else:
            finished = source.scheduler.pop_finished()
        n = 0
        for req in finished.values():
            if self.observe(req, policy_version=policy_version):
                n += 1
        return n

    # --------------------------------------------------------------- scoring

    def _bank_group(
        self,
        prompt: List[int],
        members: List[Tuple[int, List[int]]],
        policy_version: int,
    ) -> None:
        uids = tuple(uid for uid, _ in members)
        completions = [toks for _, toks in members]
        scores = self._score_group(prompt, completions)
        self.buffer.put(
            LabeledGroup(
                prompt=prompt,
                completions=completions,
                scores=scores,
                policy_version=policy_version,
                uids=uids,
            )
        )
        with self._lock:
            self._groups_ready += 1
            ready = self._groups_ready
        gauges.set("online/groups_ready", float(ready))

    def _score_group(
        self, prompt: List[int], completions: List[List[int]]
    ) -> np.ndarray:
        if self.reward_fn is not None:
            return np.asarray(
                self.reward_fn(prompt, completions), dtype=np.float32
            )
        if self.preference_fn is not None:
            return self._pairwise_win_rates(prompt, completions)
        raise ValueError(
            "PreferenceCollector needs a reward_fn or a preference_fn to "
            "score harvested groups"
        )

    def _pairwise_win_rates(
        self, prompt: List[int], completions: List[List[int]]
    ) -> np.ndarray:
        """Round-robin pairwise judging reduced to mean win rates. The judge
        returns p(a beats b); each ordered pair is judged once and credited
        symmetrically, so G completions cost G*(G-1)/2 judge calls."""
        g = len(completions)
        wins = np.zeros(g, dtype=np.float32)
        for i in range(g):
            for j in range(i + 1, g):
                p = float(self.preference_fn(prompt, completions[i], completions[j]))
                wins[i] += p
                wins[j] += 1.0 - p
        return wins / max(1, g - 1)

    # ----------------------------------------------------------- environment

    def collect_environment(
        self,
        env: Environment,
        generate_fn: Callable[[List[int]], List[int]],
        episodes: int,
        max_turns: int = 4,
        seed: int = 0,
        policy_version: int = 0,
    ) -> int:
        """Collect ``episodes`` groups of environment rollouts.

        Each group re-seeds the environment so its ``group_size`` members
        share one initial observation (the group baseline needs a shared
        prompt); ``generate_fn`` supplies the diversity. Scores are episode
        returns — no reward_fn / preference_fn needed. Returns groups
        banked."""
        banked = 0
        for g in range(int(episodes)):
            group_seed = int(seed) + g
            prompt: Optional[List[int]] = None
            completions: List[List[int]] = []
            returns: List[float] = []
            for _ in range(self.group_size):
                p, actions, ep_return = run_environment_rollout(
                    env, generate_fn, max_turns=max_turns, seed=group_seed
                )
                if prompt is None:
                    prompt = p
                completions.append(actions)
                returns.append(ep_return)
            self.buffer.put(
                LabeledGroup(
                    prompt=prompt or [],
                    completions=completions,
                    scores=np.asarray(returns, dtype=np.float32),
                    policy_version=int(policy_version),
                )
            )
            banked += 1
            with self._lock:
                self._harvested += self.group_size
                self._groups_ready += 1
                harvested, ready = self._harvested, self._groups_ready
            gauges.set("online/labels_harvested", float(harvested))
            gauges.set("online/groups_ready", float(ready))
        return banked

    # ---------------------------------------------------------------- stats

    def flush(self) -> int:
        """Drop partial groups (end of a run / before a policy swap whose
        staleness would mix versions inside one group). Returns completions
        discarded."""
        with self._lock:
            dropped = sum(len(v) for v in self._pending.values())
            self._pending.clear()
            self._pending_version.clear()
        gauges.set("online/pending_completions", 0.0)
        return dropped

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "labels_harvested": float(self._harvested),
                "groups_ready": float(self._groups_ready),
                "pending_completions": float(
                    sum(len(v) for v in self._pending.values())
                ),
                "duplicates_dropped": float(self._duplicates),
            }
