"""GenerationClient: the seam between rollout production and the engine
(counterpart of ``trlx_tpu/serving/client.py``).

- :meth:`generate_batch` — the rollout path. Takes a ragged batch of prompt
  arrays and returns ``(sequences [B, P+N], response_mask [B, N], P)``:
  prompts left-padded to the shared length bucket, responses padded with
  ``pad_token_id`` after finish, mask 1 on every generated token up to and
  including eos.
- :meth:`submit` / :meth:`stream` / :meth:`cancel` — the request API: tokens
  stream out as the engine decodes them, and a cancelled request releases
  its blocks on the next admission round. A shed or expired request raises
  its typed error after its tokens, tagged with its tenant.
- :meth:`stream_batch` — :meth:`generate_batch` with a callback per
  finished sequence, the seam of stream-overlapped PPO.

``engine`` may be a :class:`~trlx_tpu_torch.serving.supervisor.ServingSupervisor`:
the same surface, with crashes turned into supervised restarts.

The client serializes engine stepping: concurrent callers interleave their
requests into the same continuous batch, one caller driving at a time.
Collecting a batch's results journals a ``store`` flight event per request
on the scheduler's clock (closing its ``store_wait`` tail) when the flight
recorder is enabled.
"""

import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from trlx_tpu_torch.obs.flight import flight
from trlx_tpu_torch.ops.generation import pad_to_bucket
from trlx_tpu_torch.serving.engine import PREFILL_LEN_BUCKETS, ServingEngine
from trlx_tpu_torch.serving.policy import EngineStoppedError, RequestExpiredError, RequestShedError
from trlx_tpu_torch.serving.scheduler import FINISH_DEADLINE, FINISH_SHED, Request


class GenerationClient:
    def __init__(self, engine: ServingEngine):
        self.engine = engine
        self._step_lock = threading.Lock()

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        stop_sequences: Sequence[Sequence[int]] = (),
        deadline_s: Optional[float] = None,
        tenant_id: Optional[str] = None,
    ) -> int:
        return self.engine.submit(
            prompt, max_new_tokens, stop_sequences=stop_sequences, deadline_s=deadline_s, tenant_id=tenant_id,
        )

    def cancel(self, uid: int) -> bool:
        return self.engine.cancel(uid)

    @property
    def policy_version(self) -> int:
        """The broadcast version the engine serves (-1: no generation island)."""
        return int(getattr(self.engine, "serving_version", -1))

    def _request(self, uid: int) -> Request:
        req = self.engine.scheduler.get_request(uid)
        if req is None:
            raise KeyError(f"unknown request uid {uid}")
        return req

    def stream(self, uid: int) -> Iterator[int]:
        """Yield the request's tokens as the engine produces them, driving
        engine rounds while the request is live. A shed request raises
        :class:`RequestShedError` and an expired one :class:`RequestExpiredError`,
        after every token decoded before it ended; an engine that drained with
        the request unaccounted raises :class:`EngineStoppedError` instead of
        spinning. Each error carries the request's tenant and class."""
        req = self._request(uid)
        sent = 0
        while True:
            gen = req.generated
            while sent < len(gen):
                yield gen[sent]
                sent += 1
            if req.done:
                break
            with self._step_lock:
                if not req.done:
                    self.engine.step()
                    if not req.done and not self.engine.scheduler.has_work:
                        raise EngineStoppedError(
                            f"engine drained with request uid={uid} unaccounted "
                            f"({sent} tokens streamed)",
                            **self._tags(req), uid=uid,
                        )
        for tok in req.generated[sent:]:
            yield tok
        self._raise_if_failed(req, f"request uid={req.uid}")

    def _replica_of(self, uid: int) -> Optional[int]:
        """Replica attribution for typed errors: a fleet router knows which
        replica served the uid (``replica_of``); a bare engine or supervisor
        is its own replica (``replica_id``, None outside a fleet)."""
        fn = getattr(self.engine, "replica_of", None)
        if fn is not None:
            return fn(uid)
        return getattr(self.engine, "replica_id", None)

    def _tags(self, req: Request) -> Dict[str, object]:
        return dict(tenant_id=req.tenant_id, slo_class=req.slo_class, replica_id=self._replica_of(req.uid))

    def _raise_if_failed(self, req: Request, what: str) -> None:
        """The typed error of a shed or expired request (nothing otherwise)."""
        if req.finish_reason == FINISH_SHED:
            raise RequestShedError(f"{what} was shed after {len(req.generated)} tokens",
                                   **self._tags(req), uid=req.uid)
        if req.finish_reason == FINISH_DEADLINE:
            raise RequestExpiredError(
                f"{what} expired (deadline_s={req.deadline_s}) after {len(req.generated)} tokens",
                **self._tags(req), uid=req.uid)

    def generate_batch(
        self,
        prompts: List[np.ndarray],
        max_new_tokens: int,
        stop_sequences: Sequence[Sequence[int]] = (),
        tenant_id: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Continuous-batched drop-in for the one-shot generate path:
        ``(sequences [B, P+N], response_mask [B, N], P)`` with P the shared
        prompt bucket. With ``tenant_id`` a member that ends shed or expired
        raises its typed error instead of returning a truncated row; the
        default-tenant path returns whatever the engine produced."""
        engine = self.engine
        N = int(max_new_tokens)
        P = pad_to_bucket(max((len(p) for p in prompts), default=1), PREFILL_LEN_BUCKETS)
        with self._step_lock:
            uids = [
                engine.submit(np.asarray(p).tolist(), N, stop_sequences=stop_sequences, tenant_id=tenant_id)
                for p in prompts
            ]
            done = engine.run(uids)
        t_store = engine.scheduler.clock() if flight.enabled else 0.0
        for uid in uids:
            engine.scheduler.pop_request(uid)
            if flight.enabled:
                flight.record(uid, "store", t=t_store)
            if tenant_id is not None:
                self._raise_if_failed(done[uid], f"batch member uid={uid}")
        return self._collate(prompts, [done[u] for u in uids], P, N)

    def _collate(self, prompts, reqs: List[Request], P: int, N: int) -> Tuple[np.ndarray, np.ndarray, int]:
        seqs = np.full((len(prompts), P + N), self.engine.pad_token_id, np.int32)
        mask = np.zeros((len(prompts), N), np.int32)
        for i, (req, p) in enumerate(zip(reqs, prompts)):
            p = np.asarray(p, np.int32)
            gen = np.asarray(req.generated, np.int32)
            seqs[i, P - len(p):P] = p
            seqs[i, P:P + len(gen)] = gen
            mask[i, : len(gen)] = 1
        return seqs, mask, P

    def stream_batch(
        self,
        prompts: List[np.ndarray],
        max_new_tokens: int,
        on_finish: Callable[[int, Request], None],
        stop_sequences: Sequence[Sequence[int]] = (),
        on_step: Optional[Callable[[float, float], None]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """:meth:`generate_batch` with a completion callback per sequence.

        ``on_finish(i, req)`` fires exactly once per batch index ``i``, on the
        calling thread, as soon as the engine finishes that sequence, while
        the rest of the batch is still decoding. It runs under the client's
        step lock between engine rounds, so it must hand heavy work to another
        thread and return quickly. Exactly once holds across supervised
        restarts: a finished request carried into a new engine generation is
        de-duplicated by uid before delivery.

        ``on_step(t0, t1)`` receives the ``time.perf_counter`` window of every
        engine round (the decode busy intervals of the overlap ledger).
        Returns :meth:`generate_batch`'s ``(sequences, response_mask, P)``."""
        engine = self.engine
        N = int(max_new_tokens)
        P = pad_to_bucket(max((len(p) for p in prompts), default=1), PREFILL_LEN_BUCKETS)
        done: Dict[int, Request] = {}
        with self._step_lock:
            uids = [engine.submit(np.asarray(p).tolist(), N, stop_sequences=stop_sequences) for p in prompts]
            index_of = {uid: i for i, uid in enumerate(uids)}
            want = set(uids)

            def deliver(finished: Dict[int, Request]) -> None:
                for uid, req in finished.items():
                    if uid in done:  # carried over a restart: delivered already
                        continue
                    done[uid] = req
                    if uid in index_of:
                        on_finish(index_of[uid], req)

            deliver(dict(engine.scheduler.pop_finished()))
            while not want <= set(done):
                if not engine.scheduler.has_work:
                    raise EngineStoppedError(f"engine drained with requests unaccounted: {want - set(done)}")
                t0 = time.perf_counter()
                engine.step()
                t1 = time.perf_counter()
                if on_step is not None:
                    on_step(t0, t1)
                deliver(dict(engine.scheduler.pop_finished()))
                engine.export_gauges()
        for uid in uids:
            engine.scheduler.pop_request(uid)
        return self._collate(prompts, [done[u] for u in uids], P, N)

    def summary(self):
        return self.engine.summary()
