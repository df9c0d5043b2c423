"""GenerationClient: the seam between rollout production and the engine
(counterpart of ``trlx_tpu/serving/client.py``).

- :meth:`generate_batch` — the rollout path. Takes a ragged batch of prompt
  arrays and returns ``(sequences [B, P+N], response_mask [B, N], P)``:
  prompts left-padded to the shared length bucket, responses padded with
  ``pad_token_id`` after finish, mask 1 on every generated token up to and
  including eos.
- :meth:`submit` / :meth:`stream` / :meth:`cancel` — the request API: tokens
  stream out as the engine decodes them, and a cancelled request releases
  its blocks on the next admission round.

The client serializes engine stepping: concurrent callers interleave their
requests into the same continuous batch, one caller driving at a time.
Collecting a batch's results journals a ``store`` flight event per request
on the scheduler's clock (closing its ``store_wait`` tail) when the flight
recorder is enabled.
"""

import threading
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from trlx_tpu_torch.obs.flight import flight
from trlx_tpu_torch.ops.generation import pad_to_bucket
from trlx_tpu_torch.serving.engine import PREFILL_LEN_BUCKETS, ServingEngine
from trlx_tpu_torch.serving.policy import EngineStoppedError
from trlx_tpu_torch.serving.scheduler import Request


class GenerationClient:
    def __init__(self, engine: ServingEngine):
        self.engine = engine
        self._step_lock = threading.Lock()

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        stop_sequences: Sequence[Sequence[int]] = (),
    ) -> int:
        return self.engine.submit(prompt, max_new_tokens, stop_sequences=stop_sequences)

    def cancel(self, uid: int) -> bool:
        return self.engine.cancel(uid)

    def _request(self, uid: int) -> Request:
        req = self.engine.scheduler.get_request(uid)
        if req is None:
            raise KeyError(f"unknown request uid {uid}")
        return req

    def stream(self, uid: int) -> Iterator[int]:
        """Yield the request's tokens as the engine produces them, driving
        engine rounds while the request is live. An engine that drained with
        the request unaccounted raises :class:`EngineStoppedError` instead of
        spinning."""
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
                            uid=uid,
                        )
        for tok in req.generated[sent:]:
            yield tok

    def generate_batch(
        self,
        prompts: List[np.ndarray],
        max_new_tokens: int,
        stop_sequences: Sequence[Sequence[int]] = (),
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Continuous-batched drop-in for the one-shot generate path:
        ``(sequences [B, P+N], response_mask [B, N], P)`` with P the shared
        prompt bucket."""
        engine = self.engine
        N = int(max_new_tokens)
        P = pad_to_bucket(max((len(p) for p in prompts), default=1), PREFILL_LEN_BUCKETS)
        with self._step_lock:
            uids = [
                engine.submit(np.asarray(p).tolist(), N, stop_sequences=stop_sequences)
                for p in prompts
            ]
            done = engine.run(uids)
        B = len(prompts)
        seqs = np.full((B, P + N), engine.pad_token_id, np.int32)
        mask = np.zeros((B, N), np.int32)
        t_store = engine.scheduler.clock() if flight.enabled else 0.0
        for i, (uid, p) in enumerate(zip(uids, prompts)):
            req = done[uid]
            engine.scheduler.pop_request(uid)
            if flight.enabled:
                flight.record(uid, "store", t=t_store)
            p = np.asarray(p, np.int32)
            gen = np.asarray(req.generated, np.int32)
            seqs[i, P - len(p):P] = p
            seqs[i, P:P + len(gen)] = gen
            mask[i, : len(gen)] = 1
        return seqs, mask, P

    def summary(self):
        return self.engine.summary()
