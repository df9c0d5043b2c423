"""PPO rollout storage (counterpart of ``trlx_tpu/pipeline/ppo_pipeline.py``):
replay buffer of :class:`PPORLElement`, left-pad-query / right-pad-response
collate into :class:`PPORLBatch`, and JSON export."""

import json
import os
import threading
import time
from typing import Iterable, List

import numpy as np

from trlx_tpu_torch.data.ppo_types import PPORLBatch, PPORLElement
from trlx_tpu_torch.native import pad_collate_f32, pad_collate_i32
from trlx_tpu_torch.pipeline import BaseRolloutStore, NumpyLoader


def ppo_collate_fn(pad_token_id: int, elems: List[PPORLElement]) -> PPORLBatch:
    """Left-pad queries / right-pad responses and their per-token payloads."""
    P = max(len(e.query_tensor) for e in elems)
    R = max(len(e.response_tensor) for e in elems)

    queries, q_mask = pad_collate_i32(
        [e.query_tensor for e in elems], P, pad_token_id, pad_left=True
    )
    responses, r_mask = pad_collate_i32(
        [e.response_tensor for e in elems], R, pad_token_id, pad_left=False
    )
    logprobs = pad_collate_f32([e.logprobs for e in elems], R)
    values = pad_collate_f32([e.values for e in elems], R)
    rewards = pad_collate_f32([e.rewards for e in elems], R)
    versions = np.asarray(
        [int(getattr(e, "policy_version", 0) or 0) for e in elems], np.int32
    )

    return PPORLBatch(
        queries, responses, logprobs, values, rewards, q_mask, r_mask,
        policy_version=versions,
    )


class PPORolloutStorage(BaseRolloutStore):
    """Rollout storage for PPO experience (mutations lock-guarded, as the
    JAX package's store)."""

    def __init__(self, pad_token_id: int):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.history: List[PPORLElement] = []
        self._lock = threading.RLock()

    def push(self, exps: Iterable[PPORLElement]):
        exps = list(exps)
        with self._lock:
            self.history = self.history + exps

    def clear_history(self):
        with self._lock:
            self.history = []

    def export_history(self, location: str, only_text: bool = False, tokenizer=None):
        """Append rollouts as JSON for algorithm distillation."""
        assert os.path.exists(location)
        fpath = os.path.join(location, f"epoch-{str(time.time())}.json")

        def exp_to_dict(exp: PPORLElement):
            d = {
                "query_tensor": np.asarray(exp.query_tensor).tolist(),
                "response_tensor": np.asarray(exp.response_tensor).tolist(),
                "logprobs": np.asarray(exp.logprobs).tolist(),
                "values": np.asarray(exp.values).tolist(),
                "rewards": np.asarray(exp.rewards).tolist(),
            }
            if tokenizer is not None:
                d["query_text"] = tokenizer.decode(exp.query_tensor)
                d["response_text"] = tokenizer.decode(exp.response_tensor)
                if only_text:
                    d = {"query_text": d["query_text"], "response_text": d["response_text"]}
            return d

        with self._lock:
            history = self.history
        data = [exp_to_dict(exp) for exp in history]
        with open(fpath, "w") as f:
            json.dump(data, f)

    def __getitem__(self, index: int) -> PPORLElement:
        with self._lock:
            return self.history[index]

    def __len__(self) -> int:
        with self._lock:
            return len(self.history)

    def create_loader(self, batch_size: int, shuffle: bool = False, drop_last: bool = True,
                      seed: int = 0) -> NumpyLoader:
        return NumpyLoader(
            self, batch_size, lambda elems: ppo_collate_fn(self.pad_token_id, elems),
            shuffle=shuffle, drop_last=drop_last, seed=seed,
        )
