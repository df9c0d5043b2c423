"""Host-side prompt batching for generation (counterpart of the helpers at the
top of ``trlx_tpu/ops/generation.py``). The padded one-shot ``generate`` loop
belongs to a later slice; the serving engine needs only these two."""

from typing import List, Sequence, Tuple

import numpy as np


def pad_to_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length; past the last bucket, the next multiple of 64."""
    for b in sorted(buckets):
        if b >= length:
            return b
    return int(np.ceil(length / 64) * 64)


def left_pad_batch(
    ids_list: List[np.ndarray], pad_token_id: int, target_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad a ragged list of prompt id arrays to ``[B, target_len]``:
    (int32 ids, int32 0/1 mask). Rows longer than ``target_len`` keep their
    last ``target_len`` tokens."""
    B = len(ids_list)
    out = np.full((B, target_len), pad_token_id, np.int32)
    mask = np.zeros((B, target_len), np.int32)
    for i, r in enumerate(ids_list):
        r = np.asarray(r, np.int32)[-target_len:]
        out[i, target_len - len(r):] = r
        mask[i, target_len - len(r):] = 1
    return out, mask
