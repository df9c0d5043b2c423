"""Host data-plane helpers: padded collation and stop-sequence scans.

The numpy versions of ``trlx_tpu/native/__init__.py`` (same semantics; the
JAX package property-tests its C++ kernels against exactly these). The C++
data plane itself is host code that a later slice of the port brings.
"""

from typing import Sequence, Tuple

import numpy as np


def pad_collate_i32(
    rows: Sequence[np.ndarray], target_len: int, pad_value: int, pad_left: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ragged int32 rows to [B, target_len] + 0/1 mask (rows longer than
    ``target_len`` keep their last (left pad) or first (right pad) tokens)."""
    B = len(rows)
    out = np.full((B, target_len), pad_value, np.int32)
    mask = np.zeros((B, target_len), np.int32)
    for i, r in enumerate(rows):
        r = np.asarray(r, np.int32)
        r = r[-target_len:] if pad_left else r[:target_len]
        if pad_left:
            out[i, target_len - len(r):] = r
            mask[i, target_len - len(r):] = 1
        else:
            out[i, : len(r)] = r
            mask[i, : len(r)] = 1
    return out, mask


def pad_collate_f32(
    rows: Sequence[np.ndarray], target_len: int, pad_value: float = 0.0, pad_left: bool = False
) -> np.ndarray:
    """Pad ragged float32 rows to [B, target_len]."""
    B = len(rows)
    out = np.full((B, target_len), pad_value, np.float32)
    for i, r in enumerate(rows):
        r = np.asarray(r, np.float32)
        r = r[-target_len:] if pad_left else r[:target_len]
        if pad_left:
            out[i, target_len - len(r):] = r
        else:
            out[i, : len(r)] = r
    return out


def find_stop_positions(seqs: np.ndarray, stop_token_seqs: Sequence[Sequence[int]]) -> np.ndarray:
    """First start index of any stop token-sequence per row; seq_len if none."""
    seqs = np.ascontiguousarray(seqs, np.int32)
    B, T = seqs.shape
    stops = [np.asarray(s, np.int32) for s in stop_token_seqs if len(s) > 0]
    out = np.full(B, T, np.int64)
    for i in range(B):
        row = seqs[i]
        for pat in stops:
            m = len(pat)
            for j in range(0, T - m + 1):
                if int(out[i]) <= j:
                    break
                if np.array_equal(row[j : j + m], pat):
                    out[i] = min(out[i], j)
                    break
    return out
