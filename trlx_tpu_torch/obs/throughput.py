"""Throughput and model-FLOPs-utilization (MFU) accounting (counterpart of
``trlx_tpu/obs/throughput.py``).

The standard numbers from quantities the trainer already has — parameter
count, token counts and measured step wall time:

- **tokens/sec, samples/sec** — raw throughput.
- **model TFLOP/s** — achieved model FLOPs per second, from the standard
  decoder-transformer estimate (PaLM appendix B / Chinchilla accounting):
  ``6 * N`` FLOPs per trained token (fwd 2N + bwd 4N) plus the attention
  term ``12 * L * H * S`` per token when layer/hidden/seqlen are known;
  generation forwards count ``2 * N (+ attention)`` per token.
- **MFU** — achieved model FLOP/s divided by the device's peak FLOP/s.
  The peak is detected from the CUDA device's name
  (``torch.cuda.get_device_name``) for the NVIDIA parts in
  :data:`PEAK_TFLOPS_BY_DEVICE_KIND` (dense bf16 tensor-core rates from
  NVIDIA's data sheets) and can be set with
  ``observability.peak_device_tflops`` for any other device. Unknown and
  not set: ``mfu`` is not reported — never a made-up denominator.

All of this is host-side float arithmetic once per step; it adds no device
work and no synchronization.
"""

from typing import Any, Dict, Mapping, Optional

#: Peak dense bf16 TFLOP/s per card by a lowercase substring of
#: ``torch.cuda.get_device_name()`` (first hit wins, so more specific keys
#: come first). NVIDIA H100 SXM5 ("NVIDIA H100 80GB HBM3"): 989.4 TFLOP/s,
#: NVIDIA's H100 data sheet and Hopper white paper, at the 700 W limit. A
#: part joins with the name its driver was seen to report and its data
#: sheet's figure.
PEAK_TFLOPS_BY_DEVICE_KIND = {
    "h100 80gb hbm3": 989.4,
}


def param_count(tree: Any) -> int:
    """Total number of elements of a module's parameters, or of the tensors
    (or arrays) of a possibly nested mapping such as a ``state_dict``."""
    import torch

    if isinstance(tree, torch.nn.Module):
        return int(sum(p.numel() for p in tree.parameters()))
    if isinstance(tree, Mapping):
        return int(sum(param_count(v) for v in tree.values()))
    if isinstance(tree, torch.Tensor):
        return int(tree.numel())
    return int(getattr(tree, "size", 0))


def detect_peak_tflops(device_kind: str) -> Optional[float]:
    """Per-card peak TFLOP/s for a CUDA device name, or None."""
    kind = (device_kind or "").lower()
    for key, tflops in PEAK_TFLOPS_BY_DEVICE_KIND.items():
        if key in kind:
            return tflops
    return None


def transformer_flops_per_token(
    n_params: int,
    num_layers: int = 0,
    hidden_size: int = 0,
    seq_len: int = 0,
    backward: bool = True,
) -> float:
    """Model FLOPs to process one token: ``(2 or 6) * N`` matmul FLOPs plus the
    attention term ``(4 or 12) * L * H * S`` (PaLM appendix B)."""
    mult = 6.0 if backward else 2.0
    flops = mult * float(n_params)
    if num_layers and hidden_size and seq_len:
        flops += (mult * 2.0) * float(num_layers) * float(hidden_size) * float(seq_len)
    return flops


class ThroughputAccountant:
    """Per-step throughput/MFU stats from param count + measured step time."""

    def __init__(
        self,
        n_params: int,
        num_devices: int = 1,
        peak_device_tflops: Optional[float] = None,
        num_layers: int = 0,
        hidden_size: int = 0,
    ):
        if n_params < 0:
            raise ValueError(f"n_params must be >= 0, got {n_params}")
        self.n_params = int(n_params)
        self.num_devices = max(1, int(num_devices))
        self.peak_device_tflops = peak_device_tflops
        self.num_layers = int(num_layers)
        self.hidden_size = int(hidden_size)
        self.total_tokens = 0
        self.total_samples = 0

    def peak_flops(self) -> Optional[float]:
        """Peak FLOP/s over all devices, or None when no peak is known."""
        if self.peak_device_tflops is None:
            return None
        return self.peak_device_tflops * 1e12 * self.num_devices

    def step_stats(
        self,
        tokens: int,
        samples: int,
        step_time_s: float,
        seq_len: int = 0,
        backward: bool = True,
        prefix: str = "throughput/",
    ) -> Dict[str, float]:
        """Stats for one step that processed ``tokens`` tokens over
        ``step_time_s`` seconds of wall clock. ``mfu`` appears only when a
        peak FLOP/s is known (detected or configured)."""
        dt = max(float(step_time_s), 1e-9)
        self.total_tokens += int(tokens)
        self.total_samples += int(samples)
        flops = tokens * transformer_flops_per_token(
            self.n_params, self.num_layers, self.hidden_size, seq_len, backward=backward
        )
        out = {
            f"{prefix}tokens_per_sec": tokens / dt,
            f"{prefix}samples_per_sec": samples / dt,
            f"{prefix}model_tflops_per_sec": flops / dt / 1e12,
            f"{prefix}total_tokens": float(self.total_tokens),
        }
        peak = self.peak_flops()
        if peak:
            out[f"{prefix}mfu"] = (flops / dt) / peak
        return out
