"""trlx_tpu_torch: the PyTorch/CUDA port of trlx_tpu for one NVIDIA H100.

Slice 1 ported the serving path: ``serving.ServingEngine`` driven through
``serving.GenerationClient`` over ``models.transformer.TransformerLM``, with
hand-written Hopper kernels for flash prefill (``csrc/flash_fwd.cu``) and
paged decode (``csrc/paged_decode.cu``). Slice 2 ports the PPO training
path behind :func:`train` — ``PPOTrainer``: padded generation, reward,
policy and reference scoring forwards, KL-shaped rewards, GAE and the
clipped PPO loss, AdamW — with the flash backward kernels (dK/dV and dQ,
``csrc/flash_bwd.cu``). Later slices add speculative decoding, SFT and
HF-format checkpoints, hydra PPO (the frozen reference branch and the value
branch), RFT and ILQL. The package imports ``torch`` and numpy, never
``jax`` or ``trlx_tpu``.
"""

from trlx_tpu_torch.data.configs import TRLConfig


def train(*args, **kwargs):
    """Training (:func:`trlx_tpu_torch.trlx.train`); imported lazily so
    importing the package stays light."""
    from trlx_tpu_torch.trlx import train as _train

    return _train(*args, **kwargs)


__all__ = ["train", "TRLConfig"]
