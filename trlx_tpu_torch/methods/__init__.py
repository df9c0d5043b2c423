"""RL method definitions: each algorithm is a registered MethodConfig
dataclass that owns its loss (counterpart of ``trlx_tpu/methods``).
Importing this package registers the methods the port brings: PPO. SFT,
ILQL, RFT and GRPO come with later slices (``data.method_configs.LATER_METHODS``)."""

from trlx_tpu_torch.methods.ppo import AdaptiveKLController, FixedKLController, PPOConfig

__all__ = ["PPOConfig", "AdaptiveKLController", "FixedKLController"]
