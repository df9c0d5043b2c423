"""RL method definitions: each algorithm is a registered MethodConfig
dataclass that owns its loss (counterpart of ``trlx_tpu/methods``).
Importing this package registers the methods the port brings: PPO and SFT.
ILQL, RFT and GRPO come with later slices (``data.method_configs.LATER_METHODS``)."""

from trlx_tpu_torch.methods.ppo import AdaptiveKLController, FixedKLController, PPOConfig
from trlx_tpu_torch.methods.sft import SFTConfig

__all__ = ["PPOConfig", "SFTConfig", "AdaptiveKLController", "FixedKLController"]
