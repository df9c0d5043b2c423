"""RL method definitions: each algorithm is a registered MethodConfig
dataclass that owns its loss (counterpart of ``trlx_tpu/methods``).
Importing this package registers the methods the port brings: PPO, SFT, RFT
and ILQL. GRPO comes with a later slice (``data.method_configs.LATER_METHODS``)."""

from trlx_tpu_torch.methods.ilql import ILQLConfig
from trlx_tpu_torch.methods.ppo import AdaptiveKLController, FixedKLController, PPOConfig
from trlx_tpu_torch.methods.rft import RFTConfig
from trlx_tpu_torch.methods.sft import SFTConfig

__all__ = ["PPOConfig", "SFTConfig", "RFTConfig", "ILQLConfig", "AdaptiveKLController", "FixedKLController"]
