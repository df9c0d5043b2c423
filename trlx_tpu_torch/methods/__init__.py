"""RL method definitions: each algorithm is a registered MethodConfig
dataclass that owns its loss (counterpart of ``trlx_tpu/methods``).
Importing this package registers the methods the port brings: PPO, GRPO,
SFT, RFT and ILQL."""

from trlx_tpu_torch.methods.grpo import GRPOConfig
from trlx_tpu_torch.methods.ilql import ILQLConfig
from trlx_tpu_torch.methods.ppo import AdaptiveKLController, FixedKLController, PPOConfig
from trlx_tpu_torch.methods.rft import RFTConfig
from trlx_tpu_torch.methods.sft import SFTConfig

__all__ = [
    "PPOConfig", "GRPOConfig", "SFTConfig", "RFTConfig", "ILQLConfig", "AdaptiveKLController", "FixedKLController",
]
