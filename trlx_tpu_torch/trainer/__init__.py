"""Trainer registry + abstract base (counterpart of ``trlx_tpu/trainer``).
Importing this package registers the trainers the port brings: PPO, GRPO,
SFT, RFT and ILQL."""

from abc import abstractmethod
from typing import Callable, Dict, List, Optional

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.utils.registry import make_registry

_TRAINERS: Dict[str, type] = {}

#: Decorator registering a trainer class by (lowercased) name.
register_trainer = make_registry(_TRAINERS)

class BaseRLTrainer:
    """Abstract trainer protocol: {learn, push_to_store, add pipelines}."""

    def __init__(
        self,
        config: TRLConfig,
        reward_fn: Optional[Callable] = None,
        metric_fn: Optional[Callable] = None,
        stop_sequences: Optional[List[str]] = None,
        **kwargs,
    ):
        self.config = config
        self.reward_fn = reward_fn
        self.metric_fn = metric_fn
        self.stop_sequences = stop_sequences or []

    def push_to_store(self, data):
        self.store.push(data)

    def add_prompt_pipeline(self, pipeline):
        """Attach the rollout prompt pipeline (PPO)."""
        raise NotImplementedError

    def add_eval_pipeline(self, eval_pipeline):
        self.eval_pipeline = eval_pipeline

    @abstractmethod
    def learn(self):
        """Run the training loop."""
        ...


from trlx_tpu_torch.trainer.mesh_trainer import MeshRLTrainer  # noqa: E402,F401
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer  # noqa: E402,F401
from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer  # noqa: E402,F401
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer  # noqa: E402,F401
from trlx_tpu_torch.trainer.rft_trainer import RFTTrainer  # noqa: E402,F401
from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer  # noqa: E402,F401
