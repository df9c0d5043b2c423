"""RFT (rejection fine-tuning, ReST-style) method config (counterpart of
``trlx_tpu/methods/rft.py``): N generations per prompt, scored by the reward
function, filtered by a per-prompt percentile threshold that rises over
``n_improve_steps``, deduplicated, then SFT on the survivors."""

from dataclasses import dataclass, field
from typing import Any, Dict

from trlx_tpu_torch.data.method_configs import register_method
from trlx_tpu_torch.methods.sft import SFTConfig


@register_method
@dataclass
class RFTConfig(SFTConfig):
    """:param n_generations_per_prompt: samples drawn per prompt each improve step.
    :param start_percentile / end_percentile: score-filter schedule bounds.
    :param n_improve_steps: how many filtering iterations per epoch.
    :param n_residual_prompts: prompts kept for logging unfiltered stats."""

    name: str = "RFTConfig"
    n_generations_per_prompt: int = 4
    start_percentile: float = 0.7
    end_percentile: float = 0.95
    n_improve_steps: int = 4
    n_residual_prompts: int = 0
    gen_kwargs: Dict[str, Any] = field(
        default_factory=lambda: dict(max_new_tokens=32, temperature=1.0, do_sample=True)
    )
