"""SFT method config (counterpart of ``trlx_tpu/methods/sft.py``): masked
next-token cross-entropy on (prompt, output) dialogues; ``gen_kwargs`` drive
eval generation."""

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch

from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.parallel.collectives import batch_sum


@register_method
@dataclass
class SFTConfig(MethodConfig):
    name: str = "SFTConfig"
    gen_kwargs: Dict[str, Any] = field(default_factory=lambda: dict(max_new_tokens=32))

    def loss(self, logits: torch.Tensor, labels: torch.Tensor, loss_mask: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Next-token CE: logits [B,T,V] vs labels [B,T], masked by ``loss_mask``
        (0 on prompt tokens when only outputs are supervised).

        As in the JAX package, ``log_softmax``, the mask and its sum run in
        the logits' dtype, the compute dtype: bf16 in a bf16 run."""
        shift_logits = logits[:, :-1]
        shift_labels = labels[:, 1:]
        shift_mask = loss_mask[:, 1:].to(shift_logits.dtype)
        logprobs = torch.log_softmax(shift_logits, dim=-1)
        nll = -torch.gather(logprobs, -1, shift_labels[..., None].long())[..., 0]
        n = torch.clamp(batch_sum(shift_mask.sum()), min=1.0)
        loss = batch_sum(torch.sum(nll * shift_mask)) / n
        return loss, dict(losses=dict(loss=loss))
