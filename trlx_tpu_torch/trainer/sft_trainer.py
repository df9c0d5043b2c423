"""SFT trainer (counterpart of ``trlx_tpu/trainer/sft_trainer.py``, causal
path): supervised fine-tuning on strings or (prompt, output) dialogues with
prompt-masked cross-entropy.

A batch is padded to a pow2 bucket (8 .. 8192) in length and to a multiple
of the microbatch count in rows; padded rows are fully masked (attention
mask 0, labels ignored). On the card every loss forward runs the flash
forward kernel and every backward the dK/dV and dQ kernels, once per layer
and microbatch, when the model config says ``attention_impl="flash"``; a
fully masked row gives zero attention output and zero gradient there.

The seq2seq branch (T5) raises ``NotImplementedError`` naming the seq2seq
slice (``mesh_trainer.check_port_config``).
"""

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.methods.sft import SFTConfig
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.ops.generation import pad_to_bucket
from trlx_tpu_torch.pipeline.offline_pipeline import DialogStore, tokenize_dialogue
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.mesh_trainer import POW2_BUCKETS, MeshRLTrainer
from trlx_tpu_torch.utils.modeling import flatten_dict


class SFTBatch(dict):
    """A collated SFT batch (``input_ids``, ``attention_mask``, ``labels``)
    that splits into equal microbatches along the batch dim."""

    def split(self, n: int) -> List["SFTBatch"]:
        B = len(self["input_ids"])
        if B % n:
            raise ValueError(f"batch of {B} does not split into {n} microbatches")
        m = B // n
        return [SFTBatch({k: v[i * m:(i + 1) * m] for k, v in self.items()}) for i in range(n)]


@register_trainer
class SFTTrainer(MeshRLTrainer):
    def __init__(self, config: TRLConfig, **kwargs):
        if not isinstance(config.method, SFTConfig):
            raise ValueError("SFTTrainer requires method=SFTConfig")
        super().__init__(config, **kwargs)
        self.method: SFTConfig = config.method
        self._train_step_fn = None

    def setup_model(self):
        """The trunk from ``load_pretrained``: random weights from the seed,
        then a loaded checkpoint's tensors over them."""
        # parameter names "transformer.*", as the JAX trainer's params tree
        self.model = nn.ModuleDict({"transformer": self.load_trunk(TransformerLM)})

    def gen_step_fn(self, policy=None):
        trunk = (self.model if policy is None else policy).transformer

        def step(ids, mask, positions, cache):
            # generate() samples from the last position only
            logits, hidden, _, cache = trunk(ids, mask, positions, cache, last_only=True)
            return logits, hidden, cache

        return step, trunk.init_cache

    def make_experience(self, samples: List, seq_length: int):
        """Tokenize the samples (strings or dialogues) into the DialogStore."""
        dialogs = [tokenize_dialogue(s, self.tokenizer, seq_length) for s in samples]
        self.store = DialogStore(dialogs, self.tokenizer)

    def create_train_dataloader(self):
        return self.store.create_loader(self.config.train.batch_size, shuffle=True, seed=self.config.train.seed)

    def prepare_learning(self):
        bs = self.config.train.batch_size
        self.num_mb = max(1, bs // (self.config.train.minibatch_size or bs))

    def loss_fn(self, mb: SFTBatch):
        """(loss, flat stats) of one device microbatch."""
        logits, _, _, _ = self.model.transformer(mb["input_ids"], mb["attention_mask"])
        ignore = mb["labels"] == DialogStore.IGNORE_INDEX
        loss_mask = (~ignore).to(torch.float32)
        labels = torch.where(ignore, torch.zeros_like(mb["labels"]), mb["labels"])
        loss, stats = self.method.loss(logits, labels, loss_mask * mb["attention_mask"])
        return loss, flatten_dict(stats)

    def train_step(self, batch) -> Dict[str, float]:
        B, T = batch["input_ids"].shape
        Tb = pad_to_bucket(T, POW2_BUCKETS)
        # pad rows to a num_mb multiple (fully masked rows contribute zero loss)
        Bp = ((B + self.num_mb - 1) // self.num_mb) * self.num_mb
        pad = ((0, Bp - B), (0, Tb - T))
        padded = {
            "input_ids": np.pad(batch["input_ids"], pad, constant_values=self.tokenizer.pad_token_id),
            "attention_mask": np.pad(batch["attention_mask"], pad),
            "labels": np.pad(batch["labels"], pad, constant_values=DialogStore.IGNORE_INDEX),
        }
        if self._train_step_fn is None:
            self._train_step_fn = self.make_grad_accum_step(self.loss_fn, self.num_mb)
        return self._train_step_fn(SFTBatch({k: torch.from_numpy(v).to(self.device) for k, v in padded.items()}))
