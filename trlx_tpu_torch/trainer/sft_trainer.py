"""SFT trainer (counterpart of ``trlx_tpu/trainer/sft_trainer.py``, causal
path): supervised fine-tuning on strings or (prompt, output) dialogues with
prompt-masked cross-entropy.

A batch is padded to a pow2 bucket (8 .. 8192) in length and to a multiple
of the microbatch count in rows; padded rows are fully masked (attention
mask 0, labels ignored). On the card every loss forward runs the flash
forward kernel and every backward the dK/dV and dQ kernels, once per layer
and microbatch, when the model config says ``attention_impl="flash"``; a
fully masked row gives zero attention output and zero gradient there.

With ``model.model_arch_type="seq2seq"`` the model is a T5
(``model.t5``): each dialogue's prompt segments become the encoder input
and its output segments the decoder target (:class:`Seq2SeqSFTStore`), the
loss is teacher-forced cross-entropy over the target (the decoder reads the
start token and the target shifted right), and encoder and target lengths
pad to the pow2 ladder independently. T5 attends on the plain path: no
kernel runs there.
"""

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.methods.sft import SFTConfig
from trlx_tpu_torch.models.t5 import T5LM
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.ops.generation import pad_to_bucket
from trlx_tpu_torch.parallel.collectives import batch_sum
from trlx_tpu_torch.pipeline import NumpyLoader
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


def _resolve_pad_id(tokenizer):
    """``pad_token_id``, falling back to ``eos_token_id``; None when both are."""
    pad = tokenizer.pad_token_id
    if pad is None:
        pad = getattr(tokenizer, "eos_token_id", None)
    return pad


class Seq2SeqSFTStore:
    """(encoder prompt ids, decoder target ids) pairs, right-padded at
    collate: ``input_ids`` / ``attention_mask`` with the pad id, ``labels``
    with ``IGNORE_INDEX``."""

    IGNORE_INDEX = DialogStore.IGNORE_INDEX

    def __init__(self, pairs, tokenizer):
        self.pairs = pairs  # list of (enc_ids, dec_ids) int arrays
        self.tokenizer = tokenizer
        self.pad_id = _resolve_pad_id(tokenizer)
        if self.pad_id is None:
            raise ValueError(
                "Seq2SeqSFTStore requires a tokenizer with pad_token_id (or eos_token_id as a fallback); "
                f"both are None on {type(tokenizer).__name__}"
            )

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, ix):
        return self.pairs[ix]

    def create_loader(self, batch_size: int, shuffle: bool = True, drop_last: bool = True, seed: int = 0):
        pad = self.pad_id

        def collate(items):
            enc_w = max(len(e) for e, _ in items)
            dec_w = max(len(d) for _, d in items)
            B = len(items)
            out = {
                "input_ids": np.full((B, enc_w), pad, np.int32),
                "attention_mask": np.zeros((B, enc_w), np.int32),
                "labels": np.full((B, dec_w), self.IGNORE_INDEX, np.int32),
            }
            for i, (e, d) in enumerate(items):
                out["input_ids"][i, : len(e)] = e
                out["attention_mask"][i, : len(e)] = 1
                out["labels"][i, : len(d)] = d
            return out

        return NumpyLoader(self, batch_size, collate, shuffle=shuffle, drop_last=drop_last, seed=seed)


@register_trainer
class SFTTrainer(MeshRLTrainer):
    def __init__(self, config: TRLConfig, **kwargs):
        if not isinstance(config.method, SFTConfig):
            raise ValueError("SFTTrainer requires method=SFTConfig")
        super().__init__(config, **kwargs)
        self.method: SFTConfig = config.method
        self._train_step_fn = None

    def setup_model(self):
        """The trunk from ``load_pretrained`` (a seq2seq model: the T5 from
        ``load_pretrained_seq2seq``): random weights from the seed, then a
        loaded checkpoint's tensors over them."""
        if self.is_seq2seq:
            # parameter names "t5.*", as the JAX trainer's params tree
            self.model = self.load_t5(lambda config: nn.ModuleDict({"t5": T5LM(config)}))
            return
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
        """Tokenize the samples (strings or dialogues) into the DialogStore;
        seq2seq: the prompt segments into the encoder input and the output
        segments into the target (a pair empty after truncation is dropped)."""
        dialogs = [tokenize_dialogue(s, self.tokenizer, seq_length) for s in samples]
        if self.is_seq2seq:
            pairs = []
            for msgs in dialogs:
                enc = [t for m in msgs if not m.is_output for t in m.tokens]
                dec = [t for m in msgs if m.is_output for t in m.tokens]
                if enc and dec:
                    pairs.append((np.asarray(enc, np.int32), np.asarray(dec, np.int32)))
            self.store = Seq2SeqSFTStore(pairs, self.tokenizer)
            return
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

    def loss_fn_s2s(self, mb: SFTBatch):
        """Teacher-forced cross-entropy of one seq2seq microbatch: the decoder
        reads [start, y_0 .. y_{T-2}] and predicts y_t; the mean over the
        target tokens (the logits' log-softmax in f32)."""
        labels = mb["labels"]
        valid = labels != Seq2SeqSFTStore.IGNORE_INDEX
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        ones = torch.ones_like(labels[:, :1])
        dec_in = torch.cat([ones * self.decoder_start_token_id, safe[:, :-1]], dim=1)
        dec_mask = torch.cat([ones, valid[:, :-1].to(labels.dtype)], dim=1)
        logits, _, _ = self.model.t5(mb["input_ids"], mb["attention_mask"], dec_in, dec_mask)
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logprobs, -1, safe.long()[..., None])[..., 0]
        mask = valid.float()
        # the mean over the global batch's target tokens on a mesh (batch_sum: the batch ranks')
        loss = batch_sum((nll * mask).sum()) / torch.clamp(batch_sum(mask.sum()), min=1.0)
        return loss, flatten_dict(dict(losses=dict(loss=loss)))

    def train_step(self, batch) -> Dict[str, float]:
        if self.is_seq2seq:
            return self._train_step_s2s(batch)
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

    def _train_step_s2s(self, batch) -> Dict[str, float]:
        """One seq2seq step: encoder and target lengths pad to the pow2
        ladder, rows to a multiple of the microbatch count (padded rows are
        fully ignored)."""
        B, Te = batch["input_ids"].shape
        Td = batch["labels"].shape[1]
        Teb, Tdb = pad_to_bucket(Te, POW2_BUCKETS), pad_to_bucket(Td, POW2_BUCKETS)
        Bp = ((B + self.num_mb - 1) // self.num_mb) * self.num_mb
        padded = {
            "input_ids": np.pad(batch["input_ids"], ((0, Bp - B), (0, Teb - Te)),
                                constant_values=_resolve_pad_id(self.tokenizer)),
            "attention_mask": np.pad(batch["attention_mask"], ((0, Bp - B), (0, Teb - Te))),
            "labels": np.pad(batch["labels"], ((0, Bp - B), (0, Tdb - Td)),
                             constant_values=Seq2SeqSFTStore.IGNORE_INDEX),
        }
        if self._train_step_fn is None:
            self._train_step_fn = self.make_grad_accum_step(self.loss_fn_s2s, self.num_mb)
        return self._train_step_fn(SFTBatch({k: torch.from_numpy(v).to(self.device) for k, v in padded.items()}))
