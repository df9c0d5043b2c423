"""ILQL datatypes (counterpart of ``trlx_tpu/data/ilql_types.py``, causal
and seq2seq): plain dataclasses of host numpy arrays or torch tensors. The JAX
package makes them ``flax.struct`` pytrees; the port moves a batch to its
device field by field (:meth:`ILQLBatch.to`) and splits it into
microbatches (:meth:`ILQLBatch.split`)."""

from dataclasses import dataclass, fields
from typing import Any


@dataclass
class ILQLElement:
    """One tokenized sample: its tokens, per-action rewards and the index
    bookkeeping of :func:`trlx_tpu_torch.trainer.ilql_trainer.make_experience`."""

    input_ids: Any  # [T]
    attention_mask: Any  # [T]
    rewards: Any  # [A]
    states_ixs: Any  # [A+1]
    actions_ixs: Any  # [A]
    dones: Any  # [A+1]


class _Batch:
    """Moving a collated batch to a device and splitting it into
    microbatches, field by field."""

    def to(self, device):
        """The batch as torch tensors on ``device``."""
        import torch

        return type(self)(**{f.name: torch.as_tensor(getattr(self, f.name)).to(device) for f in fields(self)})

    def split(self, n: int):
        """``n`` equal microbatches along the batch dim (the JAX step's reshape)."""
        B = len(self.input_ids)
        if B % n:
            raise ValueError(f"batch of {B} does not split into {n} microbatches")
        m = B // n
        return [type(self)(**{f.name: getattr(self, f.name)[i * m:(i + 1) * m] for f in fields(self)})
                for i in range(n)]


@dataclass
class ILQLBatch(_Batch):
    """Collated ILQL samples, every field right-padded."""

    input_ids: Any  # [B, T]
    attention_mask: Any  # [B, T]
    rewards: Any  # [B, A]
    states_ixs: Any  # [B, A+1]
    actions_ixs: Any  # [B, A]
    dones: Any  # [B, A+1]


@dataclass
class ILQLSeq2SeqElement:
    """One seq2seq sample: encoder tokens, decoder tokens (the output, no
    start token), per-action rewards and the index bookkeeping of
    :func:`trlx_tpu_torch.trainer.ilql_trainer.make_experience_seq2seq`."""

    input_ids: Any  # [S]
    attention_mask: Any  # [S]
    decoder_input_ids: Any  # [T]
    rewards: Any  # [A]
    states_ixs: Any  # [A+1]
    actions_ixs: Any  # [A]
    dones: Any  # [A+1]


@dataclass
class ILQLSeq2SeqBatch(_Batch):
    """Collated seq2seq ILQL samples, every field right-padded; the loss
    takes the actions from ``decoder_input_ids[:, 1:]``."""

    input_ids: Any  # [B, S]
    attention_mask: Any  # [B, S]
    decoder_input_ids: Any  # [B, T]
    rewards: Any  # [B, A]
    states_ixs: Any  # [B, A+1]
    actions_ixs: Any  # [B, A]
    dones: Any  # [B, A+1]
