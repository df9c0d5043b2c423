"""Prompt and dialogue pipelines (counterpart of
``trlx_tpu/pipeline/offline_pipeline.py``): ``PromptPipeline``, and for SFT
``tokenize_dialogue`` (truncation-side aware interleaved dialogue
tokenization) and ``DialogStore`` (prompt labels masked with -100), and
for ILQL ``ILQLRolloutStorage`` with its collate function. Collation is
numpy; trainers move batches to their device."""

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Tuple, Union

import numpy as np

from trlx_tpu_torch.data.ilql_types import ILQLBatch, ILQLElement, ILQLSeq2SeqBatch, ILQLSeq2SeqElement
from trlx_tpu_torch.pipeline import BasePipeline, BaseRolloutStore, NumpyLoader, register_datapipeline


@dataclass
class DialogMessage:
    """One dialogue phrase: output (model) or prompt (user) tokens."""

    is_output: bool
    tokens: Tuple[int, ...]


def tokenize_dialogue(dialogue, tokenizer, max_length: int = 2048) -> List[DialogMessage]:
    """Tokenize an interleaved (prompt_1, output_1, prompt_2, ...) dialogue,
    or a single string (an output after a bos prompt), to at most
    ``max_length`` tokens: an eos is appended to the last phrase, truncation
    takes tokens from the tokenizer's ``truncation_side``, and a bos is
    re-inserted when the leading prompt was truncated away."""
    if isinstance(dialogue, str):
        bos_token = getattr(tokenizer, "bos_token", None) or tokenizer.eos_token
        dialogue = [bos_token, dialogue]
    else:
        dialogue = list(dialogue)
        if len(dialogue) % 2 != 0:
            raise ValueError("Dialogue must have an even number of phrases, alternating prompt and output")

    if not dialogue[-1].endswith(tokenizer.eos_token):
        dialogue[-1] = dialogue[-1] + tokenizer.eos_token

    tokenized = [
        DialogMessage(is_output=i % 2 == 1, tokens=tuple(tokenizer(dialogue[i], add_special_tokens=False).input_ids))
        for i in range(len(dialogue))
    ]

    # flip so truncation always removes from the far end of the chosen side
    if tokenizer.truncation_side == "left":
        tokenized = [DialogMessage(m.is_output, m.tokens[::-1]) for m in tokenized[::-1]]

    lengths = [len(t.tokens) for t in tokenized]
    cumsum_lengths = [sum(lengths[:i]) for i in range(len(lengths))]
    truncated = [
        DialogMessage(t.is_output, t.tokens[: max(max_length - cl, 0)])
        for t, cl in zip(tokenized, cumsum_lengths)
    ]

    if tokenizer.truncation_side == "left":
        truncated = [DialogMessage(m.is_output, m.tokens[::-1]) for m in truncated[::-1]]

    out = [t for t in truncated if len(t.tokens) > 0]

    if out and out[0].is_output:
        # leading prompt was fully truncated: re-insert a bos, trimming one token
        # if the dialogue already saturates max_length
        if sum(len(m.tokens) for m in out) == max_length:
            if tokenizer.truncation_side == "left":
                out[0] = DialogMessage(out[0].is_output, out[0].tokens[1:])
            else:
                out[-1] = DialogMessage(out[-1].is_output, out[-1].tokens[:-1])
        bos = getattr(tokenizer, "bos_token_id", None)
        if bos is None:
            bos = tokenizer.eos_token_id
        out.insert(0, DialogMessage(False, (bos,)))
    return out


@register_datapipeline
class PromptPipeline(BasePipeline):
    """Tokenizes and stores prompts; prompts may be dicts carrying extra
    metadata keys, which are forwarded to reward/metric functions."""

    def __init__(self, prompts: List[Union[str, Dict[str, Any]]], max_prompt_length: int,
                 tokenizer, add_special_tokens: bool = False):
        super().__init__()
        self.tokenizer = tokenizer

        if prompts and isinstance(prompts[0], dict):
            metadata = [dict(p) for p in prompts]
            prompts = [m.pop("prompt") for m in metadata]
        else:
            metadata = [{}] * len(prompts)

        self.prompts = []
        for prompt, meta in zip(prompts, metadata):
            ids = tokenizer(prompt, add_special_tokens=add_special_tokens).input_ids
            if tokenizer.truncation_side == "left":
                ids = ids[-max_prompt_length:]
            else:
                ids = ids[:max_prompt_length]
            self.prompts.append({"input_ids": ids, **meta})

    def __getitem__(self, ix: int):
        return self.prompts[ix]

    def __len__(self) -> int:
        return len(self.prompts)

    def create_loader(self, batch_size: int, shuffle: bool = False, drop_last: bool = False,
                      seed: int = 0) -> NumpyLoader:
        def collate(xs: List[dict]) -> Dict[str, Any]:
            out: Dict[str, Any] = {
                "input_ids": [np.asarray(x["input_ids"], np.int32) for x in xs]
            }
            for key in xs[0]:
                if key != "input_ids":
                    out[key] = [x[key] for x in xs]
            return out

        return NumpyLoader(self, batch_size, collate, shuffle=shuffle, drop_last=drop_last, seed=seed)


class DialogStore(BaseRolloutStore):
    """SFT store of tokenized dialogues: ``input_ids``, ``attention_mask``
    and ``labels`` with prompt tokens masked as ``IGNORE_INDEX``; batches
    are right-padded."""

    IGNORE_INDEX = -100

    def __init__(self, dialogs: List[List[DialogMessage]], tokenizer):
        super().__init__()
        self.tokenizer = tokenizer
        self.history = []
        for d in dialogs:
            ids = [t for m in d for t in m.tokens]
            labels = [t if m.is_output else self.IGNORE_INDEX for m in d for t in m.tokens]
            self.history.append(
                dict(
                    input_ids=np.asarray(ids, np.int32),
                    attention_mask=np.ones(len(ids), np.int32),
                    labels=np.asarray(labels, np.int32),
                )
            )

    def __getitem__(self, ix: int):
        return self.history[ix]

    def create_loader(self, batch_size: int, shuffle: bool = False, seed: int = 0) -> NumpyLoader:
        pad = self.tokenizer.pad_token_id

        def collate(xs):
            return dict(
                input_ids=_rpad_stack([x["input_ids"] for x in xs], pad),
                attention_mask=_rpad_stack([x["attention_mask"] for x in xs], 0),
                labels=_rpad_stack([x["labels"] for x in xs], self.IGNORE_INDEX),
            )

        return NumpyLoader(self.history, batch_size, collate, shuffle=shuffle, seed=seed)


def _rpad_stack(rows: List[np.ndarray], value) -> np.ndarray:
    T = max(len(r) for r in rows)
    out = np.full((len(rows), T), value, dtype=np.asarray(rows[0]).dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def ilql_collate_fn(elems: Iterable[ILQLElement]) -> ILQLBatch:
    """Right-pad every field of the elements into one :class:`ILQLBatch`
    (zeros; rewards 0.0)."""
    elems = list(elems)
    return ILQLBatch(
        _rpad_stack([x.input_ids for x in elems], 0),
        _rpad_stack([x.attention_mask for x in elems], 0),
        _rpad_stack([x.rewards for x in elems], 0.0),
        _rpad_stack([x.states_ixs for x in elems], 0),
        _rpad_stack([x.actions_ixs for x in elems], 0),
        _rpad_stack([x.dones for x in elems], 0),
    )


class ILQLRolloutStorage(BaseRolloutStore):
    """Offline ILQL storage: per-sample token, reward and index arrays."""

    def __init__(self, input_ids, attention_mask, rewards, states_ixs, actions_ixs, dones):
        super().__init__()
        self.input_ids = input_ids
        self.attention_mask = attention_mask
        self.rewards = rewards
        self.states_ixs = states_ixs
        self.actions_ixs = actions_ixs
        self.dones = dones

    def __getitem__(self, ix: int) -> ILQLElement:
        return ILQLElement(
            self.input_ids[ix], self.attention_mask[ix], self.rewards[ix],
            self.states_ixs[ix], self.actions_ixs[ix], self.dones[ix],
        )

    def __len__(self) -> int:
        return len(self.input_ids)

    def create_loader(self, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                      seed: int = 0) -> NumpyLoader:
        """Batches of ``batch_size`` (the last partial one dropped), each
        pass shuffled from ``seed`` + pass number, as the JAX loader."""
        return NumpyLoader(self, batch_size, ilql_collate_fn, shuffle=shuffle, drop_last=drop_last, seed=seed)


def ilql_seq2seq_collate_fn(elems: Iterable[ILQLSeq2SeqElement]) -> ILQLSeq2SeqBatch:
    """Right-pad every field of the seq2seq elements into one
    :class:`ILQLSeq2SeqBatch` (tokens with 0, as the causal collate)."""
    elems = list(elems)
    return ILQLSeq2SeqBatch(
        _rpad_stack([x.input_ids for x in elems], 0),
        _rpad_stack([x.attention_mask for x in elems], 0),
        _rpad_stack([x.decoder_input_ids for x in elems], 0),
        _rpad_stack([x.rewards for x in elems], 0.0),
        _rpad_stack([x.states_ixs for x in elems], 0),
        _rpad_stack([x.actions_ixs for x in elems], 0),
        _rpad_stack([x.dones for x in elems], 0),
    )


class ILQLSeq2SeqRolloutStorage(BaseRolloutStore):
    """Offline seq2seq ILQL storage: encoder and decoder tokens per sample."""

    def __init__(self, input_ids, attention_mask, decoder_input_ids, rewards, states_ixs, actions_ixs, dones):
        super().__init__()
        self.input_ids = input_ids
        self.attention_mask = attention_mask
        self.decoder_input_ids = decoder_input_ids
        self.rewards = rewards
        self.states_ixs = states_ixs
        self.actions_ixs = actions_ixs
        self.dones = dones

    def __getitem__(self, ix: int) -> ILQLSeq2SeqElement:
        return ILQLSeq2SeqElement(
            self.input_ids[ix], self.attention_mask[ix], self.decoder_input_ids[ix],
            self.rewards[ix], self.states_ixs[ix], self.actions_ixs[ix], self.dones[ix],
        )

    def __len__(self) -> int:
        return len(self.input_ids)

    def create_loader(self, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                      seed: int = 0) -> NumpyLoader:
        return NumpyLoader(self, batch_size, ilql_seq2seq_collate_fn, shuffle=shuffle, drop_last=drop_last,
                           seed=seed)
