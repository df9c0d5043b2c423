"""ILQL trainer (counterpart of ``trlx_tpu/trainer/ilql_trainer.py``, causal
path): offline experience building (standardized returns on the last
action, action and state index bookkeeping), the ILQL loss step, the
periodic Polyak sync of the target Q heads, and the advantage-shaped
generation of evaluation (``beta`` times the target-Q advantage added to
the logits, and an optional next-token ``logit_mask``).

On the card every loss forward runs the flash forward kernel and every
backward the dK/dV and dQ kernels, once per layer and microbatch, and every
generation prefill the flash forward, when the model config says
``attention_impl="flash"``. With ``model.model_arch_type="seq2seq"`` the
model is T5 with ILQL heads over the decoder (:func:`make_experience_seq2seq`:
the prompt segments are the encoder input, the output segments the decoder
tokens and the actions), on the plain attention path.
"""

from functools import reduce
from typing import Dict

import numpy as np
import torch

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.ilql_types import ILQLBatch, ILQLSeq2SeqBatch
from trlx_tpu_torch.methods.ilql import ILQLConfig, batched_index_select
from trlx_tpu_torch.models.heads import sync_target_q_heads
from trlx_tpu_torch.models.policy import CausalLMWithILQLHeads, Seq2SeqLMWithILQLHeads
from trlx_tpu_torch.ops.generation import pad_to_bucket
from trlx_tpu_torch.pipeline.offline_pipeline import (
    ILQLRolloutStorage,
    ILQLSeq2SeqRolloutStorage,
    tokenize_dialogue,
)
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.mesh_trainer import MeshRLTrainer
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.modeling import flatten_dict

logger = logging.get_logger(__name__)

#: the padding ladder of a training batch's length and action count (4 .. 8192)
BUCKETS = [2 ** i for i in range(2, 14)]


def make_experience(samples, rewards, tokenizer=None, max_length: int = 2048,
                    verbose: bool = True) -> ILQLRolloutStorage:
    """Tokenize dialogues and compute ILQL's index bookkeeping: per sample,
    ``actions_ixs`` are the positions whose *next* token is an output token,
    ``states_ixs`` the actions plus the terminal position, ``dones`` 1 but
    at the terminal state; rewards are the standardized returns placed on
    the last action."""
    if verbose:
        logger.info("Collecting rollouts")
    if tokenizer is not None:
        samples = [tokenize_dialogue(s, tokenizer, max_length) for s in samples]

    all_input_ids, all_actions_ixs, all_states_ixs, all_dones = [], [], [], []
    for sample in samples:
        length = 0
        input_ids = np.asarray([t for msg in sample for t in msg.tokens], np.int32)
        all_input_ids.append(input_ids)
        actions_ixs = []
        for dm in sample:
            if dm.is_output:
                actions_ixs.append(np.arange(length - 1, length + len(dm.tokens) - 1))
            length += len(dm.tokens)
        states_ixs = np.concatenate([*actions_ixs, [length - 1]])
        all_dones.append(np.asarray([1] * (len(states_ixs) - 1) + [0], np.int32))
        all_actions_ixs.append(np.concatenate(actions_ixs).astype(np.int32))
        all_states_ixs.append(states_ixs.astype(np.int32))

    attention_mask = [np.ones(len(x), np.int32) for x in all_input_ids]
    return ILQLRolloutStorage(
        all_input_ids, attention_mask, _standardized_last_rewards(rewards, all_actions_ixs), all_states_ixs,
        all_actions_ixs, all_dones,
    )


def _standardized_last_rewards(rewards, all_actions_ixs):
    """Per-sample rewards: zeros, the standardized return on the last action."""
    returns = np.asarray(rewards, np.float64)
    returns = returns - returns.mean()
    std = returns.std()
    if not np.isnan(std) and std > 0:
        returns = returns / (std + np.finfo(returns.dtype).eps)
    rewards_per_token = [np.zeros(len(x), np.float32) for x in all_actions_ixs]
    for rs, ret in zip(rewards_per_token, returns):
        rs[-1] = ret
    return rewards_per_token


def make_experience_seq2seq(samples, rewards, tokenizer=None, max_length: int = 2048,
                            verbose: bool = True) -> ILQLSeq2SeqRolloutStorage:
    """Seq2seq ILQL experience: the encoder input is the prompt segments'
    tokens, the decoder tokens the output segments'; actions are decoder
    positions ``0 .. max(len - 1, 1) - 1``, states the actions and the last,
    and the standardized return sits on the last action."""
    if verbose:
        logger.info("Collecting rollouts (seq2seq)")
    if tokenizer is not None:
        samples = [tokenize_dialogue(s, tokenizer, max_length) for s in samples]

    all_input_ids, all_output_ids, all_actions_ixs, all_states_ixs, all_dones = [], [], [], [], []
    for sample in samples:
        all_input_ids.append(np.asarray([t for m in sample if not m.is_output for t in m.tokens], np.int32))
        out = np.asarray([t for m in sample if m.is_output for t in m.tokens], np.int32)
        all_output_ids.append(out)
        actions_ixs = np.arange(0, max(len(out) - 1, 1))
        states_ixs = np.concatenate([actions_ixs, [max(len(out) - 1, 1)]])
        all_dones.append(np.asarray([1] * (len(states_ixs) - 1) + [0], np.int32))
        all_actions_ixs.append(actions_ixs.astype(np.int32))
        all_states_ixs.append(states_ixs.astype(np.int32))

    attention_mask = [np.ones(len(x), np.int32) for x in all_input_ids]
    return ILQLSeq2SeqRolloutStorage(
        all_input_ids, attention_mask, all_output_ids, _standardized_last_rewards(rewards, all_actions_ixs),
        all_states_ixs, all_actions_ixs, all_dones,
    )


@register_trainer
class ILQLTrainer(MeshRLTrainer):
    def __init__(self, config: TRLConfig, logit_mask=None, **kwargs):
        if not isinstance(config.method, ILQLConfig):
            raise ValueError("ILQLTrainer requires method=ILQLConfig")
        super().__init__(config, **kwargs)
        self.method: ILQLConfig = config.method
        # `beta` shapes decode logits; it is not a generation-loop kwarg. A
        # list stays in generate_kwargs so evaluate() sweeps it, and
        # pop_gen_processor_kwargs routes each call's value to the logits
        # processor; the default beta is the first entry
        beta = self.generate_kwargs.get("beta", 1.0)
        if isinstance(beta, (list, tuple)):
            # evaluate()'s sweep detection matches lists only
            self.generate_kwargs["beta"] = list(beta)
            self.ilql_beta = float(beta[0])
        else:
            self.ilql_beta = float(self.generate_kwargs.pop("beta", 1.0))
        # optional [V, V] next-token transition mask: row = previous token
        self.logit_mask = None if logit_mask is None else np.asarray(logit_mask, bool)
        self._train_step_fn = None

    def setup_model(self):
        """Trunk (or T5) + ILQL heads, random weights from the seed, a loaded
        checkpoint's trunk over them; the target heads start equal to the Q
        heads."""
        two_qs = self.config.method.two_qs
        if self.is_seq2seq:
            self.model = self.load_t5(lambda config: Seq2SeqLMWithILQLHeads(config, two_qs=two_qs))
        else:
            self.model = self.load_trunk(lambda config: CausalLMWithILQLHeads(config, two_qs=two_qs))
        sync_target_q_heads(self.model.ilql_heads, alpha=1.0)

    def trainable_path_predicate(self, path: str) -> bool:
        if "target_q_heads" in path:
            return False  # target heads update only through the Polyak sync
        return super().trainable_path_predicate(path)

    # ------------------------------------------------------------- generation

    def gen_step_fn(self, policy=None):
        trunk = (self.model if policy is None else policy).transformer

        def step(ids, mask, positions, cache):
            # generate() samples from the last position only
            logits, hidden, _, cache = trunk(ids, mask, positions, cache, last_only=True)
            return logits, hidden, cache

        return step, trunk.init_cache

    def pop_gen_processor_kwargs(self, gen_kwargs):
        if "beta" in gen_kwargs:
            val = gen_kwargs.pop("beta")
            # an un-swept list: its first entry
            beta = float(val[0]) if isinstance(val, (list, tuple)) else float(val)
            return {"beta": beta}
        return {}

    def gen_logits_processor(self, beta=None):
        """Add ``beta * (min target Q - V)`` of the ILQL heads on the decode
        hidden state to the logits; with a ``logit_mask``, tokens that may
        not follow the previous token get -1e10."""
        model = self.model
        beta = self.ilql_beta if beta is None else beta
        logit_mask = None if self.logit_mask is None else torch.as_tensor(self.logit_mask, device=self.device)

        def processor(hidden, logits, prev_tok):
            _, target_qs, vs = model.heads_only(hidden[:, None, :])
            q = reduce(torch.minimum, target_qs)
            adv = q[:, 0, :] - vs[:, 0, :]
            shaped = logits + beta * adv
            if logit_mask is not None:
                allowed = logit_mask[prev_tok.long()]  # [B, V]
                shaped = torch.where(allowed, shaped, torch.full_like(shaped, -1e10))
            return shaped

        return processor

    # ------------------------------------------------------------- experience

    def make_experience(self, samples, rewards, max_length: int = 2048):
        build = make_experience_seq2seq if self.is_seq2seq else make_experience
        self.store = build(samples, rewards, self.tokenizer, max_length)

    # ------------------------------------------------------------- train loop

    def prepare_learning(self):
        bs = self.config.train.batch_size
        self.num_mb = max(1, bs // (self.config.train.minibatch_size or bs))

    def create_train_dataloader(self):
        return self.store.create_loader(self.config.train.batch_size, shuffle=True, seed=self.config.train.seed)

    def loss_fn(self, mb: ILQLBatch):
        """(loss, flat stats) of one device microbatch."""
        logits, qs, target_qs, vs, _ = self.model(
            mb.input_ids, mb.attention_mask, None, mb.actions_ixs, mb.states_ixs
        )
        action_logits = batched_index_select(logits, mb.actions_ixs)
        loss, stats = self.method.loss((action_logits, (qs, target_qs, vs)), mb)
        return loss, flatten_dict(stats)

    def loss_fn_s2s(self, mb: ILQLSeq2SeqBatch):
        """(loss, flat stats) of one seq2seq device microbatch."""
        logits, qs, target_qs, vs = self.model(
            mb.input_ids, mb.attention_mask, mb.decoder_input_ids, None, mb.actions_ixs, mb.states_ixs
        )
        action_logits = batched_index_select(logits, mb.actions_ixs)
        loss, stats = self.method.loss((action_logits, (qs, target_qs, vs)), mb)
        return loss, flatten_dict(stats)

    def train_step(self, batch: ILQLBatch) -> Dict[str, float]:
        """One optimizer step; the batch's length and action count pad up
        to :data:`BUCKETS` first (padding is masked: attention 0, dones 0).
        Seq2seq: the decoder length pads to one more than the padded action
        count (the loss reads the actions from ``decoder_input_ids[:, 1:]``)."""
        pad2 = lambda x, n, v=0: np.pad(np.asarray(x), ((0, 0), (0, n - x.shape[1])), constant_values=v)
        if self.is_seq2seq:
            T, D, A = batch.input_ids.shape[1], batch.decoder_input_ids.shape[1], batch.actions_ixs.shape[1]
            Tb, Ab = pad_to_bucket(T, BUCKETS), pad_to_bucket(max(A, D - 1), BUCKETS)
            padded = ILQLSeq2SeqBatch(
                input_ids=pad2(batch.input_ids, Tb, self.tokenizer.pad_token_id),
                attention_mask=pad2(batch.attention_mask, Tb),
                decoder_input_ids=pad2(batch.decoder_input_ids, Ab + 1, self.tokenizer.pad_token_id),
                rewards=pad2(batch.rewards, Ab, 0.0),
                states_ixs=pad2(batch.states_ixs, Ab + 1),
                actions_ixs=pad2(batch.actions_ixs, Ab),
                dones=pad2(batch.dones, Ab + 1),
            )
            if self._train_step_fn is None:
                self._train_step_fn = self.make_grad_accum_step(self.loss_fn_s2s, self.num_mb)
            return self._train_step_fn(padded.to(self.device))
        T, A = batch.input_ids.shape[1], batch.actions_ixs.shape[1]
        Tb, Ab = pad_to_bucket(T, BUCKETS), pad_to_bucket(A, BUCKETS)
        padded = ILQLBatch(
            input_ids=pad2(batch.input_ids, Tb, self.tokenizer.pad_token_id),
            attention_mask=pad2(batch.attention_mask, Tb),
            rewards=pad2(batch.rewards, Ab, 0.0),
            states_ixs=pad2(batch.states_ixs, Ab + 1),
            actions_ixs=pad2(batch.actions_ixs, Ab),
            dones=pad2(batch.dones, Ab + 1),
        )
        if self._train_step_fn is None:
            self._train_step_fn = self.make_grad_accum_step(self.loss_fn, self.num_mb)
        return self._train_step_fn(padded.to(self.device))

    def post_backward_callback(self):
        """Polyak-sync the target Q heads every ``steps_for_target_q_sync`` steps."""
        if self.iter_count % self.method.steps_for_target_q_sync == 0:
            sync_target_q_heads(self.model.ilql_heads, self.method.alpha)
