"""ILQL method (counterpart of ``trlx_tpu/methods/ilql.py``): the expectile
V loss, the double-Q TD loss, the CQL regularizer and the AWAC-weighted
cross-entropy, with the JAX package's index conventions: heads are read at
state positions (``states_ixs``, one more than the action count), Q values
are gathered at the action token ids, targets take the minimum over the
target Q heads, and every term is normalized by the count of non-terminal
transitions. Every loss sum accumulates in f32, as the reference's."""

from dataclasses import dataclass, field
from functools import reduce
from typing import Any, Dict, Tuple

import torch

from trlx_tpu_torch.analysis.census.entrypoints import Entry, register_entrypoint
from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.parallel.collectives import batch_sum
from trlx_tpu_torch.utils.modeling import masked_mean


def topk_mask(xs: torch.Tensor, k: int) -> torch.Tensor:
    """Set everything below the k-th largest value (last axis) to -inf."""
    if k >= xs.shape[-1]:
        return xs
    mintop = torch.topk(xs, k, dim=-1).values[..., -1:]
    return torch.where(xs < mintop, torch.full_like(xs, -float("inf")), xs)


def batched_index_select(x: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """Gather vectors at ``idxs`` along dim 1: [B, T, H], [B, I] -> [B, I, H]."""
    return torch.gather(x, 1, idxs.long()[..., None].expand(*idxs.shape, x.shape[-1]))


def _take(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[..., ids]`` per position: [B, A, V], [B, A] -> [B, A]."""
    return torch.gather(x, -1, ids.long()[..., None])[..., 0]


@register_method
@dataclass
class ILQLConfig(MethodConfig):
    """ILQL hyperparameters (the JAX package's names and meanings): ``tau``
    expectile, ``gamma`` discount, ``cql_scale``, ``awac_scale``, Polyak
    ``alpha``, AWAC ``beta``, ``steps_for_target_q_sync``, ``two_qs``, and
    ``gen_kwargs`` (whose ``beta`` drives advantage-shaped decoding)."""

    name: str = "ILQLConfig"
    tau: float = 0.7
    gamma: float = 0.99
    cql_scale: float = 0.1
    awac_scale: float = 1.0
    alpha: float = 0.001
    beta: float = 0.0
    steps_for_target_q_sync: int = 200
    two_qs: bool = True
    gen_kwargs: Dict[str, Any] = field(
        default_factory=lambda: dict(max_new_tokens=56, top_k=20, beta=4.0, temperature=1.0)
    )

    def loss(self, outputs, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``outputs = (logits_at_actions, (qs, target_qs, vs))``; ``batch`` is
        an :class:`~trlx_tpu_torch.data.ilql_types.ILQLBatch` (or
        ``ILQLSeq2SeqBatch``) of tensors.

        Shapes: qs / target_qs tuples of [B, A, V] at action positions; vs
        [B, A+1, 1] at state positions; ``batch.rewards`` [B, A];
        ``batch.dones`` [B, A+1] (1 while non-terminal); ``logits_at_actions``
        [B, A, V], the policy's logits at the action positions."""
        logits, (qs, target_qs, vs) = outputs
        f32 = torch.float32
        terminal_mask = batch.dones[:, :-1].to(vs.dtype)
        n_nonterminal = torch.clamp(batch_sum(terminal_mask.sum(dtype=f32)), min=1.0)

        # the token taken at each action position: causal, input_ids shifted
        # left and gathered at the actions; seq2seq, the decoder tokens after
        # the first
        if hasattr(batch, "decoder_input_ids"):
            actions = batch.decoder_input_ids[:, 1:]
        else:
            actions = torch.gather(batch.input_ids[:, 1:], 1, batch.actions_ixs.long())

        Q = [_take(q, actions) for q in qs]
        targetQ = reduce(torch.minimum, [_take(q, actions).detach() for q in target_qs])

        V = vs[:, :-1, 0]
        Vnext = vs[:, 1:, 0] * batch.dones[:, 1:].to(vs.dtype)
        Q_ = batch.rewards + self.gamma * Vnext.detach()

        loss_q = sum(batch_sum(torch.sum(((Qi - Q_) * terminal_mask) ** 2, dtype=f32)) / n_nonterminal for Qi in Q)

        expectile_w = torch.where(targetQ >= V, self.tau, 1.0 - self.tau).to(vs.dtype)
        loss_v = batch_sum(torch.sum(expectile_w * (targetQ - V) ** 2 * terminal_mask, dtype=f32)) / n_nonterminal

        def cql_loss(q):
            nll = -_take(torch.log_softmax(q, dim=-1), actions)
            return batch_sum(torch.sum(nll * terminal_mask, dtype=f32)) / n_nonterminal

        loss_cql = sum(cql_loss(q) for q in qs)

        ce = -_take(torch.log_softmax(logits, dim=-1), actions)
        awac_weight = torch.exp(self.beta * (targetQ - V)).detach()
        loss_awac = batch_sum(torch.sum(ce * awac_weight * terminal_mask, dtype=f32)) / n_nonterminal

        loss = loss_q + loss_v + self.cql_scale * loss_cql + self.awac_scale * loss_awac

        stats = dict(
            losses=dict(loss=loss, loss_q=loss_q, loss_v=loss_v, loss_cql=loss_cql, loss_awac=loss_awac),
            values=dict(mean=masked_mean(V, terminal_mask)),
            qvalues={str(ix): dict(mean=masked_mean(Q[ix], terminal_mask)) for ix in range(len(Q))},
            awac_weight=dict(mean=masked_mean(awac_weight, terminal_mask)),
        )
        return loss, stats


# -- the census (python -m trlx_tpu_torch.analysis.census) ---------------------


@register_entrypoint(
    "ilql_train_step",
    roots=(
        "trlx_tpu_torch.trainer.ilql_trainer.ILQLTrainer.train_step",
        "trlx_tpu_torch.trainer.ilql_trainer.ILQLTrainer.loss_fn",
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.make_grad_accum_step",
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.clip_grads",
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.global_grad_norm",
        "trlx_tpu_torch.methods.ilql.*",
        "trlx_tpu_torch.models.policy.CausalLMWithILQLHeads.*",
        "trlx_tpu_torch.models.transformer.*",
        "trlx_tpu_torch.ops.attention.*",
    ),
    readback={
        # the step's stats, one transfer (one site per health-guard branch)
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.make_grad_accum_step.step": 2,
        # the overlapped FSDP step's stats, one transfer
        "trlx_tpu_torch.parallel.fsdp.make_overlapped_grad_accum_step.step": 1,
    },
)
def build_ilql_train_step(device, size, shared):
    """One ILQL optimizer step (``ILQLTrainer.train_step``: bucket padding,
    the copy to the device, the loss over the Q, target-Q and V heads; the
    reference's ``ilql_train_step``, ``trlx_tpu/methods/ilql.py:135``)."""
    from trlx_tpu_torch.analysis.census import fixtures

    tr = fixtures.trainer("ilql", device, size, shared)
    batches = fixtures.ilql_batches(size, tr)
    return Entry(step=lambda k: tr.train_step(batches[k]), optimizer=tr.optimizer)
