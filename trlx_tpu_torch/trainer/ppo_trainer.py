"""PPO trainer (counterpart of ``trlx_tpu/trainer/ppo_trainer.py``): rollout
store management, the frozen reference (a full copy of the trunk, or with
``num_layers_unfrozen = N > 0`` the hydra branch: a frozen copy of the top N
layers and the head, run from the trunk's activation), the KL controllers,
the serial ``make_experience`` pipeline (generate -> reward -> policy and
reference scoring forwards -> KL-penalized rewards -> rollout store) and
the PPO loss and train step. With ``train.serving.enabled`` the rollouts
come from the continuous-batching ``ServingEngine`` (paged decode, and with
``spec_k`` / ``prefill_chunk`` speculative decoding and chunked prefill)
instead of the padded ``generate``.

With ``train.async_rollouts`` (and ``max_staleness > 0``) a producer thread
(:class:`~trlx_tpu_torch.rollout.AsyncRolloutEngine`) runs generate ->
reward -> score continuously on the newest published parameter snapshot
while the learner trains: the learner publishes a copy of its trained
state every ``publish_interval`` steps, every element carries the version
that sampled it, staleness is stamped on each batch just before its step,
and the loss reweights stale rows with clipped importance weights. The
producer never runs ``self.model``: it owns a copy of the policy
(``_producer_model``), loaded from each new snapshot, and samples with its
own ``torch.Generator``; both threads queue their CUDA work on the default
stream, which orders each snapshot's clone before the producer's read.
``evaluate`` pauses the producer. ``method.overlap_reward_scoring`` runs
reward_fn for one generation's chunks on a worker thread while the next
generates.

On the card every multi-token forward (generation prefill, both scoring
forwards, the loss forward) runs the flash forward kernel when the model
config says ``attention_impl="flash"``, and every learner backward runs the
flash dK/dV and dQ kernels once per layer and microbatch.

With ``train.self_healing`` the experience quarantine screens every
assembled element (both the synchronous path and the async producer go
through ``_score_and_store``), the async producer runs under a
:class:`~trlx_tpu_torch.rollout.ProducerSupervisor`, and a health-guard
rollback rebuilds the prompt stream and republishes the restored weights
(``_post_rollback_restore``).

The serving engine's production layers: ``train.serving_resilience``
installs a :class:`~trlx_tpu_torch.serving.ServingResiliencePolicy` and
wraps the engine in a :class:`~trlx_tpu_torch.serving.ServingSupervisor`
(a crash or wedge rebuilds the engine and replays every request);
``train.serving_tenancy`` installs one
:class:`~trlx_tpu_torch.serving.TenantRegistry`, shared by every engine
generation. ``train.serving.stream_overlap`` streams the experience phase
(:meth:`PPOTrainer._make_experience_streamed`): each sequence's reward
call starts as soon as the engine finishes it, scoring runs in
microbuckets while the rest of the batch decodes, and the first epoch's
learner batches are staged on the device before the phase ends.

Serving across engines: ``train.serving_fleet`` puts N supervised replicas
behind a :class:`~trlx_tpu_torch.fleet.FleetRouter` (replica ``i`` samples
from ``seed + 17 + i``, so a fleet of one is the bare engine), with the
:class:`~trlx_tpu_torch.fleet.FleetAutoscaler` observing after every
generation when ``autoscale`` is on. ``train.islands`` (with async rollouts
and the engine) makes the engine a
:class:`~trlx_tpu_torch.serving.GenerationIsland`: the learner publishes
through a :class:`~trlx_tpu_torch.rollout.ChunkedParameterPublisher` that
shares the island's round gate, the engine swaps each committed version at
its own round boundaries (the producer installs nothing), and the train
step and the publish are the learner island's busy intervals.

Seq2seq (``model.model_arch_type="seq2seq"``): the policy is T5 with a
value MLP over the decoder (:class:`~trlx_tpu_torch.models.policy.Seq2SeqLMWithValueHead`),
rollouts come from the encoder-decoder ``generate_seq2seq``, the scoring
and loss forwards read the response through the decoder (the start token
and the response shifted right), and the KL reference is a full frozen T5
copy or, with ``0 < num_layers_unfrozen < num_decoder_layers``, the
decoder-top branch (:class:`~trlx_tpu_torch.models.t5.T5Branch`), with the
encoder and the lower decoder blocks frozen. T5 attends on the plain path;
the serving engine does not serve it (the padded generate runs instead).

peft (``model.peft_config``; LoRA only for T5): the adapters and the heads
train, and the KL reference is the same trunk run with its adapters
disabled (:func:`~trlx_tpu_torch.models.transformer.disable_adapters`): no
copy of the trunk and no hydra branch, whatever ``num_layers_unfrozen``
says. Prompt and prefix tuning roll out through the padded ``generate``
(the engine's paged cache has no room for virtual rows); LoRA serves.

``model.offload_ref`` with the full-copy reference keeps that copy in host
memory (pinned on the card) and uploads it once per experience phase, for
scoring, releasing it before the learner steps; a streamed phase pins the
uploaded copy for its whole window (:meth:`PPOTrainer._pin_ref`). With peft
or a hydra branch it warns and is ignored, as in the JAX package.
``train.rollout_param_dtype`` builds the engine's trunk in that dtype, so
each phase's install is the one cast.
"""

import copy
import os
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from trlx_tpu_torch.analysis.census.entrypoints import Entry, register_entrypoint
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.ppo_types import PPORLBatch, PPORLElement
from trlx_tpu_torch.fleet import FleetAutoscaler, fleet_factory
from trlx_tpu_torch.methods.ppo import PPOConfig
from trlx_tpu_torch.models.policy import (
    CausalLMWithValueHead,
    ModelBranch,
    Seq2SeqLMWithValueHead,
    branch_param_subtree,
    init_value_branch_from_trunk,
    t5_branch_param_subtree,
)
from trlx_tpu_torch.models.t5 import T5LM, T5Branch
from trlx_tpu_torch.models.transformer import TransformerLM, disable_adapters
from trlx_tpu_torch.obs import span
from trlx_tpu_torch.obs.flight import flight
from trlx_tpu_torch.obs.overlap import OverlapWindow
from trlx_tpu_torch.ops.generation import left_pad_batch, pad_to_bucket
from trlx_tpu_torch.parallel.mesh import carve_islands
from trlx_tpu_torch.parallel.sharding import replicated_batch
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage, ppo_collate_fn
from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.resilience.quarantine import ExperienceQuarantine, chaos_corrupt_elements
from trlx_tpu_torch.rollout import (
    AsyncRolloutEngine,
    ChunkedParameterPublisher,
    ExperienceQueue,
    ParameterPublisher,
    ProducerSupervisor,
    ReorderBuffer,
    StalenessAccountant,
    length_bucketed,
)
from trlx_tpu_torch.serving import (
    GenerationClient,
    GenerationIsland,
    ServingEngine,
    ServingResiliencePolicy,
    ServingSupervisor,
)
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.parallel import collectives as coll
from trlx_tpu_torch.parallel import mesh as mesh_lib
from trlx_tpu_torch.trainer.mesh_trainer import POW2_BUCKETS, MeshRLTrainer
from trlx_tpu_torch.utils import infinite_loader, logging
from trlx_tpu_torch.utils.metrics import gauges
from trlx_tpu_torch.utils.modeling import RunningMoments, flatten_dict, logprobs_of_labels

logger = logging.get_logger(__name__)

#: at most this many response-length buckets per (B, P) scoring family on the
#: streamed path: the JAX package's ``stream_score_ladder`` shape contract
#: (``trlx_tpu/analysis/rt/contracts.py``), copied as a number
_STREAM_MAX_R_BUCKETS = 4


def overlap_r_buckets(max_new: int) -> List[int]:
    """The quantized response-length ladder of the streaming microbuckets:
    at most :data:`_STREAM_MAX_R_BUCKETS` pow2 shapes covering up to
    ``max_new + 1`` (decode may re-append eos)."""
    top = max(1, max_new + 1)
    # ceil(top / d) for d in 8, 4, 2, 1, deduplicated after pow2 padding: at
    # most 4 entries, the full shape always among them
    return sorted({pad_to_bucket(max(1, -(-top // d)), POW2_BUCKETS) for d in (8, 4, 2, 1)})


def quantize_stream_response(r: int, ladder: List[int]) -> int:
    """Snap a raw completion length onto the streaming ladder: the one path
    from a data-dependent length to the scoring forward's R dimension."""
    for cand in ladder:
        if r <= cand:
            return cand
    return pad_to_bucket(r, POW2_BUCKETS)  # defensive: the ladder covers max_new + 1


def check_stream_bucket_family(families, B: int, P: int, R: int, limit: int = _STREAM_MAX_R_BUCKETS):
    """Record R under the (B, P) family and assert the family stays within
    ``limit`` shapes: a length escaping the ladder fails loudly instead of
    growing the set of scoring shapes without bound."""
    fam = families.setdefault((B, P), set())
    fam.add(R)
    if len(fam) > limit:
        raise AssertionError(
            f"streaming score-fn bucket family (B={B}, P={P}) grew to "
            f"{sorted(fam)}; the response-length quantizer must keep "
            f"<= {limit} shapes per family"
        )


@register_trainer
class PPOTrainer(MeshRLTrainer):
    def __init__(self, config: TRLConfig, **kwargs):
        if not isinstance(config.method, PPOConfig):
            raise ValueError("PPOTrainer requires method=PPOConfig")
        super().__init__(config, **kwargs)
        self.method: PPOConfig = config.method

        self.store = PPORolloutStorage(self.tokenizer.pad_token_id)
        self.kl_ctl = self.method.kl_controller()
        self.running_moments = RunningMoments()
        self.mean_kl = 0.0
        self.rollout_stats: Dict[str, float] = {}
        self._train_step_fn = None
        # the serving engine behind rollouts (train.serving), built by
        # _resolve_serving in prepare_learning; None keeps the padded generate
        self._serving_client = None
        self._serving_engine = None
        self._serving_max_new = 0
        self._serving_min_new = 0
        # (B, P) -> R shapes the streamed scoring ran (bounded by the ladder)
        self._score_fn_families = {}
        #: the last streamed experience phase's overlap ledger (seconds)
        self.last_overlap = None
        # the snapshot the engine holds (async: installed only when it changes)
        self._serving_param_ref = None
        # train.serving_fleet's autoscaler (None: no fleet, or autoscale off)
        self._serving_autoscaler = None
        # train.islands: the engine as the generation island (async only)
        self._island = None

        # async rollouts (train.async_rollouts), started in prepare_learning:
        # the producer engine, its copy of the policy and its sampling stream
        self._engine = None
        self._async_cfg = None
        self._policy_version = 0
        self._producer_model = None
        self._producer_params = None
        self._producer_generator = None
        #: the drain ledger of the last async run (set by on_learn_end)
        self.rollout_engine_summary = None

        # prompt-stream position: draws from the infinite prompt iterator,
        # checkpointed and replayed on resume
        self._prompt_batches_drawn = 0
        self._resume_prompt_batches = 0
        self._prompt_pipeline = None

        # the experience quarantine (train.self_healing): screens every
        # assembled element; None trusts every element
        self._quarantine = None
        sh_config = config.train.self_healing
        if sh_config.enabled:
            self._quarantine = ExperienceQuarantine(
                sh_config.quarantine_dir or os.path.join(config.train.checkpoint_dir, "quarantine")
            )

        if config.train.rollout_logging_dir is not None:
            self.log_rollouts = True
            self.setup_rollout_logging(config)
        else:
            self.log_rollouts = False

    # ------------------------------------------------------------------ model

    def setup_model(self):
        """Policy + value model, random weights from the seed, a loaded
        checkpoint's trunk over the policy's (the value head keeps its seed
        init, as ``merge_loaded_params`` in the JAX trainer), a value branch
        copied from the trunk's top layers (``num_value_layers_unfrozen >
        0``), and the frozen KL reference: with ``num_layers_unfrozen = N >
        0`` the hydra branch (``frozen_branch``, a copy of the top N layers,
        the final norm and the head, started at ``branch_start``), otherwise
        a full copy of the trunk (``ref_model``, or with ``model.offload_ref``
        a host copy uploaded per experience phase). With ``model.peft_config``
        the reference is the policy's own trunk with its adapters disabled
        (``peft_base_ref``): no copy, no branch."""
        self._ref_host = self._ref_dev = None
        self._ref_pinned = False
        #: on a mesh, the offloaded reference's blocks on this rank's host (bytes), else None
        self.ref_host_bytes = None
        #: host -> device uploads of the offloaded reference, and their seconds
        self.ref_uploads, self.ref_upload_s = 0, []
        self.peft_base_ref = bool(self.config.model.peft_config)
        if self.is_seq2seq:
            return self._setup_seq2seq_model()
        n_unfrozen = self.config.model.num_layers_unfrozen
        n_value = self.config.method.num_value_layers_unfrozen

        def build(config):
            if n_unfrozen > config.num_layers:
                raise ValueError(f"num_layers_unfrozen={n_unfrozen} exceeds num_layers={config.num_layers}")
            return CausalLMWithValueHead(config, num_value_layers=n_value)

        self.model = self.load_trunk(build)
        if n_value > 0:
            state = init_value_branch_from_trunk(self.model.state_dict(), self.model_config, n_value)
            self.model.load_state_dict(state)
        if self.config.model.offload_ref and (self.peft_base_ref or n_unfrozen > 0):
            # only the FULL-copy reference lives in HBM at size worth offloading;
            # the hydra ref is already the cheap option — say so instead of
            # silently ignoring the flag
            logger.warning(
                "offload_ref ignored: the reference is a hydra branch / disabled-"
                "adapter view (num_layers_unfrozen > 0 or peft), not a full copy"
            )
        self.ref_model = self.frozen_branch = self.branch_start = None
        if self.peft_base_ref:
            pass  # the reference is the trunk itself, adapters disabled
        elif n_unfrozen > 0:
            self.branch_start = self.model_config.num_layers - n_unfrozen
            with torch.device(self.device):
                self.frozen_branch = ModelBranch(self.model_config, self.branch_start)
            self.frozen_branch.load_state_dict(
                branch_param_subtree(self.model.transformer.state_dict(), self.branch_start, self.model_config)
            )
            self.frozen_branch.requires_grad_(False)
        elif self.config.model.offload_ref and not self.multi_rank:
            self._setup_ref_offload(self.model.transformer.state_dict())
        else:
            with torch.device(self.device):
                self.ref_model = TransformerLM(self.model_config)
            self.ref_model.load_state_dict(self.model.transformer.state_dict())
            self.ref_model.requires_grad_(False)

    def _setup_seq2seq_model(self):
        """T5 + value MLP, random weights from the seed, a loaded T5
        checkpoint over the trunk, and the frozen reference: with ``0 <
        num_layers_unfrozen < num_decoder_layers`` the decoder-top branch
        (``frozen_branch``, started at ``branch_start``), otherwise a full
        frozen T5 copy (``ref_model``, or the offloaded host copy): with every
        decoder block trained the branch would reuse a relative bias that
        trains. With T5 LoRA the reference is the policy's T5 with its
        adapters disabled."""
        n_unfrozen = self.config.model.num_layers_unfrozen
        self.model = self.load_t5(Seq2SeqLMWithValueHead)
        n_dec = self.model_config.num_decoder_layers
        if n_unfrozen > n_dec:
            raise ValueError(f"num_layers_unfrozen={n_unfrozen} exceeds num_decoder_layers={n_dec}")
        if self.config.model.offload_ref and (self.peft_base_ref or 0 < n_unfrozen < n_dec):
            logger.warning("offload_ref ignored: the seq2seq reference is a decoder branch / disabled-adapter "
                           "view, not a full copy")
        self.ref_model = self.frozen_branch = self.branch_start = None
        if self.peft_base_ref:
            pass  # the reference is the T5 itself, adapters disabled
        elif 0 < n_unfrozen < n_dec:
            self.branch_start = n_dec - n_unfrozen
            with torch.device(self.device):
                self.frozen_branch = T5Branch(self.model_config, self.branch_start)
            self.frozen_branch.load_state_dict(
                t5_branch_param_subtree(self.model.t5.state_dict(), self.branch_start, self.model_config)
            )
            self.frozen_branch.requires_grad_(False)
        elif self.config.model.offload_ref and not self.multi_rank:
            self._setup_ref_offload(self.model.t5.state_dict())
        else:
            with torch.device(self.device):
                self.ref_model = T5LM(self.model_config)
            self.ref_model.load_state_dict(self.model.t5.state_dict())
            self.ref_model.requires_grad_(False)

    # ------------------------------------------------------- offloaded reference

    def _setup_ref_offload(self, trunk_state):
        """``model.offload_ref``: the full frozen reference held in host
        memory (pinned on a CUDA trainer, so each upload is one DMA; plain
        on the CPU, where ``pin_memory`` needs CUDA), uploaded by
        :meth:`_ref_scoring_model` once per experience phase and released by
        :meth:`_release_ref` before the learner steps: the reference's NeMo
        CPU-pinned policy/ref swap."""
        pin = self.device.type == "cuda"
        self._ref_host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin).copy_(v)
                          for k, v in trunk_state.items()}
        logger.info(f"offload_ref: frozen reference held in {'pinned' if pin else 'plain'} host memory")

    def setup_sharding(self):
        """The mesh's placement, then on a mesh with ``model.offload_ref``
        the reference's blocks move to this rank's host memory (pinned on a
        card): each rank holds the shard the rules give the resident
        reference, as the JAX package's pinned-host placement does."""
        super().setup_sharding()
        if self.multi_rank and self.config.model.offload_ref and self.ref_model is not None:
            self.ref_host_bytes = self.shards.offload("ref_model", pin=self.device.type == "cuda")
            logger.info(f"offload_ref: this rank's reference blocks held in host memory "
                        f"({self.ref_host_bytes} bytes)", ranks=[-1])

    def _ref_scoring_model(self):
        """The full-copy reference for the scoring forwards: ``ref_model``,
        or the offloaded copy uploaded on first use in a phase (built on the
        meta device, its tensors assigned from the upload; on a mesh, this
        rank's blocks copied back into ``ref_model``; the upload's seconds
        land in ``ref_upload_s``)."""
        if self._ref_host is None and self.ref_host_bytes is None:
            return self.ref_model
        if self._ref_dev is None:
            t0 = time.perf_counter()
            if self.ref_host_bytes is not None:
                self.shards.upload("ref_model", self.device)
                ref = self.ref_model
            else:
                with torch.device("meta"):
                    ref = T5LM(self.model_config) if self.is_seq2seq else TransformerLM(self.model_config)
                ref.load_state_dict({k: v.to(self.device, non_blocking=True) for k, v in self._ref_host.items()},
                                    assign=True)
                ref.requires_grad_(False)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._ref_dev = ref
            self.ref_uploads += 1
            self.ref_upload_s.append(time.perf_counter() - t0)
        return self._ref_dev

    def _pin_ref(self):
        """Hold the uploaded reference for a whole streamed window: upload it
        once now, and make :meth:`_release_ref` a no-op until
        :meth:`_unpin_ref`."""
        self._ref_pinned = True
        if self._ref_host is not None or self.ref_host_bytes is not None:
            self._ref_scoring_model()

    def _unpin_ref(self):
        """End of the streamed window: release is allowed again."""
        self._ref_pinned = False

    def _release_ref(self):
        """Free the uploaded reference after an experience phase (before the
        learner steps, where memory peaks); a no-op without offload or while
        a streamed window holds the pin."""
        if not self._ref_pinned:
            if self.ref_host_bytes is not None and self._ref_dev is not None:
                self.shards.release_upload("ref_model")
            self._ref_dev = None

    def sharded_modules(self):
        """The policy and the frozen reference (the full copy or the hydra
        branch), placed on the mesh alike."""
        modules = {"": self.model}
        if self.ref_model is not None:
            modules["ref_model"] = self.ref_model
        if self.frozen_branch is not None:
            modules["frozen_branch"] = self.frozen_branch
        return modules

    def _new_policy(self):
        """An untrained module shaped like ``self.model`` on the device (the
        async producer's copy)."""
        with torch.device(self.device):
            if self.is_seq2seq:
                return Seq2SeqLMWithValueHead(self.model_config)
            return CausalLMWithValueHead(self.model_config,
                                         num_value_layers=self.method.num_value_layers_unfrozen)

    def trainable_path_predicate(self, path: str) -> bool:
        """Seq2seq with ``num_layers_unfrozen = N >= 0``: the top N decoder
        blocks, the final decoder norm and the value head train; the
        encoder, the embedding (and so the tied head) and the lower decoder
        blocks are frozen."""
        n_unfrozen = self.config.model.num_layers_unfrozen
        if not self.is_seq2seq or self.config.model.peft_config:
            # peft: adapters and heads (the base predicate)
            return super().trainable_path_predicate(path)
        if n_unfrozen < 0 or not path.startswith("t5."):
            return True
        if "decoder_blocks_" in path:
            layer = int(path.split("decoder_blocks_")[1].split(".")[0])
            return layer >= self.model_config.num_decoder_layers - n_unfrozen
        return "decoder_ln" in path

    def gen_step_fn(self, policy=None):
        trunk = (self.model if policy is None else policy).transformer

        def step(ids, mask, positions, cache):
            # generate() samples from the last position only
            logits, hidden, _, cache = trunk(ids, mask, positions, cache, last_only=True)
            return logits, hidden, cache

        return step, trunk.init_cache

    # ------------------------------------------------------------- experience

    def add_prompt_pipeline(self, pipeline):
        """Attach the prompt pipeline for rollouts: an endless shuffled
        stream of ``decode_batch_size`` (default ``chunk_size``) prompts."""
        batch = self.method.decode_batch_size or self.method.chunk_size
        self._prompt_pipeline = pipeline
        loader = pipeline.create_loader(batch, shuffle=True, seed=self.config.train.seed)
        self.prompt_iterator = length_bucketed(
            infinite_loader(loader), self.config.train.async_rollouts.length_bucket_lookahead
        )

    def setup_rollout_logging(self, config):
        import json
        import uuid

        self.run_id = f"run-{uuid.uuid4()}"
        self.rollout_logging_dir = os.path.join(config.train.rollout_logging_dir, self.run_id)
        os.makedirs(self.rollout_logging_dir, exist_ok=True)
        with open(os.path.join(self.rollout_logging_dir, "config.json"), "w") as f:
            f.write(json.dumps(config.to_dict(), indent=2))

    def score(self, seq: np.ndarray, mask: np.ndarray, P: int, R: int, policy=None):
        """Policy logprobs and values and reference logprobs over the
        response window of ``seq`` (prompt left-padded to P, response
        right-padded to R): host f32 arrays [B, R]. The hydra reference runs
        the frozen branch from the activation the policy forward captured at
        ``branch_start``. ``policy`` replaces ``self.model`` (the async
        producer passes its snapshot copy)."""
        rows = mesh_lib.local_rows(self.mesh, len(seq)) if self.multi_rank else None
        if rows is not None:  # this rank's rows, then the whole batch on every rank
            seq, mask = seq[rows], mask[rows]
        replicated = self.multi_rank and rows is None and mesh_lib.dp_size(self.mesh) > 1
        with self.params_gathered(), replicated_batch(replicated):
            out = self._score_device(torch.from_numpy(seq).to(self.device), torch.from_numpy(mask).to(self.device),
                                     P, R, policy=policy)
        if rows is not None:
            out = [coll.all_gather(x, self.mesh.batch_group, 0) for x in out]
        return tuple(x.cpu().numpy() for x in out)

    @torch.no_grad()
    def _score_device(self, seq_t: torch.Tensor, mask_t: torch.Tensor, P: int, R: int, policy=None):
        """:meth:`score`'s forwards on device tensors, returning device
        tensors [B, R]: nothing here waits for the device, so the streamed
        path leaves the work in flight until its harvest."""
        policy = self.model if policy is None else policy
        labels = seq_t[:, P:P + R]
        logits, values, branch_hidden, _ = policy(seq_t, mask_t, branch_layer=self.branch_start)
        # the window's logits only: log_softmax is per position
        logprobs = logprobs_of_labels(logits[:, P - 1:P - 1 + R], labels)
        values = values[:, P - 1:P - 1 + R].float()
        del logits
        if self.peft_base_ref:
            # the same (frozen) trunk with its adapters disabled
            with disable_adapters():
                ref_logits = policy.transformer(seq_t, mask_t)[0]
        elif self.frozen_branch is not None:
            ref_logits = policy.forward_branch(
                branch_hidden, mask_t, None, self.branch_start, branch=self.frozen_branch
            )
        else:
            ref_logits, _, _, _ = self._ref_scoring_model()(seq_t, mask_t)
        ref_logprobs = logprobs_of_labels(ref_logits[:, P - 1:P - 1 + R], labels)
        return logprobs, values, ref_logprobs

    def _decoder_inputs(self, responses: torch.Tensor, response_mask: torch.Tensor):
        """The decoder's input for reading ``responses`` back (teacher
        forcing): the start token, then the responses shifted right; and its
        mask."""
        ones = torch.ones_like(responses[:, :1])
        return (torch.cat([ones * self.decoder_start_token_id, responses[:, :-1]], dim=1),
                torch.cat([ones, response_mask[:, :-1]], dim=1))

    @torch.no_grad()
    def score_s2s(self, q_ids, q_mask, r_ids, r_mask, policy=None):
        """The seq2seq :meth:`score`: the decoder reads the start token and
        the response shifted right; policy logprobs and values and the
        reference's logprobs of the response tokens, host f32 [B, R]. The
        decoder-top reference runs from the activation the policy forward
        captured at ``branch_start``, with the policy's encoder states and
        relative bias (the encoder and lower blocks are frozen). On a mesh
        each rank scores its rows and the ranks gather the batch, as
        :meth:`score`."""
        rows = mesh_lib.local_rows(self.mesh, len(q_ids)) if self.multi_rank else None
        arrays = (q_ids, q_mask, r_ids, r_mask)
        if rows is not None:
            arrays = tuple(x[rows] for x in arrays)
        replicated = self.multi_rank and rows is None and mesh_lib.dp_size(self.mesh) > 1
        with self.params_gathered(), replicated_batch(replicated):
            out = self._score_s2s_device(*(torch.from_numpy(x).to(self.device) for x in arrays), policy=policy)
        if rows is not None:
            out = [coll.all_gather(x, self.mesh.batch_group, 0) for x in out]
        return tuple(x.cpu().numpy() for x in out)

    def _score_s2s_device(self, q, qm, r, rm, policy=None):
        policy = self.model if policy is None else policy
        dec_in, dec_mask = self._decoder_inputs(r, rm)
        if self.frozen_branch is not None:
            logits, values, enc, branch_hidden, pos_bias = policy.forward_with_branch(
                q, qm, dec_in, dec_mask, self.branch_start)
            ref_logits = self.frozen_branch.forward_branch(branch_hidden, enc, qm, dec_mask, pos_bias,
                                                           self.branch_start)
        else:
            logits, values, _ = policy(q, qm, dec_in, dec_mask)
            if self.peft_base_ref:
                with disable_adapters():
                    ref_logits, _, _ = policy.t5(q, qm, dec_in, dec_mask)
            else:
                ref_logits, _, _ = self._ref_scoring_model()(q, qm, dec_in, dec_mask)
        return logprobs_of_labels(logits, r), values.float(), logprobs_of_labels(ref_logits, r)

    # ---------------------------------------------------------------- serving

    def _resolve_serving(self):
        """Build the continuous-batching ``GenerationClient`` when
        ``train.serving.enabled`` and the run's generation settings fit the
        engine; otherwise log why and keep the padded ``generate``
        (``_serving_client`` stays None). Called from prepare_learning."""
        cfg = self.config.train.serving
        if not cfg.enabled or self._serving_client is not None:
            return

        def fallback(reason):
            logger.warning(f"train.serving disabled for this run: {reason}")

        if self.config.model.model_arch_type != "causal":
            return fallback("seq2seq generation is not paged")
        if self.model_config.stacked:
            return fallback("stacked/pipelined layouts keep the contiguous cache")
        if self.model_config.peft_type in ("prompt", "prefix"):
            return fallback("prompt/prefix peft puts virtual rows in the cache")
        if self.multi_rank:
            return fallback("multi-device mesh (the paged step is single-device)")
        if self.gen_logits_processor() is not None:
            return fallback("decode-time logits processor in use")
        gen_kwargs = dict(self.generate_experience_kwargs or self.generate_kwargs)
        gen_kwargs.setdefault("eos_token_id", self.tokenizer.eos_token_id)
        gen_kwargs.setdefault("pad_token_id", self.tokenizer.pad_token_id)
        self._serving_max_new = max_new = int(gen_kwargs.pop("max_new_tokens", 16))
        self._serving_min_new = int(gen_kwargs.pop("min_new_tokens", 0))
        eos = gen_kwargs.pop("eos_token_id")
        pad = gen_kwargs.pop("pad_token_id")
        unknown = set(gen_kwargs) - {"temperature", "top_k", "top_p", "do_sample", "top_k_impl"}
        if unknown:
            return fallback(f"unsupported gen_kwargs for the serving engine: {sorted(unknown)}")

        trunk_config = self.model_config.replace(
            kv_cache_quant=(
                self.model_config.kv_cache_quant if cfg.kv_cache_quant is None else bool(cfg.kv_cache_quant)
            ),
            paged_attention_impl=cfg.attention_impl,
        )
        if self.rollout_dtype is not None:
            # the engine's trunk IS the rollout copy: each install casts once
            trunk_config = trunk_config.replace(param_dtype=self.rollout_dtype)
        num_slots = cfg.num_slots or (self.method.decode_batch_size or self.method.chunk_size)
        svr = self.config.train.serving_resilience
        policy = None
        if svr.enabled:
            policy = ServingResiliencePolicy(
                request_ttl_s=svr.request_ttl_s,
                max_pending_age_s=svr.max_pending_age_s,
                max_pending=svr.max_pending,
                high_watermark=svr.high_watermark,
                low_watermark=svr.low_watermark,
                preemption=svr.preemption,
            )
        svt = self.config.train.serving_tenancy
        # one registry across engine generations: tenant contracts survive
        # supervised restarts
        tenants = svt.build_registry() if svt.enabled else None

        def build_engine(replica_seat=0):
            # each fleet seat samples from its own stream; seat 0 keeps the
            # single-engine seed, so a fleet of one is the bare engine
            with torch.device(self.device):
                trunk = TransformerLM(trunk_config)
            return ServingEngine(
                trunk,
                None,  # the policy's weights are installed per experience phase
                num_slots=num_slots,
                # prompts are admitted unpadded: real prompt lengths (<=
                # seq_length) plus the decode budget
                max_seq_len=self.config.train.seq_length + max_new,
                block_size=cfg.block_size,
                num_blocks=cfg.num_blocks,
                eos_token_id=eos,
                pad_token_id=pad,
                gen_kwargs=gen_kwargs,
                min_new_tokens=self._serving_min_new,
                prefix_caching=cfg.prefix_caching,
                seed=self.config.train.seed + 17 + replica_seat,
                policy=policy,
                spec_k=cfg.spec_k,
                spec_ngram=cfg.spec_ngram,
                prefill_chunk=cfg.prefill_chunk,
                tenants=tenants,
                device=self.device,
            )

        svf = self.config.train.serving_fleet
        supervision = dict(
            max_restarts=svr.max_restarts,
            backoff_base_s=svr.restart_backoff_base_s,
            backoff_max_s=svr.restart_backoff_max_s,
            wedge_timeout_s=svr.wedge_timeout_s,
            diagnostics_dir=svr.diagnostics_dir or os.path.join(self.config.train.checkpoint_dir, "diagnostics"),
        )
        if svf.enabled:
            # N supervised replicas behind the prefix-affinity router; a
            # replica's death re-routes its requests through the supervisor's
            # export / adopt seam
            self._serving_engine = fleet_factory(build_engine, svf, **supervision)
            if svf.autoscale:
                self._serving_autoscaler = FleetAutoscaler(
                    self._serving_engine,
                    min_replicas=svf.min_replicas,
                    max_replicas=svf.max_replicas,
                    scale_up_pending_per_slot=svf.scale_up_pending_per_slot,
                    scale_down_occupancy=svf.scale_down_occupancy,
                    breach_rounds=svf.breach_rounds,
                    cooldown_rounds=svf.cooldown_rounds,
                )
        elif svr.enabled:
            # a crash or wedge rebuilds the engine with the same arguments and
            # replays every accepted request
            self._serving_engine = ServingSupervisor(build_engine, **supervision)
        else:
            self._serving_engine = build_engine()
        self._serving_client = GenerationClient(self._serving_engine)
        logger.info(
            f"serving engine enabled: slots={num_slots}, block_size={cfg.block_size}, "
            f"blocks={self._serving_engine.num_blocks}, int8_kv={trunk_config.kv_cache_quant}, "
            f"impl={cfg.attention_impl}, spec_k={cfg.spec_k}, prefill_chunk={cfg.prefill_chunk}, "
            f"resilience={'on' if svr.enabled else 'off'}, tenancy={'on' if svt.enabled else 'off'}, "
            f"stream_overlap={'on' if cfg.stream_overlap else 'off'}, "
            f"fleet={svf.num_replicas if svf.enabled else 'off'}"
        )

    @staticmethod
    def _trunk_state(params):
        """The trunk's ``state_dict`` inside the policy's full one (the
        ``transformer.`` keys, prefix stripped): what the engine serves."""
        prefix = "transformer."
        return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}

    def _serving_generate(self, prompts, params=None):
        """The engine's replacement for ``self.generate`` in rollouts: the
        same ``(sequences, response_mask, pad_len)`` contract. ``params`` (a
        published snapshot of the trained state) is installed in the engine
        when it is not the snapshot the engine holds; the engine flushes its
        prefix cache then. With an island the install is skipped: the engine
        swaps to the newest committed broadcast at its own round boundaries,
        and the producer's snapshot stays the behavior-scoring policy."""
        if self._island is None and params is not None and params is not self._serving_param_ref:
            self._install_serving_params(self._trunk_state(params))
            self._serving_param_ref = params
        # the engine's rounds end in host fetches: the span times the decode
        with self.obs.span("generate"):
            out = self._serving_client.generate_batch(prompts, self._serving_max_new)
        if self._serving_autoscaler is not None:
            self._serving_autoscaler.observe()
        return out

    def _install_serving_params(self, trunk_state):
        """Install trunk weights in the engine (which flushes its prefix
        cache); under ``train.rollout_param_dtype`` the install casts them
        into the engine's low-precision trunk, counted in ``rollout_casts``."""
        self._serving_engine.set_params(trunk_state)
        if self.rollout_dtype is not None:
            self.rollout_casts += 1

    def on_learn_end(self):
        """Stop and join the rollout producer (no thread left, whatever path
        exited learn()), then close the serving engine (its gauges clear).
        Producer errors found here are logged, not raised: this runs in
        learn()'s finally and must not mask the original exception; a
        producer death during training already surfaced through collect()."""
        engine, self._engine = self._engine, None
        if engine is not None:
            try:
                self.rollout_engine_summary = engine.stop(timeout=self._async_cfg.drain_timeout_s)
                logger.info(f"async rollout engine stopped: {self.rollout_engine_summary}")
            except Exception as e:
                logger.warning(f"async rollout engine teardown: {type(e).__name__}: {e}")
        island, self._island = self._island, None
        if island is not None:
            # the final numbers before the prefix-aware gauge clear
            logger.info(f"generation island closed: {island.summary()}")
            island.close()
        self._serving_autoscaler = None
        serving, self._serving_engine, self._serving_client = self._serving_engine, None, None
        if serving is not None:
            logger.info(f"serving engine closed: {serving.summary()}")
            serving.close()  # a supervisor unregisters its watchdog escalation
            if isinstance(serving, ServingSupervisor):
                serving.engine.close()  # the current generation's gauges clear

    def _generate_chunks(self, tokenizer, policy=None, generator=None, params=None):
        """One generation at decode_batch_size, split into chunk_size
        sub-chunks for reward_fn and the scoring forward. The async producer
        passes its policy copy, its generator and the snapshot ``params``
        (which the serving engine installs)."""
        batch = next(self.prompt_iterator)
        self._prompt_batches_drawn += 1
        prompts = batch["input_ids"]
        metadata = {k: v for k, v in batch.items() if k != "input_ids"}
        t0 = time.perf_counter()
        if self._serving_client is not None:
            samples, resp_mask, pad_len = self._serving_generate(prompts, params=params)
        else:
            samples, resp_mask, pad_len = self.generate(prompts, eval_mode=False, policy=policy, generator=generator)
        self._phase_time["generate"] += time.perf_counter() - t0
        str_samples, str_prompts, str_outputs, out_ids = self.decode(
            prompts, samples, pad_len, append_eos=True, response_masks=resp_mask
        )
        cs = self.method.chunk_size
        subs = []
        for i in range(0, len(prompts), cs):
            sl = slice(i, i + cs)
            reward_kwargs = dict(
                samples=str_samples[sl], prompts=str_prompts[sl],
                outputs=str_outputs[sl], tokenizer=tokenizer,
                **{k: v[sl] for k, v in metadata.items()},
            )
            subs.append(((prompts[sl], out_ids[sl]), reward_kwargs))
        return subs

    def make_experience(self, num_rollouts: int = 1024, iter_count: int = 0):
        """Roll out prompts -> generations -> rewards -> KL-penalized per-token
        reward assembly -> rollout store. Seconds spent generating, in
        reward_fn and scoring land in ``time/rollout_{generate,reward,score}``.

        With ``method.overlap_reward_scoring``, reward_fn for one
        generation's chunks runs on a worker thread while the next
        generation runs on the device (with its own copy of the tokenizer);
        ``time/rollout_reward`` then counts the worker's seconds. With
        ``train.serving.stream_overlap`` (and the engine on) the phase is
        streamed (:meth:`_make_experience_streamed`)."""
        logger.info(f"Collecting {num_rollouts} rollouts")
        ppo_rl_elements: List[PPORLElement] = []
        accumulated_kl = []
        all_scores_log = []
        self._phase_time = {"generate": 0.0, "reward": 0.0, "score": 0.0}
        self.clock.tick()
        if self._serving_engine is not None:
            # the policy changed since the last phase: install it (the
            # engine flushes its prefix cache, computed under the old weights)
            self._install_serving_params(self.model.transformer.state_dict())
        if self._serving_client is not None and self.config.train.serving.stream_overlap:
            self._make_experience_streamed(num_rollouts, iter_count, ppo_rl_elements, accumulated_kl,
                                           all_scores_log)
        elif self.method.overlap_reward_scoring:
            if not hasattr(self, "_reward_tokenizer"):
                self._reward_tokenizer = copy.deepcopy(self.tokenizer)
            # across ranks under reward_on_process_zero, process 0's worker
            # calls reward_fn and the broadcast (a collective) runs here on
            # the main thread, at each drain, in the same order on every rank
            broadcasting = self.reward_on_process_zero and mesh_lib.process_count() > 1
            generated = 0  # counted at generation time: ppo_rl_elements lags
            with ThreadPoolExecutor(max_workers=1) as pool:
                pending = deque()
                while generated < num_rollouts or pending:
                    new = []
                    if generated < num_rollouts:
                        new = [(chunk, pool.submit(self._timed_local_reward_fn, broadcasting, **kw))
                               for chunk, kw in self._generate_chunks(self._reward_tokenizer)]
                        generated += sum(len(chunk[0]) for chunk, _ in new)
                    # store the previous generation's chunks while this one's
                    # rewards run behind the next device generation
                    while pending:
                        chunk, fut = pending.popleft()
                        scores = fut.result()
                        if broadcasting:
                            scores = self.broadcast_scores(scores)
                        self._score_and_store(chunk, scores, ppo_rl_elements, accumulated_kl, all_scores_log)
                    pending.extend(new)
        else:
            while len(ppo_rl_elements) < num_rollouts:
                self._collect_chunks(ppo_rl_elements, accumulated_kl, all_scores_log)

        self.mean_kl = float(np.mean(accumulated_kl))
        self.rollout_stats = self._rollout_stats(all_scores_log, **{"time/rollout_time": self.clock.tick()})
        if self.log_rollouts:
            self.store.export_history(location=self.rollout_logging_dir, tokenizer=self.tokenizer)
        self.push_to_store(ppo_rl_elements[:num_rollouts])
        # an offloaded reference leaves the device before the learner steps
        self._release_ref()

    def _make_experience_streamed(self, num_rollouts, iter_count, ppo_rl_elements, accumulated_kl,
                                  all_scores_log):
        """The streamed experience phase (``train.serving.stream_overlap``).

        As each sequence finishes in the engine, its reward_fn call goes to
        a bounded worker pool (``overlap_reward_workers``); sequences whose
        reward came back are taken in engine completion order (deterministic
        under greedy decode, whatever the workers' timing) into microbuckets
        of ``overlap_microbucket`` (default ``chunk_size``) for the scoring
        forward. The scoring is double-buffered: bucket k's forward is left
        in flight (enqueued on the device, no host fetch) and harvested when
        bucket k+1 dispatches or at the end of the batch, so the device runs
        it while the host goes back to decode. The harvest applies the KL
        shaping and the quarantine (a dropped element leaves a tombstone in
        the :class:`~trlx_tpu_torch.rollout.ReorderBuffer`, which hands
        elements on in submission order), then stages every first-epoch
        learner batch whose rows are all in (``overlap_learn_stage``):
        collated, copied to the device from pinned memory without blocking,
        and consumed by ``train_step`` when it matches the loader's batch.

        Rollout tokens and store order equal the serial serving path's; the
        scores are normalized per microbucket instead of per chunk, so the
        running moments group differently. An
        :class:`~trlx_tpu_torch.obs.OverlapWindow` measures decode-busy time
        against the reward / score / learn-stage work inside it
        (``serving/overlap_fraction``).
        ``TRLX_OVERLAP_SEED_REGRESSION=serialize`` blocks on every reward and
        every scoring bucket before the next engine round: the seeded
        regression the overlap fraction must expose."""
        cfg = self.config.train.serving
        serialize = os.environ.get("TRLX_OVERLAP_SEED_REGRESSION", "") == "serialize"
        mb = int(cfg.overlap_microbucket or self.method.chunk_size)
        pad_id = self.tokenizer.pad_token_id
        r_ladder = overlap_r_buckets(self._serving_max_new)
        on_cuda = self.device.type == "cuda"
        # the reward workers must not share the main thread's tokenizer
        if not hasattr(self, "_reward_tokenizer"):
            self._reward_tokenizer = copy.deepcopy(self.tokenizer)

        window = OverlapWindow()
        reorder = ReorderBuffer()
        reward_lock = threading.Lock()  # the workers add to _phase_time["reward"]
        # one clock for flight events: the engine scheduler's
        flight_clock = self._serving_client.engine.scheduler.clock
        pending = deque()  # (gidx, future, prompt, out_ids, uid) in completion order
        ready = deque()  # reward resolved, waiting for a full microbucket
        inflight = [None]  # the dispatched, not yet harvested scoring bucket
        dropped = [False]  # the quarantine broke the 1:1 index map: stop staging
        cur = {"P": 0}  # the current prompt batch's prompt bucket
        stage = {"perm": None, "next": 0}

        def to_device(arr):
            t = torch.from_numpy(np.ascontiguousarray(arr))
            return t.pin_memory().to(self.device, non_blocking=True) if on_cuda else t.to(self.device)

        def stream_reward(kw):
            # chaos site "producer-wedge" on the streamed path: this reward
            # call stalls (a stuck scorer the bounded pool rides out)
            if chaos.should_fail("producer-wedge"):
                logger.warning("chaos: streamed reward wedged at site 'producer-wedge'")
                time.sleep(0.2)
            t0 = time.perf_counter()
            with span("reward"):
                out = self.reward_fn(**kw)
            t1 = time.perf_counter()
            window.note_work(t0, t1)
            with reward_lock:
                self._phase_time["reward"] += t1 - t0
            return out

        def dispatch(items):
            # harvest bucket k-1 first: its device work had a bucket's worth of
            # decode and reward time to finish, so the fetch is short
            harvest()
            t0 = time.perf_counter()
            raw = [it[3] for it in items]
            if np.ndim(raw[0]) > 0:
                dense_scores = [np.asarray(x, np.float32) for x in raw]
                scores = np.asarray([x.sum() for x in dense_scores], np.float32)
            else:
                dense_scores = None
                scores = np.asarray(raw, np.float32).reshape(-1)
            all_scores_log.extend(scores.tolist())
            # normalization per microbucket, in completion order
            self.running_moments.update(scores)
            if self.method.cliprange_reward:
                scores = np.clip(scores, -self.method.cliprange_reward, self.method.cliprange_reward)
            if self.method.scale_reward == "running":
                scores = scores / max(self.running_moments.std, 1e-8)
            elif self.method.scale_reward == "ref":
                scores = scores / max(self.method.ref_std or 1.0, 1e-8)

            padded = list(items) + [items[-1]] * (mb - len(items))
            R = quantize_stream_response(max(len(it[2]) for it in padded), r_ladder)
            check_stream_bucket_family(self._score_fn_families, mb, cur["P"], R)
            q_ids, q_mask = left_pad_batch([it[1] for it in padded], pad_id, cur["P"])
            r_ids = np.full((mb, R), pad_id, np.int32)
            r_mask = np.zeros((mb, R), np.int32)
            for j, it in enumerate(padded):
                r_ids[j, : len(it[2])] = it[2]
                r_mask[j, : len(it[2])] = 1
            # no host fetch here: the forward stays in flight until harvest
            with span("score"):
                out = self._score_device(to_device(np.concatenate([q_ids, r_ids], axis=1)),
                                         to_device(np.concatenate([q_mask, r_mask], axis=1)), cur["P"], R)
            t1 = time.perf_counter()
            window.note_work(t0, t1)
            self._phase_time["score"] += t1 - t0
            inflight[0] = (items, scores, dense_scores, r_mask, out)
            if serialize:
                harvest()

        def harvest():
            if inflight[0] is None:
                return
            items, scores, dense_scores, rm, out = inflight[0]
            inflight[0] = None
            t0 = time.perf_counter()
            n = len(items)
            lp, v, rlp = (x.cpu().numpy()[:n] for x in out)
            rm = rm[:n]
            # per-token KL penalty and reward assembly: _score_and_store's
            # k3 math, per microbucket
            log_ratio = (lp - rlp) * rm
            kl_per_token = np.exp(log_ratio) - 1.0 - log_ratio
            accumulated_kl.append(kl_per_token.sum(axis=1).mean())
            kl_coef = self.kl_ctl.value
            t_store = flight_clock() if flight.enabled else 0.0
            new_elements = []
            for j in range(n):
                _, prompt, resp, _, uid = items[j]
                if flight.enabled:
                    flight.record(uid, "store", t=t_store)
                m = int(rm[j].sum())
                rewards = -kl_coef * log_ratio[j, :m]
                if dense_scores is not None:
                    ds = dense_scores[j]
                    rewards[: min(m, len(ds))] += ds[: min(m, len(ds))]
                else:
                    rewards[m - 1] += scores[j]
                new_elements.append(PPORLElement(
                    query_tensor=np.asarray(prompt, np.int32), response_tensor=np.asarray(resp, np.int32),
                    logprobs=lp[j, :m], values=v[j, :m], rewards=rewards.astype(np.float32),
                ))
            # the trust boundary of _score_and_store; chaos replaces by
            # position, so new_elements[j] still belongs to items[j]
            new_elements = chaos_corrupt_elements(new_elements)
            kept = new_elements
            if self._quarantine is not None:
                kept = self._quarantine.filter(new_elements, context=f"iter={self.iter_count}")
            kept_ids = {id(e) for e in kept}
            for j, elem in enumerate(new_elements):
                if id(elem) in kept_ids:
                    reorder.add(items[j][0], elem)
                else:
                    dropped[0] = True
                    reorder.add(items[j][0], None)  # tombstone: never stalls the cursor
            ppo_rl_elements.extend(reorder.pop_ready())
            maybe_stage_learn()
            t1 = time.perf_counter()
            window.note_work(t0, t1)
            self._phase_time["score"] += t1 - t0

        def maybe_stage_learn():
            if not cfg.overlap_learn_stage or dropped[0]:
                return
            bs = self.config.train.batch_size
            if stage["perm"] is None:
                # the first-epoch permutation of the loader create_train_dataloader
                # builds over the store (seed + iter_count, epoch 0); a mismatch
                # at consume time falls back to a fresh copy
                idxs = list(range(num_rollouts))
                random.Random(self.config.train.seed + iter_count).shuffle(idxs)
                stage["perm"] = idxs
            avail = min(len(ppo_rl_elements), num_rollouts)
            while (stage["next"] + 1) * bs <= num_rollouts:
                rows = stage["perm"][stage["next"] * bs:(stage["next"] + 1) * bs]
                if any(ix >= avail for ix in rows):
                    break
                t0 = time.perf_counter()
                with span("learn_stage"):
                    host = ppo_collate_fn(pad_id, [ppo_rl_elements[ix] for ix in rows])
                    self._stage_learn_batch(host, host.to(self.device, non_blocking=True))
                window.note_work(t0, time.perf_counter())
                stage["next"] += 1

        def pump(block=False):
            # FIFO-completed rewards to ready: buckets follow engine
            # completion order, never worker timing
            while pending:
                gidx, fut, prompt, resp, uid = pending[0]
                if not (block or fut.done()):
                    break
                pending.popleft()
                result = fut.result()[0]
                if flight.enabled:
                    flight.record(uid, "reward_done", t=flight_clock())
                ready.append((gidx, prompt, resp, result, uid))
            while len(ready) >= mb:
                dispatch([ready.popleft() for _ in range(mb)])

        self._clear_staged_learn()
        generated = 0
        t_phase = time.perf_counter()
        # one reference upload for the whole window (offload_ref)
        self._pin_ref()
        try:
            with ThreadPoolExecutor(max_workers=max(1, int(cfg.overlap_reward_workers)),
                                    thread_name_prefix="overlap-reward") as pool:
                while generated < num_rollouts:
                    batch = next(self.prompt_iterator)
                    self._prompt_batches_drawn += 1
                    prompts = batch["input_ids"]
                    metadata = {k: v for k, v in batch.items() if k != "input_ids"}
                    base = generated
                    generated += len(prompts)
                    cur["P"] = pad_to_bucket(max((len(p) for p in prompts), default=1), POW2_BUCKETS)

                    def on_finish(i, req, _base=base, _prompts=prompts, _meta=metadata):
                        prompt = np.asarray(_prompts[i], np.int32)
                        gen = np.asarray(req.generated, np.int32)
                        str_samples, str_prompts, str_outputs, out_ids = self.decode(
                            [prompt], np.concatenate([prompt, gen])[None, :], len(prompt), append_eos=True,
                            response_masks=np.ones((1, len(gen)), np.int32),
                        )
                        kw = dict(samples=str_samples, prompts=str_prompts, outputs=str_outputs,
                                  tokenizer=self._reward_tokenizer, **{k: [v[i]] for k, v in _meta.items()})
                        fut = pool.submit(stream_reward, kw)
                        if flight.enabled:
                            flight.record(req.uid, "reward_dispatch", t=flight_clock())
                        pending.append((_base + i, fut, prompt, out_ids[0], req.uid))
                        if serialize:
                            fut.result()  # the seeded regression: serial consumption
                        pump()

                    t0 = time.perf_counter()
                    with self.obs.span("decode"):
                        self._serving_client.stream_batch(prompts, self._serving_max_new, on_finish,
                                                          on_step=window.note_decode)
                    self._phase_time["generate"] += time.perf_counter() - t0
                    # drain before the next batch can change the prompt bucket
                    pump(block=True)
                    if ready:
                        dispatch([ready.popleft() for _ in range(len(ready))])
                    harvest()
        finally:
            self._unpin_ref()
        self._serving_engine.note_overlap(window.decode_busy_s, window.overlapped_s)
        self._serving_engine.export_gauges()
        if self._serving_autoscaler is not None:
            self._serving_autoscaler.observe()
        self.last_overlap = {"decode_busy_s": window.decode_busy_s, "overlapped_s": window.overlapped_s,
                             "work_s": window.work_s, "fraction": window.fraction,
                             "experience_s": time.perf_counter() - t_phase}

    def _timed_reward_fn(self, **kwargs):
        """reward_fn under a ``reward`` span (on the worker thread with
        ``overlap_reward_scoring``, on the producer thread under async
        rollouts), its seconds added to ``time/rollout_reward``. Every path
        that calls reward_fn for experience goes through here: the
        synchronous loop, the overlap pool, the async producer and GRPO's
        top-up."""
        t0 = time.perf_counter()
        with span("reward"):
            scores = self.call_reward_fn(**kwargs)
        self._phase_time["reward"] += time.perf_counter() - t0
        return scores

    def _timed_local_reward_fn(self, broadcasting: bool, **kwargs):
        """The overlap worker's reward call: with ``broadcasting``, process 0
        alone calls ``reward_fn`` (the others return None) and the main
        thread broadcasts; otherwise :meth:`_timed_reward_fn`."""
        if not broadcasting:
            return self._timed_reward_fn(**kwargs)
        if not self.is_main_process:
            return None
        t0 = time.perf_counter()
        with span("reward"):
            scores = self.reward_fn(**kwargs)
        self._phase_time["reward"] += time.perf_counter() - t0
        return scores

    def _collect_chunks(self, elements, kls, scores_log, policy=None, generator=None, params=None):
        """One decode batch of generate -> reward_fn -> score, its elements,
        per-sequence KLs and raw scores appended to the three lists.
        ``policy``, ``generator`` and ``params`` are the async producer's
        (:meth:`_generate_chunks`); ``policy`` also scores."""
        for chunk, reward_kwargs in self._generate_chunks(
            self.tokenizer, policy=policy, generator=generator, params=params
        ):
            scores = self._timed_reward_fn(**reward_kwargs)
            self._score_and_store(chunk, scores, elements, kls, scores_log, policy=policy)

    def _rollout_stats(self, scores_log, **extra) -> Dict[str, float]:
        """The experience stats the train steps report: the raw scores of
        this phase (0 when it scored none) and their running moments, the KL
        controller's view of ``mean_kl``, the seconds of each part of the
        phase, and ``extra``."""
        return {
            "rollout_scores/mean": float(np.mean(scores_log)) if scores_log else 0.0,
            "rollout_scores/std": float(np.std(scores_log)) if scores_log else 0.0,
            "rollout_scores/running_mean": float(self.running_moments.mean),
            "rollout_scores/running_std": float(self.running_moments.std),
            "policy/sqrt_kl": float(np.sqrt(max(self.mean_kl, 0.0))),
            "kl_ctl_value": float(self.kl_ctl.value),
            **{f"time/rollout_{k}": v for k, v in self._phase_time.items()},
            **extra,
        }

    def _score_and_store(self, chunk, scores, ppo_rl_elements, accumulated_kl, all_scores_log, policy=None):
        """Normalize scores, run the scoring forwards, and assemble
        KL-penalized PPORLElements. ``policy`` replaces ``self.model`` for
        the behavior logprobs and values (the async producer passes the
        snapshot copy it sampled with)."""
        prompts, out_ids = chunk
        dense = np.ndim(scores[0]) > 0
        if dense:
            dense_scores = [np.asarray(s, np.float32) for s in scores]
            scores = np.asarray([s.sum() for s in dense_scores], np.float32)
        else:
            dense_scores = None
            scores = np.asarray(list(scores), np.float32).reshape(-1)

        all_scores_log.extend(scores.tolist())
        self.running_moments.update(scores)
        if self.method.cliprange_reward:
            scores = np.clip(scores, -self.method.cliprange_reward, self.method.cliprange_reward)
        if self.method.scale_reward == "running":
            scores = scores / max(self.running_moments.std, 1e-8)
        elif self.method.scale_reward == "ref":
            scores = scores / max(self.method.ref_std or 1.0, 1e-8)

        P = pad_to_bucket(max(len(p) for p in prompts), POW2_BUCKETS)
        R = pad_to_bucket(max(len(o) for o in out_ids), POW2_BUCKETS)
        q_ids, q_mask = left_pad_batch(prompts, self.tokenizer.pad_token_id, P)
        r_ids = np.full((len(out_ids), R), self.tokenizer.pad_token_id, np.int32)
        r_mask = np.zeros((len(out_ids), R), np.int32)
        for i, o in enumerate(out_ids):
            r_ids[i, : len(o)] = o
            r_mask[i, : len(o)] = 1
        t0 = time.perf_counter()
        # the span includes score()'s host fetch: the forwards run
        # asynchronously until it
        with span("score"):
            if self.is_seq2seq:
                logprobs, values, ref_logprobs = self.score_s2s(q_ids, q_mask, r_ids, r_mask, policy=policy)
            else:
                logprobs, values, ref_logprobs = self.score(
                    np.concatenate([q_ids, r_ids], axis=1), np.concatenate([q_mask, r_mask], axis=1), P, R,
                    policy=policy,
                )
        self._phase_time["score"] += time.perf_counter() - t0

        # per-token KL penalty & reward assembly (k3 estimator)
        log_ratio = (logprobs - ref_logprobs) * r_mask
        kl_per_token = np.exp(log_ratio) - 1.0 - log_ratio
        # the controller sees the per-SEQUENCE kl sum
        accumulated_kl.append(kl_per_token.sum(axis=1).mean())

        kl_coef = self.kl_ctl.value
        new_elements = []
        for i in range(len(prompts)):
            n = int(r_mask[i].sum())
            rewards = -kl_coef * log_ratio[i, :n]
            if dense:
                ds = dense_scores[i]
                rewards[: min(n, len(ds))] += ds[: min(n, len(ds))]
            else:
                rewards[n - 1] += scores[i]
            new_elements.append(
                PPORLElement(
                    query_tensor=np.asarray(prompts[i], np.int32),
                    response_tensor=r_ids[i, :n],
                    logprobs=logprobs[i, :n],
                    values=values[i, :n],
                    rewards=rewards.astype(np.float32),
                )
            )
        # experience crosses a trust boundary here: the one choke point the
        # synchronous path and the async producer both assemble through.
        # Chaos site "bad-element" fabricates an offender first (free unarmed)
        new_elements = chaos_corrupt_elements(new_elements)
        if self._quarantine is not None:
            new_elements = self._quarantine.filter(new_elements, context=f"iter={self.iter_count}")
        ppo_rl_elements.extend(new_elements)

    # ---------------------------------------------------------- async rollouts

    def _resolve_async_config(self):
        """The effective ``train.async_rollouts`` block, or None for the
        synchronous path. ``max_staleness=0`` means fully on-policy, which
        is the synchronous path itself."""
        cfg = self.config.train.async_rollouts
        if not cfg.enabled:
            return None
        if cfg.max_staleness <= 0:
            logger.warning(
                "async_rollouts.max_staleness=0 requests fully on-policy data: running the synchronous rollout path"
            )
            return None
        if mesh_lib.process_count() > 1:
            logger.warning(
                "async_rollouts is single-process only (cross-host reward "
                "broadcast ordering is undefined off the main thread): "
                "running the synchronous rollout path"
            )
            return None
        return cfg

    def _start_async_engine(self):
        """Publish version 0, build the producer's copy of the policy and its
        generator, and start the producer thread (under
        ``train.self_healing``, a supervisor over engine generations that
        share the queue, the publisher and the accountant)."""
        cfg = self._async_cfg
        icfg = self.config.train.islands
        if icfg.enabled and self._serving_engine is None:
            logger.warning(
                "train.islands requires train.serving (the generation island IS the continuous-batching "
                "engine): running the monolithic publish path"
            )
        if icfg.enabled and self._serving_engine is not None:
            # the placement is logged, as the reference's; the port runs both
            # islands on self.device, so that is the carve it logs (shared)
            placement = carve_islands(icfg.gen_devices, devices=[self.device])
            # published snapshots are the policy's full state_dict; the engine
            # serves the trunk's keys
            self._island = GenerationIsland(self._serving_engine, param_selector=self._trunk_state)
            publisher = ChunkedParameterPublisher(
                chunk_layers=icfg.chunk_layers, chunk_pause_s=icfg.chunk_pause_s, round_gate=self._island.round_gate
            )
            self._island.bind_publisher(publisher)
            logger.info(
                f"generation island carved: gen={len(placement.gen)} device(s), learn={len(placement.learn)} "
                f"device(s), shared={placement.shared}, chunk_layers={icfg.chunk_layers}"
            )
        else:
            publisher = ParameterPublisher()
        self._policy_version = publisher.publish(self.model.state_dict())
        self._producer_model = self._new_policy()
        self._producer_model.requires_grad_(False)
        self._producer_params = None
        # the producer's own sampling stream: evaluate() keeps self.generator
        self._producer_generator = torch.Generator(device=self.device).manual_seed(
            int(self.config.train.seed) + 1
        )
        capacity = cfg.queue_capacity or 4 * self.method.num_rollouts
        queue = ExperienceQueue(capacity, cfg.high_watermark, cfg.low_watermark)
        accountant = StalenessAccountant(cfg.max_staleness)
        sh_config = self.config.train.self_healing
        supervised = sh_config.enabled

        def make_engine():
            # generations share queue/publisher/accountant; under supervision
            # a dead generation must not close the queue its successor feeds
            return AsyncRolloutEngine(
                self._produce_rollout_chunk, publisher, queue, accountant, close_queue_on_death=not supervised
            )

        if supervised:
            self._engine = ProducerSupervisor(
                make_engine,
                max_restarts=sh_config.max_producer_restarts,
                backoff_base_s=sh_config.restart_backoff_base_s,
                backoff_max_s=sh_config.restart_backoff_max_s,
                wedge_timeout_s=sh_config.wedge_timeout_s,
                diagnostics_dir=sh_config.diagnostics_dir
                or os.path.join(self.config.train.checkpoint_dir, "diagnostics"),
            )
        else:
            self._engine = make_engine()
        self._engine.start()
        logger.info(
            f"async rollout engine started{' (supervised)' if supervised else ''}: queue_capacity={capacity} "
            f"(high={queue.high_watermark}, low={queue.low_watermark}), "
            f"max_staleness={cfg.max_staleness}, publish_interval={cfg.publish_interval}"
        )

    def _produce_rollout_chunk(self, params, version):
        """PRODUCER THREAD: one decode batch of generate -> reward -> score,
        with the published snapshot as both sampling and behavior-scoring
        policy: the producer's copy of the policy loads a snapshot once, when
        its version is new. Shares no mutable state with the learner except
        the float stats below (atomic swaps under the GIL); evaluate() pauses
        the engine around itself."""
        with torch.no_grad():
            if params is not self._producer_params:
                self._producer_model.load_state_dict(params)
                self._producer_params = params
            elements: List[PPORLElement] = []
            kls: List[float] = []
            scores_log: List[float] = []
            self._phase_time = {"generate": 0.0, "reward": 0.0, "score": 0.0}
            t0 = time.perf_counter()
            self._collect_chunks(elements, kls, scores_log, policy=self._producer_model,
                                 generator=self._producer_generator, params=params)
        if kls:
            self.mean_kl = float(np.mean(kls))
        self.rollout_stats = self._rollout_stats(scores_log, **{
            "time/rollout_chunk_time": time.perf_counter() - t0, "rollout/producer_version": float(version)})
        return elements

    def _refill_store_async(self):
        """Pull ``num_rollouts`` staleness-admitted elements from the engine
        into the rollout store (the async analogue of make_experience)."""
        n = self.method.num_rollouts
        t0 = time.perf_counter()
        with span("queue_wait"):
            elements = self._engine.collect(n, self._policy_version, timeout=self._async_cfg.collect_timeout_s)
        gauges.set("rollout/collect_wait_s", time.perf_counter() - t0)
        if self.log_rollouts:
            self.store.export_history(location=self.rollout_logging_dir, tokenizer=self.tokenizer)
        self.push_to_store(elements[:n])

    # ------------------------------------------------------------- train loop

    def _extra_state(self):
        """The prompt-stream position, and (beyond the reference, which
        restarts both from their initial values on resume) the reward
        scores' running moments and the KL coefficient: ``scale_reward=
        "running"`` and the adaptive KL controller read them, and the step
        stats report them."""
        rm = self.running_moments
        return {
            "prompt_batches_drawn": self._prompt_batches_drawn,
            "running_moments": {"mean": rm.mean, "std": rm.std, "var": rm.var, "count": rm.count},
            "kl_ctl_value": self.kl_ctl.value,
        }

    def _restore_extra_state(self, state):
        self._resume_prompt_batches = int(state.get("prompt_batches_drawn", 0))
        for k, v in state.get("running_moments", {}).items():
            setattr(self.running_moments, k, v)
        if "kl_ctl_value" in state:
            self.kl_ctl.value = state["kl_ctl_value"]

    def _fast_forward_prompt_stream(self):
        """Replay the restored number of prompt-batch draws (exact replay:
        the loader reshuffles per epoch from ``seed + epoch``)."""
        n = self._resume_prompt_batches
        self._resume_prompt_batches = 0
        if n <= 0 or getattr(self, "prompt_iterator", None) is None:
            return
        for _ in range(n):
            next(self.prompt_iterator)
        self._prompt_batches_drawn = n
        logger.info(f"Resume: fast-forwarded the prompt stream by {n} batches")

    def prepare_learning(self):
        bs = self.config.train.batch_size
        self.num_mb = max(1, bs // (self.config.train.minibatch_size or bs))
        self._fast_forward_prompt_stream()
        self._resolve_serving()
        self._async_cfg = self._resolve_async_config()
        if self.config.train.islands.enabled and self._async_cfg is None:
            logger.warning(
                "train.islands requires train.async_rollouts (the bounded experience queue is the island seam): "
                "islands disabled"
            )
        if self._async_cfg is not None:
            self._start_async_engine()
            self._refill_store_async()
        else:
            self.make_experience(self.method.num_rollouts, self.iter_count)

    def create_train_dataloader(self):
        """ppo_epochs passes over the current rollout store per outer epoch."""
        loader = self.store.create_loader(
            self.config.train.batch_size, shuffle=True, seed=self.config.train.seed + self.iter_count
        )
        for _ in range(self.method.ppo_epochs):
            yield from loader

    def loss_fn(self, mb: PPORLBatch):
        """(loss, flat stats) of one device microbatch: the policy forward
        over prompt + response, logprobs and values over the response window,
        GAE, and the clipped PPO loss; under the async engine with
        ``staleness_correction``, the batch's staleness and the IS clip.
        Seq2seq: the query through the encoder, the response through the
        decoder (start token, response shifted right)."""
        if self.is_seq2seq:
            dec_in, dec_mask = self._decoder_inputs(mb.response_tensors, mb.response_mask)
            logits, values_pred, _ = self.model(mb.query_tensors, mb.attention_mask, dec_in, dec_mask)
            logprobs = logprobs_of_labels(logits, mb.response_tensors)
            values_pred = values_pred.float()
        else:
            seq = torch.cat([mb.query_tensors, mb.response_tensors], dim=1)
            mask = torch.cat([mb.attention_mask, mb.response_mask], dim=1)
            logits, values_pred, _, _ = self.model(seq, mask)
            start = mb.query_tensors.shape[1] - 1
            R = mb.response_tensors.shape[1]
            logprobs = logprobs_of_labels(logits[:, start:start + R], seq[:, start + 1:start + 1 + R])
            values_pred = values_pred[:, start:start + R].float()
        advantages, returns = self.method.get_advantages_and_returns(
            mb.values, mb.rewards, mb.response_mask
        )
        extra = {}
        if mb.staleness is not None:
            extra = dict(staleness=mb.staleness, is_ratio_clip=float(self._async_cfg.is_ratio_clip))
        loss, stats = self.method.loss(
            logprobs, values_pred, mb.logprobs, mb.values, advantages, returns, mb.response_mask, **extra,
        )
        return loss, flatten_dict(stats)

    def train_step(self, batch: PPORLBatch) -> Dict[str, float]:
        if self._engine is not None:
            # staleness is learner-relative and is stamped NOW (the learner
            # kept publishing while this collated batch waited)
            stale = np.maximum(0, self._policy_version - np.asarray(batch.policy_version, np.int64)).astype(np.int32)
            gauges.set("rollout/batch_staleness_mean", float(stale.mean()))
            gauges.set("rollout/batch_staleness_max", float(stale.max()))
            if self._async_cfg.staleness_correction:
                batch = batch.replace(staleness=stale)
        if self._train_step_fn is None:
            self._train_step_fn = self.make_grad_accum_step(self.loss_fn, self.num_mb)
        # the stream-overlap learn seam: the device copy staged during the
        # decode window when it matches this batch exactly, else a fresh copy
        dbatch = self._pop_staged_learn(batch)
        if dbatch is None:
            dbatch = batch.to(self.device)
        t_learn0 = time.monotonic()
        out = self._train_step_fn(dbatch)
        if self._island is not None:
            # the step's stats reached the host: the interval covers the
            # forward and backward (the optimizer update may still be queued)
            self._island.note_learn(t_learn0, time.monotonic())
            self._island.export_gauges()
        out.update(self.rollout_stats)
        if self._engine is not None:
            out.update(gauges.snapshot("rollout/"))
        if self._serving_client is not None:
            out.update(gauges.snapshot("serving/"))
            out.update(gauges.snapshot("fleet/"))
        return out

    def post_backward_callback(self):
        """KL controller update per optimizer step; under the async engine,
        also publish a copy of the trained state every ``publish_interval``
        steps, so the producer's next chunk samples the newest policy."""
        self.kl_ctl.update(self.mean_kl, n_steps=self.config.train.batch_size)
        if self._engine is not None and self.iter_count % max(1, self._async_cfg.publish_interval) == 0:
            t_pub0 = time.monotonic()
            self._policy_version = self._engine.publisher.publish(self.model.state_dict())
            gauges.set("rollout/learner_version", float(self._policy_version))
            if self._island is not None:
                # the broadcast runs on the learner's thread: learner busy
                # time, even though the chunks hide under decode
                self._island.note_learn(t_pub0, time.monotonic())

    def post_epoch_callback(self, epoch: int):
        """Discard stale rollouts and collect fresh experience (async: drain
        what the producer generated during the optimizer epochs)."""
        self.store.clear_history()
        if self._engine is not None:
            self._refill_store_async()
        else:
            self.make_experience(self.method.num_rollouts, self.iter_count)

    def _post_rollback_restore(self):
        """Mid-run health rollback: re-anchor what :meth:`load` alone cannot.
        The prompt iterator cannot rewind, so it is rebuilt from the kept
        pipeline and the restored draw count replayed (the exact-resume
        mechanics of a restart); the async producer is resynced by
        publishing the restored params, so its next chunk samples from the
        good policy (a new snapshot object, so a producer that rolls out
        through the serving engine installs it there too; the synchronous
        path installs the live weights at every experience phase); and
        experience collected from the bad policy is dropped
        (post_epoch_callback refills the store after the epoch breaks)."""

        def reanchor():
            if self._prompt_pipeline is not None:
                self.add_prompt_pipeline(self._prompt_pipeline)
                self._prompt_batches_drawn = 0
                self._fast_forward_prompt_stream()
            if self._engine is not None:
                self._policy_version = self._engine.publisher.publish(self.model.state_dict())
                gauges.set("rollout/learner_version", float(self._policy_version))

        if self._engine is not None and self._engine.running:
            # the producer draws from prompt_iterator between produce
            # iterations: swap it only while production is paused
            with self._engine.paused():
                reanchor()
        else:
            reanchor()
        self.store.clear_history()

    def evaluate(self):
        """Evaluation shares the tokenizer with the rollout producer: the
        engine pauses for its duration."""
        if self._engine is not None and self._engine.running:
            with self._engine.paused():
                return super().evaluate()
        return super().evaluate()


# -- the census (python -m trlx_tpu_torch.analysis.census) ---------------------

#: raw completion lengths: each ladder bucket once in the warmup, then only
#: already-dispatched buckets (the reference's probe, trlx_tpu/analysis/rt/probes.py:164-210)
_CENSUS_WARMUP_LENS = (5, 20, 50, 100)
_CENSUS_STEADY_LENS = (7, 25, 60, 90, 13)


@register_entrypoint(
    "stream_score_bucket",
    roots=(
        "trlx_tpu_torch.trainer.ppo_trainer.overlap_r_buckets",
        "trlx_tpu_torch.trainer.ppo_trainer.quantize_stream_response",
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer.score",
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer._score_device",
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer._ref_scoring_model",
        "trlx_tpu_torch.models.policy.CausalLMWithValueHead.*",
        "trlx_tpu_torch.models.transformer.*",
        "trlx_tpu_torch.ops.attention.flash_attention",
        "trlx_tpu_torch.utils.modeling.logprobs_of_labels",
    ),
    readback={
        # logprobs, values and reference logprobs to the host
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer.score": 1,
        # model.offload_ref: the upload of the host reference completes before its first read
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer._ref_scoring_model": 1,
    },
)
def build_stream_score_bucket(device, size, shared):
    """The streamed scoring of a microbucket: a raw completion length
    snapped onto the streaming ladder (``overlap_r_buckets`` +
    ``quantize_stream_response``), then the policy and reference scoring
    forwards at that length (``PPOTrainer.score``). One warmup step per
    ladder bucket; steady lengths land on those buckets only. Under
    ``TRLX_CENSUS_SEED_REGRESSION=shape_churn`` the raw lengths go through."""
    from trlx_tpu_torch.analysis.census import fixtures, seeds

    tr = fixtures.trainer("ppo", device, size, shared)
    s = fixtures.shapes(size, "score")
    B, P = s["B"], s["P"]
    ladder = overlap_r_buckets(s["max_new"])
    churn = seeds.active() == "shape_churn"
    lens = _CENSUS_WARMUP_LENS + _CENSUS_STEADY_LENS
    batches = {}
    for k, raw in enumerate(lens):
        R = raw if churn else quantize_stream_response(raw, ladder)
        g = np.random.default_rng(500 + k)
        seq = g.integers(1, 250, (B, P + R)).astype(np.int32)
        batches[k] = (seq, np.ones_like(seq), R)

    def step(k):
        seq, mask, R = batches[k]
        tr.score(seq, mask, P, R)

    n = len(_CENSUS_WARMUP_LENS)
    return Entry(step=step, warmup=tuple(range(n)), steady=tuple(range(n, len(lens))))
