"""MeshRLTrainer — the shared trainer engine, on one device (counterpart of
``trlx_tpu/trainer/mesh_trainer.py``; the name is kept so the counterpart is
easy to find, though the port runs no mesh).

Responsibilities: model and optimizer setup (``torch.optim`` with the JAX
package's schedules and global-norm clipping), the gradient-accumulation
train step (a Python loop over microbatches that averages their gradients),
padded one-shot generation, stop-sequence decode, evaluation, the main
``learn()`` loop with periodic eval / checkpoint / save-best, the port's own
checkpoints on the atomic-commit protocol (``torch.save`` payload,
``state.json``, the ``_COMMITTED`` sentinel last), the HF-format export
(``save_pretrained``), and tracking (jsonl, tensorboard or wandb) with the
JAX package's stat names.

``train.observability`` (:class:`~trlx_tpu_torch.obs.Observability`) adds
the span tracer (``generate``, ``evaluate``, ``learn``, ``checkpoint`` here;
``reward``, ``score``, ``queue_wait`` in PPO), per-step throughput and MFU
against the card's peak, CUDA memory gauges, request flights, the gauge
series exporters and the stall watchdog; off, it adds nothing to a step.
Each span closes after the host fetch that ends its phase, so it times the
device work and not only its launch. ``train.profile_dir`` traces the
steps ``[profile_start_step, profile_end_step)`` with ``torch.profiler``.

``train.resilience`` (:class:`~trlx_tpu_torch.resilience.Resilience`) adds
asynchronous checkpoint commits from host snapshots, SIGTERM/SIGINT
handling with a blocking emergency checkpoint, auto-resume from the newest
committed checkpoint and retried reward calls; ``train.self_healing`` adds
the health guard (a skipped optimizer step on non-finite loss or gradients
or a grad-norm spike, rollback to the newest committed checkpoint, halt
with a diagnostics bundle). Both off leave the step as it was; the plain
``save`` writes the sentinel either way.

Under ``TRLX_SWEEP`` the loop prints a ``SWEEP_METRIC {json}`` line at each
eval and a ``SWEEP_RESULT {json}`` line at the end, and returns early when
the file ``TRLX_SWEEP_STOP_FILE`` names exists (the JAX package's sweep
hooks, which the port's sweep runner, :mod:`trlx_tpu_torch.sweep`, reads).
The staged learn seam
(:meth:`MeshRLTrainer._pop_staged_learn`) hands ``train_step`` a device
copy of its batch staged during a streamed experience phase.

peft (``model.peft_config``: LoRA, prefix or prompt tuning; LoRA for T5)
trains the adapters and the heads only: the trunk's parameters get no
gradient and no optimizer state (:meth:`MeshRLTrainer.trainable_path_predicate`),
and ``save_pretrained`` exports the trunk with LoRA merged plus
``adapters.safetensors``. ``mesh.remat`` recomputes each block in the
backward (:func:`~trlx_tpu_torch.models.transformer.run_block`).
``train.rollout_param_dtype`` generates from a copy of the policy in that
dtype (:meth:`MeshRLTrainer.generation_model`), cast once per experience
phase and dropped before every learner step and on restore.

A stacked trunk (``scan_layers``, or ``pipeline_stages > 1`` with no pipe
axis) loads an HF checkpoint stacked (:meth:`MeshRLTrainer.maybe_stack_loaded`),
exports it unstacked, and trains every layer: ``num_layers_unfrozen >= 0``
raises, as the JAX trainer's freezing predicate does.

Across ranks (``TRLX_NUM_PROCESSES`` > 1, :func:`~trlx_tpu_torch.parallel.mesh.
initialize_distributed` first) the trainer builds the ``data × fsdp × pipe
× model`` mesh of ``config.mesh``: tensor parallelism over ``model`` and
each stage's layers over ``pipe``
(:func:`~trlx_tpu_torch.parallel.sharding.apply_mesh`; ``mesh.pipe > 1``
stacks the trunk and runs the GPipe schedule, with the JAX trainer's
refusals: :meth:`MeshRLTrainer.pipeline_overrides`), the sequence
dimension over ``model`` under ``mesh.sequence_shard`` or ring attention, ZeRO
storage over ``fsdp`` (:class:`~trlx_tpu_torch.parallel.fsdp.ShardedParams`,
gathered for each forward phase), gradients summed over ``data × fsdp`` and
the global-norm clip and health norm over every shard. Every rank holds the
same host data (the same prompts, samples and rollout store); each generates,
scores and trains on its rows of every batch (the rows the JAX ``put_batch``
gives its mesh position) and the results are gathered, so each rank's store
and stats are the same. The loss statistics are global over the batch ranks
(:func:`~trlx_tpu_torch.parallel.collectives.batch_group`). Process 0 alone
calls ``reward_fn`` under ``reward_on_process_zero`` (on by default across
ranks) and alone writes logs, checkpoints and the sweep lines; checkpoints
hold the gathered state and load back resharded. ``train.learner_overlap``
replaces the step by the overlapped FSDP step
(:func:`~trlx_tpu_torch.parallel.fsdp.make_overlapped_grad_accum_step`).
T5, peft (LoRA, prefix and prompt tuning) and ``model.offload_ref`` (each
rank's reference blocks in its host memory) run on a mesh too; 8-bit
Adam(W) and Adafactor over sharded leaves step through
:class:`~trlx_tpu_torch.parallel.fsdp.WholeLeafOptimizer` (the unsharded
formula). A native pre-converted store restores onto the mesh, each rank
reading only its blocks' chunks (:mod:`trlx_tpu_torch.checkpointing`).
"""

import copy
import dataclasses
import json
import os
import time
from abc import abstractmethod
from itertools import product
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models import safetensors_io
from trlx_tpu_torch.models.hf_loading import (
    ADAPTER_PARAM_NAMES,
    load_pretrained,
    load_pretrained_seq2seq,
    merge_loaded_state,
    peft_overrides,
    save_adapters,
    save_pretrained_hf,
    t5_peft_overrides,
    torch_dtype,
)
from trlx_tpu_torch.models.transformer import init_params, merge_lora_state
from trlx_tpu_torch.native import find_stop_positions
from trlx_tpu_torch.obs import Observability, batch_token_count
from trlx_tpu_torch.ops.generation import generate as generate_op
from trlx_tpu_torch.ops.generation import generate_seq2seq
from trlx_tpu_torch.ops.generation import left_pad_batch, pad_to_bucket
from trlx_tpu_torch.parallel import collectives as coll
from trlx_tpu_torch.parallel import mesh as mesh_lib
from trlx_tpu_torch.parallel.fsdp import (
    ShardedParams,
    WholeLeafOptimizer,
    can_overlap,
    full_shape,
    global_norm_sharded,
    make_overlapped_grad_accum_step,
    split_axes,
)
from trlx_tpu_torch.parallel.pipeline import stack_layer_params
from trlx_tpu_torch.parallel.sharding import apply_mesh, replicated_batch, spec_dim
from trlx_tpu_torch.pipeline.tokenization import load_tokenizer
from trlx_tpu_torch.resilience import Resilience, chaos_poison_batch, find_latest_committed, host_snapshot
from trlx_tpu_torch.resilience.checkpoint import (
    COMMITTED_SENTINEL,
    PAYLOAD_FILE,
    STATE_FILE,
    is_committed,
    mark_committed,
    write_json_atomic,
    write_payload,
)
from trlx_tpu_torch.resilience.health import TrainingHealthGuard
from trlx_tpu_torch.resilience.resume import pack_np_rng, pack_rng_key, restore_np_rng, unpack_rng_key
from trlx_tpu_torch.trainer import BaseRLTrainer, register_trainer
from trlx_tpu_torch.utils import (
    Clock,
    filter_non_scalars,
    get_optimizer_class,
    get_scheduler_class,
    logging,
    make_lr_scheduler,
    set_seed,
    significant,
)
from trlx_tpu_torch.utils.trackers import BaseTracker, make_tracker

logger = logging.get_logger(__name__)

#: the shared pow2 padding ladder (8 .. 8192) prompt and response lengths pad to
POW2_BUCKETS = [2 ** i for i in range(3, 14)]


def resolve_device(device, who: str = "trlx_tpu_torch.train") -> torch.device:
    """``None`` means the card: with no CUDA the caller must ask for the
    CPU explicitly (``device="cpu"``); nothing falls back silently. In a
    process group, ``"cuda"`` is the rank's card, ``cuda:<rank % count>``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on a CUDA device by default and none is available; "
                "pass device='cpu' to run the plain CPU path"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and mesh_lib.process_count() > 1:
        device = mesh_lib.rank_device(mesh_lib.process_index())
    return device


def check_port_config(config: TRLConfig) -> None:
    """Warn for the config keys that configure XLA alone (every mesh axis,
    ``mesh.sequence_shard`` and ring attention run in the port)."""
    for what in ("train.compilation_cache_dir", "mesh.compilation_cache_dir"):
        section, key = what.split(".")
        if getattr(getattr(config, section), key):
            logger.warning(f"{what} configures XLA's compile cache and has no effect in trlx_tpu_torch")


@register_trainer
class MeshRLTrainer(BaseRLTrainer):
    """Shared engine; algorithm trainers subclass and provide ``setup_model /
    gen_step_fn / create_train_dataloader / train_step / prepare_learning``.

    ``device=None`` resolves to ``"cuda"`` and raises when there is no CUDA
    device; pass ``device="cpu"`` for the CPU."""

    def __init__(self, config: TRLConfig, device=None, **kwargs):
        super().__init__(config, **kwargs)
        # the process group before anything that picks a device
        mesh_lib.initialize_distributed(device=device)
        check_port_config(config)
        # the pipe axis' refusals first, as the JAX trainers raise them in setup
        self._pipeline_overrides = self.pipeline_overrides()
        self.device = resolve_device(device, type(self).__name__)
        self.mesh = mesh_lib.mesh_from_config(config.mesh, self.device)
        self.multi_rank = self.mesh.size > 1
        self.is_main_process = mesh_lib.process_index() == 0
        if self.multi_rank:
            logger.info(f"rank {self.mesh.rank} of {self.mesh.size} on {self.device}, "
                        f"backend {mesh_lib.backend_name()}, coordinates {self.mesh.coords}", ranks=[-1])
        #: the ZeRO storage over fsdp (None on one rank): setup_sharding
        self.shards = None
        self.np_rng = set_seed(config.train.seed)
        # sampling stream of generate(), one per trainer (the JAX rng key)
        self.generator = torch.Generator(device=self.device).manual_seed(int(config.train.seed))
        self.tokenizer = load_tokenizer(config.tokenizer)
        self.compute_dtype = torch_dtype(config.mesh.compute_dtype)
        self.param_dtype = torch_dtype(config.mesh.param_dtype)
        #: model.model_arch_type == "seq2seq": a T5 trunk under ``t5.*``
        self.is_seq2seq = config.model.model_arch_type == "seq2seq"
        #: train.rollout_param_dtype (None: generate from the masters)
        self.rollout_dtype = None if config.train.rollout_param_dtype is None else torch_dtype(
            config.train.rollout_param_dtype)
        # the cached low-precision policy copy generation reads, and how many
        # times one was cast (generation_model)
        self._rollout_model = None
        self.rollout_casts = 0

        self.setup_model()
        self.setup_sharding()
        self.setup_optimizer()

        self.iter_count = 0
        self.nth_evaluation = 0
        self.best_reward = -float("inf")
        self.clock = Clock()
        self.generate_kwargs = dict(getattr(config.method, "gen_kwargs", {}) or {})
        self.generate_experience_kwargs = getattr(config.method, "gen_experience_kwargs", None)

        if config.train.run_name is None:
            config.train.run_name = (
                f"{config.model.model_path.split('/')[-1]}/{self.device.type}"
            ).replace("/", "_")
        # process 0 logs; the others keep a tracker that writes nothing
        self.tracker = make_tracker(config.train, config.to_dict()) if self.is_main_process else BaseTracker()
        # observability (span tracing / MFU / memory gauges / watchdog /
        # flights); disabled, every obs call is a near-no-op
        self.obs = Observability(
            config.train.observability,
            config.train.logging_dir or os.path.join(config.train.checkpoint_dir, "logs"),
            device=self.device,
        )
        # resilience (async atomic checkpointing / preemption handling /
        # auto-resume / reward retries); disabled, every hook is a no-op and
        # reward_fn is wrapped only with the free chaos check
        self.resilience = Resilience(config.train.resilience, multiprocess=mesh_lib.process_count() > 1)
        self.reward_fn = self.resilience.wrap_reward_fn(self.reward_fn)
        # the health guard (skip -> rollback -> halt); None when disabled,
        # and the optimizer step is then the unguarded one
        self.health = None
        sh_config = config.train.self_healing
        if sh_config.enabled:
            self.health = TrainingHealthGuard(
                sh_config,
                diagnostics_dir=sh_config.diagnostics_dir or os.path.join(config.train.checkpoint_dir, "diagnostics"),
            )
        self.self_healing_summary = None
        #: seconds of the last emergency checkpoint (set on preemption)
        self.emergency_checkpoint_s = None

    # ------------------------------------------------------------- model setup

    @abstractmethod
    def setup_model(self):
        """Set self.model (the trained module), self.model_config, self.model_type."""
        ...

    def load_trunk(self, build: Callable[[Any], torch.nn.Module]) -> torch.nn.Module:
        """``build(config)`` on the device for the config of
        ``load_pretrained(model.model_path)`` (which also sets
        ``self.model_config`` and ``self.model_type``), random weights from
        the seed, then a loaded checkpoint's trunk over the module's
        ``transformer`` (or the module itself when it is the trunk) with
        ``merge_loaded_state``: heads keep their seed init."""
        overrides = dict(self.config.model.model_overrides or {})
        overrides.setdefault("param_dtype", self.param_dtype)
        overrides.setdefault("compute_dtype", self.compute_dtype)
        overrides.setdefault("remat", self.config.mesh.remat)
        overrides.setdefault("sequence_sharding", self.config.mesh.sequence_shard)
        overrides.update(peft_overrides(self.config.model.peft_config))
        overrides.update(self._pipeline_overrides)
        path = self.config.model.model_path
        self.model_config, trunk_state, self.model_type = load_pretrained(path, overrides)
        trunk_state = self.maybe_stack_loaded(trunk_state)
        with torch.device(self.device):
            module = build(self.model_config)
            module.init_params(self.config.train.seed)
        if trunk_state is not None:
            merge_loaded_state(getattr(module, "transformer", module), trunk_state)
        if self.model_config.stacked and not self.config.model.peft_config:
            # the JAX trainer raises this from its freezing predicate; here
            # before a hydra branch is cut from per-layer names
            self.trainable_path_predicate("transformer.layers_scan")
        return module

    def pipeline_overrides(self) -> Dict[str, Any]:
        """Model overrides enabling pipeline parallelism when ``mesh.pipe >
        1`` (the stacked layout and the GPipe schedule,
        :mod:`trlx_tpu_torch.parallel.pipeline`), with the JAX trainer's
        refusals: stacked layers have no per-layer parameter paths, so
        partial layer freezing and the hydra / value branches (which capture
        a mid-stack activation) are unavailable, and PPO uses the full
        reference copy it uses at ``num_layers_unfrozen=-1``."""
        mc = self.config.mesh
        if mc.pipe <= 1:
            return {}
        if self.config.model.model_arch_type == "seq2seq":
            raise ValueError("pipeline parallelism (mesh.pipe > 1) is causal-LM only")
        if self.config.model.num_layers_unfrozen >= 0:
            raise ValueError(
                "mesh.pipe > 1 requires num_layers_unfrozen=-1: pipelined models "
                "keep block params stacked and cannot freeze or branch at a layer "
                "boundary (PPO then uses a full reference copy automatically)"
            )
        if getattr(self.config.method, "num_value_layers_unfrozen", 0):
            raise ValueError("mesh.pipe > 1 requires num_value_layers_unfrozen=0")
        overrides: Dict[str, Any] = {
            "pipeline_stages": mc.pipe,
            "pipeline_microbatches": mc.pipeline_microbatches,
        }
        if mc.sequence_shard:
            logger.warning(
                "mesh.sequence_shard is disabled under pipeline parallelism: "
                "the pipelined stack applies no sequence-sharding constraints"
            )
            overrides["sequence_sharding"] = False
        return overrides

    def maybe_stack_loaded(self, trunk_state):
        """A loaded per-layer trunk ``state_dict`` in the stacked layout when
        the built model uses it (``scan_layers`` or ``pipeline_stages > 1``)."""
        if self.model_config.stacked and trunk_state is not None:
            return stack_layer_params(trunk_state, self.model_config.num_layers)
        return trunk_state

    def load_t5(self, build: Callable[[Any], torch.nn.Module]) -> torch.nn.Module:
        """The seq2seq :meth:`load_trunk`: ``build(config)`` on the device for
        the :class:`~trlx_tpu_torch.models.t5.T5Config` of
        ``load_pretrained_seq2seq(model.model_path)`` (also set as
        ``self.model_config``; ``self.model_type`` is ``"t5"`` and
        ``self.decoder_start_token_id`` the config's), random weights from
        the seed, then a loaded checkpoint over the module's ``t5``."""
        overrides = dict(self.config.model.model_overrides or {})
        overrides.setdefault("param_dtype", self.param_dtype)
        overrides.setdefault("compute_dtype", self.compute_dtype)
        overrides.update(t5_peft_overrides(self.config.model.peft_config))
        path = self.config.model.model_path
        self.model_config, t5_state = load_pretrained_seq2seq(path, overrides)
        self.model_type = "t5"
        self.decoder_start_token_id = self.model_config.decoder_start_token_id
        with torch.device(self.device):
            module = init_params(build(self.model_config), self.config.train.seed)
        if t5_state is not None:
            merge_loaded_state(module.t5, t5_state)
        return module

    def trainable_path_predicate(self, path: str) -> bool:
        """Which params receive gradients: with ``model.peft_config`` only the
        adapters (LoRA, prefix K/V, prompt embeddings) and the heads, over
        ``num_layers_unfrozen``; else with num_layers_unfrozen = N >= 0 only
        the top N transformer layers and all heads; -1 trains everything.
        ``path`` is a ``state_dict`` name."""
        if self.config.model.peft_config:
            if path.rsplit(".", 1)[-1] in ADAPTER_PARAM_NAMES:
                return True
            return path.split(".", 1)[0] not in ("transformer", "t5")
        n_unfrozen = self.config.model.num_layers_unfrozen
        if n_unfrozen < 0:
            return True
        if not path.startswith("transformer."):
            return True  # heads always train
        if "layers_scan" in path:
            # stacked blocks have no per-layer paths: partial freezing
            # cannot be honoured
            raise ValueError(
                "num_layers_unfrozen >= 0 cannot be applied to a stacked "
                "(pipeline_stages > 1) model; set num_layers_unfrozen=-1"
            )
        if "layers_" in path:
            layer = int(path.split("layers_")[1].split(".")[0])
            return layer >= self.model_config.num_layers - n_unfrozen
        # embeddings / final norm / lm_head of the trunk
        return False

    def sharded_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules whose parameters live on the mesh, by name prefix
        (PPO adds its frozen reference)."""
        return {"": self.model}

    def setup_sharding(self):
        """On more than one rank: tensor parallelism over ``model`` and the
        ZeRO storage over ``fsdp`` of :meth:`sharded_modules`, by the JAX
        package's rules (every rank holds the same full parameters here)."""
        if not self.multi_rank:
            return
        modules = self.sharded_modules()
        specs = {}
        for prefix, module in modules.items():
            for name, spec in apply_mesh(module, self.mesh).items():
                specs[f"{prefix}.{name}" if prefix else name] = spec
        self.shards = ShardedParams(modules, specs, self.mesh)
        over_model = sum(spec_dim(leaf.spec, mesh_lib.MODEL_AXIS) >= 0 for leaf in self.shards.leaves)
        logger.info(f"mesh {self.mesh.shape}: {sum(leaf.sharded for leaf in self.shards.leaves)} leaves sharded "
                    f"over fsdp, {over_model} over model")

    @torch.no_grad()
    def load_full_params(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy whole parameters (``{name: tensor}``, names as in
        :meth:`sharded_modules`, the policy's without a prefix) into the
        trainer, each rank keeping its blocks."""
        if self.shards is not None:
            self.shards.load_full_state(state)
            return
        for prefix, module in self.sharded_modules().items():
            pre = f"{prefix}." if prefix else ""
            # strict=False: the policy's pass sees the reference's names too
            module.load_state_dict({k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}, strict=False)
        self._rollout_model = None

    def params_gathered(self):
        """Every fsdp-sharded parameter whole for the enclosed forwards
        (nothing to do on one rank)."""
        return self.shards.gathered() if self.shards is not None else _null_context()

    def _learner_overlap_active(self) -> bool:
        """Whether the overlapped FSDP step (``train.learner_overlap``)
        replaces the default step: on a pure data / fsdp mesh and without the
        health guard; otherwise it warns and keeps the default step, as the
        JAX trainer does."""
        cfg = self.config.train.learner_overlap
        if not cfg.enabled:
            return False
        if not can_overlap(self.mesh):
            logger.warning(
                "train.learner_overlap requires a pure data/fsdp mesh "
                f"(model=1, pipe=1), got {dict(self.mesh.shape)}: falling back "
                "to the default train step"
            )
            return False
        if self.config.train.self_healing.enabled:
            logger.warning(
                "train.learner_overlap is incompatible with the self-healing "
                "health guard (the skip lives in the default step): "
                "falling back to the default train step"
            )
            return False
        return True

    def setup_optimizer(self):
        """Optimizer and schedule from the registries over the trainable
        parameters (frozen ones get no gradient and no update, as optax's
        ``set_to_zero`` partition). The optimizer's base rate is 1 and the
        schedule sets the rate per step (``make_lr_scheduler``). On a mesh
        the optimizer updates each leaf's master (its fsdp shard, or the
        whole leaf), so its state is sharded like the parameters; under
        ``train.learner_overlap.int8_opt_state`` an Adam-family optimizer
        becomes the 8-bit one, its blocks over the local shard."""
        kwargs = dict(self.config.optimizer.kwargs)
        lr = kwargs.pop("lr", 1e-5)
        sched_kwargs = dict(self.config.scheduler.kwargs)
        sched_lr = sched_kwargs.pop("learning_rate", lr)
        self.lr_schedule = get_scheduler_class(self.config.scheduler.name)(
            learning_rate=sched_lr, **sched_kwargs
        )
        self.max_grad_norm = kwargs.pop("max_grad_norm", None)
        self.overlap = self._learner_overlap_active()
        #: the whole-leaf adapter of 8-bit Adam(W) / Adafactor over sharded leaves (None otherwise)
        self.whole_leaf = None
        opt_name = str(self.config.optimizer.name).lower()
        if self.overlap and self.config.train.learner_overlap.int8_opt_state:
            if opt_name in ("adam", "adamw", "adamw_8bit_bnb"):
                opt_name = "adamw_8bit_bnb"
            else:
                logger.warning(f"learner_overlap.int8_opt_state ignored: optimizer {opt_name!r} is not adam-family")
        # the module parameters that train, and the tensors the optimizer
        # updates for them (their masters on a mesh)
        self._leaf_params = []
        for name, p in self.model.named_parameters():
            if self.trainable_path_predicate(name):
                self._leaf_params.append(p)
            else:
                p.requires_grad_(False)
        if self.shards is None:
            self.trainable_params = list(self._leaf_params)
        else:
            leaves = [self.shards.by_param[id(p)] for p in self._leaf_params]
            for leaf in leaves:
                leaf.master.requires_grad_(True)
            self.trainable_params = [leaf.master for leaf in leaves]
            split = any(split_axes(leaf) for leaf in leaves)
            blockwise = opt_name in ("adamw_8bit_bnb", "adam_8bit_bnb")
            if split and not self.overlap and (blockwise or opt_name == "adafactor"):
                # the update reads the whole leaf: the unsharded formula over blocks
                self.whole_leaf = WholeLeafOptimizer(get_optimizer_class(opt_name), leaves, self.shards, blockwise,
                                                     learning_rate=1.0, **kwargs)
                self.optimizer = self.whole_leaf.optimizer
                self.scheduler = make_lr_scheduler(self.optimizer, self.lr_schedule)
                return
        self.optimizer = get_optimizer_class(opt_name)(
            self.trainable_params, learning_rate=1.0, **kwargs
        )
        self.scheduler = make_lr_scheduler(self.optimizer, self.lr_schedule)

    # -------------------------------------------------------------- train step

    def optimizer_step(self) -> None:
        """One optimizer update of the trained leaves (through
        :class:`~trlx_tpu_torch.parallel.fsdp.WholeLeafOptimizer` where the
        update reads whole leaves held as blocks)."""
        if self.whole_leaf is not None:
            self.whole_leaf.step()
        else:
            self.optimizer.step()

    def global_grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """optax.global_norm: the f32 L2 norm over every gradient (of
        :attr:`trainable_params`; on a mesh over every shard of them)."""
        if self.shards is not None:
            return global_norm_sharded([self.shards.by_param[id(p)] for p in self._leaf_params], grads, self.mesh)
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))

    def clip_grads(self, grads: List[torch.Tensor], norm: Optional[torch.Tensor] = None) -> None:
        """optax.clip_by_global_norm in place: past ``max_grad_norm`` every
        gradient becomes ``g / norm * max_grad_norm`` (``norm``, when given,
        is :meth:`global_grad_norm` of ``grads``)."""
        if norm is None:
            norm = self.global_grad_norm(grads)
        keep = norm < self.max_grad_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * self.max_grad_norm))

    def make_grad_accum_step(self, loss_fn: Callable, num_mb: int):
        """The optimizer step: a loop over ``num_mb`` microbatches that sums
        their gradients, divides by ``num_mb``, clips, and takes one
        optimizer step. ``loss_fn(microbatch) -> (loss, flat stats)``. The
        step returns the stats averaged over microbatches, plus
        ``learning_rate_group_0``: the schedule at the step count before the
        update, the rate the update used. It first drops the rollout copy
        (:meth:`generation_model`).

        Every trained parameter takes part in every step, as optax's update
        over the "train" partition does: one that the loss does not reach
        (GRPO's value head) gets a zero gradient, so AdamW still decays it
        and advances its moments, where a ``None`` gradient would make
        ``torch.optim`` skip it.

        With the health guard (``train.self_healing``) the step also reads
        the global norm of the averaged gradients before clipping, and takes
        the update only if the mean microbatch loss and that norm are finite
        and the norm is at most ``health.grad_norm_cap()``: the decision
        comes to the host with the stats, in their one transfer, and a
        skipped step calls neither ``optimizer.step()`` nor
        ``scheduler.step()`` (parameters, AdamW's moments and count and the
        schedule stay as they were). It reports ``health/grad_norm`` and
        ``health/update_applied``."""
        guard = self.health
        if self.overlap:
            logger.info(
                f"learner_overlap: overlapped FSDP step active (fsdp={self.mesh.shape[mesh_lib.FSDP_AXIS]}, "
                f"num_microbatches={num_mb}, optimizer={type(self.optimizer).__name__}, "
                f"max_grad_norm={self.max_grad_norm})")
            return make_overlapped_grad_accum_step(self, loss_fn, num_mb)
        dp = self.mesh.axis_size(mesh_lib.BATCH_AXES)

        def step(batch) -> Dict[str, float]:
            # the rollout copy goes BEFORE the step: the step is the memory
            # peak, and the copy is stale after it
            self._rollout_model = None
            self.optimizer.zero_grad(set_to_none=True)
            per_mb, losses = [], []
            replicated = False
            with self.params_gathered():
                for mb in batch.split(num_mb):
                    # the JAX step's layout: the global batch splits into
                    # microbatches first, and each microbatch is sharded
                    group = None
                    if dp > 1:
                        rows = mesh_lib.local_rows(self.mesh, mesh_lib.batch_rows(mb))
                        replicated = rows is None
                        if not replicated:
                            mb, group = mb.split(dp)[self.mesh.axis_index(mesh_lib.BATCH_AXES)], self.mesh.batch_group
                    # a batch kept whole on every rank shards no sequence
                    with coll.batch_group(group), replicated_batch(replicated):
                        loss, stats = loss_fn(mb)
                    loss.backward()
                    if guard is not None:
                        losses.append(loss.detach().float())
                    per_mb.append({k: torch.as_tensor(v, dtype=torch.float32, device=self.device).detach()
                                   for k, v in stats.items()})
                if self.shards is not None:
                    # each rank's replicated batch gives the whole gradient: average
                    self.shards.reduce_grads(1.0 / dp if replicated else 1.0)
            for p in self.trainable_params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in self.trainable_params]
            for g in grads:
                g.div_(num_mb)
            keys = list(per_mb[0])
            means = [torch.stack([s[k] for s in per_mb]).mean() for k in keys]
            lr = self.scheduler.get_last_lr()[0]
            if guard is None:
                if self.max_grad_norm:
                    self.clip_grads(grads)
                self.optimizer_step()
                self.scheduler.step()
                mean_stats = dict(zip(keys, torch.stack(means).tolist()))
            else:
                norm = self.global_grad_norm(grads)
                ok = torch.isfinite(torch.stack(losses).mean()) & torch.isfinite(norm) & (
                    norm <= guard.grad_norm_cap())
                values = torch.stack(means + [norm, ok.float()]).tolist()
                mean_stats = dict(zip(keys + ["health/grad_norm", "health/update_applied"], values))
                if mean_stats["health/update_applied"] >= 0.5:
                    if self.max_grad_norm:
                        self.clip_grads(grads, norm)
                    self.optimizer_step()
                    self.scheduler.step()
            mean_stats["learning_rate_group_0"] = float(lr)
            return mean_stats

        return step

    # -------------------------------------------------------------- generation

    def gen_logits_processor(self, **kwargs):
        """Optional decode-time logits processor (ILQL's advantage shaping);
        ``None`` for PPO, SFT and RFT."""
        return None

    def pop_gen_processor_kwargs(self, gen_kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """Remove and return the gen_kwargs that the logits processor takes
        rather than the generation loop (ILQL's ``beta``)."""
        return {}

    def seq2seq_gen_fns(self, policy=None) -> Dict[str, Callable]:
        """The encode / cross_kv / decode / init_cache functions of
        :func:`generate_seq2seq` over ``policy`` (default ``self.model``):
        a module with a ``t5`` trunk."""
        t5 = (self.model if policy is None else policy).t5
        return {"encode": t5.encode, "cross_kv": t5.precompute_cross_kv, "decode": t5.decode,
                "init_cache": t5.init_cache}

    @abstractmethod
    def gen_step_fn(self, policy=None):
        """Return step_fn(ids, mask, positions, cache) -> (logits, hidden,
        cache) and init_cache_fn(batch, total_len) for :func:`generate`, for
        ``policy`` (a module shaped like ``self.model``; default
        ``self.model``)."""
        ...

    def generation_model(self) -> torch.nn.Module:
        """The module ``generate`` samples from: ``self.model``, or under
        ``train.rollout_param_dtype`` a copy of it with every floating
        parameter in that dtype (norm scales too), cast at the first call
        after a learner step or a restore (one cast per experience phase) and
        cached until the next: decode then reads half the bytes and casts no
        parameter per call."""
        if self.rollout_dtype is None:
            return self.model
        if self._rollout_model is None:
            with torch.no_grad():
                memo = {id(p): torch.nn.Parameter(p.detach().to(self.rollout_dtype), requires_grad=False)
                        for p in self.model.parameters() if p.is_floating_point()}
                self._rollout_model = copy.deepcopy(self.model, memo)
            self.rollout_casts += 1
        return self._rollout_model

    def generate(self, prompts_ids: List[np.ndarray], eval_mode: bool = False, policy=None, generator=None,
                 **kwargs):
        """Generate continuations for a list of ragged prompt id arrays:
        prompts left-padded to a pow2 bucket, one padded ``generate`` on the
        trainer's device. ``policy`` and ``generator`` replace the model and
        the sampling stream (the async producer passes its own). Returns
        host ``(sequences, response_mask, P)``; for a seq2seq model the
        sequences are the decoder start token and the response, so P is 1."""
        gen_kwargs = dict(self.generate_kwargs)
        if not eval_mode and self.generate_experience_kwargs:
            gen_kwargs = dict(self.generate_experience_kwargs)
        gen_kwargs.update(kwargs)
        gen_kwargs.setdefault("eos_token_id", self.tokenizer.eos_token_id)
        gen_kwargs.setdefault("pad_token_id", self.tokenizer.pad_token_id)
        max_new = int(gen_kwargs.pop("max_new_tokens", 16))
        proc_kwargs = self.pop_gen_processor_kwargs(gen_kwargs)

        P = pad_to_bucket(max(len(p) for p in prompts_ids), POW2_BUCKETS)
        ids, mask = left_pad_batch(prompts_ids, gen_kwargs["pad_token_id"], P)
        # on a mesh each rank decodes its rows (all of them when the batch
        # does not split) and the ranks step in lockstep
        B = len(ids)
        rows = mesh_lib.local_rows(self.mesh, B) if self.multi_rank else None
        if rows is not None:
            ids, mask = ids[rows], mask[rows]
            gen_kwargs["rows"] = (rows.start, B)
        if self.multi_rank:
            gen_kwargs["sync_group"] = self.mesh.world_group
        ids_t, mask_t = torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)
        generator = self.generator if generator is None else generator
        processor = self.gen_logits_processor(**proc_kwargs)
        # the span closes after the host fetch: decode runs asynchronously
        # until it, so timing the launches alone would undercount
        replicated = self.multi_rank and rows is None and mesh_lib.dp_size(self.mesh) > 1
        with self.obs.span("generate"), self.params_gathered(), replicated_batch(replicated):
            if policy is None:
                policy = self.generation_model()
            if self.is_seq2seq:
                fns = self.seq2seq_gen_fns(policy)
                out = generate_seq2seq(
                    fns["encode"], fns["cross_kv"], fns["decode"], fns["init_cache"], ids_t, mask_t, generator,
                    max_new, decoder_start_token_id=self.decoder_start_token_id, logits_processor=processor,
                    **gen_kwargs,
                )
            else:
                step_fn, init_cache_fn = self.gen_step_fn(policy)
                out = generate_op(step_fn, init_cache_fn, ids_t, mask_t, generator, max_new,
                                  logits_processor=processor, **gen_kwargs)
            if rows is not None:
                out = {k: coll.all_gather(v, self.mesh.batch_group, 0) for k, v in out.items()}
            sequences = out["sequences"].cpu().numpy()
            response_mask = out["response_mask"].cpu().numpy()
        # seq2seq sequences are [decoder start] + response: decode()'s pad length is 1
        return sequences, response_mask, 1 if self.is_seq2seq else P

    def decode(
        self,
        prompts: List[np.ndarray],
        samples: np.ndarray,
        prompt_pad_len: int,
        append_eos: bool = False,
        response_masks: Optional[np.ndarray] = None,
    ) -> Tuple[List[str], List[str], List[str], List[np.ndarray]]:
        """Decode generated sequences into (str_samples, str_prompts,
        str_outputs, trimmed_output_ids), trimming at the first stop sequence
        and (optionally) re-appending eos — the JAX package's token-level
        trimming, line for line."""
        B = len(prompts)
        resp_all = np.ascontiguousarray(samples[:, prompt_pad_len:], np.int32)
        eos = self.tokenizer.eos_token_id
        pad = self.tokenizer.pad_token_id
        if response_masks is not None:
            lens = np.asarray(response_masks).sum(axis=1).astype(np.int64)
        else:
            valid = resp_all != pad
            lens = np.where(
                valid.any(axis=1), resp_all.shape[1] - np.argmax(valid[:, ::-1], axis=1), 0
            ).astype(np.int64)
        # response_mask counts the eos token itself; output ids exclude it
        if eos is not None and B > 0:
            last = resp_all[np.arange(B), np.maximum(lens - 1, 0)]
            lens = lens - ((lens > 0) & (last == eos)).astype(np.int64)
        token_stopped = np.zeros(B, bool)
        if self.stop_sequences:
            if not hasattr(self, "_stop_token_ids"):
                self._stop_token_ids = [
                    self.tokenizer(s, add_special_tokens=False).input_ids
                    for s in self.stop_sequences
                ]
            stop_pos = find_stop_positions(resp_all, self._stop_token_ids)
            token_stopped = stop_pos < lens
            lens = np.minimum(lens, stop_pos)

        str_samples, str_prompts, str_outputs, out_ids = [], [], [], []
        for i, prompt in enumerate(prompts):
            str_prompt = self.tokenizer.decode(prompt, skip_special_tokens=True)
            resp = resp_all[i, : lens[i]]
            if token_stopped[i]:
                # drop the whitespace run preceding the stop sequence (token-level)
                while len(resp) and self.tokenizer.decode(resp[-1:]).strip() == "":
                    resp = resp[:-1]
            str_output = self.tokenizer.decode(resp, skip_special_tokens=True)
            if token_stopped[i]:
                str_output = str_output.rstrip()
            for stop in self.stop_sequences:
                stop_ix = str_output.find(stop)
                if stop_ix >= 0:  # crossed a token boundary; rare slow path
                    str_output = str_output[:stop_ix].rstrip()
                    resp = np.asarray(
                        self.tokenizer(str_output, add_special_tokens=False).input_ids, np.int32
                    )
            trimmed = list(resp)
            if append_eos and eos is not None:
                trimmed.append(eos)
            if len(trimmed) == 0:  # never emit empty responses (breaks PPO shapes)
                trimmed = [eos or 0]
            str_samples.append(str_prompt + str_output)
            str_prompts.append(str_prompt)
            str_outputs.append(str_output)
            out_ids.append(np.asarray(trimmed, np.int32))
        return str_samples, str_prompts, str_outputs, out_ids

    # -------------------------------------------------------------- evaluation

    @property
    def reward_on_process_zero(self) -> bool:
        """Resolved ``train.reward_on_process_zero``: None (the default) means
        on exactly when the run has more than one process."""
        flag = self.config.train.reward_on_process_zero
        if flag is None:
            return mesh_lib.process_count() > 1
        return bool(flag)

    def call_reward_fn(self, **kwargs):
        """``reward_fn``; under :attr:`reward_on_process_zero` only process 0
        calls it and its scores are broadcast to every rank. Every rank must
        reach this call at the same point (the broadcast is a collective):
        the main thread only."""
        if not self.reward_on_process_zero or mesh_lib.process_count() == 1:
            return self.reward_fn(**kwargs)
        scores = self.reward_fn(**kwargs) if self.is_main_process else None
        return self.broadcast_scores(scores)

    def broadcast_scores(self, scores):
        """Process 0's scores on every rank (main thread only: a collective)."""
        if scores is not None:
            scores = [np.asarray(s, np.float32) if np.ndim(s) > 0 else float(s) for s in scores]
        return coll.broadcast_object(scores, self.mesh.world_group)

    def evaluate(self) -> Dict[str, Any]:
        """Generate on eval prompts, score with reward_fn/metric_fn, log a
        sample table (list-valued gen_kwargs sweep, one suffix per combo)."""
        logger.info("Evaluating model")
        stats: Dict[str, Any] = {}
        sweep_keys = [k for k, v in self.generate_kwargs.items() if isinstance(v, list)]
        sweeps = [{}]
        if sweep_keys:
            base = {k: v for k, v in self.generate_kwargs.items() if k not in sweep_keys}
            sweeps = [
                {**base, **dict(zip(sweep_keys, combo))}
                for combo in product(*[self.generate_kwargs[k] for k in sweep_keys])
            ]

        for sweep_kwargs in sweeps:
            suffix = "".join(f"@{k}={v}" for k, v in sweep_kwargs.items() if k in sweep_keys)
            # decode per batch with that batch's own prompt pad length
            str_samples, str_prompts, str_outputs, meta = [], [], [], {}
            for batch in self.eval_pipeline.create_loader(self.config.train.batch_size):
                prompts = batch["input_ids"]
                samples, resp_mask, pad_len = self.generate(prompts, eval_mode=True, **sweep_kwargs)
                s, p, o, _ = self.decode(prompts, samples, pad_len, response_masks=resp_mask)
                str_samples.extend(s)
                str_prompts.extend(p)
                str_outputs.extend(o)
                for k, v in batch.items():
                    if k != "input_ids":
                        meta.setdefault(k, []).extend(v)

            columns = ["prompt", "output"]
            columns_data = [str_prompts, str_outputs]
            if self.reward_fn is not None:
                rewards = self.call_reward_fn(
                    samples=str_samples, prompts=str_prompts, outputs=str_outputs,
                    tokenizer=self.tokenizer, **meta,
                )
                rewards = [float(np.sum(r)) if np.ndim(r) > 0 else float(r) for r in rewards]
                columns.append("reward")
                columns_data.append(rewards)
                stats[f"reward/mean{suffix}"] = float(np.mean(rewards))
                stats[f"reward/std{suffix}"] = float(np.std(rewards))
            if self.metric_fn is not None:
                metrics = self.metric_fn(
                    samples=str_samples, prompts=str_prompts, outputs=str_outputs, **meta
                )
                for k, xs in metrics.items():
                    stats[f"metrics/{k}{suffix}"] = float(np.mean(xs))
                    if np.ndim(xs) > 0 and len(xs) == len(str_samples):
                        columns.append(k)
                        columns_data.append(list(map(float, xs)))
            rows = list(zip(*columns_data))
            self.tracker.log_table(f"samples{suffix}", columns, [list(r) for r in rows], self.iter_count)
            for row in rows[:4]:
                logger.info(" | ".join(str(c)[:72] for c in row))
        self.nth_evaluation += 1
        return stats

    # -------------------------------------------------------------- main loop

    @abstractmethod
    def create_train_dataloader(self):
        ...

    @abstractmethod
    def train_step(self, batch) -> Dict[str, float]:
        """One optimizer step on a host batch; returns flat stats."""
        ...

    # ----------------------------------------------------- staged learn batches
    # The learn seam of stream-overlapped PPO: during the streaming window the
    # experience phase collates upcoming first-epoch learner batches and
    # copies them to the device while decode runs; the train loop consumes a
    # staged copy instead of copying again. Only a transfer optimization: the
    # staged host batch must equal the loader's batch, or the whole stage is
    # dropped, so the optimizer sees the same data either way.

    def _clear_staged_learn(self) -> None:
        self._staged_learn: List[Tuple[Any, Any]] = []

    def _stage_learn_batch(self, host_batch, device_batch) -> None:
        """Record a (host, device) learn-batch pair staged ahead of the loop."""
        if not hasattr(self, "_staged_learn"):
            self._clear_staged_learn()
        self._staged_learn.append((host_batch, device_batch))

    @staticmethod
    def _host_batches_equal(a, b) -> bool:
        """Same structure (dataclass fields or dict keys) and equal arrays."""
        def leaves(x):
            if dataclasses.is_dataclass(x):
                return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
            return dict(x)

        if type(a) is not type(b):
            return False
        la, lb = leaves(a), leaves(b)
        if la.keys() != lb.keys():
            return False
        for k, x in la.items():
            y = lb[k]
            if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
                return False
        return True

    def _pop_staged_learn(self, batch):
        """The device copy staged for ``batch``, or None for a fresh copy.
        Staged batches predict the loader's output in order; the first
        mismatch (a quarantine drop, a reshuffle) drops the rest."""
        staged = getattr(self, "_staged_learn", None)
        if not staged:
            return None
        host, dev = staged[0]
        if self._host_batches_equal(host, batch):
            staged.pop(0)
            return dev
        self._clear_staged_learn()
        return None

    def prepare_learning(self):
        pass

    def post_epoch_callback(self, epoch: int):
        pass

    def post_backward_callback(self):
        pass

    def learn(self):
        """Main training loop; :meth:`on_learn_end` runs however it exits,
        then the checkpoint writer is flushed and the signal handlers are
        released, then the obs layer writes its files and stops its
        watchdog."""
        try:
            return self._learn_loop()
        finally:
            if self.health is not None:
                self.self_healing_summary = self.health.report()
                logger.info(f"self-healing summary: {self.self_healing_summary}")
            self.on_learn_end()
            # after the producer drain: the writer flush below may be the
            # emergency checkpoint, and the producer must not race it
            self.resilience.close()
            # after on_learn_end: producer teardown spans still get recorded
            self.obs.close()

    def on_learn_end(self):
        """Teardown hook run when :meth:`learn` exits (return or exception)."""
        pass

    def _maybe_resume(self, train_config):
        """Restore from an explicit resume path (missing: a hard error, never
        a silent fresh start) or, under resilience auto-resume, from the
        newest *committed* checkpoint in checkpoint_dir. Runs before
        prepare_learning, so the first rollouts already use the restored
        params, RNG streams and prompt-stream position."""
        path = train_config.resume_from_checkpoint
        if path:
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"train.resume_from_checkpoint={path!r} does not exist; "
                    "refusing to silently train from scratch"
                )
            self.load(path)
            return
        if self.resilience.auto_resume:
            latest = find_latest_committed(train_config.checkpoint_dir)
            if latest is not None:
                logger.info(f"Auto-resume: restoring newest committed checkpoint {latest}")
                self.load(latest)

    def _learn_loop(self):
        train_config = self.config.train
        self.iter_count = 0
        self._maybe_resume(train_config)
        self.prepare_learning()
        self.obs.configure_model(self.model, getattr(self, "model_config", None))
        self.obs.beat("learner")

        with self.obs.span("evaluate"):
            results = self.evaluate() if getattr(self, "eval_pipeline", None) else {}
        self.tracker.log(results, self.iter_count)
        if self.iter_count >= train_config.total_steps:
            # resumed at (or past) the end of training: nothing left to do
            self._report_sweep_result(results)
            return results

        profiler = None
        try:
            for epoch in range(train_config.epochs):
                for batch in self.create_train_dataloader():
                    if train_config.profile_dir:
                        if self.iter_count == train_config.profile_start_step and profiler is None:
                            profiler = self._start_profiler(train_config.profile_dir)
                        elif self.iter_count >= train_config.profile_end_step and profiler is not None:
                            profiler.stop()
                            profiler = None
                    # chaos site "nan-loss": poison the batch to non-finite
                    # (free when unarmed); the health guard must catch it
                    batch = chaos_poison_batch(batch)
                    self.clock.tick()  # reset: measure train_step alone
                    # the span closes after train_step's one host transfer of
                    # its stats, which waits for the step's device work
                    with self.obs.span("learn"):
                        stats = self.train_step(batch)
                    stats["time/forward_backward"] = self.clock.tick()
                    self.iter_count += 1
                    self.obs.beat("learner")
                    self.post_backward_callback()

                    if self.health is not None:
                        action = self.health.observe(stats, self.iter_count)
                        if action == "rollback":
                            # raises TrainingHealthError (with a diagnostics
                            # bundle) when the rollback budget is spent
                            self._handle_health_rollback()
                            # the rest of this epoch's batches came from the
                            # anomalous policy: re-collect experience instead
                            # (post_epoch_callback refills the store)
                            break

                    if self.resilience.should_stop(self.iter_count):
                        return self._preempt_exit(stats)

                    if train_config.checkpoint_interval and self.iter_count % train_config.checkpoint_interval == 0:
                        with self.obs.span("checkpoint"):
                            self._save_checkpoint(os.path.join(train_config.checkpoint_dir, self._checkpoint_name()))
                            self.save_pretrained(os.path.join(train_config.checkpoint_dir, "hf_model"))

                    if (
                        train_config.eval_interval and self.iter_count % train_config.eval_interval == 0
                    ) or self.iter_count >= train_config.total_steps:
                        with self.obs.span("evaluate"):
                            results = self.evaluate() if getattr(self, "eval_pipeline", None) else {}
                        self.obs.beat("learner")  # a long eval is not a stall
                        stats.update(results)
                        if train_config.save_best and "reward/mean" in results:
                            if results["reward/mean"] > self.best_reward:
                                self.best_reward = results["reward/mean"]
                                self._save_checkpoint(os.path.join(train_config.checkpoint_dir, "best_checkpoint"))
                        if self._sweep_tick(results):
                            logger.info("Sweep scheduler requested early stop")
                            self._report_sweep_result(results)
                            return results

                    if self.obs.enabled:
                        tokens, samples, seq_len = batch_token_count(batch)
                        stats.update(self.obs.step_stats(tokens, samples, seq_len))
                    stats = {k: significant(v) if isinstance(v, float) else v for k, v in stats.items()}
                    self.tracker.log(stats, self.iter_count)
                    if self.iter_count % 10 == 0 or self.iter_count == 1:
                        brief = {k: v for k, v in stats.items() if "loss" in k or "reward" in k}
                        logger.info(f"step {self.iter_count}/{train_config.total_steps} {brief}")

                    if self.iter_count >= train_config.total_steps:
                        self._save_checkpoint(os.path.join(train_config.checkpoint_dir, self._checkpoint_name()))
                        self._report_sweep_result(results)
                        return results
                self.post_epoch_callback(epoch)
        finally:
            # the profiler window closes however the loop exits (total_steps,
            # preemption, a halt, an exception mid-window): its trace is
            # written only by stop()
            if profiler is not None:
                profiler.stop()
        self._report_sweep_result(results)
        return results

    def _sweep_tick(self, results) -> bool:
        """Under a sweep (``TRLX_SWEEP`` set): print this eval's metrics as a
        ``SWEEP_METRIC {json}`` line for the sweep scheduler and poll the stop
        file ``TRLX_SWEEP_STOP_FILE``. Returns True when the scheduler asked
        this trial to stop. One process, so the decision needs no broadcast."""
        if not os.environ.get("TRLX_SWEEP"):
            return False
        if self.is_main_process:
            print("SWEEP_METRIC " + json.dumps({"step": self.iter_count, **filter_non_scalars(results or {})}),
                  flush=True)
        # the stop decision is collective: process 0 reads the file and
        # every rank leaves learn() together
        stop_file = os.environ.get("TRLX_SWEEP_STOP_FILE")
        stop = bool(stop_file and os.path.exists(stop_file)) if self.is_main_process else False
        return bool(coll.broadcast_object(stop, self.mesh.world_group))

    def _report_sweep_result(self, results):
        """The final-metrics line a sweep runner reads (``SWEEP_RESULT {json}``)."""
        if os.environ.get("TRLX_SWEEP") and self.is_main_process:
            print("SWEEP_RESULT " + json.dumps(filter_non_scalars(results or {})), flush=True)

    def _start_profiler(self, profile_dir: str):
        """Start a ``torch.profiler`` window (CPU activity, plus CUDA on a
        CUDA device) whose Chrome trace lands under ``profile_dir`` when it
        stops (``tensorboard_trace_handler``: ``<host>_<pid>.<ns>.pt.trace.json``)."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))
        profiler.start()
        logger.info(f"torch.profiler window opened at step {self.iter_count}, writing under {profile_dir}")
        return profiler

    # ------------------------------------------------------------- checkpoints

    def _checkpoint_name(self, it: Optional[int] = None) -> str:
        """``checkpoint_<step>`` zero-padded to total_steps' width, so the
        checkpoint dir's lexicographic order is chronological (the resume
        scan also parses unpadded names numerically)."""
        it = self.iter_count if it is None else it
        return f"checkpoint_{it:0{len(str(self.config.train.total_steps))}d}"

    def _state_dict(self) -> Dict[str, Any]:
        """The JSON trainer state for ``state.json``: counters and every RNG
        stream (the sampling generator, the host numpy generator, torch's
        global CPU generator), plus algorithm extras (PPO's prompt-stream
        position): what continuing the exact sample sequence after a
        restart needs, beside params and optimizer."""
        return {
            "iter_count": self.iter_count,
            "best_reward": self.best_reward,
            "nth_evaluation": self.nth_evaluation,
            "rng_key": pack_rng_key(self.generator),
            "np_rng_state": pack_np_rng(self.np_rng),
            "torch_rng_state": torch.get_rng_state().tolist(),
            **self._extra_state(),
        }

    def _extra_state(self) -> Dict[str, Any]:
        """Algorithm-specific additions to the trainer state."""
        return {}

    def _restore_extra_state(self, state: Dict[str, Any]):
        """Inverse of :meth:`_extra_state` (``state.json``, already loaded)."""
        pass

    def _checkpoint_payload(self) -> Dict[str, Any]:
        """What ``trainer.pt`` holds: the parameters, and with
        ``train.save_optimizer`` the optimizer and the scheduler. The values
        are the live ``state_dict()`` tensors: the async path hands the
        writer a :func:`host_snapshot` of this, never the dict itself."""
        if self.shards is not None:
            return self._gathered_payload()
        payload = {"params": self.model.state_dict()}
        if self.config.train.save_optimizer:
            payload["optimizer"] = self.optimizer.state_dict()
            payload["scheduler"] = self.scheduler.state_dict()
        return payload

    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """``self.model``'s whole ``state_dict`` (gathered over the mesh: a
        collective on every rank)."""
        if self.shards is None:
            return self.model.state_dict()
        names = [name for name, _ in self.model.named_parameters()]
        full = self.shards.full_state(set(names))
        return {name: full[name] for name in names}

    def _gathered_payload(self) -> Dict[str, Any]:
        """The one-rank payload of a sharded trainer, gathered on every rank
        (a collective): whole parameters, and each optimizer state tensor
        shaped like its master gathered as its parameter is (8-bit blocks
        concatenated in fsdp order)."""
        payload = {"params": self.model_state_dict()}
        if self.config.train.save_optimizer:
            opt = self.optimizer.state_dict()
            leaves = [self.shards.by_param[id(p)] for p in self._leaf_params]
            state = {}
            for idx, leaf in enumerate(leaves):
                state[idx] = {k: self._gather_state_tensor(leaf, k, v) for k, v in opt["state"].get(idx, {}).items()}
            payload["optimizer"] = {"state": state, "param_groups": opt["param_groups"]}
            payload["scheduler"] = self.scheduler.state_dict()
        return payload

    def _gather_state_tensor(self, leaf, key, v):
        if self.whole_leaf is not None:
            return self.whole_leaf.gather_state(self.whole_leaf.leaves.index(leaf), key, v)
        if not torch.is_tensor(v) or v.dim() == 0:
            return v
        if tuple(v.shape) == tuple(leaf.master.shape):
            return self.shards.full_tensor(leaf, v)
        # blockwise state: [blocks, ...] over the local shard
        return coll.all_gather(v, self.shards.fsdp, 0) if leaf.sharded else v

    def _scatter_state_tensor(self, leaf, key, v):
        if self.whole_leaf is not None:
            return self.whole_leaf.scatter_state(self.whole_leaf.leaves.index(leaf), key, v)
        if not torch.is_tensor(v) or v.dim() == 0:
            return v
        if tuple(v.shape) == self._full_shape(leaf):
            return self.shards.local_block(leaf, v).clone()
        return coll.local_slice(v, self.shards.fsdp, 0).clone() if leaf.sharded else v

    def _full_shape(self, leaf):
        return full_shape(leaf, self.mesh)

    def _save_checkpoint(self, directory: str, block: bool = False):
        """Route one checkpoint through the resilience async writer when
        there is one (a host snapshot now, serialize + atomic commit on the
        writer thread; waits only if a *prior* write is in flight), else
        the synchronous :meth:`save`. ``block=True`` is the emergency path:
        the commit must land inside the grace window."""
        writer = self.resilience.writer
        if writer is None:
            self.save(directory)
            return
        # the writer must never see a live tensor: the next optimizer.step()
        # changes those in place (the snapshot's copies are queued before it)
        payload, ready = host_snapshot(self._checkpoint_payload())
        writer.save(os.path.abspath(directory), payload, self._state_dict(), block=block, ready=ready)

    def _preempt_exit(self, results):
        """Preemption: a blocking emergency checkpoint inside the grace
        window, then a clean return (``learn()``'s finally drains the rollout
        producer, flushes the writer and releases the signal handlers)."""
        handler = self.resilience.preemption
        logger.warning(
            f"Preempted ({handler.reason}); writing emergency checkpoint at "
            f"step {self.iter_count} ({handler.grace_remaining_s:.0f}s of grace remaining)"
        )
        t0 = time.perf_counter()
        with self.obs.span("checkpoint"):
            self._save_checkpoint(os.path.join(self.config.train.checkpoint_dir, self._checkpoint_name()), block=True)
        self.emergency_checkpoint_s = time.perf_counter() - t0
        remaining = handler.grace_remaining_s
        if remaining is not None and remaining < 0:
            logger.warning(
                f"Emergency checkpoint exceeded the grace window by {-remaining:.0f}s "
                "— raise resilience.grace_period_s or shrink checkpoint_interval"
            )
        return results

    def _handle_health_rollback(self):
        """The health guard saw ``rollback_after`` consecutive anomalies:
        restore the newest committed checkpoint if the rollback budget
        allows, else halt (raises :class:`TrainingHealthError` with a
        diagnostics bundle path — fail closed, never spin forever)."""
        if not self.health.rollback_budget_left():
            self.health.halt(
                self.iter_count,
                f"rollback budget exhausted ({self.health.config.max_rollbacks}) "
                f"with anomalies still occurring",
            )
        restored = self._health_rollback()
        self.health.on_rollback(self.iter_count, restored)

    def _health_rollback(self) -> bool:
        """Restore the newest committed checkpoint (exact-resume semantics:
        iter_count, RNG streams, prompt-stream position). False when no
        committed checkpoint exists yet: the guard still spends a unit of
        rollback budget, so a run that goes bad before its first checkpoint
        cannot loop forever."""
        target = None
        writer = self.resilience.writer
        if writer is not None:
            # an in-flight async commit may be the freshest good state; wait
            # for it (this also re-raises any writer error now, not later)
            writer.wait()
            target = writer.last_committed
        if target is None:
            target = find_latest_committed(self.config.train.checkpoint_dir)
        if target is None:
            logger.warning(
                f"health rollback requested but no committed checkpoint exists in "
                f"{self.config.train.checkpoint_dir} — continuing with current (possibly damaged) state"
            )
            return False
        self.load(target)
        self._post_rollback_restore()
        return True

    def _post_rollback_restore(self):
        """Re-anchor run state that :meth:`load` cannot rebuild by itself
        after a *mid-run* restore. PPO overrides it: it rebuilds its prompt
        stream and republishes the restored params."""
        pass

    def save(self, directory: str):
        """The synchronous checkpoint, in place: ``trainer.pt`` (a
        ``torch.save`` of :meth:`_checkpoint_payload`, written through a
        temporary name), ``state.json`` (written atomically) and the
        ``_COMMITTED`` sentinel last, so :meth:`load` and auto-resume can
        tell a whole directory from a torn one. A sentinel left by an
        earlier save of the same directory is removed first."""
        path = os.path.abspath(directory)
        # gathered on every rank (a collective); process 0 writes, then all wait
        payload = self._checkpoint_payload()
        if self.is_main_process:
            os.makedirs(path, exist_ok=True)
            sentinel = os.path.join(path, COMMITTED_SENTINEL)
            if os.path.exists(sentinel):
                os.remove(sentinel)
            write_payload(path, payload)
            write_json_atomic(os.path.join(path, STATE_FILE), self._state_dict())
            mark_committed(path)
            logger.info(f"Saved checkpoint to {path}")
        coll.barrier(self.mesh.world_group)

    def load(self, directory: str):
        """Restore a checkpoint written by :meth:`save` or the async writer,
        copying into the live parameters (``load_state_dict``), so the
        optimizer's and the publisher's references stay valid. A directory
        without the sentinel is loaded with a warning: it was asked for by
        name."""
        path = os.path.abspath(directory)
        if not is_committed(path):
            logger.warning(
                f"Checkpoint {path} has no {COMMITTED_SENTINEL} sentinel — it may be torn "
                "(interrupted write); restoring anyway since it was requested explicitly"
            )
        # onto the host first: load_state_dict copies the parameters into the
        # live tensors and moves AdamW's moments to their parameters' device,
        # leaving its step counts on the CPU where a fresh optimizer has them
        ckpt = torch.load(os.path.join(path, PAYLOAD_FILE), map_location="cpu", weights_only=False)
        if self.shards is not None:
            # every rank reads the whole state and keeps its blocks
            self.shards.load_full_state({name: ckpt["params"][name] for name, _ in self.model.named_parameters()})
        else:
            self.model.load_state_dict(ckpt["params"])
        self._rollout_model = None  # cast from the restored masters when next asked
        if "optimizer" in ckpt and self.config.train.save_optimizer:
            opt = ckpt["optimizer"]
            if self.shards is not None:
                leaves = [self.shards.by_param[id(p)] for p in self._leaf_params]
                opt = {"state": {idx: {k: self._scatter_state_tensor(leaves[idx], k, v) for k, v in st.items()}
                                 for idx, st in opt["state"].items()},
                       "param_groups": opt["param_groups"]}
            self.optimizer.load_state_dict(opt)
            self.scheduler.load_state_dict(ckpt["scheduler"])
        state_path = os.path.join(path, STATE_FILE)
        if os.path.exists(state_path):
            with open(state_path) as f:
                state = json.load(f)
            self.iter_count = state.get("iter_count", 0)
            self.best_reward = state.get("best_reward", -float("inf"))
            self.nth_evaluation = state.get("nth_evaluation", self.nth_evaluation)
            if state.get("rng_key") is not None:
                unpack_rng_key(state["rng_key"], self.generator)
            if state.get("np_rng_state") is not None:
                restore_np_rng(self.np_rng, state["np_rng_state"])
            if state.get("torch_rng_state") is not None:
                torch.set_rng_state(torch.tensor(state["torch_rng_state"], dtype=torch.uint8))
            self._restore_extra_state(state)
        logger.info(f"Restored checkpoint from {path} (iter {self.iter_count})")

    def save_pretrained(self, directory: str):
        """Export the trunk (``model.transformer``, or ``model.t5``) as an HF-format directory
        (``model.safetensors`` + ``config.json``) that ``load_pretrained`` of
        either package reads, and the heads (the value head) to
        ``heads.safetensors`` under their ``state_dict`` names. Nothing reads
        the heads file back, as nothing reads the JAX package's
        ``heads.msgpack``. When the HF export fails (a family with no
        converter), this warns and writes the heads only, as the JAX
        package does. Under LoRA the exported trunk has the adapters merged
        into its kernels, and with ``model.peft_config`` the adapters
        themselves go to ``adapters.safetensors`` (:func:`save_adapters`)."""
        state = self.model_state_dict()
        if not self.is_main_process:
            return
        prefix = "t5." if self.is_seq2seq else "transformer."
        trunk = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        if getattr(self.model_config, "lora_r", 0):
            trunk = merge_lora_state(trunk, self.model_config.lora_alpha, self.model_config.lora_r)
        heads = {k: v for k, v in state.items() if not k.startswith(prefix)}
        os.makedirs(directory, exist_ok=True)
        try:
            save_pretrained_hf(directory, self.model_type, trunk, self.model_config)
        except Exception as e:
            logger.warning(f"HF export unavailable ({e}); saving native params only")
        if heads:
            safetensors_io.save_file(heads, os.path.join(directory, "heads.safetensors"))
        if self.config.model.peft_config:
            save_adapters(directory, state)


def _null_context():
    import contextlib

    return contextlib.nullcontext()
