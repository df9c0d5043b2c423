"""Typed nested training config tree with YAML I/O and dotted-path overrides.

A copy of ``trlx_tpu/data/configs.py`` (the port imports nothing of the JAX
package), field for field, so every config dict of the JAX package parses
unchanged: ``TRLConfig`` groups {method, model, optimizer, scheduler,
tokenizer, train, mesh}, loads and saves YAML, and supports
``evolve``/``update`` with dotted-path merges that raise on unknown keys.
The block docstrings describe each feature as the JAX package runs it;
which blocks the port runs, and which raise ``NotImplementedError`` naming
the slice that brings them, the trainer decides
(``trlx_tpu_torch.trainer.mesh_trainer.check_port_config``). ``yaml`` is
imported only where YAML is read or written.
"""

from copy import deepcopy
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Set

from trlx_tpu_torch.data.method_configs import MethodConfig, get_method


# Free-form dict fields: dotted-path updates may introduce NEW keys below these
# (e.g. "model.model_overrides.scan_layers", "optimizer.kwargs.weight_decay").
# Typed config levels keep strict typo detection.
OPEN_DICT_FIELDS = {
    "model_overrides",
    "kwargs",
    "gen_kwargs",
    "gen_experience_kwargs",
    "trainer_kwargs",
    "peft_config",
    "tenants",  # serving_tenancy: {tenant_id: {slo_class, kv_block_quota, ...}}
    "class_ttl_s",  # serving_tenancy: {slo_class: ttl seconds}
}


def _mark_leaves(v: Any, path: str, updated: Set[str]) -> None:
    if isinstance(v, dict) and v:
        updated.update(_leaf_paths(v, path))
    else:
        updated.add(path)


def merge(base: Dict, update: Dict, updated: Set[str], prefix: str = "", open_dict: bool = False) -> Dict:
    """Recursively merge ``update`` into ``base``, recording consumed dotted leaf
    paths. Inside free-form dict fields (``OPEN_DICT_FIELDS``) new keys are
    accepted; elsewhere unknown keys stay unconsumed so the caller can flag them."""
    for k, v in base.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if k in update:
            if isinstance(v, dict) and isinstance(update[k], dict):
                base[k] = merge(
                    v, update[k], updated, path, open_dict or k in OPEN_DICT_FIELDS
                )
            elif isinstance(update[k], dict) and not (open_dict or k in OPEN_DICT_FIELDS):
                # dotted path descending THROUGH a scalar typed field (e.g.
                # "train.seed.value") — leave unconsumed so the caller flags it
                continue
            else:
                base[k] = update[k]
                _mark_leaves(update[k], path, updated)
    if open_dict:
        for k, v in update.items():
            if k not in base:
                path = f"{prefix}.{k}" if prefix else str(k)
                base[k] = v
                _mark_leaves(v, path, updated)
    return base


def _leaf_paths(d: Dict, prefix: str = "") -> List[str]:
    out = []
    for k, v in d.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict) and v:
            out.extend(_leaf_paths(v, path))
        else:
            out.append(path)
    return out


def _sanitize(obj):
    """Make a config dict YAML-safe: tuples → lists, recursively."""
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def _merge_dicts(base: Dict, update: Dict) -> Dict:
    """Merge ``update`` into ``base``, where ``update`` may use dotted paths as keys."""
    for k, v in update.items():
        if "." in k:
            path = k.split(".")
            node = base
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = v
        elif isinstance(v, dict) and isinstance(base.get(k), dict):
            base[k] = _merge_dicts(base[k], v)
        else:
            base[k] = v
    return base


@dataclass
class ModelConfig:
    """What model to train.

    :param model_path: HF checkpoint path/name, a local directory, or a builtin
        architecture preset name (e.g. ``"gpt2"``); resolved by
        :mod:`trlx_tpu.models.hf_loading`.
    :param model_arch_type: ``"causal"`` or ``"seq2seq"``.
    :param num_layers_unfrozen: how many top transformer blocks receive gradients;
        -1 trains everything. Also controls the hydra frozen-branch depth.
    :param peft_config: optional LoRA config dict (``{"r": 8, "alpha": 16, ...}``);
        when set, only adapter + head params are trained/saved.
    :param model_overrides: overrides applied to the architecture config
        (e.g. ``{"n_layer": 2}``) — mainly for tests and random-init runs.
    :param init_scale: stddev scale for random init when no checkpoint exists.
    :param offload_ref: keep the full frozen KL-reference copy in HOST memory
        (pinned-host placement on TPU, numpy otherwise) and stream it onto the
        device only for the rollout scoring pass. Only applies when the ref is
        a full copy (``num_layers_unfrozen=-1``, or pipeline parallelism, which
        forbids the hydra branch); at 7B+ on small meshes the resident HBM ref
        copy is otherwise the binding memory constraint. The analogue of the
        reference's NeMo CPU-pinned policy/ref swap
        (modeling_nemo_ppo.py:228-312).
    """

    model_path: str = "gpt2"
    model_arch_type: str = "causal"
    num_layers_unfrozen: int = -1
    peft_config: Optional[Dict[str, Any]] = None
    model_overrides: Optional[Dict[str, Any]] = None
    init_scale: float = 0.02
    offload_ref: bool = False

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class TokenizerConfig:
    """Tokenizer settings.

    :param tokenizer_path: HF tokenizer name/path, or a builtin offline tokenizer
        (``"char://<alphabet>"``, ``"bytes"``) — see :mod:`trlx_tpu.pipeline.tokenization`.
    :param padding_side / truncation_side: ``"left"`` or ``"right"``.
    """

    tokenizer_path: str = "gpt2"
    padding_side: str = "left"
    truncation_side: str = "right"
    tokenizer_extra_kwargs: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class OptimizerConfig:
    """Optimizer registry name + kwargs (resolved against optax in trlx_tpu.utils)."""

    name: str = "adamw"
    kwargs: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class SchedulerConfig:
    """LR scheduler registry name + kwargs (resolved against optax schedules)."""

    name: str = "cosine_annealing"
    kwargs: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class MeshConfig:
    """TPU-first device-mesh / sharding config (no reference equivalent — replaces
    accelerate/deepspeed YAMLs and NeMo's TP/PP sizes, cf. SURVEY.md §2.3).

    The mesh has up to four axes: ``data`` (pure DP), ``fsdp`` (ZeRO-style param/opt
    sharding, also used as a second data axis), ``pipe`` (pipeline parallelism:
    transformer layers stacked ``[L, ...]`` and sharded into stages, GPipe microbatch
    schedule over ``ppermute`` — the analogue of the reference's Apex pipeline engine,
    modeling_nemo_ppo.py:713-731), and ``model`` (tensor parallel). Axis sizes of -1
    mean "infer from device count" (at most one axis may be -1).

    :param data / fsdp / pipe / model: mesh axis sizes.
    :param pipeline_microbatches: microbatches per pipelined forward (``pipe > 1``
        only). If the per-step batch does not divide evenly, the largest divisor
        <= this value is used instead (with a warning). Bubble fraction is
        ``(pipe-1)/(microbatches+pipe-1)``.
    :param remat: rematerialization policy: ``"none"`` | ``"full"`` |
        ``"nothing_saveable"`` | ``"dots_saveable"``.
    :param param_dtype: dtype params are stored in.
    :param compute_dtype: dtype activations/matmuls run in (bf16 on TPU).
    :param shard_prompts_by: host data-sharding axis for input batches.
    :param sequence_shard: shard sequence dim of activations across the model axis
        (Megatron-SP analogue; free under SPMD, cf. SURVEY.md §5.7).
    """

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    model: int = 1
    pipeline_microbatches: int = 4
    # Persistent XLA compilation cache directory (also settable via the
    # TRLX_COMPILE_CACHE env var). First TPU compiles are 20-40s; subsequent
    # runs with the same shapes restore from here in milliseconds.
    compilation_cache_dir: Optional[str] = None
    remat: str = "none"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    shard_prompts_by: str = "data"
    sequence_shard: bool = False

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class AsyncRolloutConfig:
    """Disaggregated generation/learning (``trlx_tpu/rollout``; docs/rollout.md).

    When enabled, PPO experience generation runs on a continuously-producing
    background engine decoupled from the optimizer loop through a bounded
    queue, with versioned parameter snapshots and staleness-aware admission +
    importance-weight correction. Synchronous rollouts stay the default;
    ``max_staleness=0`` (or a multi-process run) falls back to them exactly.

    :param enabled: turn the async engine on (PPO only).
    :param max_staleness: cap (in policy versions, i.e. parameter publishes)
        on how stale consumed experience may be; staler elements are dropped
        at collection. 0 = fully on-policy = synchronous fallback.
    :param queue_capacity: hard bound on queued experience elements; defaults
        to ``4 * method.num_rollouts`` when None.
    :param high_watermark / low_watermark: producer gating hysteresis — above
        ``high`` production pauses until the learner drains to ``low``.
        Default: capacity and capacity // 2.
    :param publish_interval: optimizer steps between parameter publishes (each
        publish is one donate-free device copy and bumps the policy version).
    :param staleness_correction: apply the clipped per-token IS correction to
        the PPO policy loss for stale samples (exact no-op at staleness 0).
    :param is_ratio_clip: clip for the IS weights, ``[1/c, c]``.
    :param collect_timeout_s: learner-side timeout waiting for the producer to
        deliver a full experience batch (surfaces a wedged producer).
    :param drain_timeout_s: shutdown timeout joining the producer thread.
    :param length_bucket_lookahead: pool this many upcoming producer batches,
        sort the pooled prompts by length, and re-batch before generation —
        each ``generate`` call then pads to its own batch's (now much
        tighter) longest prompt instead of the stream-order worst case.
        0 disables (stream order preserved exactly, the replay-determinism
        baseline); the reorder is itself deterministic for a fixed stream,
        so exact-resume replay stays exact at any value.
    """

    enabled: bool = False
    max_staleness: int = 1
    queue_capacity: Optional[int] = None
    high_watermark: Optional[int] = None
    low_watermark: Optional[int] = None
    publish_interval: int = 1
    staleness_correction: bool = True
    is_ratio_clip: float = 2.0
    collect_timeout_s: float = 600.0
    drain_timeout_s: float = 30.0
    length_bucket_lookahead: int = 0

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class IslandConfig:
    """Sebulba-style disaggregated islands (``trlx_tpu/serving/island.py``,
    ``trlx_tpu/rollout/broadcast.py``; docs/parallelism.md "Islands").

    When enabled (requires ``serving.enabled`` and ``async_rollouts`` with
    ``max_staleness > 0``), the serving engine runs as a *generation island*
    and the PPO optimizer as a *learner island*: parameter publishes stream
    layer-by-layer through a chunked broadcast while decode rounds continue,
    the engine swaps to each committed version atomically at a round boundary
    (one prefix-cache flush per version), and per-island idle-bubble ledgers
    prove neither side waits on the other (``serving/island/*`` and
    ``rollout/broadcast/*`` gauges). Off (the default) keeps the monolithic
    publisher and the per-rollout ``set_params`` install byte-identical to
    the single-island path.

    :param enabled: master switch for the island split.
    :param gen_devices: devices carved for the generation island
        (``parallel/mesh.py:carve_islands``; with one device total the
        islands are thread-level tenants of the same chip).
    :param chunk_layers: top-level parameter-tree keys (for a transformer:
        layers) per broadcast chunk. 1 ships strictly layer-by-layer.
    :param chunk_pause_s: host-side yield between chunks — the knob that
        spreads a broadcast across more decode rounds on hardware where the
        copy itself is bandwidth-bound. 0 broadcasts back-to-back.
    """

    enabled: bool = False
    gen_devices: int = 1
    chunk_layers: int = 1
    chunk_pause_s: float = 0.0

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class ObservabilityConfig:
    """Unified observability layer (``trlx_tpu_torch/obs``; the counterpart of
    ``trlx_tpu/obs``).

    When enabled, the trainer times every phase with the hierarchical span
    tracer (per-step ``time/span/*`` stats, optional Chrome-trace ``trace.json``),
    derives tokens/sec + MFU from param count and measured step time, samples
    device-memory gauges, keeps step-time p50/p95 histograms, and runs a stall
    watchdog that dumps all thread stacks when the learner or rollout producer
    stops making progress. Off (the default) adds nothing to the step path.

    :param enabled: master switch for the whole layer.
    :param trace_path: write span events as Chrome-trace-event JSON here on
        ``learn()`` exit (viewable in chrome://tracing / Perfetto). Relative
        paths land under the tracker logging dir. None records no events
        (span timings are still aggregated per step).
    :param trace_device: additionally wrap each span in
        ``torch.profiler.record_function`` so host spans appear as named
        ranges in the ``torch.profiler`` traces captured via
        ``train.profile_dir``.
    :param max_trace_events: hard bound on recorded trace events (the trace
        notes how many were dropped past it).
    :param mfu: compute throughput/MFU stats per step.
    :param peak_device_tflops: per-card peak TFLOP/s for the MFU denominator.
        None auto-detects from the CUDA device's name (the NVIDIA parts of
        ``obs.throughput.PEAK_TFLOPS_BY_DEVICE_KIND``, from their data
        sheets); unknown devices report model TFLOP/s but omit ``mfu``.
    :param memory_interval: steps between device-memory samples (the CUDA
        caching allocator's counters; the host RSS on the CPU); 0 disables.
    :param watchdog_timeout_s: stall threshold — a warning + all-thread stack
        dump fires when the learner step or producer publish heartbeat goes
        this long without progress. 0 disables the watchdog. Size it well
        above eval pauses and a whole experience phase.
    :param watchdog_poll_s: watchdog poll period; None = timeout / 4.
    :param flight: journal per-uid request flights through the serving stack
        (``obs/flight.py``) — per-phase latency
        decomposition, per-tenant percentile gauges, Perfetto lanes in the
        span trace. No-op when the master switch is off.
    :param flight_ring: completed flights retained for percentiles/trace.
    :param flight_reservoir: newest-N completed flights kept per
        (tenant, SLO class) for the percentile gauges.
    :param series_capacity: points retained per gauge key in the per-step
        time-series sampler (fixed-retention ring).
    :param series_path: write the retained gauge time-series as JSONL here on
        ``learn()`` exit (relative paths land under the logging dir). None
        skips the dump.
    :param prom_path: write the final gauge values in Prometheus text
        exposition format here on ``learn()`` exit. None skips it.
    """

    enabled: bool = False
    trace_path: Optional[str] = None
    trace_device: bool = True
    max_trace_events: int = 100_000
    mfu: bool = True
    peak_device_tflops: Optional[float] = None
    memory_interval: int = 1
    watchdog_timeout_s: float = 0.0
    watchdog_poll_s: Optional[float] = None
    flight: bool = True
    flight_ring: int = 2048
    flight_reservoir: int = 256
    series_capacity: int = 512
    series_path: Optional[str] = None
    prom_path: Optional[str] = None

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class ResilienceConfig:
    """Fault tolerance for preemptible TPU runs (``trlx_tpu/resilience``;
    docs/resilience.md).

    When enabled, checkpoints commit asynchronously on a background thread
    with an atomic ``_COMMITTED`` sentinel (the learner only stalls if a prior
    write is still in flight), SIGTERM/SIGINT trigger an emergency checkpoint
    inside the preemption grace window, a restarted job auto-resumes from the
    newest committed checkpoint in ``checkpoint_dir`` (iter_count, RNG streams,
    and dataloader position included), and reward_fn calls are retried with
    exponential backoff + jitter under a wall-clock deadline. Off (the
    default) leaves the synchronous save path byte-identical to before.

    :param enabled: master switch for the whole subsystem.
    :param async_checkpointing: commit checkpoints on a background writer
        thread (single-process runs only; multi-host falls back to the
        synchronous collective save with a warning).
    :param keep_last: retention — keep the newest N step checkpoints, delete
        older committed ones (``best_checkpoint`` and ``hf_model`` are always
        kept). 0 keeps everything.
    :param auto_resume: on startup, scan ``checkpoint_dir`` for the newest
        committed checkpoint and resume from it. An explicit
        ``train.resume_from_checkpoint`` wins over the scan.
    :param preemption_handling: trap SIGTERM/SIGINT, write an emergency
        checkpoint at the next step boundary, drain the rollout engine, and
        exit cleanly. A second signal terminates immediately.
    :param grace_period_s: assumed preemption grace window (budget for the
        emergency checkpoint; logged if exceeded).
    :param retry_rewards: wrap ``reward_fn`` in the retry/backoff policy below
        — a transiently-failing reward endpoint no longer kills the run.
    :param retry_max_retries: retries per reward call after the first attempt.
    :param retry_base_delay_s: initial backoff; doubles per retry (max
        ``retry_max_delay_s``), with ±50% jitter.
    :param retry_deadline_s: total wall-clock budget across one call's
        retries; exceeded → ``RetryDeadlineExceeded`` aborts the run (a
        hard-down endpoint should page, not spin).
    """

    enabled: bool = False
    async_checkpointing: bool = True
    keep_last: int = 3
    auto_resume: bool = True
    preemption_handling: bool = True
    grace_period_s: float = 30.0
    retry_rewards: bool = True
    retry_max_retries: int = 3
    retry_base_delay_s: float = 0.5
    retry_max_delay_s: float = 30.0
    retry_deadline_s: float = 300.0

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class SelfHealingConfig:
    """Self-healing supervision and recovery (``trlx_tpu/rollout/supervisor.py``,
    ``trlx_tpu/resilience/health.py``; docs/resilience.md "Self-healing").

    When enabled, three layers keep a run alive through transient faults
    instead of dying on the first exception or silently training on garbage:
    a **ProducerSupervisor** restarts a crashed or watchdog-wedged async
    rollout producer with exponential backoff (resyncing from
    ``publisher.latest()``), a **TrainingHealthGuard** screens every optimizer
    step (non-finite loss/grads and grad-norm spikes are skipped on-device;
    K consecutive anomalies roll back to the last committed checkpoint; an
    exhausted rollback budget halts with a diagnostics bundle), and an
    **experience quarantine** diverts invalid rollout elements (non-finite
    logprobs/values/rewards, empty responses) to a JSONL sidecar. Off (the
    default) compiles the exact same train step and leaves checkpoint bytes
    and step stats byte-identical to an unconfigured run.

    :param enabled: master switch for supervisor + health guard + quarantine.
    :param max_producer_restarts: producer restart budget; exceeding it raises
        with a diagnostics-bundle path in the message (fail closed).
    :param restart_backoff_base_s: first restart delay; doubles per restart up
        to ``restart_backoff_max_s``.
    :param restart_backoff_max_s: backoff ceiling.
    :param wedge_timeout_s: supervisor-side wedge fallback — if the learner
        has been waiting in ``collect`` this long with a live-but-silent
        producer, restart it. Works without the obs watchdog; the watchdog
        escalation hook (``StallWatchdog.escalate``) usually fires first.
        ``None`` disables the fallback (watchdog-escalation only).
    :param anomaly_window: rolling-window length (in healthy steps) for
        grad-norm / KL spike baselines.
    :param min_window: spike detection stays inactive until the window holds
        this many healthy samples (avoids tripping on warmup noise).
    :param grad_norm_spike_factor: skip the update when the global grad norm
        exceeds ``factor`` x the rolling median (enforced inside the compiled
        step; non-finite loss or grads always skip).
    :param kl_spike_factor: count an anomaly when ``policy/sqrt_kl`` exceeds
        ``factor`` x its rolling median.
    :param rollback_after: K consecutive anomalous steps trigger a rollback
        to the last committed checkpoint (exact-resume replay from the
        resilience subsystem).
    :param max_rollbacks: rollback budget; the next rollback request past it
        halts with ``TrainingHealthError`` + diagnostics bundle (fail closed).
    :param quarantine_dir: directory for ``quarantine.jsonl``; ``None`` →
        ``<checkpoint_dir>/quarantine``.
    :param diagnostics_dir: directory for halt/budget diagnostics bundles;
        ``None`` → ``<checkpoint_dir>/diagnostics``.
    """

    enabled: bool = False
    max_producer_restarts: int = 5
    restart_backoff_base_s: float = 0.5
    restart_backoff_max_s: float = 30.0
    wedge_timeout_s: Optional[float] = 600.0
    anomaly_window: int = 32
    min_window: int = 8
    grad_norm_spike_factor: float = 10.0
    kl_spike_factor: float = 10.0
    rollback_after: int = 3
    max_rollbacks: int = 2
    quarantine_dir: Optional[str] = None
    diagnostics_dir: Optional[str] = None

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class ServingConfig:
    """Continuous-batching generation server (``trlx_tpu/serving``;
    docs/serving.md).

    When enabled, rollout generation runs through a persistent
    :class:`~trlx_tpu.serving.engine.ServingEngine` — paged KV block pool,
    in-flight batching (finished sequences replaced mid-decode), prompt-prefix
    sharing, and the fused paged-decode attention kernel — instead of one-shot
    ``generate`` calls. Off (the default) leaves the generate path byte-for-
    byte untouched. The engine requires a single-process causal LM with the
    per-layer cache layout; unsupported configs (seq2seq, stacked layers,
    prompt/prefix peft, multi-device mesh, ILQL's logit processor) log a
    warning and fall back to the generate path.

    :param enabled: route rollout generation through the serving engine.
    :param num_slots: decode slots (device batch of the steady-state step);
        0 = the rollout chunk size.
    :param block_size: tokens per KV block. Smaller = less fragmentation +
        finer prefix sharing; larger = fewer, larger DMAs per attention step.
        See docs/serving.md for tuning.
    :param num_blocks: physical blocks in the pool (one extra is reserved as
        the null block); 0 = full worst-case reservation for every slot
        (``num_slots * ceil(max_seq_len / block_size) + 1``).
    :param kv_cache_quant: int8 KV blocks with per-row f32 scales; None
        inherits ``model.kv_cache_quant``.
    :param attention_impl: paged-attention dispatch — "auto" (fused Pallas
        kernel on single-device TPU, XLA gather elsewhere), "pallas", "xla".
    :param prefix_caching: ref-counted sharing of full prompt-prefix blocks
        (flushed automatically whenever the parameter snapshot changes).
    :param spec_k: speculative decoding — draft tokens verified per decode
        round (0 = off). Drafts come from host-side prompt-lookup n-grams;
        one fixed-shape verify pass scores all K+1 positions, so each round
        delivers 1..K+1 tokens per slot at roughly the KV-bandwidth cost of
        one. Greedy output is bit-identical to non-speculative decode.
    :param spec_ngram: max n-gram order for the prompt-lookup draft model
        (longest-suffix match against the slot's own context).
    :param prefill_chunk: chunked prefill — split admission prefills into
        chunks of this many tokens, interleaved one chunk per decode round so
        long prompts stop stalling in-flight decode (0 = whole-prompt
        prefill). End state per sequence is identical to unchunked prefill.
    :param stream_overlap: stream-overlapped PPO experience (docs/serving.md
        "Stream-overlapped PPO") — score and stage learner batches while the
        tail of the rollout batch is still decoding. As each sequence finishes
        in the engine its reward_fn call is dispatched from a bounded worker
        pool, scored sequences are batched into fixed-shape microbuckets for
        the jitted score fn, and first-epoch learner microbatches are staged
        onto the device — all inside the decode window. Off (the default)
        keeps the serving experience path byte-identical to the serial one;
        on, greedy rollout contents and store order are unchanged, only
        wall-clock (and score-normalization grouping) differs.
    :param overlap_reward_workers: bounded reward_fn worker pool size for the
        streaming path.
    :param overlap_microbucket: sequences per scoring microbucket; 0 = the
        rollout chunk size.
    :param overlap_learn_stage: also pre-stage first-epoch learner
        microbatches (collate + ``device_put``) during the streaming window.
    """

    enabled: bool = False
    num_slots: int = 0
    block_size: int = 16
    num_blocks: int = 0
    kv_cache_quant: Optional[bool] = None
    attention_impl: str = "auto"
    prefix_caching: bool = True
    spec_k: int = 0
    spec_ngram: int = 3
    prefill_chunk: int = 0
    stream_overlap: bool = False
    overlap_reward_workers: int = 2
    overlap_microbucket: int = 0
    overlap_learn_stage: bool = True

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class ServingResilienceConfig:
    """Serving-grade fault tolerance for the continuous-batching engine
    (``trlx_tpu/serving/policy.py`` + ``supervisor.py``; docs/serving.md
    "Fault tolerance"). Only meaningful with ``train.serving.enabled``.

    When enabled, the engine gains per-request deadlines/TTLs (``deadline``
    outcome), a bounded pending queue with watermark load shedding (``shed``
    outcome), optimistic admission with KV-block-pressure preemption
    (re-prefill from host state, zero tokens lost), and a
    :class:`~trlx_tpu.serving.supervisor.ServingSupervisor` that rebuilds a
    crashed or wedged engine under a bounded restart budget and replays every
    live + pending request. Off (the default) keeps the serving path
    byte-identical to an unconfigured engine.

    :param enabled: master switch for policy + supervisor.
    :param request_ttl_s: default wall-clock deadline per request from
        submit; ``None`` = no default TTL.
    :param max_pending_age_s: cap on time queued before a pending request
        expires to ``deadline``; ``None`` = unbounded wait.
    :param max_pending: pending-queue bound driving load shedding; 0 =
        unbounded (no shedding).
    :param high_watermark: shed trigger as a fraction of ``max_pending``.
    :param low_watermark: shed target as a fraction of ``max_pending``.
    :param preemption: optimistic admission + longest-remaining-first
        preemption under KV-block pressure; ``False`` keeps worst-case
        up-front reservation.
    :param max_restarts: supervised engine restart budget; exceeding it
        raises with a diagnostics-bundle path in the message (fail closed).
    :param restart_backoff_base_s: first restart delay; doubles per restart
        up to ``restart_backoff_max_s``.
    :param restart_backoff_max_s: backoff ceiling.
    :param wedge_timeout_s: per-round wedge fallback — abort an engine round
        that runs this long without finishing (the watchdog escalation on the
        ``serving-engine`` heartbeat usually fires first). ``None`` disables
        the fallback.
    :param diagnostics_dir: directory for restart-budget diagnostics bundles;
        ``None`` → ``<checkpoint_dir>/diagnostics``.
    """

    enabled: bool = False
    request_ttl_s: Optional[float] = None
    max_pending_age_s: Optional[float] = None
    max_pending: int = 0
    high_watermark: float = 1.0
    low_watermark: float = 0.5
    preemption: bool = True
    max_restarts: int = 3
    restart_backoff_base_s: float = 0.05
    restart_backoff_max_s: float = 10.0
    wedge_timeout_s: Optional[float] = 60.0
    diagnostics_dir: Optional[str] = None

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class ServingTenancyConfig:
    """Multi-tenant SLO-aware serving for the continuous-batching engine
    (``trlx_tpu/serving/tenancy.py``; docs/serving.md "Multi-tenancy and SLO
    classes"). Only meaningful with ``train.serving.enabled``.

    When enabled, the engine gains per-request tenant attribution: SLO-class
    priority admission (higher classes first, aging prevents absolute
    starvation), class-ordered load shedding (lowest class first, oldest
    first within a class), per-class default TTLs, per-tenant KV-block
    quotas with fair-share preemption, and per-tenant/per-class gauges
    (``serving/tenant/*``, ``serving/class/*``). Off (the default) keeps the
    serving path byte-identical to a tenant-blind engine.

    :param enabled: master switch for the tenancy registry.
    :param default_slo_class: class for tenants not listed in ``tenants``
        (unknown tenant ids auto-register with the defaults).
    :param default_kv_block_quota: KV-block cap for unlisted tenants;
        0 = unlimited.
    :param aging_class_boost_rounds: passed-over admission rounds (past the
        scheduler's ``age_priority_after``) per +1 effective-class boost —
        the anti-starvation dial.
    :param class_ttl_s: per-SLO-class default request TTLs, e.g.
        ``{0: 30.0, 1: 120.0}`` (per-tenant and per-request TTLs override).
    :param tenants: explicit tenant contracts, e.g.
        ``{"pro": {"slo_class": 1, "kv_block_quota": 0},
        "free": {"slo_class": 0, "kv_block_quota": 16}}``. Keys inside each
        entry: ``slo_class``, ``kv_block_quota``, ``request_ttl_s``.
    """

    enabled: bool = False
    default_slo_class: int = 0
    default_kv_block_quota: int = 0
    aging_class_boost_rounds: int = 8
    class_ttl_s: Dict[int, float] = field(default_factory=dict)
    tenants: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class ServingFleetConfig:
    """Serving fleet: N supervised engine replicas behind a prefix-affinity
    router with a gauge-driven autoscaler (``trlx_tpu/fleet/``;
    docs/serving.md "Fleet serving"). Only meaningful with
    ``train.serving.enabled``; fleet replicas are always supervisor-wrapped
    regardless of ``serving_resilience.enabled``.

    Routing score per active replica =
    ``prefix_weight * warm_prefix_blocks + tenant_weight * recent_tenant_hits
    - load_weight * (live_slots + pending) / num_slots``; highest wins, so
    zeroing the affinity weights degenerates to least-loaded.

    :param enabled: master switch — off keeps the single-engine serving path
        byte-identical (a fleet of one is also byte-identical, but pays the
        router bookkeeping).
    :param num_replicas: replicas built at startup.
    :param prefix_weight: routing weight per warm prefix block the candidate
        already caches for the prompt.
    :param tenant_weight: routing weight per recent same-tenant request on
        the candidate (stickiness).
    :param load_weight: routing penalty per unit of normalized load (the
        least-loaded fallback).
    :param tenant_window: recent routing decisions per tenant feeding the
        stickiness term.
    :param autoscale: run the :class:`FleetAutoscaler` control loop.
    :param min_replicas: autoscaler floor (never drains below).
    :param max_replicas: autoscaler ceiling (never grows above).
    :param scale_up_pending_per_slot: fleet pending depth per active slot
        that counts as a scale-up breach.
    :param scale_down_occupancy: instantaneous occupancy below which an
        idle (zero-pending) fleet counts as a scale-down breach.
    :param breach_rounds: consecutive breaches required before either
        action (hysteresis: one hot round never scales).
    :param cooldown_rounds: refractory rounds after any action in which no
        further action fires (no flapping under oscillating load).
    """

    enabled: bool = False
    num_replicas: int = 2
    prefix_weight: float = 1.0
    tenant_weight: float = 0.25
    load_weight: float = 2.0
    tenant_window: int = 32
    autoscale: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_pending_per_slot: float = 1.0
    scale_down_occupancy: float = 0.25
    breach_rounds: int = 3
    cooldown_rounds: int = 8

    def __post_init__(self):
        if self.num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {self.num_replicas}")
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}"
            )

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class OnlineConfig:
    """Online learning loop: harvest labeled experience from live serving
    traffic into the GRPO learner (``trlx_tpu/online/``; docs/online.md).

    With ``enabled`` off (the default) the trainer is bit-for-bit the
    self-generating path: no buffer is built, no collector attaches, the
    experience phase never consults harvested groups.

    :param enabled: master switch for the online experience path.
    :param group_size: completions per harvested group; must equal the GRPO
        method's ``group_size`` (the trainer enforces it).
    :param buffer_capacity: bounded group count in the
        :class:`~trlx_tpu.online.buffer.OnlineExperienceBuffer`; past it the
        oldest group is evicted (old experience is the cheapest to lose).
    :param max_staleness: drop harvested groups more than this many policy
        publishes behind the learner at drain time (the same admission cap
        async PPO uses).
    :param label_type: how harvested groups are scored — ``"reward"``
        (scalar reward_fn), ``"preference"`` (pairwise judge reduced to win
        rates), or ``"environment"`` (episode returns from interaction
        loops).
    """

    enabled: bool = False
    group_size: int = 4
    buffer_capacity: int = 256
    max_staleness: int = 4
    label_type: str = "reward"

    def __post_init__(self):
        if self.group_size < 2:
            raise ValueError(f"group_size must be >= 2, got {self.group_size}")
        if self.buffer_capacity < 1:
            raise ValueError(
                f"buffer_capacity must be >= 1, got {self.buffer_capacity}"
            )
        if self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {self.max_staleness}"
            )
        if self.label_type not in ("reward", "preference", "environment"):
            raise ValueError(
                f"label_type must be 'reward' | 'preference' | 'environment', "
                f"got {self.label_type!r}"
            )

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class LearnerOverlapConfig:
    """Overlapped-collective FSDP train step (``trlx_tpu/parallel/fsdp.py``;
    docs/parallelism.md "Learner overlap & FSDP").

    When enabled (and the mesh is pure data/fsdp — ``model == pipe == 1``),
    the learner replaces the GSPMD grad-accum step with an explicit
    ``shard_map`` schedule: per-leaf parameter all-gathers prefetched ahead of
    compute, per-leaf gradient reduce-scatters during the backward (no
    full-gradient all-reduce), a gradient-SHARD accumulation carry, and a
    ZeRO-sharded optimizer whose state is born shard-local. Off (the default)
    keeps the train step byte-identical to the GSPMD path.

    :param enabled: master switch; silently falls back (with a warning) when
        the mesh has TP/PP axes or a health guard is active.
    :param int8_opt_state: swap the optimizer to the blockwise int8 Adam
        (``ops/quantized_adam.py``) with moment blocks quantized over each
        device's LOCAL shard. Only honored for adam-family optimizers.
    :param remat: override ``mesh.remat`` for the learner's model when the
        overlap step is active (``"nothing_saveable"`` / ``"dots_saveable"``
        / ``"per_layer"`` / ``"full"``); ``None`` keeps the mesh setting.
        Guidance per scale: docs/parallelism.md.
    :param flash_bwd: flash-attention backward for the learner
        (``"pallas"`` | ``"xla"``; ``None`` keeps the process default).
        ``"xla"`` materializes the O(T·S) score matrix — cheap and ~1.4x
        faster at small context (the r02→r05 gpt2 train-MFU bisect,
        ``ops/attention.py``); ``"pallas"`` recomputes per block and is
        mandatory at long context.
    """

    enabled: bool = False
    int8_opt_state: bool = False
    remat: Optional[str] = None
    flash_bwd: Optional[str] = None

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)


@dataclass
class TrainConfig:
    """Training loop hyperparameters (parity: ``TrainConfig``, configs.py:10-120 in reference).

    :param seq_length: max total sequence length (prompt + generation).
    :param epochs: outer epochs (each = one rollout phase + inner optimization).
    :param total_steps: hard cap on optimizer steps.
    :param batch_size: per-step global batch size.
    :param minibatch_size: microbatch for gradient accumulation (divides batch_size).
    :param eval_interval / checkpoint_interval: in optimizer steps.
    :param pipeline / trainer: registry names.
    :param tracker: ``"wandb"`` | ``"tensorboard"`` | ``"jsonl"`` | None.
    :param save_best: keep best checkpoint by eval reward (distributed-max guarded).
    :param seed: base seed; per-process offset is added like the reference
        (`trlx/utils/__init__.py:44-52`).
    """

    seq_length: int = 64
    epochs: int = 100
    total_steps: int = 1000
    batch_size: int = 8
    minibatch_size: Optional[int] = None

    eval_interval: int = 100
    checkpoint_interval: int = 1000
    checkpoint_dir: str = "ckpts"
    save_best: bool = True
    save_optimizer: bool = True

    pipeline: str = "PromptPipeline"
    trainer: str = "PPOTrainer"
    trainer_kwargs: Dict[str, Any] = field(default_factory=dict)

    tracker: Optional[str] = "jsonl"
    logging_dir: Optional[str] = None
    project_name: str = "trlx_tpu"
    entity_name: Optional[str] = None
    group_name: Optional[str] = None
    run_name: Optional[str] = None
    tags: List[str] = field(default_factory=list)

    seed: int = 1000
    # Persistent XLA compilation cache directory. Takes precedence over the
    # older mesh.compilation_cache_dir knob and the TRLX_COMPILE_CACHE env var
    # (resolution: trlx_tpu/utils/compilation_cache.py). Must be applied
    # before the process's FIRST compile — the trainer does this before it
    # even creates its PRNGKey. Ignored (with a warning) on the CPU backend:
    # jaxlib 0.4.36 corrupts the heap when executing cache-deserialized
    # donated executables there; TPU/GPU are unaffected.
    compilation_cache_dir: Optional[str] = None
    resume_from_checkpoint: Optional[str] = None
    reward_only_on_last: bool = False
    rollout_logging_dir: Optional[str] = None

    # Async rollout engine (disaggregated generation/learning with a bounded
    # experience queue and staleness-aware PPO) — see AsyncRolloutConfig.
    async_rollouts: "AsyncRolloutConfig" = field(default_factory=lambda: AsyncRolloutConfig())

    # Sebulba islands (generation island on the serving engine + learner
    # island, chunked decode-overlapped weight broadcast) — see IslandConfig
    # and docs/parallelism.md "Islands".
    islands: "IslandConfig" = field(default_factory=lambda: IslandConfig())

    # Observability layer (span tracing / throughput + MFU / memory gauges /
    # stall watchdog) — see ObservabilityConfig and docs/observability.md.
    observability: "ObservabilityConfig" = field(default_factory=lambda: ObservabilityConfig())

    # Resilience subsystem (async atomic checkpointing / preemption handling /
    # auto-resume / reward retries) — see ResilienceConfig and docs/resilience.md.
    resilience: "ResilienceConfig" = field(default_factory=lambda: ResilienceConfig())

    # Self-healing loop (producer supervision / anomaly-guarded updates /
    # experience quarantine) — see SelfHealingConfig and docs/resilience.md.
    self_healing: "SelfHealingConfig" = field(default_factory=lambda: SelfHealingConfig())

    # Continuous-batching generation server (paged KV cache / in-flight
    # batching / prefix sharing) — see ServingConfig and docs/serving.md.
    serving: "ServingConfig" = field(default_factory=lambda: ServingConfig())

    # Serving fault tolerance (request deadlines / load shedding / KV-pressure
    # preemption / supervised engine recovery) — see ServingResilienceConfig
    # and docs/serving.md "Fault tolerance".
    serving_resilience: "ServingResilienceConfig" = field(
        default_factory=lambda: ServingResilienceConfig()
    )

    # Multi-tenant SLO-aware serving (tenant registry / class priority /
    # KV-block quotas) — see ServingTenancyConfig and docs/serving.md
    # "Multi-tenancy and SLO classes".
    serving_tenancy: "ServingTenancyConfig" = field(
        default_factory=lambda: ServingTenancyConfig()
    )

    # Serving fleet (prefix-affinity router over N supervised replicas /
    # gauge-driven autoscaler / fleet-wide SLO ledger) — see
    # ServingFleetConfig and docs/serving.md "Fleet serving".
    serving_fleet: "ServingFleetConfig" = field(
        default_factory=lambda: ServingFleetConfig()
    )

    # Overlapped-collective FSDP learner (shard_map allgather/reduce-scatter
    # schedule + ZeRO-sharded optimizer state) — see LearnerOverlapConfig and
    # docs/parallelism.md "Learner overlap & FSDP".
    learner_overlap: "LearnerOverlapConfig" = field(
        default_factory=lambda: LearnerOverlapConfig()
    )

    # Online learning loop (GRPO experience harvested from live serving
    # traffic / bounded labeled-group buffer / staleness admission) — see
    # OnlineConfig and docs/online.md.
    online: "OnlineConfig" = field(default_factory=lambda: OnlineConfig())

    # score with reward_fn on process 0 only and broadcast the results to every
    # host. None (default) = auto: ON exactly when jax.process_count() > 1 —
    # otherwise every host hits a served reward model with identical requests
    # (N-plicated load, the hh RPC pattern, reference examples/hh/ppo_hh.py:
    # 108-222) and any nondeterminism in the server silently desyncs the hosts'
    # training data. Set False explicitly for a pure-python reward_fn that is
    # cheaper to run everywhere than to broadcast.
    reward_on_process_zero: Optional[bool] = None

    # Cast a one-time copy of the params to this dtype for GENERATION only
    # (training keeps full-precision master weights; scoring passes use them
    # too). Decode streams the whole param tree from HBM every token, so f32
    # masters make rollouts pay 2x the weight bandwidth — a bf16 rollout copy
    # recovers it. The sampled tokens come from a bf16-param policy while
    # old_logprobs are re-scored with the masters; PPO's clipped importance
    # ratios absorb the (tiny) mismatch, exactly as the reference's fp16
    # autocast sampling does against its fp32 masters.
    rollout_param_dtype: Optional[str] = None  # e.g. "bfloat16"

    # torch.profiler trace window (CPU activity, plus CUDA on a CUDA device):
    # traces steps [profile_start_step, profile_end_step) into profile_dir
    # as a Chrome trace (tensorboard_trace_handler's *.pt.trace.json).
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_end_step: int = 12

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        config = dict(config)
        ar = config.get("async_rollouts")
        if isinstance(ar, dict):
            config["async_rollouts"] = AsyncRolloutConfig.from_dict(ar)
        isl = config.get("islands")
        if isinstance(isl, dict):
            config["islands"] = IslandConfig.from_dict(isl)
        obs = config.get("observability")
        if isinstance(obs, dict):
            config["observability"] = ObservabilityConfig.from_dict(obs)
        res = config.get("resilience")
        if isinstance(res, dict):
            config["resilience"] = ResilienceConfig.from_dict(res)
        sh = config.get("self_healing")
        if isinstance(sh, dict):
            config["self_healing"] = SelfHealingConfig.from_dict(sh)
        sv = config.get("serving")
        if isinstance(sv, dict):
            config["serving"] = ServingConfig.from_dict(sv)
        svr = config.get("serving_resilience")
        if isinstance(svr, dict):
            config["serving_resilience"] = ServingResilienceConfig.from_dict(svr)
        svt = config.get("serving_tenancy")
        if isinstance(svt, dict):
            config["serving_tenancy"] = ServingTenancyConfig.from_dict(svt)
        svf = config.get("serving_fleet")
        if isinstance(svf, dict):
            config["serving_fleet"] = ServingFleetConfig.from_dict(svf)
        lov = config.get("learner_overlap")
        if isinstance(lov, dict):
            config["learner_overlap"] = LearnerOverlapConfig.from_dict(lov)
        onl = config.get("online")
        if isinstance(onl, dict):
            config["online"] = OnlineConfig.from_dict(onl)
        return cls(**config)


@dataclass
class TRLConfig:
    """Top-level config: {method, model, optimizer, scheduler, tokenizer, train, mesh}."""

    method: MethodConfig
    model: ModelConfig
    optimizer: OptimizerConfig
    scheduler: SchedulerConfig
    tokenizer: TokenizerConfig
    train: TrainConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @classmethod
    def load_yaml(cls, yml_fp: str):
        import yaml

        with open(yml_fp) as f:
            config = yaml.safe_load(f)
        return cls.from_dict(config)

    def to_dict(self) -> Dict[str, Any]:
        return _sanitize({
            "method": asdict(self.method),
            "model": asdict(self.model),
            "optimizer": asdict(self.optimizer),
            "scheduler": asdict(self.scheduler),
            "tokenizer": asdict(self.tokenizer),
            "train": asdict(self.train),
            "mesh": asdict(self.mesh),
        })

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(
            method=get_method(config["method"]["name"]).from_dict(config["method"]),
            model=ModelConfig.from_dict(config["model"]),
            optimizer=OptimizerConfig.from_dict(config["optimizer"]),
            scheduler=SchedulerConfig.from_dict(config["scheduler"]),
            tokenizer=TokenizerConfig.from_dict(config["tokenizer"]),
            train=TrainConfig.from_dict(config["train"]),
            mesh=MeshConfig.from_dict(config.get("mesh", {})),
        )

    def evolve(self, **kwargs) -> "TRLConfig":
        """Return a new config with dotted-path or nested-dict overrides applied.

        ``config.evolve(train={"seed": 1}, **{"method.gamma": 0.99})``
        """
        d = self.to_dict()
        d = _merge_dicts(d, kwargs)
        return self.from_dict(d)

    @classmethod
    def update(cls, baseconfig: Dict[str, Any], config: Dict[str, Any]) -> "TRLConfig":
        """Merge ``config`` (possibly dotted-path keyed) into ``baseconfig``;
        raises ``ValueError`` listing any keys that did not match (typo detection,
        parity with reference configs.py:303-329)."""
        if isinstance(baseconfig, TRLConfig):
            baseconfig = baseconfig.to_dict()
        update = {}
        for k, v in config.items():
            if "." in k:
                path = k.split(".")
                node = update
                for p in path[:-1]:
                    node = node.setdefault(p, {})
                node[path[-1]] = v
            else:
                update[k] = v
        updated: Set[str] = set()
        merged = merge(deepcopy(baseconfig), update, updated)
        missing = [p for p in _leaf_paths(update) if p not in updated]
        if missing:
            raise ValueError(f"Unknown config key(s): {missing}")
        return cls.from_dict(merged)

    def __str__(self):
        """Pretty YAML dump of the config."""
        import yaml

        return yaml.dump(self.to_dict(), sort_keys=False)
