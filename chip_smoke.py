#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (trlx_tpu_torch) on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a host with a
CUDA device, the CUDA toolkit (nvcc) and PyTorch built for CUDA. It exits
non-zero, printing no result, when there is no CUDA device or no port
package beside it, and when any check fails.

Phases, each printing one JSON line:

1. ``env``      — card name and power limit (the ``nvidia-smi`` line is also
                  printed on its own), torch / CUDA versions; TF32 off.
2. ``build``    — compile every kernel from ``trlx_tpu_torch/csrc`` (one
                  nvcc per source, in parallel), seconds taken, ptxas's
                  registers and spills per function, and the HMMA
                  (tensor-core) instructions per kernel instance of every
                  source from ``cuobjdump --dump-sass``: every bf16 instance
                  of the flash forward, the flash backward and the paged
                  body (7 head dims, the paged body per pool type) must have
                  some, and the D=64 and D=256 ones no spill; every spill
                  is listed.
3. ``kernels``  — each kernel against its plain PyTorch version on the card
                  at the main paths' shapes: flash prefill (K1) in bf16 and
                  f32, paged decode (K4) in bf16 and int8 at block sizes 8,
                  16 and 32, the flash backward
                  dK/dV (K2) and dQ (K3) in f32 and bf16 over MHA, GQA, MQA
                  (rep 1, 3, 4, 8, 12), ragged T/S, T = S = 16 and 17, every
                  head dim, left padding, a key tile with no valid key, a
                  query tile of dead rows, a fully masked batch row and a
                  non-causal case; two launches of each on the same inputs
                  equal bit for bit; and the whole autograd path against
                  autograd through the plain forward; the paged verify (K5)
                  over MHA and GQA, Q = 1, 2, 5, a 64-token chunk and more
                  rows than one row tile, block sizes 8, 16 and 32, f32,
                  bf16 and int8 pools, ragged lens, block edges, the table's
                  end and idle slots; K5 at Q=1 equal to K4 at lens + 1 bit
                  for bit at B=256, B=1, GQA and D=128 (f32, bf16, int8),
                  and every row j of a Q=5 round equal to K4 at lens + j + 1;
                  two launches of K1, K4 and K5 on the same inputs equal bit
                  for bit. The wide head dims: K1-K5 at D=80 and D=256
                  (GPT-J), f32 and bf16, MHA, GQA and MQA at 16 : 1, int8
                  pools, block sizes 8 to 128 (the f32 paged body's staged
                  blocks), ragged T, dead tiles and fully masked rows. Max
                  abs error within 1e-4 (f32) / 2e-2 (bf16) times max(1,
                  max|reference|); K1 and this phase's K4 cases within 1e-4
                  / 2e-2 absolute.
4. ``timing``   — CUDA-event times of kernel, plain version and the library
                  yardstick (SDPA's forward for K1, SDPA's backward for K2
                  and K3, each with its backend pinned to the fastest that
                  serves the boolean mask; none for K4 and K5) beside the
                  bound max(bytes / 3.35 TB/s, flops / 989 TFLOP/s). K1, K4
                  and K5 as device time per launch (replays of a CUDA graph
                  of 20 launches), with the eager time through the wrapper
                  beside it; K1 and SDPA's forward in turns at the engine's
                  prefill wave and the trainer's two shapes, K2, K3 and
                  SDPA's backward in turns at the training shape and the
                  learner's (five rounds of >= 200 launches and >= 50 ms
                  each, as median, min and max); K4 at the gpt2 decode
                  shape, K5 at the engine's verify shape and a chunk
                  append; and at D=256 (16 heads) K1 at a prefill wave,
                  K2/K3 at B=16 T=S=128 (with SDPA's backward), K4 at
                  B=256 and K5 at a verify round.
5. ``parity``   — the engine on the card against the same engine on the CPU
                  (plain versions): gpt2 widths at 2 layers, f32, 8 prompts x
                  16 greedy tokens must be identical.
6. ``engine``   — a main path: ``ServingEngine`` at full gpt2 width (12
                  layers, bf16, attention_impl="flash", random weights from
                  a seed) under the continuous-batching traffic of the JAX
                  package's serving benchmark (256 slots, 768 requests, a
                  64-token shared prefix, prompts <= 128 tokens, budgets 32 to
                  128 tokens, greedy), with bf16 and int8 KV, each a warm-up
                  and a measured pass. Launch counts are reset just before
                  and read just after; every prefill wave must have launched
                  the flash kernel once per layer and every decode step the
                  paged kernel once per layer; K1 and K4 replayed against
                  their plain versions at every shape the passes gave them
                  (K4 with their block tables and lens).
7. ``spec_parity`` — speculative decoding and chunked prefill on the card
                  against the CPU port on the same weights (gpt2 widths at 2
                  layers, f32, greedy): the engine with (spec_k,
                  prefill_chunk) in {(4, 0), (0, 8), (3, 5)}, plain and int8
                  KV, and a 2-step ``PPOTrainer`` rolling out through the
                  engine (spec_k 4, prefill_chunk 8). Tokens compared
                  tie-aware (at a split the CPU model may prefer its own
                  token by at most 1e-3), experience (of every element
                  with identical tokens) and losses with ``train_parity``'s
                  tolerances.
8. ``engine_spec`` — a main path: the engine at full gpt2 width with int8
                  KV, spec_k 4 and prefill_chunk 64 under the JAX package's
                  spec-leg traffic (768 requests, every budget 128), one
                  measured pass (no warm-up pass: the kernels and timing
                  phases have built and loaded K5 by then); K5 and K1
                  launched, K4 not; K5 and K1 replayed against their plain
                  versions at every shape the pass gave them (their block tables and lens,
                  their masks); the first 32 requests held against the
                  one-token engine with the same chunking and slots (running
                  the first 256 requests), tie-aware (bf16: a preference of
                  at most 2e-2 at a split), and over their whole length
                  teacher-forced through that engine (at every position it
                  prefers the chosen token, or another by <= 2e-2; on its
                  own rows, always its own token).
9. ``train_parity`` — ``PPOTrainer`` on the card against ``PPOTrainer`` on
                  the CPU (2 layers, hidden 64, f32, greedy) from the same
                  weights: one experience phase, 2 optimizer steps; tokens
                  identical, experience within 1e-4, losses within 1e-3.
10. ``train``   — a main path: ``trlx_tpu_torch.train`` at full
                  gpt2-small width (bf16 compute, f32 params and AdamW,
                  flash attention, the bytes tokenizer): 64 sampled rollouts
                  of 128 tokens per experience phase, 4 optimizer steps of 32
                  rollouts in 2 microbatches. Counts reset just before and
                  read just after: K2 and K3 once per layer and microbatch in
                  every step, K1 in every prefill, scoring and loss forward;
                  K1, K2 and K3 replayed at every shape the run gave them.
11. ``train_serving`` — a main path: ``train``'s run with ``train.serving``
                  on (block size 16, spec_k 4, prefill_chunk 64): rollouts
                  through the engine, K5 launched in every experience phase;
                  K1, K2, K3 and K5 replayed at every shape the run gave
                  them.
12. ``sft_parity`` — ``SFTTrainer`` on the card against ``SFTTrainer`` on
                  the CPU (the tiny f32 config of tests/test_torch_sft.py)
                  from the same weights: 3 steps, one on a batch padded
                  with a fully masked row; every step's loss within 1e-3
                  relative.
13. ``sft``     — a main path: ``trlx_tpu_torch.train(samples=...)`` at
                  full gpt2-small width (bf16 compute, f32 params and
                  AdamW, flash attention, the bytes tokenizer): 255 byte
                  dialogues, 8 steps of 32 rows in 2 microbatches at T=256,
                  the last batch padded with a fully masked row. K1, K2 and
                  K3 once per layer and microbatch in every step, K1 in
                  every eval prefill; every recorded shape replayed with its
                  first mask and its first fully masked row. Then
                  ``save_pretrained``: a fresh ``load_pretrained`` gives
                  logits ``torch.equal`` to the trained trunk's (f32), and a
                  ``PPOTrainer`` from the directory holds the exported
                  weights bit for bit and takes 2 learner steps.
14. ``randomwalks`` — the North star's gate, the port alone
                  (``scripts/torch_ppo_randomwalks.py``): 300 SFT steps on
                  the example's walks, export, PPO from the export to step
                  120; eval ``reward/mean`` >= 0.7 at the first eval at or
                  after step 100.
15. ``hydra_parity`` — hydra ``PPOTrainer`` (``num_layers_unfrozen=1``,
                  ``num_value_layers_unfrozen=1``) on the card against the
                  CPU with ``train_parity``'s trainer and limits.
16. ``hydra``   — a main path: hydra PPO, ``default_ppo_config()``
                  (``num_layers_unfrozen=2``) with a value branch of 1
                  layer, on ``train``'s model and traffic. K1 15 times a
                  scoring call (12 policy layers, the value block, the
                  frozen branch's 2 layers), K1 26 and K2/K3 6 times a step;
                  the 10 lower layers, embeddings, final norm and the frozen
                  branch bit-identical after the run; every recorded shape
                  replayed; step, scoring and memory beside ``train``'s.
17. ``ilql_parity`` — ``ILQLTrainer`` on the card against the CPU (the tiny
                  f32 config of tests/test_torch_ilql.py): 4 steps with
                  target syncs, losses within 1e-3; the advantage-shaped
                  processor within 1e-4.
18. ``ilql``    — a main path: ``trlx_tpu_torch.train(samples=...,
                  rewards=...)`` at full gpt2-small width (bf16): 512 byte
                  samples with seeded rewards, 8 steps of 32 in 2
                  microbatches at T=256, eval generation through the
                  processor (beta 4, top_k 20). K1, K2, K3 once per layer
                  and microbatch a step, K1 in every eval prefill; the
                  target heads change at the syncs alone, by the Polyak
                  update; every recorded shape replayed.
19. ``rft``     — a main path: ``default_rft_config()`` at full gpt2-small
                  width (bf16): one improve step (8 sampled generations of
                  64 tokens for 32 prompts, scored, filtered) and 2 SFT
                  steps on the survivors; K1 in every prefill, K1/K2/K3 per
                  layer and microbatch a step; every recorded shape
                  replayed.
20. ``randomwalks_hydra`` — the randomwalks gate with hydra PPO
                  (``num_layers_unfrozen=2``): ``reward/mean`` >= 0.7 at the
                  first eval at or after step 100.
21. ``randomwalks_ilql`` — ``scripts/torch_ilql_randomwalks.py``: the ILQL
                  example at top_k=1 over its 1000 steps, optimality >= 0.6
                  at the final eval.
22. ``randomwalks_rft`` — ``scripts/torch_rft_randomwalks.py``: 300 SFT
                  steps, 100 RFT steps, final ``reward/mean`` >= 0.9 and no
                  lower than its step 0.
23. ``grpo_parity`` — the GRPO learner on the card against the CPU (2
                  layers, hidden 64, f32) on the same sampled experience: 2
                  steps, losses/* and group/* within 1e-3 relative, the
                  group advantages within 1e-5.
24. ``grpo``    — a main path: ``default_grpo_config()`` (hydra, groups of
                  4, 40 sampled tokens) at full gpt2 width through
                  ``train(environment=...)``: 128 rollouts, 4 steps of 32 in
                  2 microbatches; whole adjacent groups in every decode
                  batch, value loss 0, group_adv_std > 0; K1 per prefill /
                  scoring call / step, K2 and K3 in the 2 trained layers.
25. ``online_grpo`` — a main path: the JAX online leg with one
                  ``ServingEngine`` (full width, sampled, block 16): 4 waves
                  of 32 prompts x 4 harvested by a ``PreferenceCollector``,
                  a ``GRPOTrainer`` on the drained groups (4 steps), the
                  engine republished and one more wave at version 1;
                  exactly-once harvest, no KV block left, K1 and K4
                  launched; K1, K2/K3 and K4 held against their plain
                  versions at the path's shapes.
26. ``async``   — a main path: ``train``'s run with
                  ``train.async_rollouts`` (max_staleness 2), 6 steps; no
                  producer thread left, the drain ledger balanced, a batch
                  trained at staleness >= 1; K1/K2/K3 totals exact across
                  both threads.
27. ``grpo_synthetic`` — ``scripts/torch_grpo_synthetic.py``: the GRPO
                  example's recipe, 3 seeds x 200 steps, 64 eval samples;
                  the mean late ``reward/mean`` within 0.07 of the JAX
                  runs', the mean rise at least half of theirs, every run
                  above its step 0.
28. ``randomwalks_async`` — the randomwalks gate with async rollouts
                  (max_staleness 1): ``reward/mean`` >= 0.7 at the first
                  eval at or after step 100.

29. ``resilience`` — a main path: ``train.resilience`` and
                  ``train.self_healing`` at full gpt2 width with ``train``'s
                  traffic (:func:`phase_resilience`): a real SIGTERM, the
                  emergency checkpoint and an auto-resume equal to an
                  uninterrupted 4-step run (parameters, AdamW state and
                  stats); the learner's stall per save, sync against
                  async, and the async checkpoint equal to the state at its
                  save; ``checkpoint:1``; ``nan-loss:2`` skipped and rolled
                  back; a halt with its bundle; ``bad-element:1``; the
                  producer supervisor through ``rollout-producer:1,
                  producer-wedge:1``; K1/K2/K3 counted and replayed at every
                  recorded shape.
30. ``observability`` — a main path: ``train.observability`` and
                  ``train.profile_dir`` at full gpt2 width with ``train``'s
                  traffic (:func:`phase_observability`): two 4-step runs
                  (off, then on) with ``losses/*`` equal across them;
                  spans, step-time percentiles, throughput and MFU
                  against the card's data-sheet peak, CUDA-allocator memory
                  gauges (no host RSS), ``trace.json``, the series and
                  Prometheus exports; request flights on the
                  ``train.serving`` leg (one terminal event each, engine
                  phases = latency, no block left); a wedged producer
                  restarted by the watchdog's escalation; last, a 2-step
                  "on" run whose torch.profiler window holds step 1 alone,
                  K1/K2/K3 kernel events inside ``learn``; K1/K2/K3/K5
                  counted over the runs with the layer on and replayed at
                  every recorded shape.
31. ``production_serving`` — a main path: production serving on one engine
                  at gpt2 full width (:func:`phase_production_serving`).
                  ``resilience_parity`` (f32, 32 requests, 8 slots): the
                  policy without faults ``==`` the plain engine; KV-pressure
                  preemption and ``serving-prefill:1,serving-decode:1``
                  under the supervisor equal to the plain run but at near
                  ties (<= 1e-3); ``serving_chaos`` and ``tenant_scenario``
                  (bf16; the JAX chaos and tenant legs' card sizes, every
                  serving chaos site armed): one terminal state per uid, no
                  block leaked, no quota violation, the SLO order, and the
                  scheduling facts equal to the same legs run by the port
                  on the CPU (2 layers, hidden 64); ``stream_overlap``
                  (``train_serving``'s trainer with ``stream_overlap`` and
                  ``serving_resilience``, greedy, a 30 ms reward a sample):
                  a serial and a streamed phase with the same tokens,
                  store order and raw scores, logprobs and values within
                  2e-2, a serialized phase with a lower overlap fraction, a
                  chaos phase with one reward call per rollout, and one PPO
                  epoch consuming the staged batches. K1–K5 counted from 0
                  over the card legs and replayed at every recorded shape.
32. ``serving_fleet`` — a main path: serving across engines at gpt2 full
                  width (:func:`phase_serving_fleet`). ``fleet_of_one``: a
                  ``FleetRouter`` of one replica ``==`` the bare engine on 128
                  requests (64 slots). ``fleet_scenario``: the JAX fleet
                  leg's card sizes (3 replicas of 16 slots, 4 tenants in 2
                  classes, one replica kill and two mis-routes, the
                  autoscaler between 1 and 4), its scheduling facts equal to
                  the same leg run by the port on the CPU (2 layers, hidden
                  64). ``fleet_trainer``: ``train_serving``'s trainer
                  (greedy) with ``train.serving_fleet`` (2 replicas) and
                  ``serving_resilience``, 2 steps: one terminal state per
                  uid, both seats routed, the store whole and in order, no
                  block left. ``online_fleet``: ``online_grpo``'s traffic
                  through 2 replicas x 64 slots with a replica kill in wave
                  2, harvested exactly once, no SLO burn, 4 GRPO steps,
                  ``set_params`` to every replica, the next wave at version
                  1. ``islands_bubble``: a saturated 64-slot engine as a
                  ``GenerationIsland`` beside a learner publishing chunked
                  broadcasts, 2 s windows in turns (chunked, blocking,
                  chunked, blocking): no torn version, one flush per swap,
                  a ``broadcast-chunk:1`` abort that burns its version.
                  ``islands_trainer``: the ``async`` trainer with the
                  engine and ``train.islands``, 4 steps. Device memory back
                  within 64 MiB after every leg; K1–K5 counted from 0 over
                  the card legs and replayed at every recorded shape.

33. ``families_seq2seq`` — a main path: the optimizers, bloom, seq2seq and
                  the sweep (:func:`phase_families_seq2seq`). ``optimizers``:
                  the ``train`` phase's gpt2 trainer at full width with
                  each of sgd (momentum 0.9, decay 0.01), lion, adafactor
                  and rmsprop, 2 steps each from the same initial weights
                  on one shared experience phase: losses
                  finite, parameters moved, the optimizer state's bytes
                  equal to the formula of ``fs_state_bytes_formula``, K2
                  and K3 once per layer and microbatch, every recorded
                  K1/K2/K3 shape held against the plain versions; each
                  then on the card against the CPU with ``train_parity``'s
                  trainer and limits. ``bloom``: PPO on bloom-560m (24
                  layers, hidden 1024, vocab 250880, bf16 compute) for 2
                  steps through the padded generate, ``save_pretrained``
                  -> ``load_pretrained`` logits ``torch.equal``, and a
                  narrow f32 bloom on the card against the CPU (greedy
                  tokens identical, logits within 1e-5). ``seq2seq``: at
                  t5-small widths SFT 4 steps with its export reloaded to
                  ``torch.equal`` logits, PPO 2 steps with a full frozen
                  reference and 2 with the decoder-top branch, ILQL 4
                  steps, greedy decode with the int8 decoder cache against
                  bf16 (every differing row at a near tie, 2e-2), and a
                  2 + 2-layer f32 PPO on the card against the CPU. K1–K5
                  launch 0 times in the bloom and T5 legs (the reference
                  keeps ALiBi and T5 off its kernels). ``sweep``: ``python
                  -m trlx_tpu_torch.sweep scripts/torch_ppo_randomwalks.py``
                  over a 2-trial grid: both trials recorded with their
                  metric, and the report written.
34. ``peft_memory`` — a main path: peft and the training-memory options at
                  gpt2 full width with ``train``'s trainer
                  (:func:`phase_peft_memory`). ``peft_parity``: LoRA, prefix
                  and prompt tuning on the card against the CPU
                  (``train_parity``'s trainer and limits). ``lora_ppo``:
                  r 8 / alpha 16 on q_proj and v_proj, 4 steps through
                  ``train.serving``: no reference copy, the trunk
                  ``torch.equal`` to its initial weights with no gradient
                  or optimizer state, AdamW's moments (294,912 + 1,182,721)
                  x 8 B, the merged export against the adapter forward and
                  the adapter file reloaded ``torch.equal``.
                  ``prompt_prefix``: 2 steps each, prompt tuning on K1-K3,
                  prefix tuning on none. ``remat``: one learner batch under
                  none and each policy, losses and gradients
                  ``torch.equal``, K1 twice per layer under remat, peak
                  memory and seconds. ``offload_ref``: a streamed phase
                  uploads the pinned host reference once and releases it;
                  ``memory_allocated`` moves by exactly its 497,759,232 B;
                  scoring ``torch.equal`` to a resident copy.
                  ``rollout_dtype``: bf16 rollout parameters on the card
                  against the CPU, then one cast per experience phase and
                  none inside a step over 4 steps, device operations per
                  decode step with and without the copy. ``adamw_8bit``:
                  on the card against the CPU, then full fine-tuning with
                  state bytes equal to the formula and a checkpoint resumed
                  ``torch.equal``. Launches counted from 0 per full-width
                  leg and summed.
35. ``scale_out`` — a main path across ranks (:func:`phase_scale_out`): (a)
                  one rank over NCCL (``TRLX_NUM_PROCESSES=1``,
                  ``mesh.data=-1``): ``train_parity``'s trainer, its stats
                  ``==`` the card trainer's in this process, then PPO at
                  gpt2 full width in f32 compute for 2 steps through
                  ``trlx_tpu_torch.train`` (and again with half the
                  minibatch: the reference of the overlapped step, whose
                  statistics are per rank-microbatch); (b), at the same
                  time, two processes sharing ``cuda:0`` over gloo:
                  ``data=2``, ``fsdp=2`` with
                  ``train.learner_overlap`` and ``model=2``, each the same
                  PPO run, stats within 1e-3 relative (+1e-6) of (a). Per
                  rank and run: parameter plus optimizer bytes (at
                  ``fsdp=2`` <= 0.55 of (a)'s), peak memory, step seconds,
                  backend, collectives staged through host memory; K1, K2
                  and K3 launched on every rank, and held against their
                  plain versions at every shape the ranks gave them (6
                  heads under ``model=2``, half the rows under ``data`` and
                  ``fsdp``). (c), at the same time, two more processes on
                  ``cuda:0`` over gloo, PPO at 15 new tokens (an even
                  length, so the sequence path runs): ``pipe=2`` (2
                  microbatches, the full reference copy pipelined too),
                  ``model=2`` with ``mesh.sequence_shard`` and ``model=2``
                  with ring attention, each within 1e-3 relative (+1e-6) of
                  its one-rank baseline in (a) at the same lengths (the
                  same stacked trunk; flash), both ranks' stats ``==``;
                  the pipe ranks' parameter plus optimizer bytes <= 0.70 of
                  one rank's; sequence scatters and ring rotations > 0; K1,
                  K2 and K3 held at the stage's microbatch rows and, under
                  sequence sharding, at 6 heads and the whole length (the
                  ring run launches none: the reference keeps ring
                  attention off the flash kernels). (d), at the same
                  time, a second one-rank process and two more groups of
                  two: the native store (the CLI converts gpt2 from seed
                  0 in bf16 through ``--dtype`` in the background,
                  ``inspect``; the port's writer stores the card trainer's
                  own seed-0 init in f32; each restored onto ``cuda:0``
                  ``torch.equal`` to its source; PPO from the f32 store
                  ``==`` (a)'s, and its ``fsdp=2`` / ``model=2`` blocks
                  ``torch.equal`` their slices, with the chunk bytes each
                  rank read), LoRA r 8 on ``fsdp=2`` and ``model=2``
                  (within 1e-3 of one rank, the trunk and the adapter
                  export ``torch.equal``), t5-small on ``model=2``
                  (sampled; within 1e-3, no launch), ``offload_ref`` on
                  ``fsdp=2`` (scoring ``==`` (b)'s resident sharded
                  reference, host bytes ~half the reference's), 8-bit
                  AdamW and Adafactor on ``fsdp=2`` (state bytes a rank
                  = the formula, this rank's blocks; Adafactor's
                  parameters within 1e-5 of one rank, 8-bit's within
                  twice f32 AdamW's own two-rank difference, since the
                  ranks sum gradients in another order; and, after the
                  run, each rank's whole-leaf step within 1e-6 of the
                  plain optimizer's step on the same seeded gradient and
                  state, 8-bit's codes within 1 of it and at most 0.1%
                  differing).

36. ``gptj``    — a main path at GPT-J's width (run after ``hydra``;
                  :func:`phase_gptj`): the ``gptj`` preset (vocab 50,400,
                  hidden 4,096, 16 heads of 256, gptj rotary over 64 dims,
                  parallel residual, untied head) cut to 4 layers, under
                  examples/hh/ppo_hh.py's traffic, hydra PPO through
                  ``trlx_tpu_torch.train`` and the engine, each run
                  ``ppo_main_path``'s (exact launch counts, no KV block
                  left, the frozen layers and branch bit-identical, every
                  kernel shape replayed against its plain version): (a)
                  bf16 compute, 2 steps over bf16 pools (K4) and 2 over
                  int8 pools with spec_k 4 (K5), K1-K3 in both, finite
                  losses; (b) f32 and greedy, once through the kernels and
                  once through the plain versions from the same weights:
                  tokens identical but at near ties (1e-3), experience
                  within 1e-4, losses/* within 1e-3 relative. Step seconds
                  and peak memory beside the card.

The learning gates (14, 20, 21, 22, 28: tiny models, no launch counts, no
time held to a bar) run in this order in a child process started after
``serving_fleet``, beside ``families_seq2seq`` to ``analysis``, none of
which holds a time to a bar; their lines are printed when the child ends
(``gates_child`` and ``gates_wait`` in the phase seconds).

Then the seconds of each phase (``{"phase_seconds": {...}}``), the kernel
table (``{"kernels": [...]}``) and, last, the result line
``{"ok": true, "device": {...}}``. ``--phases`` runs a subset (the result
line needs all of them).
"""

import argparse
import concurrent.futures
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PHASES = ("env", "build", "kernels", "timing", "parity", "engine", "spec_parity", "engine_spec",
          "train_parity", "train", "train_serving", "sft_parity", "sft",
          "hydra_parity", "hydra", "gptj", "ilql_parity", "ilql", "rft",
          "grpo_parity", "grpo", "online_grpo", "async", "grpo_synthetic", "resilience",
          "observability", "production_serving", "serving_fleet",
          "randomwalks", "randomwalks_hydra", "randomwalks_ilql", "randomwalks_rft", "randomwalks_async",
          "families_seq2seq", "peft_memory", "stacked", "scale_out", "analysis")
#: the learning gates: tiny models, no launch counts and no timing bar. In a
#: whole run they run in order in a child process (:func:`gates_start`)
#: beside the phases after them, none of which holds a time to a bar
GATE_PHASES = ("randomwalks", "randomwalks_hydra", "randomwalks_ilql", "randomwalks_rft", "randomwalks_async")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ inputs


def flash_case(torch, gen, B, H, Hkv, T, D, dtype, pad, dev):
    q = torch.randn(B, H, T, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Hkv, T, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Hkv, T, D, generator=gen, device=dev).to(dtype)
    valid = torch.ones(B, T, dtype=torch.int32, device=dev)
    for b, p in enumerate(pad):
        valid[b, :p] = 0  # left padding (p == T: a row with no valid key)
    return q, k, v, valid


def paged_case(torch, gen, B, H, Hkv, D, BS, MB, quant, dev, dtype=None):
    """Pools with ragged lens, slots sharing a 4-block prefix in pairs, and
    every 16th slot idle at len 1 on the null block 0."""
    from trlx_tpu_torch.models.transformer import quantize_kv_rows

    dtype = dtype or torch.bfloat16
    NB = B * MB + 1
    kf = torch.randn(NB, BS, Hkv, D, generator=gen, device=dev)
    vf = torch.randn(NB, BS, Hkv, D, generator=gen, device=dev)
    tables = torch.arange(1, NB, dtype=torch.int32, device=dev).reshape(B, MB)
    tables[1::2, :4] = tables[0::2, :4]  # prefix-shared blocks
    lens = torch.randint(1, MB * BS + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    tables[::16] = 0
    lens[::16] = 1
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    if quant:
        kq, ks = quantize_kv_rows(kf)
        vq, vs = quantize_kv_rows(vf)
        return dict(q=q, k_pool=kq, v_pool=vq, block_tables=tables, context_lens=lens,
                    k_scale=ks[..., 0].contiguous(), v_scale=vs[..., 0].contiguous())
    return dict(q=q, k_pool=kf.to(dtype), v_pool=vf.to(dtype), block_tables=tables,
                context_lens=lens)


def paged_call(fn, case):
    return fn(case["q"], case["k_pool"], case["v_pool"], case["block_tables"],
              case["context_lens"], k_scale=case.get("k_scale"), v_scale=case.get("v_scale"))


def verify_case(torch, gen, B, Q, H, Hkv, D, BS, MB, quant, dev, dtype=None, lens=None):
    """paged_case's pools with q [B, Q, H, D] and PRE-append lens: ragged in
    [0, MB*BS - Q], every 8th slot (from 1) at BS - 1 so its queries cross a
    block edge, every 8th (from 2) at MB*BS - Q so its last query reaches
    the table's end, every 16th idle (null table row, len 0). With ``lens``
    given, every slot is live at those lens."""
    case = paged_case(torch, gen, B, H, Hkv, D, BS, MB, quant, dev, dtype)
    case["q"] = torch.randn(B, Q, H, D, generator=gen, device=dev).to(case["q"].dtype)
    if lens is None:
        lens = torch.randint(0, MB * BS - Q + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
        lens[1::8] = min(BS - 1, MB * BS - Q)
        lens[2::8] = MB * BS - Q
        lens[::16] = 0
    else:
        case["block_tables"] = torch.arange(1, B * MB + 1, dtype=torch.int32, device=dev).reshape(B, MB)
    case["context_lens"] = lens
    return case


def paged_bound(case):
    lens = case["context_lens"].long()
    B, H, D = case["q"].shape
    Hkv = case["k_pool"].shape[2]
    live = int(lens.sum())
    byts = 2 * live * Hkv * D * case["k_pool"].element_size()
    if "k_scale" in case:
        byts += 2 * live * Hkv * 4
    byts += 2 * B * H * D * case["q"].element_size() + case["block_tables"].numel() * 4 + B * 4
    flops = 4 * live * H * D
    return byts, flops


def verify_bound(case):
    """Live K/V read once (the positions the slot's last query sees, scales
    too under int8), q and out, tables and lens; 4*D flops per head and
    visible (query, position) pair."""
    import torch

    lens = case["context_lens"].long()
    B, Q, H, D = case["q"].shape
    NB, BS, Hkv, _ = case["k_pool"].shape
    S = case["block_tables"].shape[1] * BS
    live = int((lens + Q).clamp(max=S).sum())
    byts = 2 * live * Hkv * D * case["k_pool"].element_size()
    if "k_scale" in case:
        byts += 2 * live * Hkv * 4
    byts += 2 * B * Q * H * D * case["q"].element_size() + case["block_tables"].numel() * 4 + B * 4
    pairs = int((lens[:, None] + 1 + torch.arange(Q, device=lens.device)[None, :]).clamp(max=S).sum())
    return byts, 4 * pairs * H * D


def bound_ms(byts, flops):
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases


def phase_env(ctx):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    ctx["smi"] = smi
    # the native store's zstd (libzstd through ctypes); without it the port writes uncompressed stores
    from trlx_tpu_torch.store import zstd

    emit({"phase": "env", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0], "libzstd_loads": zstd.available(),
          "libzstd_version": zstd.version()})


def ptxas_per_function(log):
    """``-Xptxas=-v`` output as {mangled function: {registers, spill_stores,
    spill_loads}}."""
    import re

    funcs, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", ln)
        if m:
            name = m.group(1)
            funcs.setdefault(name, {})
        elif name and "spill stores" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln).groups()
            funcs[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in ln and "registers" in ln:
            funcs[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return funcs


def sass_hmma_counts(lib_path):
    """{mangled function: number of HMMA (tensor-core) instructions} in a
    built library's SASS (``cuobjdump --dump-sass``, from the CUDA toolkit)."""
    import re

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "--dump-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"\bHMMA\b", ln):
            counts[name] += 1
    return counts


#: the tensor-core (bf16) kernels per source: {stem: {kernel name: instances}}
#: (one per head dim of FLASH_HEAD_DIMS / PAGED_MMA_HEAD_DIMS, 7; the paged
#: body also per pool type, bf16 and int8)
MMA_KERNELS = {
    "flash_fwd": {"fwd_mma_kernel": 7},
    "flash_bwd": {"dkv_mma_kernel": 7, "dq_mma_kernel": 7},
    "paged_decode": {"paged_mma_kernel": 14},
}
#: bf16 instances that must not spill: the gpt2 head dim and GPT-J's
NO_SPILL_DIMS = (64, 256)


def phase_build(ctx):
    """Build every source; report ptxas's registers and spills per function
    and the tensor-core (HMMA) instruction count per kernel instance of
    every source. Fails when a bf16 (tensor-core) instance of the flash
    forward, the flash backward or the paged body has no HMMA, or a D=64 or
    D=256 one spills; every other instance's spills are reported
    (``spills``)."""
    from trlx_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    per_kernel = _kernels.build()
    for name in _kernels.KERNELS:
        _kernels.library(name)  # load, so a bad library fails here
    ptxas = {stem: ptxas_per_function(log) for stem, log in _kernels.BUILD_LOG.items()}
    with concurrent.futures.ThreadPoolExecutor(len(MMA_KERNELS)) as pool:  # one cuobjdump a library, together
        hmma = dict(zip(MMA_KERNELS, pool.map(lambda stem: sass_hmma_counts(_kernels._lib_path(f"{stem}.cu")),
                                              MMA_KERNELS)))
    spilled = {f: p for funcs in ptxas.values() for f, p in funcs.items()
               if p.get("spill_stores", 0) + p.get("spill_loads", 0) > 0}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": per_kernel, "ptxas": ptxas, "hmma": hmma, "spills": spilled})
    bad = {}
    for stem, kernels in MMA_KERNELS.items():
        for kernel, instances in kernels.items():
            with_hmma = sum(n > 0 for f, n in hmma[stem].items() if kernel in f)
            if with_hmma != instances:
                bad[kernel] = {f: n for f, n in hmma[stem].items() if kernel in f}
    gated = {f: p for f, p in spilled.items() if any(f"_mma_kernelILi{d}E" in f for d in NO_SPILL_DIMS)}
    if bad or gated:
        raise AssertionError(f"bf16 tensor-core instances: missing HMMA {bad}; D=64 / D=256 spills {gated}")


def phase_kernels(ctx):
    import torch

    from trlx_tpu_torch.ops.paged_attention import paged_attention_kernel, paged_attention_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results, errs = [], {"flash_fwd": 0.0, "paged_decode": 0.0, "flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0,
                         "paged_verify": 0.0}
    flash_cases = [
        ("gpt2_prefill", dict(B=16, H=12, Hkv=12, T=128, D=64,
                              pad=[int(x) for x in torch.randint(0, 96, (16,), generator=gen, device=dev)])),
        ("gqa_d128_t200", dict(B=2, H=32, Hkv=8, T=200, D=128, pad=(0, 37))),
        ("fully_masked_row", dict(B=2, H=4, Hkv=4, T=70, D=64, pad=(70, 5))),
        # the wide head dims: 80 (Pythia-2.8B, OPT-2.7B) and 256 (GPT-J)
        ("d80_gqa_t150", dict(B=2, H=8, Hkv=2, T=150, D=80, pad=(0, 41))),
        ("d80_fully_masked_row", dict(B=2, H=4, Hkv=4, T=70, D=80, pad=(70, 5))),
        ("gptj_prefill_d256", dict(B=4, H=16, Hkv=16, T=128,
                                   D=256, pad=[int(x) for x in torch.randint(0, 96, (4,), generator=gen, device=dev)])),
        ("d256_mqa_16_1_t200", dict(B=2, H=16, Hkv=1, T=200, D=256, pad=(64, 0))),
        ("d256_fully_masked_row", dict(B=2, H=4, Hkv=2, T=70, D=256, pad=(70, 5))),
    ]
    for name, shape in flash_cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, valid = flash_case(torch, gen, dtype=dtype, dev=dev, **shape)
            results.append(compare_fwd(torch, name, q, k, v, valid, errs,
                                       zero_row=name.endswith("fully_masked_row")))
    # K1 at the trainer's shapes, with its mask: left-padded prompts plus
    # right-padded responses
    for name, B, P, R, r_max in TRAIN_FWD_CASES:
        valid = train_valid(torch, gen, B, P, R, dev, r_max)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, _ = flash_case(torch, gen, B, 12, 12, P + R, 64, dtype, (), dev)
            results.append(compare_fwd(torch, name, q, k, v, valid, errs))
    paged_cases = [
        ("gpt2_decode", dict(B=256, H=12, Hkv=12, D=64, BS=16, MB=16)),
        ("gqa_rep4_d128", dict(B=64, H=32, Hkv=8, D=128, BS=16, MB=16)),
        # block sizes other than one k16 step: the walk goes through the table per position
        ("gpt2_decode_bs8", dict(B=64, H=12, Hkv=12, D=64, BS=8, MB=32)),
        ("gqa_12_3_bs32", dict(B=64, H=12, Hkv=3, D=64, BS=32, MB=8)),
        # the wide head dims at block sizes 8, 16 and 32, MHA, GQA and MQA at
        # gpt_bigcode's 16 : 1 (every 16th slot idle at len 1 on the null block)
        ("gptj_decode_d256", dict(B=64, H=16, Hkv=16, D=256, BS=16, MB=16)),
        ("d256_mqa_16_1_bs8", dict(B=32, H=16, Hkv=1, D=256, BS=8, MB=32)),
        ("d256_gqa_16_4_bs32", dict(B=32, H=16, Hkv=4, D=256, BS=32, MB=8)),
        ("d80_gqa_32_8_bs8", dict(B=64, H=32, Hkv=8, D=80, BS=8, MB=32)),
        ("d80_mqa_16_1_bs16", dict(B=32, H=16, Hkv=1, D=80, BS=16, MB=16)),
        ("d80_bs32", dict(B=32, H=32, Hkv=32, D=80, BS=32, MB=8)),
    ]
    for name, shape in paged_cases:
        for quant in (False, True):
            case = paged_case(torch, gen, quant=quant, dev=dev, **shape)
            out = paged_call(paged_attention_kernel, case)
            ref = paged_call(paged_attention_reference, case)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= TOL["bfloat16"] and bool(torch.isfinite(out.float()).all())
            results.append({"kernel": "paged_decode", "case": name, "kv": "int8" if quant else "bf16",
                            "max_abs_err": err, "tol": TOL["bfloat16"], "ok": ok})
            errs["paged_decode"] = max(errs["paged_decode"], err)
    # f32 queries (f32 pools, and int8 pools under f32 queries) at the gpt2
    # decode shape and the wide head dims: the tight tolerance. At D = 256
    # the block sizes 64 and 128 make the f32 body stage a block in parts
    # (its tiles would not fit the CTA's shared memory whole)
    f32_cases = [("gpt2_decode", paged_cases[0][1], False),
                 ("d80_gqa_32_8_bs8", dict(B=16, H=32, Hkv=8, D=80, BS=8, MB=32), True),
                 ("d256_bs64", dict(B=16, H=16, Hkv=4, D=256, BS=64, MB=4), True),
                 ("d256_mqa_16_1_bs128", dict(B=8, H=16, Hkv=1, D=256, BS=128, MB=2), True)]
    for name, shape, with_int8 in f32_cases:
        for quant in (False, True) if with_int8 else (False,):
            case = paged_case(torch, gen, quant=quant, dev=dev, dtype=torch.float32, **shape)
            out = paged_call(paged_attention_kernel, case)
            err = (out - paged_call(paged_attention_reference, case)).abs().max().item()
            results.append({"kernel": "paged_decode", "case": name, "kv": "int8, f32 q" if quant else "f32",
                            "max_abs_err": err, "tol": TOL["float32"],
                            "ok": err <= TOL["float32"] and bool(torch.isfinite(out).all())})
    results += check_flash_backward(torch, gen, dev, errs)
    results += check_paged_verify(torch, gen, dev, errs)
    results += check_two_launches(torch, gen, dev)
    for r in results:
        emit({"phase": "kernels", **r})
    ctx["max_abs_err"] = errs
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")


def compare_fwd(torch, name, q, k, v, valid, errs, zero_row=False, causal=True, scale=None):
    """K1 (out and lse) against attention_reference on the same CUDA
    tensors; ``zero_row``: some batch row sees no key (all of ``valid``'s
    row is 0), and every such row must give 0 and lse == -1e30."""
    from trlx_tpu_torch.ops.attention import attention_reference, flash_attention

    out, lse = flash_attention(q, k, v, valid, causal, scale, return_lse=True)
    ref, ref_lse = attention_reference(q, k, v, valid, causal, scale, return_lse=True)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[str(q.dtype).split(".")[-1]]
    # lse is f32 in both; the kernel's sum order differs from torch's
    lse_err = (lse - ref_lse).abs().max().item()
    ok = err <= tol and lse_err <= 1e-3 and bool(torch.isfinite(out.float()).all())
    if zero_row:
        dead = (valid == 0).all(dim=1)
        ok = ok and bool(dead.any()) and bool((out[dead] == 0).all()) and bool((lse[dead] == -1e30).all())
    errs["flash_fwd"] = max(errs["flash_fwd"], err)
    return {"kernel": "flash_fwd", "case": name, "shape": list(q.shape), "dtype": str(q.dtype),
            "max_abs_err": err, "lse_err": lse_err, "tol": tol, "ok": ok}


def compare_bwd(torch, name, q, k, v, g, valid, errs, zero_row=False, causal=True, scale=None):
    """K2 (dK/dV) and K3 (dQ) against flash_backward_reference on the same
    CUDA tensors (out and lse from K1). Tolerance per gradient: max abs
    error <= TOL[dtype] * max(1, max|grad|); ``zero_row``: some batch row
    sees no key (all of ``valid``'s row is 0), and the gradients of every
    such row must be exactly 0."""
    from trlx_tpu_torch.ops.attention import flash_attention, flash_backward, flash_backward_reference

    out, lse = flash_attention(q, k, v, valid, causal, scale, return_lse=True)
    got = flash_backward(q, k, v, valid, out, lse, g, causal, scale)
    ref = flash_backward_reference(q, k, v, valid, out, lse, g, causal, scale)
    torch.cuda.synchronize()
    tol_rel = TOL[str(q.dtype).split(".")[-1]]
    results = []
    dead = (valid == 0).all(dim=1)
    for kernel, idx in (("flash_bwd_dkv", (1, 2)), ("flash_bwd_dq", (0,))):
        # per gradient, so a NaN fails its own comparison (Python's max()
        # would drop it)
        errs_i = [(got[i].float() - ref[i].float()).abs().max().item() for i in idx]
        tols_i = [tol_rel * max(1.0, ref[i].float().abs().max().item()) for i in idx]
        ok = all(e <= t for e, t in zip(errs_i, tols_i)) and all(
            bool(torch.isfinite(got[i]).all()) and bool(torch.isfinite(ref[i]).all()) for i in idx)
        if zero_row:
            ok = ok and bool(dead.any()) and all(bool((got[i][dead] == 0).all()) for i in idx)
        err, tol = max(errs_i), max(tols_i)
        results.append({"kernel": kernel, "case": name, "shape": list(q.shape), "dtype": str(q.dtype),
                        "max_abs_err": err, "tol": tol, "ok": ok})
        errs[kernel] = max(errs[kernel], err)
    return results


#: K1 at the trainer's shapes: (name, B, P, R, longest response). Scoring
#: runs B=32 at P + R = 384: the trainer appends an eos to every 128-token
#: response, so 129 tokens round up to the 256 bucket. The loss forward runs
#: a microbatch of 16 padded to its longest response, 129.
TRAIN_FWD_CASES = [
    ("gpt2_scoring", 32, 128, 256, 129),
    ("gpt2_loss", 16, 128, 129, 129),
]

#: flash backward cases: (name, B, H, Hkv, T, S, D, left pads per batch row,
#: or ("train", P, R) for a learner batch's mask)
BWD_CASES = [
    ("gpt2_learner", 16, 12, 12, 257, 257, 64, ("train", 128, 129)),
    ("gpt2_train", 4, 12, 12, 256, 256, 64, (0, 37, 128, 255)),
    ("gqa_12_4_t200", 2, 12, 4, 200, 200, 64, (0, 61)),
    ("mqa_t37_s200", 2, 8, 1, 37, 200, 32, (5, 0)),
    ("ragged_t37", 3, 4, 4, 37, 37, 64, (0, 3, 36)),
    ("gqa_d128", 2, 8, 2, 100, 100, 128, (17, 0)),
    ("fully_masked_row", 2, 4, 2, 70, 70, 64, (70, 9)),
    # the tensor-core tiling's edges: T = S below one tile, every head dim,
    # rep 12, a key tile with no valid key and a query tile of dead rows
    ("t16", 2, 4, 4, 16, 16, 64, (0, 5)),
    ("t17", 2, 4, 2, 17, 17, 64, (3, 0)),
    ("d16", 2, 4, 4, 80, 80, 16, (0, 7)),
    ("d96_gqa", 2, 4, 2, 80, 80, 96, (9, 0)),
    ("mqa_rep12", 2, 12, 1, 130, 130, 64, (0, 70)),
    ("dead_tiles", 2, 4, 4, 200, 200, 64, (64, 130)),
    # the wide head dims: 80, and 256 (the split of each 16-row group over
    # two warps, the f32 body's 32-row tiles) at GPT-J's learner shape, MQA
    # at 16 : 1, dead tiles, ragged T and a fully masked row
    ("d80_gqa_t100", 2, 8, 2, 100, 100, 80, (17, 0)),
    ("d80_ragged_t37", 3, 4, 4, 37, 37, 80, (0, 3, 36)),
    ("gptj_learner_d256", 16, 16, 16, 96, 96, 256, ("train", 48, 48)),
    ("d256_mqa_16_1_dead_tiles", 2, 16, 1, 200, 200, 256, (64, 130)),
    ("d256_t17", 2, 4, 2, 17, 17, 256, (3, 0)),
    ("d256_fully_masked_row", 2, 4, 2, 70, 70, 256, (70, 9)),
]
#: non-causal flash backward cases (the same fields)
BWD_CASES_NONCAUSAL = [
    ("noncausal_gqa_t70_s130", 2, 6, 2, 70, 130, 64, (0, 66)),
    ("noncausal_d256_t70_s130", 2, 4, 2, 70, 130, 256, (0, 66)),
]


def bwd_case(torch, gen, B, H, Hkv, T, S, D, pad, dtype, dev):
    q = torch.randn(B, H, T, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dtype)
    g = torch.randn(B, H, T, D, generator=gen, device=dev).to(dtype)
    if pad and pad[0] == "train":
        return q, k, v, g, train_valid(torch, gen, B, pad[1], pad[2], dev)
    valid = torch.ones(B, S, dtype=torch.int32, device=dev)
    for b, p in enumerate(pad):
        valid[b, :p] = 0  # left padding (p == S: a batch row with no valid key)
    return q, k, v, g, valid


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_flash_backward(torch, gen, dev, errs):
    """K2 (dK/dV) and K3 (dQ) against flash_backward_reference on the same
    CUDA tensors (out and lse from K1), f32 and bf16; then the whole autograd
    path against autograd through attention_reference in f32, and two
    launches of each kernel on the same inputs, which must be equal bit for
    bit. Tolerance: max abs error <= TOL[dtype] * max(1, max|grad|)."""
    from trlx_tpu_torch.ops.attention import (
        attention_reference, bwd_delta, flash_attention, flash_bwd_dkv, flash_bwd_dq, set_flash_backward,
    )

    results = []
    for causal, cases in ((True, BWD_CASES), (False, BWD_CASES_NONCAUSAL)):
        for name, B, H, Hkv, T, S, D, pad in cases:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, g, valid = bwd_case(torch, gen, B, H, Hkv, T, S, D, pad, dtype, dev)
                results += compare_bwd(torch, name, q, k, v, g, valid, errs, causal=causal,
                                       zero_row=name.endswith("fully_masked_row"))
    # determinism: no atomics, so two launches on the same inputs give the same bits
    for dtype in (torch.float32, torch.bfloat16):
        name, B, H, Hkv, T, S, D, pad = BWD_CASES[0]
        q, k, v, g, valid = bwd_case(torch, gen, B, H, Hkv, T, S, D, pad, dtype, dev)
        out, lse = flash_attention(q, k, v, valid, return_lse=True)
        delta = bwd_delta(q, k, v, valid, out, lse, g)
        for kernel, fn in (("flash_bwd_dkv", flash_bwd_dkv), ("flash_bwd_dq", flash_bwd_dq)):
            first, second = (as_tuple(fn(q, k, v, valid, g, lse, delta)) for _ in range(2))
            results.append({"kernel": kernel, "case": f"{name}: two launches equal", "dtype": str(dtype),
                            "ok": all(torch.equal(a, b) for a, b in zip(first, second))})
    # the autograd path: flash_attention(...).backward through K1, K2 and K3
    prev = set_flash_backward("pallas")
    try:
        for name, B, H, Hkv, T, S, D, pad in BWD_CASES[1:4]:
            q, k, v, g, valid = bwd_case(torch, gen, B, H, Hkv, T, S, D, pad, torch.float32, dev)
            qkv = [x.requires_grad_(True) for x in (q, k, v)]
            got = torch.autograd.grad(flash_attention(*qkv, valid), qkv, g)
            ref = torch.autograd.grad(attention_reference(*qkv, valid), qkv, g)
            err = max((a - b).abs().max().item() for a, b in zip(got, ref))
            tol = TOL["float32"] * max(1.0, max(b.abs().max().item() for b in ref))
            results.append({"kernel": "flash_attention.backward", "case": name, "dtype": "torch.float32",
                            "max_abs_err": err, "tol": tol, "ok": err <= tol})
    finally:
        set_flash_backward(prev)
    return results


#: K5 cases: (name, B, Q, H, Hkv, D, BS, MB); 256 positions per slot
VERIFY_CASES = [
    ("gpt2_verify_q1", 64, 1, 12, 12, 64, 16, 16),
    ("gpt2_verify_q2", 64, 2, 12, 12, 64, 16, 16),
    ("gpt2_verify_q5", 256, 5, 12, 12, 64, 16, 16),
    ("gpt2_chunk_q64", 4, 64, 12, 12, 64, 16, 16),
    ("mha_q100_two_row_tiles", 4, 100, 12, 12, 64, 16, 16),
    ("gqa_12_3_q5", 64, 5, 12, 3, 64, 16, 16),
    ("gqa_12_3_q64_four_row_tiles", 4, 64, 12, 3, 64, 16, 16),
    ("gqa_32_8_q3_d128", 16, 3, 32, 8, 128, 16, 16),
    # block sizes other than one k16 step
    ("gpt2_verify_q5_bs8", 64, 5, 12, 12, 64, 8, 32),
    ("gpt2_chunk_q64_bs32", 4, 64, 12, 12, 64, 32, 8),
    ("gqa_12_3_q5_bs32", 64, 5, 12, 3, 64, 32, 8),
    # the wide head dims: a GPT-J verify round, MQA at 16 : 1, a chunk append
    # over two row tiles, block sizes 8 and 32 (and 64 for the f32 body's
    # staging of a block in parts)
    ("gptj_verify_q5_d256", 64, 5, 16, 16, 256, 16, 16),
    ("d256_mqa_16_1_q5_bs8", 32, 5, 16, 1, 256, 8, 32),
    ("d256_chunk_q64_bs32", 4, 64, 16, 4, 256, 32, 8),
    ("d256_q3_bs64", 16, 3, 16, 16, 256, 64, 4),
    ("d80_gqa_32_8_q3", 32, 3, 32, 8, 80, 16, 16),
    ("d80_mqa_16_1_q64_bs8", 4, 64, 16, 1, 80, 8, 32),
]
#: K5 at Q=1 against K4 at lens + 1: (name, B, H, Hkv, D, lens of every
#: slot or None for verify_case's ragged mix)
Q1_EQUAL_CASES = [
    ("gpt2_b256", 256, 12, 12, 64, None),
    ("b1", 1, 12, 12, 64, 219),
    ("gqa_12_3", 64, 12, 3, 64, None),
    ("gqa_32_8_d128", 16, 32, 8, 128, None),
    ("gptj_d256", 64, 16, 16, 256, None),
    ("mqa_16_1_d80", 16, 16, 1, 80, None),
]


def check_paged_verify(torch, gen, dev, errs):
    """K5 against paged_verify_attention_reference on the same CUDA tensors
    over VERIFY_CASES with f32, bf16 and int8 pools (int8 under bf16
    queries); then K5 at Q=1 with lens against K4 with lens + 1, which must
    be equal bit for bit (f32, bf16, int8)."""
    from trlx_tpu_torch.ops.paged_attention import (
        paged_attention_kernel, paged_verify_attention_kernel, paged_verify_attention_reference,
    )

    results = []
    for name, B, Q, H, Hkv, D, BS, MB in VERIFY_CASES:
        for kv, quant, dtype in (("f32", False, torch.float32), ("bf16", False, torch.bfloat16),
                                 ("int8", True, torch.bfloat16)):
            case = verify_case(torch, gen, B, Q, H, Hkv, D, BS, MB, quant, dev, dtype)
            out = paged_call(paged_verify_attention_kernel, case)
            ref = paged_call(paged_verify_attention_reference, case)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[str(dtype).split(".")[-1]] * max(1.0, ref.float().abs().max().item())
            ok = err <= tol and bool(torch.isfinite(out.float()).all()) and out.shape == case["q"].shape
            results.append({"kernel": "paged_verify", "case": name, "kv": kv, "shape": list(case["q"].shape),
                            "max_abs_err": err, "tol": tol, "ok": ok})
            errs["paged_verify"] = max(errs["paged_verify"], err)
    for name, B, H, Hkv, D, lens in Q1_EQUAL_CASES:
        for kv, quant, dtype in (("f32", False, torch.float32), ("bf16", False, torch.bfloat16),
                                 ("int8", True, torch.bfloat16)):
            live = None if lens is None else torch.full((B,), lens, dtype=torch.int32, device=dev)
            case = verify_case(torch, gen, B, 1, H, Hkv, D, 16, 16, quant, dev, dtype, lens=live)
            verify = paged_call(paged_verify_attention_kernel, case)[:, 0]
            decode = paged_call(paged_attention_kernel, dict(case, q=case["q"][:, 0].contiguous(),
                                                             context_lens=case["context_lens"] + 1))
            torch.cuda.synchronize()
            results.append({"kernel": "paged_verify", "case": f"{name}: q1 == paged_decode at lens + 1", "kv": kv,
                            "max_abs_err": (verify.float() - decode.float()).abs().max().item(),
                            "ok": bool(torch.equal(verify, decode))})
    # every row of a verify round is the decode step of its own position: a
    # row's walk, masks and sums do not depend on the round's other rows
    for kv, quant, dtype in (("f32", False, torch.float32), ("bf16", False, torch.bfloat16),
                             ("int8", True, torch.bfloat16)):
        case = verify_case(torch, gen, 256, 5, 12, 12, 64, 16, 16, quant, dev, dtype)
        verify = paged_call(paged_verify_attention_kernel, case)
        rows = [paged_call(paged_attention_kernel, dict(case, q=case["q"][:, j].contiguous(),
                                                        context_lens=case["context_lens"] + j + 1))
                for j in range(5)]
        torch.cuda.synchronize()
        results.append({"kernel": "paged_verify", "case": "gpt2_verify_q5: row j == paged_decode at lens + j + 1",
                        "kv": kv, "max_abs_err": max((verify[:, j].float() - r.float()).abs().max().item()
                                                     for j, r in enumerate(rows)),
                        "ok": all(torch.equal(verify[:, j], r) for j, r in enumerate(rows))})
    return results


def check_two_launches(torch, gen, dev):
    """K1, K4 and K5 launched twice on the same inputs must give the same
    bits (no atomics; a fixed-order combine): K1 at the engine's prefill
    shape with lse, K4 at the gpt2 decode shape, K5 at the verify shape and
    a chunk append, each in every dtype its kernel serves."""
    from trlx_tpu_torch.ops.attention import flash_attention
    from trlx_tpu_torch.ops.paged_attention import paged_attention_kernel, paged_verify_attention_kernel

    results = []
    pad = [int(x) for x in torch.randint(0, 96, (16,), generator=gen, device=dev)]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, valid = flash_case(torch, gen, 16, 12, 12, 128, 64, dtype, pad, dev)
        first, second = (flash_attention(q, k, v, valid, return_lse=True) for _ in range(2))
        results.append({"kernel": "flash_fwd", "case": "gpt2_prefill: two launches equal", "dtype": str(dtype),
                        "ok": all(torch.equal(a, b) for a, b in zip(first, second))})
    pools = (("f32", False, torch.float32), ("bf16", False, torch.bfloat16), ("int8", True, torch.bfloat16))
    for kv, quant, dtype in pools:
        case = paged_case(torch, gen, B=256, H=12, Hkv=12, D=64, BS=16, MB=16, quant=quant, dev=dev, dtype=dtype)
        first, second = (paged_call(paged_attention_kernel, case) for _ in range(2))
        results.append({"kernel": "paged_decode", "case": "gpt2_decode: two launches equal", "kv": kv,
                        "ok": bool(torch.equal(first, second))})
        for name, B, Q in (("gpt2_verify_q5", 256, 5), ("gpt2_chunk_q64", 4, 64)):
            case = verify_case(torch, gen, B, Q, 12, 12, 64, 16, 16, quant, dev, dtype)
            first, second = (paged_call(paged_verify_attention_kernel, case) for _ in range(2))
            results.append({"kernel": "paged_verify", "case": f"{name}: two launches equal", "kv": kv,
                            "ok": bool(torch.equal(first, second))})
    return results


def phase_timing(ctx):
    import torch
    import torch.nn.functional as F

    from trlx_tpu_torch.ops.paged_attention import paged_attention_kernel, paged_attention_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    timings = {"flash_fwd": time_flash_fwd(torch, F, gen, dev)}
    for quant in (False, True):
        key = "paged_decode" if not quant else "paged_decode_int8"
        timings[key] = time_paged_decode(torch, gen, dev, quant)
    timings.update(time_flash_backward(torch, F, gen, dev))
    timings.update(time_paged_verify(torch, gen, dev))
    # GPT-J's head dim (D = 256, 16 heads): a prefill wave, a learner-sized
    # backward, a decode step and a verify round, beside their bounds (and the
    # library's time for K1-K3)
    d256 = {"flash_fwd": time_flash_fwd(torch, F, gen, dev, H=16, D=256, train_shapes=False),
            "paged_decode": time_paged_decode(torch, gen, dev, False, H=16, D=256)}
    d256.update(time_flash_backward_at(torch, F, gen, dev, 16, 64, 64, H=16, D=256))
    d256["paged_verify"] = time_paged_verify(torch, gen, dev, H=16, D=256, shapes=("paged_verify",))["paged_verify"]
    for name, t in timings.items():
        emit({"phase": "timing", "kernel": name, "card": ctx.get("smi"), **t})
    for name, t in d256.items():
        emit({"phase": "timing", "kernel": name, "head_dim": 256, "card": ctx.get("smi"), **t})
    ctx["timings"], ctx["timings_d256"] = timings, d256


def time_paged_decode(torch, gen, dev, quant, H=12, D=64):
    """K4 at the engine's decode step (B=256 slots, MB=16 blocks of 16,
    ragged lens) as device time per launch (:func:`graphed`), beside the
    eager time, its plain version and its bound; no PyTorch call reads K/V
    through block tables. The timed output is held against the plain one
    with the kernels phase's tolerance."""
    from trlx_tpu_torch.ops.paged_attention import paged_attention_kernel, paged_attention_reference

    case = paged_case(torch, gen, B=256, H=H, Hkv=H, D=D, BS=16, MB=16, quant=quant, dev=dev)
    out, ref = paged_call(paged_attention_kernel, case), paged_call(paged_attention_reference, case)
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= TOL["bfloat16"]:
        raise AssertionError(f"paged_decode disagrees with its plain version at D={D}: {err}")
    byts, flops = paged_bound(case)
    b_ms, b_by = bound_ms(byts, flops)
    return {
        "shape": f"B=256 H={H} D={D} BS=16 MB=16 {'int8' if quant else 'bf16'} KV, "
                 f"{int(case['context_lens'].sum())} live tokens",
        **device_and_eager_ms(torch, lambda: paged_call(paged_attention_kernel, case)),
        "plain_ms": cuda_time_ms(lambda: paged_call(paged_attention_reference, case)),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by, "bytes": byts, "flops": flops, "max_abs_err": err,
    }


#: launches captured per CUDA graph when a kernel is timed by graph replays
GRAPH_LAUNCHES = 20


def graphed(torch, fn, n=GRAPH_LAUNCHES):
    """A no-argument call that replays ``n`` calls of ``fn`` captured in one
    CUDA graph: timed with CUDA events and divided by ``n`` it is the
    device's time per launch without the host's launch overhead (the
    wrappers' Python checks and the ctypes call). ``fn`` runs once first,
    outside the capture, so builds and first-call set-up stay out of it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    torch.cuda.synchronize()
    return graph.replay


def device_and_eager_ms(torch, fn):
    """{"ms": device time per launch (graph replays, :func:`graphed`),
    "eager_ms": time per call launched eagerly through the wrapper}."""
    return {"ms": cuda_time_ms(graphed(torch, fn)) / GRAPH_LAUNCHES, "eager_ms": cuda_time_ms(fn)}


def sdpa_forward_call(torch, F, q, k, v, mask):
    """The fastest SDPA forward over the backends that serve this boolean
    mask: each backend pinned with ``sdpa_kernel`` around its call, timed
    briefly by graph replays. Returns (call, backend name, {backend: ms or
    "unsupported"})."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    probes, calls = {}, {}
    for name in SDPA_BACKENDS:
        def call(backend=getattr(SDPBackend, name)):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        try:
            call()
        except RuntimeError:
            probes[name] = "unsupported"
            continue
        calls[name] = call
        probes[name] = cuda_time_ms(graphed(torch, call)) / GRAPH_LAUNCHES
    best = min(calls, key=lambda name: probes[name])
    return calls[best], best, probes


def time_flash_fwd(torch, F, gen, dev, H=12, D=64, train_shapes=True):
    """K1 in bf16 at the engine's prefill wave (B=16, T=S=128, left-padded)
    and at the trainer's two shapes (TRAIN_FWD_CASES: scoring [32, 384] and
    the loss forward [16, 257], their PPO masks), each against the SDPA
    forward on the same boolean mask with its backend pinned to the fastest
    that serves it (:func:`sdpa_forward_call`). Kernel and SDPA are timed in
    turns (:func:`interleaved_ms`: median, min and max of 5 rounds) as
    device time per launch (:func:`graphed`); the eager time through the
    wrapper, the plain version's and the bound stand beside them. The timed
    output is held against the plain one with the kernels phase's
    tolerance. Returns the B=16 row with the other shapes under
    ``at_<name>`` (``train_shapes``: the prefill wave alone when false)."""
    from trlx_tpu_torch.ops.attention import attention_reference, flash_attention

    shapes = [("gpt2_prefill", 16, 128, None)] + [(name, B, P + R, (P, R, r_max))
                                                  for name, B, P, R, r_max in TRAIN_FWD_CASES if train_shapes]
    rows = {}
    for name, B, T, train in shapes:
        if train is None:
            pad = [int(x) for x in torch.randint(0, 96, (B,), generator=gen, device=dev)]
            q, k, v, valid = flash_case(torch, gen, B, H, H, T, D, torch.bfloat16, pad, dev)
            shape = f"B={B} H={H} T=S={T} D={D} bf16 causal, left-padded"
        else:
            q, k, v, _ = flash_case(torch, gen, B, H, H, T, D, torch.bfloat16, (), dev)
            valid = train_valid(torch, gen, B, train[0], train[1], dev, train[2])
            shape = (f"B={B} H={H} T=S={T} D={D} bf16 causal, P={train[0]} left-padded + "
                     f"R={train[1]} right-padded (responses <= {train[2]})")
        out, ref = flash_attention(q, k, v, valid), attention_reference(q, k, v, valid)
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL["bfloat16"] * max(1.0, ref.float().abs().max().item())
        if not err <= tol:  # a NaN fails here too
            raise AssertionError(f"flash_fwd disagrees with its plain version at {shape}: {err} > {tol}")
        mask = torch.ones(T, T, dtype=torch.bool, device=dev).tril()[None, None] & (valid > 0)[:, None, None, :]
        sdpa, backend, probes = sdpa_forward_call(torch, F, q, k, v, mask)
        kernel = lambda: flash_attention(q, k, v, valid)  # noqa: E731
        times = interleaved_ms(torch, {"flash_fwd": graphed(torch, kernel), "sdpa": graphed(torch, sdpa)})
        t, lib = ({key: times[n][key] / GRAPH_LAUNCHES for key in ("ms", "min", "max")}
                  for n in ("flash_fwd", "sdpa"))
        byts = (2 * B * H * T * D + 2 * B * H * T * D) * q.element_size() + B * T * 4
        b_ms, b_by = bound_ms(byts, 2 * 2 * D * visible_pairs(valid) * H)  # S and P V over the visible pairs
        rows[name] = {
            "shape": shape, "ms": t["ms"], "min_ms": t["min"], "max_ms": t["max"],
            "launches_per_timing": times["flash_fwd"]["launches"] * GRAPH_LAUNCHES, "eager_ms": cuda_time_ms(kernel),
            "plain_ms": cuda_time_ms(lambda: attention_reference(q, k, v, valid)),
            "library_ms": lib["ms"], "library_min_ms": lib["min"], "library_max_ms": lib["max"],
            "library": f"SDPA forward, boolean mask, backend {backend} pinned", "library_backend": backend,
            "library_probe_ms": probes, "library_eager_ms": cuda_time_ms(sdpa),
            "over_library": t["ms"] / lib["ms"],
            "bound_ms": b_ms, "bound_by": b_by, "bytes": byts, "flops": 2 * 2 * D * visible_pairs(valid) * H,
            "max_abs_err": err, "tol": tol,
        }
    first = rows.pop("gpt2_prefill")
    return {**first, **{f"at_{name}": row for name, row in rows.items()}}


def time_paged_verify(torch, gen, dev, H=12, D=64, shapes=None):
    """K5 at the engine's verify shape (256 slots, the pending token + 4
    drafts, MB=16 blocks of 16, bf16 and int8 KV) and at a chunk append (one
    slot, 64 tokens onto 64 already there), beside its plain version and its
    bound; no single PyTorch call computes it. The timed outputs are held
    against the plain ones with the kernels phase's tolerance. ``shapes``
    names a subset."""
    from trlx_tpu_torch.ops.paged_attention import paged_verify_attention_kernel, paged_verify_attention_reference

    timings = {}
    rows = [
        ("paged_verify", dict(B=256, Q=5, quant=False), None),
        ("paged_verify_int8", dict(B=256, Q=5, quant=True), None),
        ("paged_verify_chunk", dict(B=1, Q=64, quant=False), 64),
    ]
    for key, shp, lens in [row for row in rows if shapes is None or row[0] in shapes]:
        lens = None if lens is None else torch.full((shp["B"],), lens, dtype=torch.int32, device=dev)
        case = verify_case(torch, gen, shp["B"], shp["Q"], H, H, D, 16, 16, shp["quant"], dev, lens=lens)
        out = paged_call(paged_verify_attention_kernel, case)
        ref = paged_call(paged_verify_attention_reference, case)
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL["bfloat16"] * max(1.0, ref.float().abs().max().item())
        if not err <= tol:
            raise AssertionError(f"{key} disagrees with its plain version: {err} > {tol}")
        byts, flops = verify_bound(case)
        b_ms, b_by = bound_ms(byts, flops)
        live = int((case["context_lens"].long() + shp["Q"]).clamp(max=256).sum())
        timings[key] = {
            "shape": f"B={shp['B']} Q={shp['Q']} H={H} D={D} BS=16 MB=16 "
                     f"{'int8' if shp['quant'] else 'bf16'} KV, {live} live tokens",
            **device_and_eager_ms(torch, lambda: paged_call(paged_verify_attention_kernel, case)),
            "plain_ms": cuda_time_ms(lambda: paged_call(paged_verify_attention_reference, case)),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": byts, "flops": flops, "max_abs_err": err,
        }
    return timings


def train_valid(torch, gen, B, P, R, dev, r_max=None):
    """kv_valid of a PPO batch: prompts left-padded to P (P/2..P real
    tokens), responses right-padded to R (1..r_max real tokens; r_max
    defaults to R)."""
    p_len = torch.randint(P // 2, P + 1, (B,), generator=gen, device=dev)
    r_len = torch.randint(1, (r_max or R) + 1, (B,), generator=gen, device=dev)
    pos = torch.arange(P + R, device=dev)[None, :]
    valid = ((pos >= P - p_len[:, None]) & (pos < P)) | ((pos >= P) & (pos < P + r_len[:, None]))
    return valid.to(torch.int32).contiguous()


def visible_pairs(valid, causal=True):
    """(query, key) pairs this batch's mask lets through, summed over the
    batch: what the attention work of this data needs."""
    c = valid.long().cumsum(dim=1) if causal else valid.long().sum(dim=1, keepdim=True).expand_as(valid)
    return int(c.sum())


def time_flash_backward(torch, F, gen, dev):
    """K2 and K3, each alone, at the training shape the JAX package's gpt2
    train leg used (B=32, H=12, T=S=256, D=64, bf16, causal, a P=128 +
    R=128 batch) and at the learner microbatch the train phase runs (B=16,
    T=S=257: 128 prompt bytes + 128 sampled tokens + the eos the trainer
    appends), beside their plain versions (each recomputes P and dS as its
    kernel does), the SDPA backward (the library call computing dQ, dK and
    dV together: ``torch.autograd.grad`` of SDPA's output, its backend
    pinned) and each kernel's bound (:func:`time_flash_backward_at`)."""
    timings = time_flash_backward_at(torch, F, gen, dev, 32, 128, 128)
    learner = time_flash_backward_at(torch, F, gen, dev, TRAIN_MB, TRAIN_P, TRAIN_N + 1)
    for name in timings:
        timings[name]["at_learner_shape"] = learner[name]
    return timings


#: SDPA backends probed for the backward yardstick (torch.nn.attention.SDPBackend names)
SDPA_BACKENDS = ("CUDNN_ATTENTION", "EFFICIENT_ATTENTION", "FLASH_ATTENTION", "MATH")


def interleaved_ms(torch, fns, repeats=5, min_launches=200, min_ms=50.0):
    """CUDA-event ms per launch of each no-argument call in ``fns``, timed in
    turns (all calls once per round, ``repeats`` rounds), each timing over
    max(min_launches, enough launches for min_ms of device time). Returns
    {name: {"ms": median, "min", "max", "launches", "runs"}}."""
    per = {name: cuda_time_ms(fn, iters=20, warmup=5) for name, fn in fns.items()}
    n = {name: max(min_launches, int(min_ms / max(ms, 1e-6)) + 1) for name, ms in per.items()}
    runs = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            runs[name].append(cuda_time_ms(fn, iters=n[name], warmup=2))
    return {name: {"ms": sorted(r)[len(r) // 2], "min": min(r), "max": max(r), "launches": n[name], "runs": r}
            for name, r in runs.items()}


def sdpa_backward_call(torch, F, q, k, v, g, mask):
    """The fastest SDPA backward over the backends that serve this boolean
    mask: each backend is pinned with ``sdpa_kernel`` for its forward (the
    backward runs the node that forward recorded) and timed briefly. Returns
    (call, backend name, its grad_fn's name, {backend: ms or "unsupported"})."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    probes, calls = {}, {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        except RuntimeError:
            probes[name] = "unsupported"
            continue
        calls[name] = (lambda o=out: torch.autograd.grad(o, (qs, ks, vs), g, retain_graph=True), out.grad_fn.name())
        probes[name] = cuda_time_ms(calls[name][0])
    best = min(calls, key=lambda name: probes[name])
    return calls[best][0], best, calls[best][1], probes


def time_flash_backward_at(torch, F, gen, dev, B, P, R, H=12, D=64):
    """K2, K3 and the pinned SDPA backward at one shape, interleaved
    (:func:`interleaved_ms`: median, min and max of 5 rounds), the plain
    versions beside them; the timed outputs are held against the plain ones
    with the kernels phase's tolerance."""
    from trlx_tpu_torch.ops.attention import (
        bwd_delta, flash_attention, flash_bwd_dkv, flash_bwd_dkv_reference, flash_bwd_dq,
        flash_bwd_dq_reference,
    )

    T = P + R
    q, k, v, g, _ = bwd_case(torch, gen, B, H, H, T, T, D, (), torch.bfloat16, dev)
    valid = train_valid(torch, gen, B, P, R, dev)
    out, lse = flash_attention(q, k, v, valid, return_lse=True)
    delta = bwd_delta(q, k, v, valid, out, lse, g)
    pairs = visible_pairs(valid) * H
    elem = q.element_size()
    io = 4 * B * H * T * D * elem + 2 * B * H * T * 4  # q, k, v, dO; lse and delta
    shape = f"B={B} H={H} T=S={T} D={D} bf16 causal, P={P} left-padded + R={R} right-padded"
    mask = torch.ones(T, T, dtype=torch.bool, device=dev).tril()[None, None] & (valid > 0)[:, None, None, :]
    sdpa, backend, grad_fn, probes = sdpa_backward_call(torch, F, q, k, v, g, mask)

    kernels = {
        # dK/dV: S and dP recomputed, dV and dK produced (4 products); dQ: S, dP, dQ (3)
        "flash_bwd_dkv": (lambda: flash_bwd_dkv(q, k, v, valid, g, lse, delta),
                          lambda: flash_bwd_dkv_reference(q, k, v, valid, out, lse, g), 4, 2 * B * H * T * D * elem),
        "flash_bwd_dq": (lambda: flash_bwd_dq(q, k, v, valid, g, lse, delta),
                         lambda: flash_bwd_dq_reference(q, k, v, valid, out, lse, g), 3, B * H * T * D * elem),
    }
    checks = {}
    for name, (fn, plain, _, _) in kernels.items():
        got, ref = as_tuple(fn()), as_tuple(plain())
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)]
        tols = [TOL["bfloat16"] * max(1.0, b.float().abs().max().item()) for b in ref]
        if not all(e <= t for e, t in zip(errs, tols)):  # a NaN fails here too
            raise AssertionError(f"{name} disagrees with its plain version at {shape}: {errs} > {tols}")
        checks[name] = (max(errs), max(tols))
    times = interleaved_ms(torch, {"flash_bwd_dkv": kernels["flash_bwd_dkv"][0],
                                   "flash_bwd_dq": kernels["flash_bwd_dq"][0], "sdpa": sdpa})
    lib = times["sdpa"]
    library = {"library_ms": lib["ms"], "library_min_ms": lib["min"], "library_max_ms": lib["max"],
               "library": f"SDPA backward (dQ, dK, dV together), autograd.grad alone, backend {backend} pinned",
               "library_backend": backend, "library_grad_fn": grad_fn, "library_probe_ms": probes}
    timings = {}
    for name, (fn, plain, n_mm, out_bytes) in kernels.items():
        byts, flops = io + out_bytes, n_mm * 2 * D * pairs
        b_ms, b_by = bound_ms(byts, flops)
        t = times[name]
        timings[name] = {
            "shape": shape, "ms": t["ms"], "min_ms": t["min"], "max_ms": t["max"], "launches_per_timing": t["launches"],
            "plain_ms": cuda_time_ms(plain), **library,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": byts, "flops": flops,
            "max_abs_err": checks[name][0], "tol": checks[name][1],
        }
    # the pair's bound: five products over the visible pairs; q, k, v, dO,
    # dQ, dK, dV once each, plus lse and delta
    b_ms, b_by = bound_ms(io + 3 * B * H * T * D * elem, 5 * 2 * D * pairs)
    pair_ms = times["flash_bwd_dkv"]["ms"] + times["flash_bwd_dq"]["ms"]
    for name in kernels:
        timings[name].update(pair_bound_ms=b_ms, pair_ms=pair_ms, pair_over_library=pair_ms / lib["ms"])
    return timings


def gpt2_config(layers: int, dtype, quant: bool = False):
    """The gpt2 preset at full width, cut to ``layers``, flash prefill."""
    from trlx_tpu_torch.models.presets import PRESETS

    return PRESETS["gpt2"].replace(
        num_layers=layers, compute_dtype=dtype, param_dtype=dtype,
        attention_impl="flash", kv_cache_quant=quant,
    )


def _last_logits(trunk, prompt, generated, pos):
    """``trunk``'s f32 logits for generated position ``pos`` after the prompt
    and ``generated[:pos]``."""
    import torch

    ids = torch.tensor([list(prompt) + list(generated[:pos])], device=trunk.device)
    with torch.no_grad():
        return trunk(ids, torch.ones_like(ids))[0][0, -1].float()


def _logit_gap(trunk, prompt, generated, pos):
    """Top-2 logit gap of ``trunk`` at generated position ``pos`` (a gap far
    above float noise means the contexts differed, not a near tie)."""
    import torch

    top = torch.topk(_last_logits(trunk, prompt, generated, pos), 2).values
    return float(top[0] - top[1])


def phase_parity(ctx):
    import numpy as np
    import torch

    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.serving import GenerationClient, ServingEngine

    cfg = gpt2_config(2, torch.float32)
    state = TransformerLM(cfg).init_params(SEED).state_dict()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 40, 8)]
    outs = {}
    for device in ("cuda", "cpu"):
        eng = ServingEngine(TransformerLM(cfg), state, num_slots=4, max_seq_len=64, block_size=16,
                            gen_kwargs=dict(do_sample=False), seed=SEED, device=device)
        seqs, mask, P = GenerationClient(eng).generate_batch(prompts, 16)
        assert eng.allocator.blocks_in_use == 0
        outs[device] = (seqs, mask, P, eng)
    cu, cp = outs["cuda"], outs["cpu"]
    same = np.array_equal(cu[0], cp[0]) and np.array_equal(cu[1], cp[1])
    report = {"phase": "parity", "prompts": len(prompts), "new_tokens": 16,
              "identical": bool(same), "prefill_waves": cu[3].stats.prefill_waves}
    if not same:
        P = cu[2]
        row = int(np.nonzero((cu[0] != cp[0]).any(axis=1))[0][0])
        pos = int(np.nonzero(cu[0][row, P:] != cp[0][row, P:])[0][0])
        report.update(row=row, position=pos,
                      cpu_logit_gap=_logit_gap(cp[3].trunk, prompts[row], cp[0][row, P:], pos),
                      cuda_logit_gap=_logit_gap(cu[3].trunk, prompts[row], cp[0][row, P:], pos))
    emit(report)
    if not same:
        raise AssertionError("engine on the card diverged from the CPU engine")


#: the JAX package's serving benchmark traffic (bench.py _serving_perf)
SLOTS, PROMPT_CAP, MAX_NEW = 256, 128, 128


def serving_traffic(vocab_size: int, seed: int = SEED):
    """(prompts, budgets): 3 x SLOTS requests, each a 64-token shared prefix
    plus 1..64 own tokens, budgets spread over [MAX_NEW/4, MAX_NEW]."""
    import numpy as np

    n_req = 3 * SLOTS
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab_size, PROMPT_CAP // 2)
    prompts = [
        np.concatenate([shared, rng.integers(1, vocab_size, 1 + int(rng.integers(0, PROMPT_CAP // 2)))])
        .astype(np.int32).tolist()
        for _ in range(n_req)
    ]
    budgets = [MAX_NEW // 4 + (i * (3 * MAX_NEW // 4)) // n_req for i in range(n_req)]
    return prompts, budgets


def full_width_engine(quant: bool, state=None, num_slots=None, **knobs):
    """(engine, state): gpt2 at full width, 12 layers, bf16, flash prefill,
    random weights from SEED (or ``state``), ``num_slots`` (default SLOTS) slots; ``knobs``
    (spec_k, prefill_chunk) pass to the engine."""
    import torch

    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.serving import ServingEngine

    cfg = gpt2_config(12, torch.bfloat16, quant)
    if state is None:
        state = TransformerLM(cfg, device="cuda").init_params(SEED).state_dict()
    engine = ServingEngine(TransformerLM(cfg), state, num_slots=num_slots or SLOTS,
                           max_seq_len=PROMPT_CAP + MAX_NEW,
                           gen_kwargs=dict(do_sample=False), seed=SEED, **knobs)
    return engine, state


def phase_engine(ctx):
    import torch

    from trlx_tpu_torch.ops import _kernels

    prompts, budgets = serving_traffic(gpt2_config(12, torch.bfloat16).vocab_size)
    state = None
    seen = {}  # kernel call shapes of the main path (record_kernel_shapes)
    restore_kernels = record_kernel_shapes(seen)
    _kernels.reset_launches()
    try:
        for quant in (False, True):
            state = engine_passes(ctx, prompts, budgets, quant, state)
    finally:
        restore_kernels()
    ctx["main_path_launches"] = _kernels.launches()
    emit({"phase": "engine", "kernel_shapes": kernel_shapes(seen)})
    check_main_path_shapes(ctx, seen, "engine", ("flash_fwd", "paged_decode"))


def engine_passes(ctx, prompts, budgets, quant, state):
    """phase_engine's warm-up and measured pass of one KV layout, their
    report lines and checks; returns the weights for the next engine. The
    warm-up serves the traffic's first ``SLOTS`` requests (one wave of every
    slot; the whole traffic until PR 14, cut for the script's time limit),
    the measured pass all of it."""
    import torch

    from trlx_tpu_torch.ops import _kernels

    eng, state = full_width_engine(quant, state)
    L = eng.trunk.config.num_layers
    for label, prompts, budgets in (("warmup", prompts[:SLOTS], budgets[:SLOTS]),
                                    ("measured", prompts, budgets)):
        before = dict(_kernels.launches())
        waves0, steps0 = eng.stats.prefill_waves, eng.stats.decode_steps
        prefill0, decode0 = eng.stats.prefill_s, eng.stats.decode_s
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        uids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
        done = eng.run(uids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delivered = sum(len(done[u].generated) for u in uids)
        for u in uids:
            eng.scheduler.pop_request(u)
        waves = eng.stats.prefill_waves - waves0
        steps = eng.stats.decode_steps - steps0
        flash = _kernels.launches()["flash_fwd"] - before["flash_fwd"]
        paged = _kernels.launches()["paged_decode"] - before["paged_decode"]
        short = [u for u, n in zip(uids, budgets) if len(done[u].generated) != n]
        run = {"phase": "engine", "kv": "int8" if quant else "bf16", "pass": label,
               "card": ctx.get("smi"), "requests": len(prompts), "slots": SLOTS,
               "delivered_tokens": delivered, "wall_s": wall, "tok_s": delivered / wall,
               "decode_steps": steps, "prefill_waves": waves,
               "prefill_s": eng.stats.prefill_s - prefill0,
               "decode_s": eng.stats.decode_s - decode0,
               "flash_launches": flash, "paged_launches": paged,
               "blocks_in_use": eng.allocator.blocks_in_use,
               "prefix_cache_hit_rate": eng.allocator.stats.hit_rate,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        emit(run)
        checks = {
            "flash launches == prefill waves x layers": flash == waves * L and flash > 0,
            "paged launches == decode steps x layers": paged == steps * L and paged > 0,
            "no blocks in use at the end": eng.allocator.blocks_in_use == 0,
            "every request ran its whole budget": not short,
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"engine {run['kv']} {label}: {failed}")
    eng.allocator.check_invariants()
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return state


def tie_aware_splits(ref_trunk, prompts, generated, ref_generated):
    """Rows whose generated tokens differ from the reference's, each at its
    first split: ``logit_gap`` is ``ref_trunk``'s logit of the reference's
    token minus its logit of the other token, over the common prefix, and
    ``top_logit`` its largest logit there (None when one row merely ended
    first). ``generated`` / ``ref_generated``: one token list per prompt."""
    splits = []
    for row, (got, want) in enumerate(zip(generated, ref_generated)):
        got, want = list(got), list(want)
        if got == want:
            continue
        pos = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
        split = {"row": row, "position": pos, "lengths": [len(got), len(want)], "logit_gap": None,
                 "top_logit": None}
        if pos < min(len(got), len(want)):
            logits = _last_logits(ref_trunk, prompts[row], want, pos)
            split.update(tokens=[int(got[pos]), int(want[pos])],
                         logit_gap=float(logits[want[pos]] - logits[got[pos]]),
                         top_logit=float(logits.max()))
        splits.append(split)
    return splits


def teacher_forced_gaps(ref_trunk, prompts, generated):
    """For every generated position of every row: ``ref_trunk``'s top logit
    minus its logit of the row's own token, given the prompt and the row's
    own earlier tokens (0 where the row took the reference's greedy choice).
    Unlike :func:`tie_aware_splits` this covers each row over its whole
    length, whatever happened before."""
    import torch

    gaps = []
    for prompt, row in zip(prompts, generated):
        ids = torch.tensor([list(prompt) + list(row)], device=ref_trunk.device)
        with torch.no_grad():
            logits = ref_trunk(ids, torch.ones_like(ids))[0][0, len(prompt) - 1:len(prompt) - 1 + len(row)].float()
        chosen = logits.gather(1, torch.tensor(list(row), device=logits.device)[:, None])[:, 0]
        gaps += (logits.max(1).values - chosen).tolist()
    return gaps


def engine_forced_gaps(eng, prompts, rows):
    """Teacher-forced gaps under an engine's own numerics: ``eng``, a
    one-token engine (spec_k 0) whose prefill chunk every prompt exceeds,
    runs ``prompts`` with its greedy sampling replaced by ``rows`` (one token
    list per prompt): at every position, the engine's top logit minus its
    logit of the row's token, given the prompt and the row's earlier tokens,
    and the row's token is what the slot takes next. The paged kernels, the
    int8 KV, the chunking and the decode batch are the one-token engine's,
    so on the rows it generated itself every gap is exactly 0. Returns one
    list of gaps per row; raises if a request did not take its row."""
    import numpy as np
    import torch

    if eng.spec_k or not all(len(p) > eng.prefill_chunk > 0 for p in prompts):
        raise ValueError("engine_forced_gaps: a one-token engine whose every prompt is chunked")
    forced, gaps, order = {}, {}, []  # uid -> row; (uid, position) -> gap; slots of the chunk steps

    def pick(logits, new_counts, rows):
        """The engine's tokens for ``logits`` with each (row, slot) of
        ``rows`` forced to its request's next token, whose gap is kept."""
        out = eng._sample(logits, new_counts).clone()
        where, toks, keys = [], [], []
        for i, slot in rows:
            req = eng.scheduler.slots[slot]
            if req is None or len(req.generated) >= len(forced[req.uid]):
                continue
            where.append(i)
            toks.append(forced[req.uid][len(req.generated)])
            keys.append((req.uid, len(req.generated)))
        if where:
            w = torch.tensor(where, device=out.device)
            t = torch.tensor(toks, device=out.device, dtype=out.dtype)
            lf = logits[w].float()
            g = lf.max(1).values - lf.gather(1, t.long()[:, None])[:, 0]
            out[w] = t
            gaps.update(zip(keys, g.tolist()))
        return out

    @torch.no_grad()
    def decode_step(tok, new_counts):
        logits, _, eng.cache = eng.trunk.paged_decode(tok[:, None], eng.cache)
        live = [(s, s) for s in range(eng.num_slots) if not eng._prefilling[s]]
        return pick(logits[:, -1, :], new_counts, live)

    @torch.no_grad()
    def chunk_step(ids, cache, last_idx, new_counts):
        logits, _, _ = eng.trunk.paged_verify(ids, cache)
        last = logits[torch.arange(ids.shape[0], device=ids.device), last_idx.long()]
        slot = order.pop(0)
        req = eng.scheduler.slots[slot]
        if req.prefilled + eng.prefill_chunk < len(req.prefill_ids):
            return eng._sample(last, new_counts)  # not the final chunk: its token is unused
        return pick(last, new_counts, [(0, slot)])  # the final chunk samples the first token

    advance = eng._advance_prefill_chunks

    def advance_chunks():
        # the slots _advance_prefill_chunks steps through, in its order
        order[:] = [int(s) for s in np.nonzero(eng._prefilling)[0] if eng.scheduler.slots[int(s)] is not None]
        out = advance()
        assert not order, "engine_forced_gaps: a chunk step went unseen"
        return out

    eng._decode_step, eng._chunk_step, eng._advance_prefill_chunks = decode_step, chunk_step, advance_chunks
    try:
        uids = [eng.submit(p, len(row)) for p, row in zip(prompts, rows)]
        forced.update(zip(uids, (list(map(int, row)) for row in rows)))
        done = eng.run(uids)
    finally:
        del eng._decode_step, eng._chunk_step, eng._advance_prefill_chunks
    for u in uids:
        if list(done[u].generated) != forced[u] or any((u, i) not in gaps for i in range(len(forced[u]))):
            raise AssertionError(f"engine_forced_gaps: request {u} did not take its row")
        eng.scheduler.pop_request(u)
    return [[gaps[(u, i)] for i in range(len(forced[u]))] for u in uids]


def near_tie(split, dtype: str) -> bool:
    """A split is a near tie when the reference prefers its own token by at
    most TIE_GAP[dtype] (an absolute logit gap)."""
    return split["logit_gap"] is not None and split["logit_gap"] <= TIE_GAP[dtype]


def generated_rows(seqs, mask, P):
    """Per-row generated tokens of a ``generate_batch`` result."""
    return [list(seqs[i, P:P + int(mask[i].sum())]) for i in range(len(seqs))]


def engine_counts(engine):
    """The engine's counters (its stats without the host-clock seconds)."""
    return {k: v for k, v in vars(engine.stats).items() if not k.endswith("_s")}


#: (spec_k, prefill_chunk) settings of the spec_parity engines
SPEC_KNOBS = [(4, 0), (0, 8), (3, 5)]
#: a split is a near tie when the reference prefers its own token by at most
#: TIE_GAP logits (:func:`near_tie`): f32 / bf16
TIE_GAP = {"float32": 1e-3, "bfloat16": 2e-2}


def repetitive_prompts(vocab_size, n, seed):
    """``n`` seeded prompts of 6..60 tokens, each a random 3..12-token
    segment repeated, then 0..8 own tokens: repetition gives the n-gram
    draft something to match."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(n):
        seg = rng.integers(1, vocab_size, int(rng.integers(3, 13)))
        body = np.tile(seg, int(rng.integers(2, 5)))
        prompts.append(np.concatenate([body, rng.integers(1, vocab_size, int(rng.integers(0, 9)))])
                       .astype(np.int32)[:60])
    return prompts


def phase_spec_parity(ctx):
    """Speculative decoding and chunked prefill on the card against the CPU
    port on the same weights (gpt2 widths at 2 layers, f32, greedy, 8
    repetitive prompts x 24 tokens through 4 slots), per SPEC_KNOBS setting
    and KV layout; then a 2-step PPOTrainer rolling out through the engine.
    Tokens tie-aware; stats, experience and losses as train_parity's."""
    import torch

    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.serving import GenerationClient, ServingEngine

    cfg = gpt2_config(2, torch.float32)
    state = TransformerLM(cfg).init_params(SEED).state_dict()
    prompts = repetitive_prompts(cfg.vocab_size, 8, SEED + 7)
    failed = []
    for quant in (False, True):
        for spec_k, chunk in SPEC_KNOBS:
            runs = {}
            for device in ("cuda", "cpu"):
                eng = ServingEngine(TransformerLM(cfg.replace(kv_cache_quant=quant)), state, num_slots=4,
                                    max_seq_len=96, block_size=16, gen_kwargs=dict(do_sample=False),
                                    seed=SEED, spec_k=spec_k, prefill_chunk=chunk, device=device)
                seqs, mask, P = GenerationClient(eng).generate_batch(prompts, 24)
                runs[device] = (generated_rows(seqs, mask, P), eng)
            (cu, cu_eng), (cp, cp_eng) = runs["cuda"], runs["cpu"]
            splits = tie_aware_splits(cp_eng.trunk, prompts, cu, cp)
            s = cu_eng.summary()
            report = {"phase": "spec_parity", "kv": "int8" if quant else "f32", "spec_k": spec_k,
                      "prefill_chunk": chunk, "identical": not splits, "splits": splits,
                      "spec_rounds": s["spec_rounds"], "accepted_tok_per_round": s["accepted_tok_per_round"],
                      "spec_accept_rate": s["spec_accept_rate"], "chunk_appends": s["chunk_appends"],
                      "cpu_spec_rounds": cp_eng.stats.spec_rounds,
                      "blocks_in_use": [cu_eng.allocator.blocks_in_use, cp_eng.allocator.blocks_in_use]}
            emit(report)
            if (not all(near_tie(x, "float32") for x in splits)
                    or report["blocks_in_use"] != [0, 0]
                    or (spec_k > 0) != (s["spec_rounds"] > 0) or (chunk > 0) != (s["chunk_appends"] > 0)
                    or (not splits and engine_counts(cu_eng) != engine_counts(cp_eng))):
                failed.append(report)
    trainer_report, ok = train_parity_report(
        {"train.serving": {"enabled": True, "block_size": 16, "spec_k": 4, "prefill_chunk": 8}},
        tie_dtype="float32",
    )
    emit({"phase": "spec_parity", "trainer": "train.serving spec_k=4 prefill_chunk=8", **trainer_report})
    if not ok:
        failed.append(trainer_report)
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"speculative / chunked engine on the card disagrees with the CPU port: {failed}")


def engine_spec_pass(ctx, eng, prompts, budgets, label, L):
    """One pass of engine_spec's traffic through ``eng``, its report line and
    checks; returns the first 32 requests' generated tokens."""
    import torch

    from trlx_tpu_torch.ops import _kernels

    before = dict(_kernels.launches())
    stats0 = dict(vars(eng.stats))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    uids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    done = eng.run(uids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delivered = sum(len(done[u].generated) for u in uids)
    first = {i: list(done[u].generated) for i, u in enumerate(uids[:32])}
    for u in uids:
        eng.scheduler.pop_request(u)
    d = {k: v - stats0[k] for k, v in vars(eng.stats).items()}
    launched = {k: _kernels.launches()[k] - before[k] for k in before}
    short = [u for u, n in zip(uids, budgets) if len(done[u].generated) != n]
    run = {"phase": "engine_spec", "kv": "int8", "pass": label, "card": ctx.get("smi"),
           "requests": len(prompts), "slots": SLOTS, "spec_k": 4, "prefill_chunk": PROMPT_CAP // 2,
           "delivered_tokens": delivered, "wall_s": wall, "tok_s": delivered / wall,
           "decode_rounds": d["decode_steps"], "prefill_waves": d["prefill_waves"],
           "chunk_appends": d["chunk_appends"],
           "accepted_tok_per_round": d["delivered_tokens"] / max(1, d["decode_slot_rounds"]),
           "spec_accept_rate": d["spec_accepted_tokens"] / max(1, d["spec_draft_tokens"]),
           "prefill_s": d["prefill_s"], "decode_s": d["decode_s"],
           "flash_launches": launched["flash_fwd"], "verify_launches": launched["paged_verify"],
           "decode_launches": launched["paged_decode"],
           "blocks_in_use": eng.allocator.blocks_in_use,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(run)
    checks = {
        "K5 launches == (verify rounds + chunk appends) x layers":
            launched["paged_verify"] == (d["spec_rounds"] + d["chunk_appends"]) * L and d["spec_rounds"] > 0,
        "K1 launches == prefill waves x layers": launched["flash_fwd"] == d["prefill_waves"] * L > 0,
        "K4 never launched": launched["paged_decode"] == 0,
        "chunked prefill ran": d["chunk_appends"] > 0,
        "no blocks in use at the end": eng.allocator.blocks_in_use == 0,
        "every request ran its whole budget": not short,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"engine_spec {label}: {failed}")
    return first


#: requests of engine_spec's pass: the first two slot-fulls of the traffic
#: (all 768 before the script's time limit forced the cut)
ES_REQUESTS = 2 * SLOTS


def phase_engine_spec(ctx):
    """A main path: the engine at full gpt2 width, int8 KV, spec_k=4 and
    prefill_chunk=64, under the JAX package's spec-leg traffic (bench.py
    ``_serving_perf``: the first ES_REQUESTS of its 768 requests of a
    64-token shared prefix plus 1..64 own tokens, every budget 128, greedy),
    one measured pass.
    Launch counts are reset just before and read just after: K5 on every
    verify round and chunk append, K1 on every prefill wave, K4 never. Then
    every kernel call shape of the pass against the plain versions
    (:func:`check_main_path_shapes`), and the first 32 requests against the
    one-token engine (spec_k 0, the same prefill_chunk) on the same weights,
    tie-aware (that engine with this one's slots, running the first SLOTS
    requests, so the two share the first admission wave and the batch
    size): this isolates the speculative rounds, and the CPU tests hold
    chunked against unchunked output exactly in f32. Each of those rows is
    also held over its whole length, teacher-forced through the one-token
    engine itself (:func:`engine_forced_gaps`: its kernels, int8 KV and
    chunking): at every position it may prefer another token by at most
    2e-2, and on its own rows it must prefer its own token at every
    position. A split's gap is the same engine's preference at the split.
    The dense model's teacher-forced gaps (no int8 KV) are reported beside,
    for the speculative and the one-token rows."""
    import torch

    from trlx_tpu_torch.ops import _kernels

    prompts, _ = serving_traffic(gpt2_config(12, torch.bfloat16).vocab_size)
    prompts = prompts[:ES_REQUESTS]
    budgets = [MAX_NEW] * len(prompts)
    eng, state = full_width_engine(True, spec_k=4, prefill_chunk=PROMPT_CAP // 2)
    L = eng.trunk.config.num_layers
    first = {}
    seen = {}  # kernel call shapes of the main path (record_kernel_shapes)
    restore_kernels = record_kernel_shapes(seen)
    _kernels.reset_launches()
    try:
        first = engine_spec_pass(ctx, eng, prompts, budgets, "measured", L)
    finally:
        restore_kernels()
    ctx["spec_path_launches"] = _kernels.launches()
    emit({"phase": "engine_spec", "kernel_shapes": kernel_shapes(seen)})
    eng.allocator.check_invariants()
    eng.close()
    del eng
    torch.cuda.empty_cache()
    check_main_path_shapes(ctx, seen, "engine_spec", ("flash_fwd", "paged_verify"))

    n = len(first)
    ref, _ = full_width_engine(True, state, prefill_chunk=PROMPT_CAP // 2)
    report, failures = hold_against_one_token(ref, prompts[:SLOTS], [first[i] for i in range(n)], MAX_NEW,
                                              "bfloat16")
    emit({"phase": "engine_spec", "check": f"first {n} requests vs the one-token engine, tie-aware",
          "one_token_engine": f"{SLOTS} slots, the first {SLOTS} requests", **report})
    ref.allocator.check_invariants()
    ref.close()
    del ref
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"engine_spec: {failures}")


def hold_against_one_token(ref, prompts, got, budget, dtype):
    """engine_spec's tie-aware check of the speculative engine's rows ``got``
    (``budget`` tokens each), those of the first ``len(got)`` of
    ``prompts``, against ``ref``: a one-token engine (spec_k 0) on the same
    weights, whose prefill chunk every prompt exceeds, with the speculative
    engine's slots, so that running all of ``prompts`` it admits them in the
    same first wave and decodes them in a batch of the same size: the two
    engines then differ in the speculative rounds only. ``ref`` generates
    the rows itself, then is teacher-forced onto its own rows (every gap
    must be 0: the arbiter reproduces the engine) and onto ``got`` in place
    of its first rows (:func:`engine_forced_gaps`). A split from ``ref``'s
    row must be a near tie under ``ref``'s own logits at the split, and
    every position of ``got`` at most TIE_GAP[dtype] below ``ref``'s greedy
    choice. The dense model's teacher-forced gaps (no int8 KV) are reported,
    not held. Returns (report, failures)."""
    n = len(got)
    uids = [ref.submit(p, budget) for p in prompts]
    done = ref.run(uids)
    want = [list(done[u].generated) for u in uids]
    for u in uids:
        ref.scheduler.pop_request(u)
    own = engine_forced_gaps(ref, prompts, want)
    forced = engine_forced_gaps(ref, prompts, list(got) + want[n:])[:n]
    prompts, want = prompts[:n], want[:n]
    splits = tie_aware_splits(ref.trunk, prompts, got, want)
    for x in splits:  # the one-token engine's own preference at the split (the common prefix)
        x["dense_logit_gap"] = x["logit_gap"]
        if x["logit_gap"] is not None:
            x["logit_gap"] = forced[x["row"]][x["position"]]
    gaps = [g for row in forced for g in row]
    limit = TIE_GAP[dtype]

    def over(g):
        return {"positions": len(g), "not_greedy": sum(x > 0 for x in g), "over_limit": sum(x > limit for x in g),
                "max_gap": max(g)}

    own_max = max(abs(g) for row in own for g in row)
    report = {"whole_row_matches": len(got) - len(splits),
              # tokens held against the one-token engine: whole rows, and each split row up to its split
              "tokens_compared": sum(map(len, got)) - sum(len(got[x["row"]]) - x["position"] for x in splits),
              "tokens": sum(map(len, got)),
              "splits": splits, "near_ties": sum(near_tie(x, dtype) for x in splits),
              "teacher_forced": {"arbiter": "the one-token engine", **over(gaps), "limit": limit,
                                 "own_rows_max_abs_gap": own_max},
              "dense_model_teacher_forced": {
                  "speculative_rows": over(teacher_forced_gaps(ref.trunk, prompts, got)),
                  "one_token_rows": over(teacher_forced_gaps(ref.trunk, prompts, want))}}
    failures = []
    if own_max != 0:
        failures.append(f"the forced one-token engine does not reproduce its own rows (gap {own_max})")
    bad = [x for x in splits if not near_tie(x, dtype)]
    if bad:
        failures.append(f"spec output split from the one-token engine off a tie: {bad}")
    if not max(gaps) <= limit:  # a NaN fails here too
        failures.append(f"a speculative token is {max(gaps)} below the greedy choice (> {limit})")
    return report, failures


# ------------------------------------------------------------------ training


def byte_prompts(n, lo, hi, seed):
    """``n`` seeded prompts of lo..hi bytes over lowercase letters and spaces."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz    ", dtype=np.uint8)
    return [bytes(rng.choice(letters, int(rng.integers(lo, hi + 1)))).decode() for _ in range(n)]


def byte_share_reward(samples, prompts, outputs, **_):
    """Deterministic host reward: the share of the byte 'e' in each output."""
    return [o.count("e") / max(1, len(o)) for o in outputs]


def ppo_config(**train_over):
    """The port's PPO config for the training phases (``train_over`` merged
    in dotted form)."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    base = default_ppo_config()
    base.model.num_layers_unfrozen = -1
    return TRLConfig.update(base, train_over)


def with_optimizer(cfg, name, kwargs):
    """``cfg`` with its optimizer block replaced by ``name`` and ``kwargs``
    (``TRLConfig.update`` would merge the kwargs into the old ones)."""
    from trlx_tpu_torch.data.configs import TRLConfig

    d = cfg.to_dict()
    d["optimizer"] = dict(name=name, kwargs=dict(kwargs))
    return TRLConfig.from_dict(d)


def parity_trainer(device, state=None, optimizer=None, **over):
    """PPOTrainer at 2 layers / hidden 64 (4 heads of 16), f32, greedy, on
    ``device``; ``state`` replaces the seeded initial weights; ``over``
    merges more dotted config overrides; ``optimizer`` = (name, kwargs)
    replaces the optimizer block (:func:`with_optimizer`)."""
    import tempfile

    from trlx_tpu_torch.models.policy import branch_param_subtree
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = ppo_config(**over, **{
        "model.model_path": "gpt2",
        "model.model_overrides": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4,
                                      max_position_embeddings=128, attention_impl="flash"),
        "mesh.compute_dtype": "float32", "mesh.param_dtype": "float32",
        "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": 64, "train.batch_size": 8, "train.minibatch_size": 4, "train.total_steps": 2,
        "train.tracker": None, "train.checkpoint_dir": tempfile.mkdtemp(prefix="chip_smoke_parity_"),
        "train.seed": SEED,
        "method.num_rollouts": 16, "method.chunk_size": 8, "method.ppo_epochs": 1,
        "method.gen_kwargs": dict(max_new_tokens=16, do_sample=False),
        "optimizer.kwargs": dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6),
        "scheduler.kwargs": dict(T_max=10, eta_min=1e-4),
    })
    if optimizer is not None:
        cfg = with_optimizer(cfg, *optimizer)
    trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=byte_share_reward, device=device)
    if state is not None:
        trainer.model.load_state_dict(state)
        trunk = trainer.model.transformer.state_dict()
        if trainer.frozen_branch is not None:
            trainer.frozen_branch.load_state_dict(
                branch_param_subtree(trunk, trainer.branch_start, trainer.model_config))
        elif trainer.ref_model is not None:
            trainer.ref_model.load_state_dict(trunk)
        elif trainer._ref_host is not None:  # offload_ref: the host copy
            trainer._setup_ref_offload(trunk)
        # peft: the reference is the trunk itself, adapters disabled
    prompts = PromptPipeline(byte_prompts(16, 8, 40, SEED + 3), 48, trainer.tokenizer)
    trainer.add_prompt_pipeline(prompts)
    return trainer


def phase_train_parity(ctx):
    """PPOTrainer on the card against PPOTrainer on the CPU from the same
    weights: one experience phase of 16 rollouts and 2 optimizer steps.
    Tokens identical; logprobs / values / rewards within 1e-4; every step's
    losses/* within 1e-3 relative (+1e-6 absolute: the policy loss of the
    first step is ~0 by construction)."""
    report, ok = train_parity_report({})
    emit({"phase": "train_parity", **report})
    if not ok:
        raise AssertionError(f"PPOTrainer on the card disagrees with the CPU trainer: {report}")


def phase_hydra_parity(ctx):
    """Hydra PPO on the card against the CPU from the same weights, with the
    train_parity trainer and limits: ``num_layers_unfrozen=1`` (the frozen
    branch is layer 1, the final norm and the tied head) and
    ``num_value_layers_unfrozen=1``; one experience phase, 2 steps."""
    report, ok = train_parity_report({"model.num_layers_unfrozen": 1, "method.num_value_layers_unfrozen": 1})
    emit({"phase": "hydra_parity", **report})
    if not ok:
        raise AssertionError(f"hydra PPOTrainer on the card disagrees with the CPU trainer: {report}")


def train_parity_report(over, tie_dtype=None, optimizer=None, state_fn=None):
    """(report, ok) of parity_trainer (with ``over``) on the card against the
    CPU: prepare_learning (one experience phase), then 2 optimizer steps.
    Tokens must be identical — or, with ``tie_dtype``, may split at a near
    tie (:func:`near_tie` under the CPU policy). Experience (logprobs,
    values, rewards) within 1e-4 for every element whose query and response
    tokens are identical (``elements_compared``); losses/* within 1e-3
    relative + 1e-6 when every token is identical (after a split the two
    learners train on different batches: ``losses_compared`` false). Also:
    no blocks left in a serving engine. ``state_fn`` edits the shared
    initial weights (after the x3)."""
    import shutil

    import numpy as np
    import torch

    cpu = parity_trainer("cpu", optimizer=optimizer, **over)
    # sharper logits than the 0.02 init, so greedy ties are far above float noise
    state = {k: v * 3 if v.is_floating_point() else v for k, v in cpu.model.state_dict().items()}
    if state_fn is not None:
        state = state_fn(state)
    cpu = parity_trainer("cpu", state, optimizer=optimizer, **over)
    card = parity_trainer("cuda", state, optimizer=optimizer, **over)
    runs, blocks = {}, []
    for name, tr in (("cuda", card), ("cpu", cpu)):
        tr.prepare_learning()
        steps = [tr.train_step(batch) for batch in list(tr.create_train_dataloader())[:2]]
        runs[name] = (list(tr.store.history), steps)
        if tr._serving_engine is not None:
            blocks.append(tr._serving_engine.allocator.blocks_in_use)
            tr.on_learn_end()
        shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    (ce, cs), (pe, ps) = runs["cuda"], runs["cpu"]
    same_elem = [np.array_equal(a.query_tensor, b.query_tensor) and np.array_equal(a.response_tensor, b.response_tensor)
                 for a, b in zip(ce, pe)] if len(ce) == len(pe) else []
    same_tokens = bool(same_elem) and all(same_elem)
    report = {"elements": len(ce), "steps": len(cs), "identical_tokens": same_tokens,
              "serving_blocks_in_use": blocks, "elements_compared": sum(same_elem), "losses_compared": same_tokens}
    ok = same_tokens and not any(blocks)
    if not same_tokens and tie_dtype is not None:
        splits = tie_aware_splits(cpu.model.transformer, [e.query_tensor for e in pe],
                                  [e.response_tensor for e in ce], [e.response_tensor for e in pe])
        report.update(splits=splits)
        ok = bool(same_elem) and all(near_tie(x, tie_dtype) for x in splits) and not any(blocks)
    elif not same_tokens:
        row = next(i for i, (a, b) in enumerate(zip(ce, pe))
                   if not np.array_equal(a.response_tensor, b.response_tensor))
        a, b = ce[row].response_tensor, pe[row].response_tensor
        pos = int(np.nonzero(a[:len(b)] != b[:len(a)])[0][0]) if (a[:len(b)] != b[:len(a)]).any() else min(len(a), len(b))
        report.update(row=row, position=pos,
                      cpu_logit_gap=_logit_gap(cpu.model.transformer, pe[row].query_tensor, b, pos),
                      cuda_logit_gap=_logit_gap(card.model.transformer, pe[row].query_tensor, b, pos))
    elem_errs = [
        float(np.abs(getattr(a, f) - getattr(b, f)).max()) for (a, b), same in zip(zip(ce, pe), same_elem) if same
        for f in ("logprobs", "values", "rewards")
    ]
    if elem_errs:
        report.update(max_element_abs_err=max(elem_errs))
        ok = ok and all(e <= 1e-4 for e in elem_errs)  # a NaN fails here
    if same_tokens:
        loss_err = max(
            abs(x[k] - y[k]) / max(abs(y[k]), 1e-3) for x, y in zip(cs, ps) for k in y if k.startswith("losses/")
        )
        loss_ok = all(
            abs(x[k] - y[k]) <= 1e-3 * abs(y[k]) + 1e-6 for x, y in zip(cs, ps) for k in y if k.startswith("losses/")
        )
        report.update(max_loss_rel_err=loss_err,
                      losses_cuda=[{k: v for k, v in x.items() if k.startswith("losses/")} for x in cs],
                      losses_cpu=[{k: v for k, v in y.items() if k.startswith("losses/")} for y in ps])
        ok = ok and loss_ok and len(cs) == 2
    del card, cpu
    torch.cuda.empty_cache()
    return report, ok


#: the full-width train phase's shape (bench.py's gpt2 train leg: B=32, P=N=128)
TRAIN_B, TRAIN_P, TRAIN_N, TRAIN_MB = 32, 128, 128, 16
#: the train phase's stop sequences: its rollouts go through the data plane's stop scan
TRAIN_STOPS = ["e ", "zz"]


def full_width_train_config(ckpt_dir):
    """The train phase's config: the gpt2 preset at full width with flash
    attention, bf16 compute, f32 params, the bytes tokenizer, 64 rollouts of
    TRAIN_N sampled tokens per experience phase, 4 steps of TRAIN_B rollouts
    in TRAIN_B / TRAIN_MB microbatches."""
    return ppo_config(**{
        "model.model_path": "gpt2", "model.model_overrides": {"attention_impl": "flash"},
        "mesh.compute_dtype": "bfloat16", "mesh.param_dtype": "float32",
        "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": TRAIN_P + TRAIN_N, "train.batch_size": TRAIN_B,
        "train.minibatch_size": TRAIN_MB, "train.total_steps": 4, "train.eval_interval": 100,
        "train.checkpoint_interval": 100, "train.save_best": False, "train.save_optimizer": False,
        "train.tracker": None, "train.checkpoint_dir": ckpt_dir, "train.seed": SEED,
        "method.num_rollouts": 64, "method.chunk_size": TRAIN_B, "method.ppo_epochs": 1,
        "method.gen_kwargs": dict(max_new_tokens=TRAIN_N, do_sample=True, top_k=0, top_p=1.0),
    })


def phase_train(ctx):
    """The main training path at full gpt2-small width: trlx_tpu_torch.train
    with 12 layers, hidden 768, vocab 50257, random weights from the seed,
    bf16 compute, f32 params and AdamW state, flash attention, a full-copy
    reference (``num_layers_unfrozen=-1``); 64 rollouts of 128 sampled
    tokens per experience phase, 4 optimizer steps of 32 rollouts in 2
    microbatches, stop sequences on. Every prefill and scoring forward must
    have launched K1 once per layer and model, and every learner step K1, K2
    and K3 once per layer and microbatch (:func:`ppo_main_path`). Every call
    of the host data plane the run makes (prompt padding, collates, stop
    scans) is recorded for phase ``analysis`` (:func:`an_data_plane`)."""
    import tempfile

    from trlx_tpu_torch import native

    L, num_mb = 12, TRAIN_B // TRAIN_MB
    seen, restore = record_data_plane()
    native.reset_calls()
    try:
        ctx["train_summary"], ctx["train_launches"] = ppo_main_path(
            ctx, "train", full_width_train_config(tempfile.mkdtemp(prefix="chip_smoke_train_")),
            {"loss_fwd": L * num_mb, "bwd": L * num_mb, "prefill": L, "score": 2 * L},
            train_kwargs=dict(reward_fn=byte_share_reward, prompts=byte_prompts(64, 64, 128, SEED + 1),
                              eval_prompts=byte_prompts(32, 64, 128, SEED + 2), stop_sequences=TRAIN_STOPS))
    finally:
        restore()
    ctx["train_data_plane"] = {"seen": seen, "calls": native.calls()}


def record_data_plane():
    """Wrap the host data plane where the main path calls it (the collate,
    the prompt padding, the stop scan) so that every call's inputs and
    output are kept. Returns ({function: [(args, kwargs, out)]}, the
    function that restores the call sites)."""
    from trlx_tpu_torch.ops import generation
    from trlx_tpu_torch.pipeline import ppo_pipeline
    from trlx_tpu_torch.trainer import mesh_trainer

    seen = {"pad_collate_i32": [], "pad_collate_f32": [], "find_stop_positions": []}
    sites = [(ppo_pipeline, "pad_collate_i32"), (ppo_pipeline, "pad_collate_f32"), (generation, "pad_collate_i32"),
             (mesh_trainer, "find_stop_positions")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in sites]

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen[name].append((args, kwargs, out))
            return out
        return wrapped

    for mod, name, fn in saved:
        setattr(mod, name, recorder(name, fn))

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return seen, restore


def phase_hydra(ctx):
    """A main path: hydra PPO, ``default_ppo_config()`` as it stands
    (``num_layers_unfrozen=2``) with ``num_value_layers_unfrozen=1``, on the
    train phase's model (the gpt2 preset at full width, bf16 compute, f32
    params, the bytes tokenizer) and traffic (64 rollouts of 128 sampled
    tokens, 4 steps of 32 in 2 microbatches). The reference is the frozen
    branch: scoring runs the policy's 12 layers, the value block and the
    branch's 2 layers (K1 15 times); a learner step runs K1 in the 12 trunk
    layers and the value block and K2/K3 only in the 2 trained layers and
    the value block, per microbatch. The 10 lower layers, the embeddings,
    the final norm and the frozen branch must be ``torch.equal`` before and
    after, the trained layers and the value branch must move. Step, scoring
    and memory figures are printed beside the train phase's (full copy)."""
    import tempfile

    from trlx_tpu_torch.data.configs import TRLConfig

    L, num_mb, n_unfrozen = 12, TRAIN_B // TRAIN_MB, 2
    cfg = TRLConfig.update(full_width_train_config(tempfile.mkdtemp(prefix="chip_smoke_hydra_")), {
        "model.num_layers_unfrozen": n_unfrozen, "method.num_value_layers_unfrozen": 1})
    summary, ctx["hydra_launches"] = ppo_main_path(
        ctx, "hydra", cfg,
        {"loss_fwd": (L + 1) * num_mb, "bwd": (n_unfrozen + 1) * num_mb, "prefill": L,
         "score": L + 1 + n_unfrozen})
    full = ctx.get("train_summary") or {}
    emit({"phase": "hydra", "check": "beside the train phase (full-copy reference)", "card": ctx.get("smi"),
          **{f"{k}_{who}": d.get(k) for k in ("score_s", "learn_s", "peak_mem_gib", "peak_over_start_gib")
             for who, d in (("hydra", summary), ("full_copy", full))}})


#: GPT-J at its published width (the ``gptj`` preset: vocab 50,400, hidden
#: 4,096, 16 heads of 256, gptj rotary over 64 dims, parallel residual, an
#: untied head with a bias), depth cut from 28 layers to GPTJ_LAYERS, random
#: init from the seed; the traffic of examples/hh/ppo_hh.py, the reference's
#: HH setting: its four prompts x 8, seq_length 96, batch 16, chunk 16, 32
#: rollouts of up to 32 new tokens, its stop sequences, hydra with 2 unfrozen
#: layers
GPTJ_LAYERS = 4
HH_PROMPTS = [
    "Human: How do I bake bread? Assistant:",
    "Human: What is a good way to learn piano? Assistant:",
    "Human: My laptop is slow, what can I do? Assistant:",
    "Human: How can I sleep better? Assistant:",
]
HH_STOPS = ["Human:", "human:"]


def gptj_config(ckpt_dir, compute="bfloat16", greedy=False, plain=False, serving=None):
    """The gptj phase's config (``plain``: every attention through its plain
    version, the serving engine's paged attention too)."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    return TRLConfig.update(default_ppo_config(), {
        "model.model_path": "gptj", "model.num_layers_unfrozen": 2,
        "model.model_overrides": {"num_layers": GPTJ_LAYERS, "attention_impl": "xla" if plain else "flash"},
        "mesh.compute_dtype": compute, "mesh.param_dtype": "float32",
        "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": 96, "train.batch_size": 16, "train.total_steps": 2, "train.eval_interval": 100,
        "train.checkpoint_interval": 100, "train.save_best": False, "train.save_optimizer": False,
        "train.tracker": None, "train.checkpoint_dir": ckpt_dir, "train.seed": SEED,
        "train.serving": {"enabled": True, "block_size": 16, "attention_impl": "xla" if plain else "auto",
                          **(serving or {})},
        "method.chunk_size": 16, "method.num_rollouts": 32, "method.init_kl_coef": 0.05, "method.target": 6.0,
        "method.gen_kwargs": dict(max_new_tokens=32, top_k=0, top_p=1.0, do_sample=not greedy),
    })


def phase_gptj(ctx):
    """A main path at GPT-J's width: hydra PPO through ``trlx_tpu_torch.train``
    on the ``gptj`` preset cut to GPTJ_LAYERS layers, HH traffic, rollouts
    through the serving engine (block 16), so K1-K5 run at D = 256. Every
    run is :func:`ppo_main_path`'s: exact launch counts per layer, learner
    step, scoring call, prefill wave and engine round, no KV block left,
    the lower layers and the frozen branch bit-identical, every recorded
    kernel shape held against its plain version afterwards; the trainer's
    final checkpoint (4.9 GB) is noted but not written.

    (a) bf16 compute, f32 parameters, flash attention, sampled: 2 steps over
    bf16 pools (K1 prefill, K4 decode, K2/K3), then 2 over int8 pools with
    spec_k 4 (K5 verify rounds and chunk appends), with finite losses.

    (b) f32 compute, greedy, spec_k 4 over f32 pools: once through the
    kernels and once through the plain versions (``attention_impl="xla"``,
    the engine's ``attention_impl="xla"``, ``TRLX_FLASH_BWD=xla``) from the
    same initial weights (``torch.equal``): the plain run launches nothing;
    tokens identical but at near ties (the plain model prefers its token by
    <= 1e-3, ``spec_parity``'s limit), the experience of every identical
    element within 1e-4, and with every token identical ``losses/*`` within
    1e-3 relative (+1e-6), the trainer-parity limits."""
    import tempfile

    import numpy as np
    import torch

    from trlx_tpu_torch.ops import attention as attn

    L, n_unfrozen = GPTJ_LAYERS, 2

    def run(label, kinds, keep=None, init=None, plain=False, **kw):
        cfg = gptj_config(tempfile.mkdtemp(prefix="chip_smoke_gptj_"), plain=plain, **kw)
        assert cfg.model.num_layers_unfrozen == n_unfrozen and not cfg.method.num_value_layers_unfrozen
        num_mb = cfg.train.batch_size // (cfg.train.minibatch_size or cfg.train.batch_size)
        n = 0 if plain else 1
        expect = {"loss_fwd": n * L * num_mb, "bwd": n * n_unfrozen * num_mb, "prefill": n * L,
                  "score": n * (L + n_unfrozen), "paged": n * L, "steps": 2}
        return ppo_main_path(ctx, f"gptj ({label})", cfg, expect, kinds=kinds, init=init, keep=keep,
                             checkpoint=False, train_kwargs=dict(
                                 reward_fn=byte_share_reward, prompts=HH_PROMPTS * 8, eval_prompts=HH_PROMPTS,
                                 stop_sequences=HH_STOPS))

    flash = ("flash_fwd", "flash_bwd")
    a, a_launches = run("bf16_pools", flash + ("paged_decode",), serving={"kv_cache_quant": False})
    b, b_launches = run("int8_pools_spec4", flash + ("paged_verify",), serving={"kv_cache_quant": True, "spec_k": 4})
    checks = {
        "(a) every rollout through the engine": bool(a["engine_generations"] and b["engine_generations"]),
        "(a) K4 over bf16 pools": a_launches["paged_decode"] > 0 and a_launches["paged_verify"] == 0,
        "(a) K5 over int8 pools with spec_k 4": b_launches["paged_verify"] > 0,
        "(a) losses finite": a["losses_finite"] and b["losses_finite"],
    }

    greedy = dict(compute="float32", greedy=True, serving={"spec_k": 4})
    kern, plain = {}, {}
    k, k_launches = run("f32_kernels", flash + ("paged_verify",), keep=kern, **greedy)
    prev = attn.set_flash_backward("xla")
    try:
        p, _ = run("f32_plain", (), keep=plain, init=kern["init"], plain=True, **greedy)
    finally:
        attn.set_flash_backward(prev)
    ke, pe = kern["store"], plain["store"]
    same_elem = [np.array_equal(x.query_tensor, y.query_tensor) and np.array_equal(x.response_tensor, y.response_tensor)
                 for x, y in zip(ke, pe)] if len(ke) == len(pe) else []
    same_tokens = bool(same_elem) and all(same_elem)
    parity = {"elements": len(ke), "identical_tokens": same_tokens, "elements_compared": sum(same_elem)}
    splits_ok = same_tokens
    if not same_tokens and same_elem:
        # the arbiter: the plain run's trunk at the initial weights its rollouts came from
        ref = gptj_reference_trunk(kern["init"], plain["model_config"])
        splits = tie_aware_splits(ref, [y.query_tensor for y in pe], [x.response_tensor for x in ke],
                                  [y.response_tensor for y in pe])
        del ref
        parity["splits"] = splits
        splits_ok = all(near_tie(x, "float32") for x in splits)
    kern.clear()
    torch.cuda.empty_cache()
    elem_errs = [float(np.abs(getattr(x, f) - getattr(y, f)).max()) for (x, y), same in zip(zip(ke, pe), same_elem)
                 if same for f in ("logprobs", "values", "rewards")]
    parity["max_element_abs_err"] = max(elem_errs) if elem_errs else None
    loss_ok = True
    if same_tokens:
        pairs = [(x[key], y[key]) for x, y in zip(k["step_stats"], p["step_stats"]) for key in y
                 if key.startswith("losses/")]
        parity["max_loss_rel_err"] = max(abs(x - y) / max(abs(y), 1e-3) for x, y in pairs)
        loss_ok = all(abs(x - y) <= 1e-3 * abs(y) + 1e-6 for x, y in pairs)
    emit({"phase": "gptj", "check": "(b) kernels against the plain versions, f32 greedy", **parity})
    checks.update({
        "(b) every rollout through the engine": bool(k["engine_generations"] and p["engine_generations"]),
        "(b) tokens identical but at near ties (<= 1e-3)": bool(same_elem) and splits_ok,
        "(b) experience within 1e-4": bool(elem_errs) and all(e <= 1e-4 for e in elem_errs),
        "(b) losses within 1e-3 relative": loss_ok,
    })
    runs = {"bf16_pools": a, "int8_pools_spec4": b, "f32_kernels": k, "f32_plain": p}
    ctx["gptj_launches"] = {name: a_launches[name] + b_launches[name] + k_launches[name] for name in a_launches}
    emit({"phase": "gptj", "card": ctx.get("smi"), "launches": ctx["gptj_launches"],
          "step_s": {label: r["learn_s"] for label, r in runs.items()},
          "peak_mem_gib": {label: r["peak_mem_gib"] for label, r in runs.items()},
          "peak_over_start_gib": {label: r["peak_over_start_gib"] for label, r in runs.items()},
          "checks": checks})
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"gptj phase: {failed}")


def gptj_reference_trunk(state0, config):
    """A trunk of ``config`` (the plain run's: f32, plain attention) on the
    card holding the policy trunk of ``state0``: the arbiter of a token split
    in the gptj phase's leg (b)."""
    from trlx_tpu_torch.models.transformer import TransformerLM

    trunk = TransformerLM(config.replace(attention_impl="xla"), device="cuda")
    trunk.load_state_dict({k[len("transformer."):]: v for k, v in state0.items() if k.startswith("transformer.")})
    return trunk.eval()


def ppo_main_path(ctx, phase, cfg, expect, train_kwargs=None, kinds=("flash_fwd", "flash_bwd"), init=None,
                  keep=None, checkpoint=True):
    """Drive ``trlx_tpu_torch.train`` (PPO, or GRPO: ``train_kwargs``
    replaces the default ``reward_fn`` and prompts) with ``cfg`` on the card once:
    launch counts reset just before and read just after; per learner step
    K1 ``expect["loss_fwd"]`` times and K2, K3 ``expect["bwd"]`` times, K1
    ``expect["prefill"]`` times per generate and ``expect["score"]`` times
    per scoring call, and nothing outside them; ``expect.get("steps", 4)``
    optimizer steps. Through the serving engine (``train.serving``) K1 runs
    ``expect["prefill"]`` times per prefill wave, K4 ``expect["paged"]``
    times per plain decode round and K5 as often per verify round and chunk
    append (the engine's own counts), and no KV block stays in use after a
    generation. The run records each kernel call's shape and the first mask
    of each shape; afterwards every shape is held against the plain versions
    (:func:`check_main_path_shapes`; ``kinds`` must each have been
    recorded, none for a plain run). With ``model.num_layers_unfrozen = N >
    0`` the trunk's lower layers, embeddings and final norm and the frozen
    branch must be bit-identical after the run, and every trainable tensor
    but the seed-init value head must have moved. ``init``: the initial
    weights (policy, and ``frozen_branch.``-prefixed branch) the run must
    start from, ``torch.equal``. ``keep``, where given, receives the run's
    experience (``store``), its initial weights (``init``) and its
    ``model_config``. ``checkpoint=False`` notes the trainer's final
    checkpoint but does not write it. Returns (summary, launches)."""
    import shutil

    import numpy as np
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    ckpt_dir = cfg.train.checkpoint_dir
    calls = []  # (kind, seconds, launch deltas, train_step stats or engine counts, [B, T] of the call)
    store, saves = [], []
    originals = {name: getattr(PPOTrainer, name) for name in (
        "generate", "_serving_generate", "score", "train_step", "prepare_learning", "push_to_store",
        "_save_checkpoint")}
    engine_keys = ("prefill_waves", "decode_steps", "spec_rounds", "chunk_appends")

    def call_shape(name, arg):
        if name == "train_step":  # the collated batch; its microbatches share its T
            return [len(arg.query_tensors), arg.query_tensors.shape[1] + arg.response_tensors.shape[1]]
        if name == "score":
            return list(arg.shape)
        return [len(arg)]

    def wrap(name):
        fn = originals[name]

        def timed(self, *a, **kw):
            before = dict(_kernels.launches())
            counts = self._serving_engine.summary() if name == "_serving_generate" else None
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            delta = {k: _kernels.launches()[k] - before[k] for k in before}
            if name == "_serving_generate":  # the engine's rounds in this call, and its blocks after it
                after = self._serving_engine.summary()
                info = {**{k: int(after[k] - counts[k]) for k in engine_keys},
                        "blocks_in_use": self._serving_engine.allocator.blocks_in_use}
            else:
                info = out if name == "train_step" else None
            calls.append((name, seconds, delta, info, call_shape(name, a[0])))
            return out

        return timed

    seen = {}  # kernel call shape -> calls and the first mask (record_kernel_shapes)
    params0, branch0 = {}, {}

    def snapshot_init(self, *a, **kw):
        if not params0:
            params0.update({k: v.detach().clone() for k, v in self.model.state_dict().items()})
            if self.frozen_branch is not None:
                branch0.update({k: v.detach().clone() for k, v in self.frozen_branch.state_dict().items()})
        return originals["prepare_learning"](self, *a, **kw)

    def push_to_store(self, data):
        store.extend(data)
        return originals["push_to_store"](self, data)

    for name in ("generate", "_serving_generate", "score", "train_step"):
        setattr(PPOTrainer, name, wrap(name))
    PPOTrainer.prepare_learning = snapshot_init
    if keep is not None:
        PPOTrainer.push_to_store = push_to_store
    if not checkpoint:
        PPOTrainer._save_checkpoint = lambda self, directory, block=False: saves.append(os.path.basename(directory))
    restore_kernels = record_kernel_shapes(seen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()  # what earlier phases still hold
    _kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(config=cfg, **(train_kwargs or dict(
            reward_fn=byte_share_reward, prompts=byte_prompts(64, 64, 128, SEED + 1),
            eval_prompts=byte_prompts(32, 64, 128, SEED + 2))))
    finally:
        for name, fn in originals.items():
            setattr(PPOTrainer, name, fn)
        restore_kernels()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launches()
    peak = torch.cuda.max_memory_allocated()

    steps = [(sec, d, out, shp) for kind, sec, d, out, shp in calls if kind == "train_step"]
    gens = [(sec, d, shp) for kind, sec, d, _, shp in calls if kind == "generate"]
    serves = [(sec, d, eng) for kind, sec, d, eng, _ in calls if kind == "_serving_generate"]
    scores = [(sec, d, shp) for kind, sec, d, _, shp in calls if kind == "score"]
    # learner tokens: the padded positions the step computes, B x (P + R)
    for i, (sec, d, out, shp) in enumerate(steps):
        emit({"phase": phase, "step": i + 1, "card": ctx.get("smi"), "learn_s": sec,
              "batch_shape": shp, "learner_tok_s": shp[0] * shp[1] / sec,
              "losses": {k: v for k, v in out.items() if k.startswith("losses/")},
              "group": {k: v for k, v in out.items() if k.startswith("group/")},
              "rollout_s": {k: out[k] for k in ("time/rollout_generate", "time/rollout_reward",
                                                "time/rollout_score", "time/rollout_time")},
              "launches": d})
    state = trainer.model.state_dict()
    n_unfrozen, n_steps = cfg.model.num_layers_unfrozen, expect.get("steps", 4)
    frozen = [k for k in state if not any(p.data_ptr() == state[k].data_ptr() for p in trainer.trainable_params)]
    moved = [k for k in state if k not in frozen and not torch.equal(params0[k], state[k])]
    finite = all(np.isfinite(v) for _, _, out, _ in steps for k, v in out.items() if k.startswith("losses/"))
    summary = {
        "phase": phase, "card": ctx.get("smi"), "wall_s": wall, "steps": len(steps),
        "num_layers_unfrozen": n_unfrozen, "reference": "hydra branch" if trainer.frozen_branch is not None
        else "full copy",
        "generate_calls": len(gens), "generate_s": [g[0] for g in gens],
        "engine_generations": [{"s": sec, **eng} for sec, _, eng in serves],
        "score_calls": len(scores), "score_s": [c[0] for c in scores], "score_shapes": [c[2] for c in scores],
        "learn_s": [st[0] for st in steps], "learn_batch_shapes": [st[3] for st in steps],
        "learner_tok_s_mean": sum(st[3][0] * st[3][1] for st in steps) / max(sum(st[0] for st in steps), 1e-9),
        "peak_mem_gib": peak / 2 ** 30, "peak_over_start_gib": (peak - start_mem) / 2 ** 30,
        "launches": launches, "frozen_tensors": len(frozen), "trained_tensors_moved": len(moved),
        "losses_finite": finite, "kernel_shapes": kernel_shapes(seen), "checkpoints_skipped": saves,
        "step_stats": [{k: v for k, v in out.items() if k.split("/")[0] in ("losses", "group", "time")}
                       for _, _, out, _ in steps],
    }
    emit(summary)
    paged = expect.get("paged", 0)
    checks = {
        f"{n_steps} optimizer steps": len(steps) == n_steps,
        "losses finite": finite,
        "params changed": bool(moved),
        "K2 and K3 per step": all(
            d["flash_bwd_dkv"] == expect["bwd"] and d["flash_bwd_dq"] == expect["bwd"] for _, d, _, _ in steps),
        "K1 on every loss forward": all(d["flash_fwd"] == expect["loss_fwd"] for _, d, _, _ in steps),
        "K1 on every prefill": bool(gens or serves) and all(d["flash_fwd"] == expect["prefill"] for _, d, _ in gens)
        and all(d["flash_fwd"] == expect["prefill"] * eng["prefill_waves"] for _, d, eng in serves),
        "K1 on every scoring forward (policy + reference)": bool(scores) and all(
            d["flash_fwd"] == expect["score"] for _, d, _ in scores),
        "no kernel outside generate / score / train_step": all(
            launches[k] == sum(c[2][k] for c in calls) for k in launches),
    }
    if serves:
        checks.update({
            "K4 on every plain decode round, K5 on every verify round and chunk append": all(
                d["paged_decode"] == paged * (eng["decode_steps"] - eng["spec_rounds"])
                and d["paged_verify"] == paged * (eng["spec_rounds"] + eng["chunk_appends"]) for _, d, eng in serves),
            "no KV block left after any generation": not any(eng["blocks_in_use"] for _, _, eng in serves),
        })
    start = {**params0, **{f"frozen_branch.{k}": v for k, v in branch0.items()}}
    if init is not None:
        checks["the same initial weights"] = init.keys() == start.keys() and all(
            torch.equal(init[k], v) for k, v in start.items())
    if n_unfrozen > 0:
        L = trainer.model_config.num_layers
        lower = [k for k in state if k.startswith("transformer.") and not any(
            k.startswith(f"transformer.layers_{i}.") for i in range(L - n_unfrozen, L))]
        checks.update({
            "frozen: exactly the lower layers, embeddings and final norm": sorted(frozen) == sorted(lower),
            "lower layers, embeddings, final norm bit-identical": all(torch.equal(params0[k], state[k])
                                                                     for k in lower),
            "frozen branch bit-identical": bool(branch0) and all(
                torch.equal(branch0[k], v) for k, v in trainer.frozen_branch.state_dict().items()),
            "the trained top layers left the frozen branch": not torch.equal(
                state[f"transformer.layers_{L - 1}.attn.q_proj.kernel"],
                trainer.frozen_branch.state_dict()[f"layers_{L - 1}.attn.q_proj.kernel"]),
        })
    failed = [k for k, ok in checks.items() if not ok]
    emit({"phase": phase, "checks": checks})
    if keep is not None:
        keep.update(store=store, init=start, model_config=trainer.model_config)
    del trainer, state, start, params0, branch0
    gc.collect()  # a trainer's cycles hold its parameters and optimizer state
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{phase} phase: {failed}")
    if kinds:
        check_main_path_shapes(ctx, seen, phase, kinds)
    return summary, launches


def phase_train_serving(ctx):
    """A main path: the train phase's run (gpt2 full width, 64 sampled
    rollouts of 128 tokens per experience phase, 4 steps of 32 in 2
    microbatches) with ``train.serving`` on: block size 16, spec_k 4,
    prefill_chunk 64, so every rollout goes through the engine's verify
    rounds and chunk appends (K5) and its prefill waves (K1). Launch counts
    are reset just before ``train`` and read just after; K5 must have
    launched in every experience phase and K4 never, K2 and K3 once per
    layer and microbatch in every step, and the engine must hold no block
    after every generation. Every kernel call shape of the run is recorded
    and afterwards held against the plain versions
    (:func:`check_main_path_shapes`)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_serving_")
    cfg = TRLConfig.update(full_width_train_config(ckpt_dir), {
        "train.serving": {"enabled": True, "block_size": 16, "spec_k": 4, "prefill_chunk": 64}})
    num_mb = TRAIN_B // TRAIN_MB
    phases, gens, steps = [], [], []  # experience phases, generate calls, learner steps
    originals = {name: getattr(PPOTrainer, name)
                 for name in ("make_experience", "_serving_generate", "train_step", "prepare_learning")}
    params0 = {}

    def measured(name, sink, extra=lambda self, out: {}):
        fn = originals[name]

        def run(self, *a, **kw):
            before = dict(_kernels.launches())
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            sink.append({"s": time.perf_counter() - t0,
                         "launches": {k: _kernels.launches()[k] - before[k] for k in before},
                         **extra(self, out)})
            return out

        return run

    def prepare(self, *a, **kw):
        params0.update({k: v.detach().clone() for k, v in self.model.state_dict().items()})
        return originals["prepare_learning"](self, *a, **kw)

    PPOTrainer.make_experience = measured("make_experience", phases, lambda self, out: {
        "generate_s": self._phase_time["generate"], "score_s": self._phase_time["score"],
        "reward_s": self._phase_time["reward"]})
    PPOTrainer._serving_generate = measured("_serving_generate", gens, lambda self, out: {
        "blocks_in_use": self._serving_engine.allocator.blocks_in_use,
        "summary": self._serving_engine.summary()})
    PPOTrainer.train_step = measured("train_step", steps, lambda self, out: {"stats": out})
    PPOTrainer.prepare_learning = prepare
    seen = {}  # kernel call shapes of the main path (record_kernel_shapes)
    restore_kernels = record_kernel_shapes(seen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(
            reward_fn=byte_share_reward, prompts=byte_prompts(64, 64, 128, SEED + 1),
            eval_prompts=byte_prompts(32, 64, 128, SEED + 2), config=cfg,
        )
    finally:
        for name, fn in originals.items():
            setattr(PPOTrainer, name, fn)
        restore_kernels()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launches()
    ctx["serving_train_launches"] = launches

    for i, ph in enumerate(phases):
        emit({"phase": "train_serving", "experience_phase": i + 1, "card": ctx.get("smi"),
              "experience_s": ph["s"], "generate_s": ph["generate_s"], "score_s": ph["score_s"],
              "reward_s": ph["reward_s"], "launches": ph["launches"]})
    for i, st in enumerate(steps):
        out = st["stats"]
        emit({"phase": "train_serving", "step": i + 1, "card": ctx.get("smi"), "learn_s": st["s"],
              "experience_s": out["time/rollout_time"], "generate_s": out["time/rollout_generate"],
              "accepted_tok_per_round": out.get("serving/accepted_tok_per_round"),
              "spec_accept_rate": out.get("serving/spec_accept_rate"),
              "losses": {k: v for k, v in out.items() if k.startswith("losses/")},
              "launches": st["launches"]})
    L = trainer.model_config.num_layers
    changed = any(not torch.equal(params0[k], v) for k, v in trainer.model.state_dict().items())
    finite = all(np.isfinite(v) for st in steps for k, v in st["stats"].items() if k.startswith("losses/"))
    emit({"phase": "train_serving", "card": ctx.get("smi"), "wall_s": wall, "steps": len(steps),
          "experience_phases": len(phases), "generate_calls": len(gens),
          "generate_s": [g["s"] for g in gens], "engine_after_each_generate": [
              {k: g["summary"][k] for k in ("accepted_tok_per_round", "spec_accept_rate", "spec_rounds",
                                            "chunk_appends", "delivered_tokens", "blocks_in_use")} for g in gens],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": launches,
          "params_changed": changed, "losses_finite": finite, "kernel_shapes": kernel_shapes(seen)})
    checks = {
        "4 optimizer steps": len(steps) == 4,
        "losses finite": finite,
        "params changed": changed,
        "rollouts went through the engine": bool(gens) and len(gens) == 2 * len(phases),
        "K5 launched in every experience phase": bool(phases) and all(
            ph["launches"]["paged_verify"] > 0 for ph in phases),
        "K4 never launched": launches["paged_decode"] == 0,
        "no blocks in use after every generation": all(g["blocks_in_use"] == 0 for g in gens),
        "K2 and K3: num_layers x num_mb per step": all(
            st["launches"]["flash_bwd_dkv"] == L * num_mb and st["launches"]["flash_bwd_dq"] == L * num_mb
            for st in steps),
        "serving gauges in the step stats": all("serving/accepted_tok_per_round" in st["stats"] for st in steps),
    }
    failed = [k for k, ok in checks.items() if not ok]
    del trainer
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"train_serving phase: {failed}")
    check_main_path_shapes(ctx, seen, "train_serving", ("flash_fwd", "flash_bwd", "paged_verify"))


#: the sft phase: 255 seeded byte dialogues (so the last batch of the epoch
#: has 31 rows: padded to 32, one fully masked row), seq_length 256, batch 32
#: in 2 microbatches of 16, 8 steps (one epoch)
SFT_N, SFT_SEQ, SFT_B, SFT_MB, SFT_STEPS = 255, 256, 32, 16, 8


def byte_dialogues(n, seed):
    """``n`` seeded (prompt, output) byte dialogues: prompts of 32..128
    bytes, outputs of 64..128 bytes."""
    return [[p, o] for p, o in zip(byte_prompts(n, 32, 128, seed), byte_prompts(n, 64, 128, seed + 1))]


def full_width_sft_config(ckpt_dir):
    """The sft phase's config: the gpt2 preset at full width with flash
    attention, bf16 compute, f32 params and AdamW, the bytes tokenizer."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_sft_config

    return TRLConfig.update(default_sft_config(), {
        "model.model_path": "gpt2", "model.model_overrides": {"attention_impl": "flash"},
        "mesh.compute_dtype": "bfloat16", "mesh.param_dtype": "float32",
        "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": SFT_SEQ, "train.batch_size": SFT_B, "train.minibatch_size": SFT_MB,
        "train.total_steps": SFT_STEPS, "train.eval_interval": 100, "train.checkpoint_interval": 100,
        "train.save_best": False, "train.save_optimizer": False, "train.tracker": None,
        "train.checkpoint_dir": ckpt_dir, "train.seed": SEED,
        "optimizer.kwargs": dict(lr=1e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6),
    })


def phase_sft(ctx):
    """A main path: ``trlx_tpu_torch.train(samples=...)`` at full gpt2-small
    width (12 layers, hidden 768, vocab 50257, random weights from the seed,
    bf16 compute, f32 params and AdamW, flash attention, the bytes
    tokenizer): 255 byte dialogues, 8 steps of 32 rows in 2 microbatches of
    16 at T = 256, the last batch padded to 32 rows with a fully masked one.
    Launch counts reset just before and read just after: every step must
    launch K1, K2 and K3 once per layer and microbatch, every eval prefill
    K1 once per layer, and nothing else; every recorded shape (with its
    first mask and its first fully masked row) is held against the plain
    versions. Then the HF-format export: a fresh ``load_pretrained`` of the
    directory gives logits ``torch.equal`` to the trained trunk's (f32
    compute), and a ``PPOTrainer`` from ``model_path`` = the directory (the
    train phase's config) holds the exported weights bit for bit in its
    trunk and reference and takes 2 learner steps with finite losses."""
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.models.hf_loading import load_pretrained
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_sft_")
    num_mb = SFT_B // SFT_MB
    calls = []  # (kind, seconds, launch deltas, train_step stats, rows, real tokens)
    originals = {name: getattr(SFTTrainer, name) for name in ("generate", "train_step")}

    def wrap(name):
        fn = originals[name]

        def timed(self, batch, *a, **kw):
            before = dict(_kernels.launches())
            # known on the host: this step pads rows up to num_mb with fully masked ones
            padded_step[0] = name == "train_step" and len(batch["input_ids"]) % num_mb != 0
            t0 = time.perf_counter()
            out = fn(self, batch, *a, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            padded_step[0] = False
            delta = {k: _kernels.launches()[k] - before[k] for k in before}
            if name == "train_step":
                calls.append((name, seconds, delta, out, len(batch["input_ids"]), int(batch["attention_mask"].sum())))
            else:
                calls.append((name, seconds, delta, None, len(batch), 0))
            return out

        return timed

    seen, padded_step = {}, [False]
    for name in originals:
        setattr(SFTTrainer, name, wrap(name))
    restore_kernels = record_kernel_shapes(seen, dead_rows=lambda: padded_step[0])
    samples = byte_dialogues(SFT_N, SEED + 11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()  # what earlier phases still hold
    _kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(samples=samples, config=full_width_sft_config(ckpt_dir))
    finally:
        for name, fn in originals.items():
            setattr(SFTTrainer, name, fn)
        restore_kernels()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pick_dead_rows(seen)
    launches = _kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    L, dev = trainer.model_config.num_layers, trainer.device
    steps = [c for c in calls if c[0] == "train_step"]
    gens = [c for c in calls if c[0] == "generate"]
    losses = [c[3]["losses/loss"] for c in steps]
    step_s = [c[1] for c in steps]
    summary = {
        "phase": "sft", "card": ctx.get("smi"), "wall_s": wall, "steps": len(steps),
        "step_s": step_s, "step_s_median": statistics.median(step_s) if step_s else None,
        "rows": [c[4] for c in steps], "real_tokens": [c[5] for c in steps],
        "learner_real_tok_s": sum(c[5] for c in steps) / max(sum(step_s), 1e-9),
        "learner_real_tok_s_median_step": statistics.median(c[5] / c[1] for c in steps) if steps else None,
        "losses": losses, "peak_mem_gib": peak / 2 ** 30, "peak_over_start_gib": (peak - start_mem) / 2 ** 30,
        "launches": launches,
        "launches_per_step": [c[2] for c in steps], "eval_generate_calls": len(gens),
        "kernel_shapes": kernel_shapes(seen),
    }
    emit(summary)
    checks = {
        f"{SFT_STEPS} optimizer steps": len(steps) == SFT_STEPS,
        "a batch not a multiple of num_mb": any(c[4] % num_mb for c in steps),
        "losses finite": bool(losses) and all(np.isfinite(x) for x in losses),
        "K1, K2 and K3: num_layers x num_mb per step": all(
            c[2]["flash_fwd"] == L * num_mb and c[2]["flash_bwd_dkv"] == L * num_mb
            and c[2]["flash_bwd_dq"] == L * num_mb for c in steps),
        "K1 on every eval prefill": bool(gens) and all(c[2]["flash_fwd"] == L for c in gens),
        "no kernel outside generate / train_step": all(
            launches[k] == sum(c[2][k] for c in calls) for k in launches),
        "a fully masked row reached K1 and K2/K3": any(
            "kv_valid_dead_row" in e for key, e in seen.items() if key[0] == "flash_fwd") and any(
            "kv_valid_dead_row" in e for key, e in seen.items() if key[0] == "flash_bwd"),
    }
    failed = [k for k, ok in checks.items() if not ok]
    ctx["sft_launches"] = launches
    if failed:
        raise AssertionError(f"sft phase: {failed}")
    check_main_path_shapes(ctx, seen, "sft", ("flash_fwd", "flash_bwd"))

    # export, reload, PPO from the export
    export = os.path.join(ckpt_dir, "export")
    try:
        t0 = time.perf_counter()
        trainer.save_pretrained(export)
        save_s = time.perf_counter() - t0
        trained = trainer.model.transformer
        f32 = {"compute_dtype": torch.float32, "attention_impl": "flash"}
        config, state, model_type = load_pretrained(export, f32)
        with torch.device(dev):
            fresh, again = TransformerLM(config), TransformerLM(trained.config.replace(compute_dtype=torch.float32))
        fresh.load_state_dict(state)
        again.load_state_dict(trained.state_dict())
        gen = torch.Generator().manual_seed(SEED + 12)
        ids = torch.randint(3, 259, (4, 64), generator=gen).to(dev)
        mask = torch.ones_like(ids, dtype=torch.int32)
        mask[1, 40:] = 0
        with torch.no_grad():
            equal_logits = torch.equal(fresh(ids, mask)[0], again(ids, mask)[0])
        del fresh, again, trainer

        ppo_cfg = full_width_train_config(os.path.join(ckpt_dir, "ppo"))
        ppo_cfg.model.model_path = export
        ppo = PPOTrainer(config=ppo_cfg, reward_fn=byte_share_reward)
        ppo.add_prompt_pipeline(PromptPipeline(byte_prompts(64, 64, 128, SEED + 1), TRAIN_P, ppo.tokenizer))
        bit_identical = all(
            torch.equal(ppo.model.transformer.state_dict()[k].cpu(), v)
            and torch.equal(ppo.ref_model.state_dict()[k].cpu(), v) for k, v in state.items())
        t0 = time.perf_counter()
        ppo.prepare_learning()
        ppo_stats = [ppo.train_step(b) for b in list(ppo.create_train_dataloader())[:2]]
        torch.cuda.synchronize()
        ppo_s = time.perf_counter() - t0
        ppo_losses = [{k: v for k, v in st.items() if k.startswith("losses/")} for st in ppo_stats]
        ppo_finite = len(ppo_stats) == 2 and all(np.isfinite(v) for st in ppo_losses for v in st.values())
        del ppo
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    report = {"phase": "sft", "check": "export, reload, PPO from the export", "model_type": model_type,
              "save_s": save_s, "reload_logits_equal": equal_logits,
              "ppo_weights_bit_identical": bit_identical, "ppo_losses": ppo_losses, "ppo_s": ppo_s,
              "ok": equal_logits and bit_identical and ppo_finite}
    emit(report)
    if not report["ok"]:
        raise AssertionError(f"sft phase: export / reload / PPO from the export failed: {report}")


#: the CPU test's tiny SFT config (tests/test_torch_sft.py), its samples and seed
SFT_PARITY_ALPHABET = "abcdefgh "
SFT_PARITY_SAMPLES = [
    ["ab", "cd ef"], "hhh a", ["gh", "a b c"], "bad cafe", ["e", "fg ab"], "dead beef", ["a", "bb"],
]


def sft_parity_trainer(device, state=None):
    """SFTTrainer at 2 layers / hidden 32 (2 heads of 16), f32, flash
    attention, char tokenizer, batch 4 in 2 microbatches, on ``device``;
    ``state`` replaces the seeded initial trunk."""
    import tempfile

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.from_dict(dict(
        method=dict(name="SFTConfig", gen_kwargs=dict(max_new_tokens=4, do_sample=False)),
        train=dict(seq_length=12, epochs=4, total_steps=3, batch_size=4, minibatch_size=2,
                   checkpoint_interval=100, eval_interval=100,
                   checkpoint_dir=tempfile.mkdtemp(prefix="chip_smoke_sft_parity_"), pipeline="PromptPipeline",
                   trainer="SFTTrainer", tracker=None, seed=3, save_best=False),
        model=dict(model_path="gpt2", num_layers_unfrozen=-1, model_overrides=dict(
            vocab_size=len(SFT_PARITY_ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64, attention_impl="flash")),
        tokenizer=dict(tokenizer_path=f"char://{SFT_PARITY_ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4, max_grad_norm=1.0)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    ))
    trainer = get_trainer("SFTTrainer")(config=cfg, device=device)
    if state is not None:
        trainer.model.transformer.load_state_dict(state)
    return trainer


def phase_sft_parity(ctx):
    """SFTTrainer on the card against SFTTrainer on the CPU from the same
    weights (the tiny f32 config of the CPU test): 3 optimizer steps, one
    of them on a 3-row batch padded to 4 with a fully masked row; every
    step's ``losses/loss`` within 1e-3 relative (PERF.md's trainer-parity
    tolerance)."""
    import shutil

    import torch

    cpu = sft_parity_trainer("cpu")
    card = sft_parity_trainer("cuda", cpu.model.transformer.state_dict())
    runs = {}
    for name, tr in (("cuda", card), ("cpu", cpu)):
        tr.make_experience(SFT_PARITY_SAMPLES, tr.config.train.seq_length)
        tr.prepare_learning()
        stats, rows = [], []
        while len(stats) < 3:
            for batch in tr.create_train_dataloader():
                rows.append(len(batch["input_ids"]))
                stats.append(tr.train_step(batch))
                if len(stats) == 3:
                    break
        runs[name] = ([s["losses/loss"] for s in stats], rows)
        shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    (lc, rc), (lp, rp) = runs["cuda"], runs["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(lc, lp)]
    report = {"phase": "sft_parity", "losses_cuda": lc, "losses_cpu": lp, "rows": rc, "max_rel_err": max(rel),
              "tol": 1e-3, "ok": rc == rp and 3 in rc and len(lc) == 3 and all(r <= 1e-3 for r in rel)}
    emit(report)
    del card, cpu
    torch.cuda.empty_cache()
    if not report["ok"]:
        raise AssertionError(f"SFTTrainer on the card disagrees with the CPU trainer: {report}")


#: the PPO gates' last step: the gate reads the eval at step 100, which a run
#: to step 100 still makes (its final eval); 120 until PR 14 cut the 20
#: steps past the gate for the script's time limit
GATE_PPO_STEPS = 100


def phase_randomwalks(ctx):
    """The North star's gate run by the port alone
    (``scripts/torch_ppo_randomwalks.py``): the randomwalks example's recipe
    on the card, f32 — 300 SFT steps at lr 1e-3 on the sampled walks,
    ``save_pretrained``, then PPO from the exported directory to step
    ``GATE_PPO_STEPS`` (100).
    The eval ``reward/mean`` at the first eval at or after step 100 must be
    >= 0.7. Prints the whole eval curve beside the JAX package's recorded
    one, the SFT stage's final loss and the seconds."""
    import tempfile

    import torch

    from scripts.torch_ppo_randomwalks import run_gate

    # the SFT export is kept for randomwalks_hydra, whose recipe has the same SFT stage
    export = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_walks_"), "sft_model")
    t0 = time.perf_counter()
    report = run_gate(pretrain_steps=300, ppo_steps=GATE_PPO_STEPS, export_to=export)
    ctx["randomwalks_export"] = export
    torch.cuda.synchronize()
    emit({"phase": "randomwalks", "card": ctx.get("smi"), "seconds": time.perf_counter() - t0, **report})
    torch.cuda.empty_cache()
    if not report["ok"]:
        raise AssertionError(f"randomwalks phase: eval reward/mean below the bar: {report['gate_eval']}")


def phase_randomwalks_hydra(ctx):
    """The hydra gate (``scripts/torch_ppo_randomwalks.py
    --num-layers-unfrozen 2``): the randomwalks phase's recipe with the PPO
    stage as hydra PPO (the top 2 layers train, the reference is the frozen
    branch); eval ``reward/mean`` >= 0.7 at the first eval at or after step
    100. The JAX package's recorded hydra run reached 0.943 within 120
    steps. The SFT stage is the randomwalks phase's when that phase ran
    (the same recipe and seed), else its own."""
    import torch

    from scripts.torch_ppo_randomwalks import run_gate

    t0 = time.perf_counter()
    report = run_gate(pretrain_steps=300, ppo_steps=GATE_PPO_STEPS, num_layers_unfrozen=2,
                      warm_start=ctx.get("randomwalks_export"))
    torch.cuda.synchronize()
    emit({"phase": "randomwalks_hydra", "card": ctx.get("smi"), "seconds": time.perf_counter() - t0, **report})
    torch.cuda.empty_cache()
    if not report["ok"] or report["reference"] != "hydra branch":
        raise AssertionError(f"randomwalks_hydra phase: below the bar: {report['gate_eval']}")


def phase_randomwalks_ilql(ctx):
    """The ILQL gate (``scripts/torch_ilql_randomwalks.py``): the ILQL
    randomwalks example's config with eval decoding at top_k=1, its whole
    budget of 1000 steps; eval optimality >= 0.6 at the final eval (the
    JAX package's CPU runs of five seeds: 0.654-0.795 at step 992)."""
    import torch

    from scripts.torch_ilql_randomwalks import run_gate

    t0 = time.perf_counter()
    report = run_gate(steps=1000)
    torch.cuda.synchronize()
    emit({"phase": "randomwalks_ilql", "card": ctx.get("smi"), "seconds": time.perf_counter() - t0, **report})
    torch.cuda.empty_cache()
    if not report["ok"]:
        raise AssertionError(f"randomwalks_ilql phase: below the bar: {report['gate_eval']}")


def phase_randomwalks_rft(ctx):
    """The RFT gate (``scripts/torch_rft_randomwalks.py``): 300 SFT steps on
    the walks, export, 100 RFT steps (32 sampled generations per prompt, the
    top percentile band kept); the final eval ``reward/mean`` >= 0.9 and no
    lower than the run's step 0 (the JAX package's CPU run at this cut
    ended at 1.0)."""
    import torch

    from scripts.torch_rft_randomwalks import run_gate

    t0 = time.perf_counter()
    report = run_gate(pretrain_steps=300, rft_steps=100)
    torch.cuda.synchronize()
    emit({"phase": "randomwalks_rft", "card": ctx.get("smi"), "seconds": time.perf_counter() - t0, **report})
    torch.cuda.empty_cache()
    if not report["ok"]:
        raise AssertionError(f"randomwalks_rft phase: below the bar: {report['gate_eval']}")


#: the ilql phase: 512 seeded byte samples of 64..192 bytes with seeded
#: rewards, seq_length 256, 8 steps of 32 in 2 microbatches of 16, a target
#: sync every 4 steps
ILQL_N, ILQL_SEQ, ILQL_B, ILQL_MB, ILQL_STEPS, ILQL_SYNC = 512, 256, 32, 16, 8, 4


def full_width_ilql_config(ckpt_dir):
    """The ilql phase's config: ``default_ilql_config()`` on the gpt2 preset
    at full width with flash attention, bf16 compute, f32 params and AdamW,
    the bytes tokenizer; eval decoding with beta 4 and top_k 20."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_ilql_config

    return TRLConfig.update(default_ilql_config(), {
        "model.model_path": "gpt2", "model.model_overrides": {"attention_impl": "flash"},
        "mesh.compute_dtype": "bfloat16", "mesh.param_dtype": "float32",
        "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": ILQL_SEQ, "train.batch_size": ILQL_B, "train.minibatch_size": ILQL_MB,
        "train.total_steps": ILQL_STEPS, "train.eval_interval": 100, "train.checkpoint_interval": 100,
        "train.save_best": False, "train.save_optimizer": False, "train.tracker": None,
        "train.checkpoint_dir": ckpt_dir, "train.seed": SEED,
        "method.steps_for_target_q_sync": ILQL_SYNC,
        "method.gen_kwargs": dict(max_new_tokens=32, top_k=20, beta=4.0, temperature=1.0),
    })


def phase_ilql(ctx):
    """A main path: ``trlx_tpu_torch.train(samples=..., rewards=...)`` (ILQL)
    at full gpt2-small width (bf16 compute, f32 params and AdamW, flash
    attention, the bytes tokenizer): 512 seeded byte samples with seeded
    rewards, 8 steps of 32 rows in 2 microbatches at T = 256, and the eval
    generation (32 prompts, 32 tokens, beta 4 through the target-Q
    processor, top_k 20) at steps 0 and 8. Launch counts reset just before
    and read just after: every step must launch K1, K2 and K3 once per layer
    and microbatch, every eval prefill K1 once per layer, nothing else;
    every recorded shape is held against the plain versions. The target Q
    heads must change at the syncs (steps 4 and 8) alone, each time to
    ``alpha * q + (1 - alpha) * target``; the losses must be finite."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ilql_")
    cfg = full_width_ilql_config(ckpt_dir)
    num_mb = ILQL_B // ILQL_MB
    calls, syncs = [], []  # (kind, seconds, launch deltas, stats); (step, changed, max |err| vs Polyak)
    originals = {name: getattr(ILQLTrainer, name) for name in ("generate", "train_step", "post_backward_callback")}

    def wrap(name):
        fn = originals[name]

        def timed(self, *a, **kw):
            before = dict(_kernels.launches())
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            calls.append((name, time.perf_counter() - t0, {k: _kernels.launches()[k] - before[k] for k in before},
                          out if name == "train_step" else None))
            return out

        return timed

    def sync_checked(self):
        heads = self.model.ilql_heads
        q = [t.detach().clone() for h in heads.q_heads for t in h.parameters()]
        before = [t.detach().clone() for h in heads.target_q_heads for t in h.parameters()]
        originals["post_backward_callback"](self)
        after = [t.detach() for h in heads.target_q_heads for t in h.parameters()]
        changed = any(not torch.equal(a, b) for a, b in zip(after, before))
        a = self.method.alpha
        err = max(float((x - (a * qi + (1.0 - a) * b)).abs().max()) for x, qi, b in zip(after, q, before)) \
            if changed else None
        syncs.append((self.iter_count, changed, err))

    ILQLTrainer.generate, ILQLTrainer.train_step = wrap("generate"), wrap("train_step")
    ILQLTrainer.post_backward_callback = sync_checked
    seen = {}
    restore_kernels = record_kernel_shapes(seen)
    rng = np.random.default_rng(SEED + 21)
    samples = byte_prompts(ILQL_N, 64, 192, SEED + 20)
    rewards = rng.normal(size=ILQL_N).tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(samples=samples, rewards=rewards,
                                       eval_prompts=byte_prompts(ILQL_B, 16, 64, SEED + 22), config=cfg)
    finally:
        for name, fn in originals.items():
            setattr(ILQLTrainer, name, fn)
        restore_kernels()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    L = trainer.model_config.num_layers
    steps = [c for c in calls if c[0] == "train_step"]
    gens = [c for c in calls if c[0] == "generate"]
    losses = [c[3]["losses/loss"] for c in steps]
    summary = {
        "phase": "ilql", "card": ctx.get("smi"), "wall_s": wall, "steps": len(steps), "step_s": [c[1] for c in steps],
        "losses": losses, "loss_terms_last": {k: v for k, v in steps[-1][3].items() if k.startswith("losses/")}
        if steps else None, "eval_generate_s": [c[1] for c in gens], "target_syncs": syncs,
        "peak_mem_gib": peak / 2 ** 30, "peak_over_start_gib": (peak - start_mem) / 2 ** 30, "launches": launches,
        "launches_per_step": [c[2] for c in steps], "kernel_shapes": kernel_shapes(seen),
    }
    emit(summary)
    checks = {
        f"{ILQL_STEPS} optimizer steps": len(steps) == ILQL_STEPS,
        "losses finite": bool(losses) and all(np.isfinite(v) for c in steps for k, v in c[3].items()
                                               if k.startswith("losses/")),
        "K1, K2 and K3: num_layers x num_mb per step": all(
            c[2]["flash_fwd"] == L * num_mb and c[2]["flash_bwd_dkv"] == L * num_mb
            and c[2]["flash_bwd_dq"] == L * num_mb for c in steps),
        "K1 on every eval prefill": len(gens) == 2 and all(c[2]["flash_fwd"] == L for c in gens),
        "no kernel outside generate / train_step": all(launches[k] == sum(c[2][k] for c in calls) for k in launches),
        "target heads changed at the syncs alone": [st for st, changed, _ in syncs if changed] == list(
            range(ILQL_SYNC, ILQL_STEPS + 1, ILQL_SYNC)),
        "every sync is the Polyak update": all(err <= 1e-6 for _, changed, err in syncs if changed),
    }
    failed = [k for k, ok in checks.items() if not ok]
    emit({"phase": "ilql", "checks": checks})
    ctx["ilql_launches"] = launches
    del trainer
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"ilql phase: {failed}")
    check_main_path_shapes(ctx, seen, "ilql", ("flash_fwd", "flash_bwd"))


#: the CPU test's tiny ILQL samples (tests/test_torch_ilql.py)
ILQL_PARITY_SAMPLES = [["ab", "cd"], ["ef", "gh"], ["a", "bc"], ["de", "fg"], ["h", "abc d"], ["b a", "e"],
                       ["cc", "ddd"], ["g", "a"]]
ILQL_PARITY_REWARDS = [1.0, 0.5, -0.5, 0.25, 0.75, -1.0, 0.0, 2.0]


def ilql_parity_trainer(device, state=None):
    """ILQLTrainer at 2 layers / hidden 32 (2 heads of 16), f32, flash
    attention, char tokenizer, batch 4 in 2 microbatches, a target sync
    every 2 steps, on ``device``; ``state`` replaces the seeded weights."""
    import tempfile

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.from_dict(dict(
        method=dict(name="ILQLConfig", steps_for_target_q_sync=2, two_qs=True, alpha=0.1, beta=0.5,
                    gen_kwargs=dict(max_new_tokens=4, top_k=4, beta=1.0, do_sample=False)),
        train=dict(seq_length=16, epochs=4, total_steps=3, batch_size=4, minibatch_size=2,
                   checkpoint_interval=100, eval_interval=100,
                   checkpoint_dir=tempfile.mkdtemp(prefix="chip_smoke_ilql_parity_"), pipeline="PromptPipeline",
                   trainer="ILQLTrainer", tracker=None, seed=2, save_best=False),
        model=dict(model_path="gpt2", num_layers_unfrozen=-1, model_overrides=dict(
            vocab_size=len(SFT_PARITY_ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64, attention_impl="flash")),
        tokenizer=dict(tokenizer_path=f"char://{SFT_PARITY_ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4, max_grad_norm=1.0)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    ))
    trainer = get_trainer("ILQLTrainer")(config=cfg, device=device)
    if state is not None:
        trainer.model.load_state_dict(state)
    return trainer


def phase_ilql_parity(ctx):
    """ILQLTrainer on the card against ILQLTrainer on the CPU from the same
    weights (the tiny f32 config of the CPU test, the weights perturbed so
    the Q heads and their targets differ): 2 epochs of 2 optimizer steps
    with a target sync every 2 steps, every step's ``losses/*`` within 1e-3
    relative (+1e-6);
    then the advantage-shaped processor on one seeded decode state within
    the f32 kernel tolerance, 1e-4 x max(1, max|ref|)."""
    import shutil

    import torch

    cpu = ilql_parity_trainer("cpu")
    gen = torch.Generator().manual_seed(SEED + 23)
    state = {k: v + 0.05 * torch.randn(v.shape, generator=gen) for k, v in cpu.model.state_dict().items()}
    cpu = ilql_parity_trainer("cpu", state)
    card = ilql_parity_trainer("cuda", state)
    runs = {}
    for name, tr in (("cuda", card), ("cpu", cpu)):
        tr.make_experience(ILQL_PARITY_SAMPLES, ILQL_PARITY_REWARDS, tr.config.train.seq_length)
        tr.prepare_learning()
        stats = []
        for _ in range(2):
            for batch in tr.create_train_dataloader():
                stats.append(tr.train_step(batch))
                tr.iter_count += 1
                tr.post_backward_callback()
        runs[name] = [{k: v for k, v in st.items() if k.startswith("losses/")} for st in stats]
        shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    hidden = torch.randn(4, 32, generator=gen)
    logits = torch.randn(4, len(SFT_PARITY_ALPHABET) + 3, generator=gen)
    prev = torch.tensor([0, 3, 5, 11])
    with torch.no_grad():
        ref = cpu.gen_logits_processor()(hidden, logits, prev)
        out = card.gen_logits_processor()(hidden.cuda(), logits.cuda(), prev.cuda()).cpu()
    proc_err = float((out - ref).abs().max())
    lc, lp = runs["cuda"], runs["cpu"]
    rel = [abs(x[k] - y[k]) / max(abs(y[k]), 1e-3) for x, y in zip(lc, lp) for k in y]
    report = {"phase": "ilql_parity", "losses_cuda": lc, "losses_cpu": lp, "max_loss_rel_err": max(rel),
              "processor_max_abs_err": proc_err, "tol": 1e-3,
              "ok": len(lc) == len(lp) == 4 and all(abs(x[k] - y[k]) <= 1e-3 * abs(y[k]) + 1e-6
                                                     for x, y in zip(lc, lp) for k in y)
              and proc_err <= 1e-4 * max(1.0, float(ref.abs().max()))}
    emit(report)
    del card, cpu
    torch.cuda.empty_cache()
    if not report["ok"]:
        raise AssertionError(f"ILQLTrainer on the card disagrees with the CPU trainer: {report}")


#: the rft phase: 32 byte prompts, 8 generations of 64 tokens each, batch 32
#: in 2 microbatches, seq_length 160, 2 SFT steps on the survivors
RFT_PROMPTS, RFT_GENS, RFT_NEW, RFT_B, RFT_MB, RFT_STEPS = 32, 8, 64, 32, 16, 2


def byte_len_reward(samples, prompts, outputs, **_):
    """Deterministic host reward: the output's length in characters. A
    random-weight model at vocab 50257 samples a byte token ~0.5 % of the
    time, so outputs are short and their lengths differ."""
    return [float(len(o)) for o in outputs]


def phase_rft(ctx):
    """A main path: ``trlx_tpu_torch.train(reward_fn=...)`` with
    ``default_rft_config()`` at full gpt2-small width (bf16 compute, f32
    params and AdamW, flash attention, the bytes tokenizer): one improve
    step (8 sampled generations of 64 tokens for each of 32 prompts, the
    output length as reward, the 0.7 percentile filter) and 2 SFT steps of 32 rows in 2
    microbatches on the survivors. Launch counts reset just before and read
    just after: K1 once per layer in every generation prefill (the improve
    step's and the eval's), K1, K2 and K3 once per layer and microbatch in
    every step, nothing else; every recorded shape is held against the plain
    versions."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_rft_config
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.trainer.rft_trainer import RFTTrainer

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_rft_")
    cfg = TRLConfig.update(default_rft_config(), {
        "model.model_path": "gpt2", "model.model_overrides": {"attention_impl": "flash"},
        "mesh.compute_dtype": "bfloat16", "mesh.param_dtype": "float32", "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": 160, "train.batch_size": RFT_B, "train.minibatch_size": RFT_MB,
        "train.total_steps": RFT_STEPS, "train.eval_interval": 100, "train.checkpoint_interval": 100,
        "train.save_best": False, "train.save_optimizer": False, "train.tracker": None,
        "train.checkpoint_dir": ckpt_dir, "train.seed": SEED,
        "method.n_generations_per_prompt": RFT_GENS,
        "method.gen_kwargs": dict(max_new_tokens=RFT_NEW, temperature=1.0, do_sample=True),
    })
    num_mb = RFT_B // RFT_MB
    calls, improve = [], []
    originals = {name: getattr(RFTTrainer, name) for name in ("generate", "train_step", "make_experience")}

    def wrap(name):
        fn = originals[name]

        def timed(self, *a, **kw):
            before = dict(_kernels.launches())
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            entry = (name, time.perf_counter() - t0, {k: _kernels.launches()[k] - before[k] for k in before},
                     out if name == "train_step" else None)
            (improve if name == "make_experience" else calls).append(entry)
            if name == "make_experience":
                improve[-1] += (len(self.store.history) if self.store is not None else 0,)
            return out

        return timed

    for name in originals:
        setattr(RFTTrainer, name, wrap(name))
    seen = {}
    restore_kernels = record_kernel_shapes(seen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(
            reward_fn=byte_len_reward, prompts=byte_prompts(RFT_PROMPTS, 16, 64, SEED + 30),
            eval_prompts=byte_prompts(RFT_B, 16, 64, SEED + 31), config=cfg)
    finally:
        for name, fn in originals.items():
            setattr(RFTTrainer, name, fn)
        restore_kernels()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    L = trainer.model_config.num_layers
    steps = [c for c in calls if c[0] == "train_step"]
    gens = [c for c in calls if c[0] == "generate"]
    losses = [c[3]["losses/loss"] for c in steps]
    summary = {
        "phase": "rft", "card": ctx.get("smi"), "wall_s": wall, "steps": len(steps), "step_s": [c[1] for c in steps],
        "losses": losses, "improve_steps": len(improve), "improve_s": [c[1] for c in improve],
        "kept_samples": [c[4] for c in improve], "generate_calls": len(gens), "generate_s": [c[1] for c in gens],
        "peak_mem_gib": peak / 2 ** 30, "peak_over_start_gib": (peak - start_mem) / 2 ** 30, "launches": launches,
        "launches_per_step": [c[2] for c in steps], "kernel_shapes": kernel_shapes(seen),
    }
    emit(summary)
    checks = {
        f"{RFT_STEPS} SFT steps": len(steps) == RFT_STEPS,
        "one improve step kept samples": len(improve) == 1 and improve[0][4] > RFT_B,
        "losses finite": bool(losses) and all(np.isfinite(x) for x in losses),
        "generations: n_generations_per_prompt per prompt batch + 2 evals": len(gens) == RFT_GENS * (
            -(-RFT_PROMPTS // RFT_B)) + 2,
        "K1 on every generation prefill": all(c[2]["flash_fwd"] == L for c in gens),
        "K1, K2 and K3: num_layers x num_mb per step": all(
            c[2]["flash_fwd"] == L * num_mb and c[2]["flash_bwd_dkv"] == L * num_mb
            and c[2]["flash_bwd_dq"] == L * num_mb for c in steps),
        "no kernel outside generate / train_step": all(launches[k] == sum(c[2][k] for c in calls) for k in launches),
    }
    failed = [k for k, ok in checks.items() if not ok]
    emit({"phase": "rft", "checks": checks})
    ctx["rft_launches"] = launches
    del trainer
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"rft phase: {failed}")
    check_main_path_shapes(ctx, seen, "rft", ("flash_fwd", "flash_bwd"))


#: the GRPO phases' traffic: 32 prompts x groups of 4, 40 sampled tokens;
#: steps of 32 in 2 microbatches
GRPO_PROMPTS, GRPO_G, GRPO_N, GRPO_B, GRPO_MB = 32, 4, 40, 32, 16


def grpo_parity_trainer(device, state=None):
    """GRPOTrainer at 2 layers / hidden 64 (4 heads of 16), f32, groups of
    4 over 16 sampled tokens, a full-copy reference, on ``device``; ``state``
    replaces the seeded initial weights."""
    import tempfile

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_grpo_config
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.update(default_grpo_config(), {
        "model.model_path": "gpt2", "model.num_layers_unfrozen": -1,
        "model.model_overrides": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4,
                                      max_position_embeddings=128, attention_impl="flash"),
        "mesh.compute_dtype": "float32", "mesh.param_dtype": "float32", "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": 64, "train.batch_size": 8, "train.minibatch_size": 4, "train.total_steps": 2,
        "train.tracker": None, "train.checkpoint_dir": tempfile.mkdtemp(prefix="chip_smoke_grpo_parity_"),
        "train.seed": SEED, "method.num_rollouts": 16, "method.chunk_size": 8, "method.ppo_epochs": 1,
        "method.gen_kwargs": dict(max_new_tokens=16, do_sample=True, top_k=0, top_p=1.0),
        "optimizer.kwargs": dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6),
        "scheduler.kwargs": dict(T_max=10, eta_min=1e-4),
    })
    trainer = get_trainer("GRPOTrainer")(config=cfg, reward_fn=byte_share_reward, device=device)
    if state is not None:
        trainer.model.load_state_dict(state)
        trainer.ref_model.load_state_dict(trainer.model.transformer.state_dict())
    trainer.add_prompt_pipeline(PromptPipeline(byte_prompts(16, 8, 40, SEED + 3), 48, trainer.tokenizer))
    return trainer


def phase_grpo_parity(ctx):
    """The GRPO learner on the card against the CPU from the same weights
    and the same experience: one sampled experience phase on the CPU (16
    rollouts in groups of 4), its store copied to the card trainer, then 2
    learner steps on the same batches in both. losses/* and group/* within
    1e-3 relative + 1e-6 absolute (group/policy_delta + 1e-5: at step 1 it
    is mean |ratio - 1| of the card's logprobs against the CPU's, f32 noise
    of ~1e-6, where the CPU reads exactly 0), the per-token group
    advantages of each batch within 1e-5, losses/value_loss exactly 0."""
    import shutil

    import numpy as np
    import torch

    cpu = grpo_parity_trainer("cpu")
    state = {k: v * 3 if v.is_floating_point() else v for k, v in cpu.model.state_dict().items()}
    cpu, card = grpo_parity_trainer("cpu", state), grpo_parity_trainer("cuda", state)
    cpu.prepare_learning()
    card.num_mb = cpu.num_mb
    card.store.history = list(cpu.store.history)
    card.rollout_stats = cpu.rollout_stats
    batches = list(cpu.create_train_dataloader())[:2]
    stats, adv_err = {"cuda": [], "cpu": []}, 0.0
    for batch in batches:
        advs = []
        for name, tr in (("cuda", card), ("cpu", cpu)):
            b = batch.to(tr.device)
            adv, _ = tr.method.get_advantages_and_returns(b.values, b.rewards, b.response_mask)
            advs.append(adv.float().cpu())
            stats[name].append(tr.train_step(batch))
        adv_err = max(adv_err, float((advs[0] - advs[1]).abs().max()))
    keys = [k for k in stats["cpu"][0] if k.startswith(("losses/", "group/"))]
    rel = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-3) for x, y in zip(stats["cuda"], stats["cpu"]) for k in keys)
    ok_stats = all(abs(x[k] - y[k]) <= 1e-3 * abs(y[k]) + (1e-5 if k == "group/policy_delta" else 1e-6)
                   for x, y in zip(stats["cuda"], stats["cpu"]) for k in keys)
    groups = [e.query_tensor.tolist() for e in cpu.store.history]
    report = {"phase": "grpo_parity", "elements": len(groups), "steps": len(stats["cuda"]), "keys": keys,
              "max_stat_rel_err": rel, "max_group_adv_abs_err": adv_err,
              "stats_cuda": [{k: x[k] for k in keys} for x in stats["cuda"]],
              "stats_cpu": [{k: y[k] for k in keys} for y in stats["cpu"]]}
    emit(report)
    checks = {
        "2 steps": len(stats["cuda"]) == 2,
        "losses/* and group/* within 1e-3 relative (+ the absolute floors)": ok_stats and len(keys) >= 6,
        "group advantages within 1e-5": adv_err <= 1e-5,
        "value loss exactly 0": all(x["losses/value_loss"] == 0.0 for x in stats["cuda"] + stats["cpu"]),
        "whole adjacent groups": all(groups[i] == groups[i - i % 4] for i in range(len(groups))),
        "sampled: a group with spread": any(
            len({tuple(e.response_tensor.tolist()) for e in cpu.store.history[i:i + 4]}) > 1
            for i in range(0, len(groups), 4)),
    }
    emit({"phase": "grpo_parity", "checks": checks})
    for tr in (cpu, card):
        shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    del card, cpu
    torch.cuda.empty_cache()
    failed = [k for k, v in checks.items() if not v]
    if failed or not np.isfinite(rel):
        raise AssertionError(f"grpo_parity phase: {failed}")


def byte_environment():
    """The grpo phase's environment: a ``SyntheticEnvironment`` over the
    bytes tokenizer's ids (259) whose reward is the share of the action
    (the output re-encoded) in the 40 sampled tokens: how much of the
    sample the tokenizer can print. ``SyntheticEnvironment``'s own reward,
    the share of one target token, has no spread on random weights over
    gpt2's 50257 ids (about 1 hit in 50257 tokens), and a group without
    spread has no advantage."""
    from trlx_tpu_torch.online import SyntheticEnvironment

    class PrintableShare(SyntheticEnvironment):
        def evaluate(self, prompt, action):
            return len(action) / GRPO_N

    return PrintableShare(vocab_size=259, prompt_len=4, target_token=100, seed=SEED)


def phase_grpo(ctx):
    """A main path: ``default_grpo_config()`` (hydra reference,
    ``num_layers_unfrozen=2``, groups of 4, 40 sampled tokens) on the gpt2
    preset at full width, bf16 compute, f32 params and AdamW, the bytes
    tokenizer, through ``trlx_tpu_torch.train(environment=...)``: one
    experience phase of 128 rollouts (32 prompts x 4), then ``ppo_epochs=1``:
    4 learner steps of 32 in 2 microbatches. Every decode batch must hold
    whole adjacent groups; losses/value_loss is 0; the gauge
    online/group_adv_std > 0. K1 once per layer in every prefill, 14 times a
    scoring call (12 policy layers, the frozen branch's 2), 24 times a step;
    K2 and K3 4 times a step (2 trained layers x 2 microbatches: the value
    head takes no attention backward). Prints experience and step seconds,
    peak memory over the start, group/policy_delta."""
    import tempfile

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_grpo_config
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.utils.metrics import gauges

    cfg = TRLConfig.update(default_grpo_config(), {
        "model.model_path": "gpt2", "model.model_overrides": {"attention_impl": "flash"},
        "mesh.compute_dtype": "bfloat16", "mesh.param_dtype": "float32", "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": 128 + GRPO_N, "train.batch_size": GRPO_B, "train.minibatch_size": GRPO_MB,
        "train.total_steps": 4, "train.eval_interval": 100, "train.checkpoint_interval": 100,
        "train.save_best": False, "train.save_optimizer": False, "train.tracker": None,
        "train.checkpoint_dir": tempfile.mkdtemp(prefix="chip_smoke_grpo_"), "train.seed": SEED,
        "method.num_rollouts": GRPO_PROMPTS * GRPO_G, "method.chunk_size": GRPO_PROMPTS * GRPO_G,
        "method.ppo_epochs": 1,
    })
    assert cfg.method.group_size == GRPO_G and cfg.method.gen_kwargs["max_new_tokens"] == GRPO_N
    L, n_unfrozen, num_mb = 12, cfg.model.num_layers_unfrozen, GRPO_B // GRPO_MB
    batches, generate = [], PPOTrainer.generate

    def grouped_generate(self, prompts, *a, **kw):
        if not kw.get("eval_mode", a[0] if a else False):
            batches.append([list(map(int, p)) for p in prompts])
        return generate(self, prompts, *a, **kw)

    gauges.clear(prefix="online/")
    PPOTrainer.generate = grouped_generate
    try:
        summary, ctx["grpo_launches"] = ppo_main_path(
            ctx, "grpo", cfg,
            {"loss_fwd": L * num_mb, "bwd": n_unfrozen * num_mb, "prefill": L, "score": L + n_unfrozen},
            train_kwargs=dict(environment=byte_environment(),
                              prompts=byte_prompts(GRPO_PROMPTS * GRPO_G, 64, 128, SEED + 1),
                              eval_prompts=byte_prompts(GRPO_B, 64, 128, SEED + 2)))
    finally:
        PPOTrainer.generate = generate
    adv_std, raw_std = gauges.get("online/group_adv_std"), gauges.get("online/raw_score_std")
    steps = summary["step_stats"]
    value_head_ms = time_value_head(summary["learn_batch_shapes"][0][1])
    emit({"phase": "grpo", "card": ctx.get("smi"), "experience_s": steps[0]["time/rollout_time"],
          "experience_split_s": {k: steps[0][f"time/rollout_{k}"] for k in ("generate", "reward", "score")},
          "learn_s": summary["learn_s"], "peak_over_start_gib": summary["peak_over_start_gib"],
          "policy_delta": [st["group/policy_delta"] for st in steps], "group_adv_std": adv_std,
          "raw_score_std": raw_std, "decode_batches": len(batches),
          "value_head_fwd_ms_per_microbatch": value_head_ms,
          "value_head_share_of_step": 2 * value_head_ms / 1e3 / min(summary["learn_s"])})
    checks = {
        "one experience phase of 128 rollouts in one decode batch": len(batches) == 1
        and len(batches[0]) == GRPO_PROMPTS * GRPO_G,
        "every decode batch holds whole adjacent groups": all(
            b[i] == b[i - i % GRPO_G] for b in batches for i in range(len(b))),
        "losses/value_loss == 0": all(st["losses/value_loss"] == 0.0 for st in steps),
        "online/group_adv_std > 0": adv_std > 0,
    }
    emit({"phase": "grpo", "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"grpo phase: {failed}")


def time_value_head(T):
    """CUDA-event ms of the value head's forward at a learner microbatch
    [GRPO_MB, T, 768] (bf16 compute, f32 params): what GRPO's loss forward
    computes and never reads."""
    import torch

    from trlx_tpu_torch.models.heads import ValueHead

    cfg = gpt2_config(12, torch.bfloat16).replace(param_dtype=torch.float32)
    head = ValueHead(cfg).to("cuda")
    hidden = torch.randn(GRPO_MB, T, cfg.hidden_size, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        return cuda_time_ms(lambda: head(hidden))


#: online_grpo: 4 waves of 32 prompts x groups of 4, 64-byte prompts, 40 sampled tokens
ONLINE_WAVES, ONLINE_PROMPT_BYTES = 4, 64


def phase_online_grpo(ctx):
    """A main path: the JAX package's online leg (``bench.py``'s
    ``_online_grpo_perf``) with its fleet replaced by one ``ServingEngine``
    (gpt2 at full width, bf16, flash prefill, block 16, sampled, 128
    slots): 4 waves of 32 prompts x 4, 64-byte prompts, 40 new tokens,
    harvested by a ``PreferenceCollector`` through ``harvest(engine)``
    (the JAX leg's reward: the mean token id over the vocab); a
    ``GRPOTrainer`` (``train.online.enabled``, the same weights) takes the
    buffer with ``attach_online`` and 4 steps of 32 in 2 microbatches on the
    drained groups; ``engine.set_params`` republishes its trunk and one more
    wave is harvested at ``policy_version=1``. Launch counts reset just
    before and read just after: K1 in every prefill wave, K4 in every decode
    step, K1/K2/K3 in the learner. Labels harvested 4 x 32 x 4, no
    duplicate, the post-publish group at version 1, no KV block left. K1,
    K2/K3 and K4 are then held against their plain versions at every shape
    this path gave them (:func:`check_main_path_shapes`)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_grpo_config
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.online import OnlineExperienceBuffer, PreferenceCollector
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.serving import ServingEngine
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.update(default_grpo_config(), {
        "model.model_path": "gpt2", "model.model_overrides": {"attention_impl": "flash"},
        "mesh.compute_dtype": "bfloat16", "mesh.param_dtype": "float32", "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": ONLINE_PROMPT_BYTES + GRPO_N, "train.batch_size": GRPO_B,
        "train.minibatch_size": GRPO_MB, "train.total_steps": 4, "train.eval_interval": 100,
        "train.checkpoint_interval": 100, "train.save_best": False, "train.save_optimizer": False,
        "train.tracker": None, "train.checkpoint_dir": tempfile.mkdtemp(prefix="chip_smoke_online_"),
        "train.seed": SEED, "method.num_rollouts": GRPO_PROMPTS * GRPO_G,
        "method.chunk_size": GRPO_PROMPTS * GRPO_G, "method.ppo_epochs": 1,
        "train.online": dict(enabled=True, group_size=GRPO_G, buffer_capacity=256, max_staleness=4),
    })
    trainer = get_trainer("GRPOTrainer")(config=cfg)
    vocab = trainer.model_config.vocab_size
    engine = ServingEngine(TransformerLM(gpt2_config(12, torch.bfloat16)), trainer.model.transformer.state_dict(),
                           num_slots=GRPO_PROMPTS * GRPO_G, max_seq_len=ONLINE_PROMPT_BYTES + GRPO_N,
                           block_size=16, eos_token_id=trainer.tokenizer.eos_token_id, pad_token_id=0,
                           gen_kwargs=dict(do_sample=True), seed=SEED)

    def reward_fn(prompt, completions):
        return [float(np.mean(c)) / vocab for c in completions]

    buffer = OnlineExperienceBuffer(capacity=256, max_staleness=4)
    collector = PreferenceCollector(buffer, group_size=GRPO_G, reward_fn=reward_fn)
    prompts = [trainer.tokenizer.encode(p) for p in byte_prompts(GRPO_PROMPTS, ONLINE_PROMPT_BYTES,
                                                                 ONLINE_PROMPT_BYTES, SEED + 40)]

    def wave(version):
        for p in prompts:
            for _ in range(GRPO_G):
                engine.submit(p, GRPO_N)
        got = 0
        while engine.scheduler.has_work:
            engine.step()
            got += collector.harvest(engine, policy_version=version)
        return got + collector.harvest(engine, policy_version=version)

    steps, seen = [], {}
    restore_kernels = record_kernel_shapes(seen)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        harvested = [wave(0) for _ in range(ONLINE_WAVES)]
        torch.cuda.synchronize()
        harvest_s = time.perf_counter() - t0
        serve_launches = _kernels.launches()
        trainer.attach_online(buffer)
        original = trainer.train_step

        def recorded(batch):
            t_step = time.perf_counter()
            out = original(batch)
            torch.cuda.synchronize()
            steps.append(dict(out, step_s=time.perf_counter() - t_step))
            return out

        trainer.train_step = recorded
        t1 = time.perf_counter()
        trainer.learn()
        torch.cuda.synchronize()
        learn_s = time.perf_counter() - t1
        engine.set_params(trainer.model.transformer.state_dict())
        post = wave(1)
        launches = _kernels.launches()
        drained = buffer.drain(256, learner_version=1)  # 96 older groups, then the new wave's 32
        blocks = engine.allocator.blocks_in_use
    finally:
        restore_kernels()
        engine.close()
        shutil.rmtree(cfg.train.checkpoint_dir, ignore_errors=True)
    stats = collector.stats()
    labels = ONLINE_WAVES * GRPO_PROMPTS * GRPO_G
    report = {
        "phase": "online_grpo", "card": ctx.get("smi"), "harvested_per_wave": harvested, "post_publish": post,
        "collector": stats, "online_labels_per_s": labels / harvest_s,
        "online_learner_steps_per_s": len(steps) / max(sum(s["step_s"] for s in steps), 1e-9),
        "harvest_s": harvest_s, "learn_s": learn_s, "step_s": [s["step_s"] for s in steps], "steps": len(steps),
        "groups_consumed": [s.get("online/groups_consumed") for s in steps],
        "group_adv_std": [s.get("online/group_adv_std") for s in steps],
        "policy_delta": [s.get("group/policy_delta") for s in steps], "blocks_in_use": blocks,
        "serve_launches": serve_launches, "launches": launches, "engine": engine.summary(),
        "kernel_shapes": kernel_shapes(seen),
    }
    emit(report)
    checks = {
        "labels harvested 4 x 32 x 4": harvested == [GRPO_PROMPTS * GRPO_G] * ONLINE_WAVES
        and stats["labels_harvested"] == labels + GRPO_PROMPTS * GRPO_G,
        "no duplicate harvested": stats["duplicates_dropped"] == 0.0,
        "4 learner steps on drained groups": len(steps) == 4 and steps[0].get("online/groups_consumed") == 32.0,
        "losses finite": all(np.isfinite(s["losses/total_loss"]) for s in steps),
        "post-publish wave at policy_version 1": post == GRPO_PROMPTS * GRPO_G
        and len(drained) == ONLINE_WAVES * GRPO_PROMPTS
        and [g.policy_version for g in drained] == [0] * (ONLINE_WAVES - 1) * GRPO_PROMPTS + [1] * GRPO_PROMPTS,
        "no KV block in use": blocks == 0,
        "K1 (prefill) and K4 (decode) launched": serve_launches["flash_fwd"] > 0
        and serve_launches["paged_decode"] > 0 and serve_launches["paged_verify"] == 0,
        "K2 and K3 in the learner": launches["flash_bwd_dkv"] == launches["flash_bwd_dq"]
        == 4 * cfg.model.num_layers_unfrozen * (GRPO_B // GRPO_MB),
    }
    ctx["online_grpo_launches"] = launches
    emit({"phase": "online_grpo", "checks": checks})
    del trainer, engine
    torch.cuda.empty_cache()
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"online_grpo phase: {failed}")
    check_main_path_shapes(ctx, seen, "online_grpo", ("flash_fwd", "flash_bwd", "paged_decode"))


#: the async phase's learner steps
ASYNC_STEPS = 6


def phase_async(ctx):
    """A main path: the train phase's configuration and traffic (gpt2 full
    width, 64 sampled rollouts of SHORT_N tokens per refill, steps of 32 in 2
    microbatches) with ``train.async_rollouts`` on (max_staleness 2,
    publish_interval 1, staleness_correction), 6 learner steps. The producer
    thread generates and scores on its snapshot copy while the learner
    trains. Launch counts reset just before and read just after: K2 and K3
    exactly once per layer and microbatch in every step (only the learner
    runs a backward), and K1 exactly 12 per generate call, 24 per scoring
    call and 24 per step, whichever thread made them. After learn(): no
    ``rollout-producer`` thread alive; the drain ledger balances (produced
    == consumed + dropped_stale + leftover + dropped_shutdown); at least one
    step trained on a batch with staleness >= 1 (the IS branch ran). Prints
    per-step staleness, collect wait and overlap, and the seconds per step
    beside the synchronous train phase's (whose rollouts are twice as
    long)."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_async_")
    cfg = TRLConfig.update(full_width_train_config(ckpt_dir), {
        **short_traffic(do_sample=True), "train.total_steps": ASYNC_STEPS, "train.async_rollouts": dict(
            enabled=True, max_staleness=2, publish_interval=1, staleness_correction=True)})
    num_mb, L = TRAIN_B // TRAIN_MB, 12
    lock, counts, steps = threading.Lock(), {"generate": 0, "score": 0}, []
    originals = {name: getattr(PPOTrainer, name) for name in ("generate", "score", "train_step")}

    def counted(name):
        fn = originals[name]

        def run(self, *a, **kw):
            with lock:
                counts[name] += 1
            return fn(self, *a, **kw)

        return run

    def train_step(self, batch):
        t0 = time.perf_counter()
        out = originals["train_step"](self, batch)
        steps.append((time.perf_counter() - t0, out))
        return out

    PPOTrainer.generate, PPOTrainer.score, PPOTrainer.train_step = counted("generate"), counted("score"), train_step
    seen = {}
    restore_kernels = record_kernel_shapes(seen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(
            reward_fn=byte_share_reward, prompts=byte_prompts(64, 64, 128, SEED + 1),
            eval_prompts=byte_prompts(32, 64, 128, SEED + 2), config=cfg)
    finally:
        for name, fn in originals.items():
            setattr(PPOTrainer, name, fn)
        restore_kernels()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    ledger = trainer.rollout_engine_summary or {}
    alive = [t.name for t in threading.enumerate() if t.name == "rollout-producer" and t.is_alive()]
    stale = [out.get("rollout/batch_staleness_max", -1.0) for _, out in steps]
    sync = ctx.get("train_summary") or {}
    report = {
        "phase": "async", "card": ctx.get("smi"), "wall_s": wall, "steps": len(steps),
        "s_per_step": wall / max(len(steps), 1),
        "sync_train_s_per_step": sync["wall_s"] / sync["steps"] if sync.get("steps") else None,
        "learn_s": [s for s, _ in steps], "batch_staleness_max": stale,
        "batch_staleness_mean": [out.get("rollout/batch_staleness_mean") for _, out in steps],
        "is_weight_mean": [out.get("staleness/is_weight_mean") for _, out in steps],
        "collect_wait_s": [out.get("rollout/collect_wait_s") for _, out in steps],
        "overlap_fraction": ledger.get("overlap_fraction"), "ledger": ledger, "producer_threads_alive": alive,
        "generate_calls": counts["generate"], "score_calls": counts["score"], "launches": launches,
        "peak_mem_gib": peak / 2 ** 30, "peak_over_start_gib": (peak - start_mem) / 2 ** 30,
        "kernel_shapes": kernel_shapes(seen),
    }
    emit(report)
    balanced = bool(ledger) and ledger["produced"] == (
        ledger["consumed"] + ledger["dropped_stale"] + ledger["leftover"] + ledger["dropped_shutdown"])
    checks = {
        f"{ASYNC_STEPS} optimizer steps": len(steps) == ASYNC_STEPS,
        "losses finite": all(np.isfinite(out["losses/total_loss"]) for _, out in steps),
        "no rollout-producer thread alive after learn()": not alive and trainer._engine is None,
        "drain ledger balances": balanced,
        "a consumed batch with staleness >= 1 (the IS branch ran)": max(stale, default=-1) >= 1,
        "the IS weights in every step": all("staleness/is_weight_mean" in out for _, out in steps),
        "K2 and K3: layers x microbatches per step": launches["flash_bwd_dkv"] == launches["flash_bwd_dq"]
        == ASYNC_STEPS * L * num_mb,
        "K1: 12 per generate, 24 per scoring call, 24 per step": launches["flash_fwd"]
        == L * counts["generate"] + 2 * L * counts["score"] + L * num_mb * ASYNC_STEPS,
        "no paged kernel": launches["paged_decode"] == launches["paged_verify"] == 0,
    }
    ctx["async_launches"] = launches
    emit({"phase": "async", "checks": checks})
    del trainer
    torch.cuda.empty_cache()
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"async phase: {failed}")
    check_main_path_shapes(ctx, seen, "async", ("flash_fwd", "flash_bwd"))


def phase_grpo_synthetic(ctx):
    """The GRPO gate (``scripts/torch_grpo_synthetic.py``): the example's
    ``build_config`` (char tokenizer, hidden 64, 2 layers, groups of 4, eval
    every 20) through ``train(environment=SyntheticEnvironment)`` for seeds
    1-3 and 200 steps, each eval on 64 samples; over the seeds, the mean late
    ``reward/mean`` (the last three evals) at least the JAX package's CPU
    runs' less 0.07, the mean rise over step 0 at least half of theirs, and
    every run's late reward above its step 0. Head dim 32 and the preset's
    ``attention_impl="xla"``: no kernel."""
    import torch

    from scripts.torch_grpo_synthetic import run_gate

    t0 = time.perf_counter()
    report = run_gate()
    torch.cuda.synchronize()
    emit({"phase": "grpo_synthetic", "card": ctx.get("smi"), "seconds": time.perf_counter() - t0, **report})
    torch.cuda.empty_cache()
    if not report["ok"]:
        raise AssertionError(f"grpo_synthetic phase: below the bar: {report['gate']}")


def phase_randomwalks_async(ctx):
    """The randomwalks gate with async rollouts
    (``scripts/torch_ppo_randomwalks.py --async-max-staleness 1``): the
    randomwalks phase's recipe with ``train.async_rollouts`` on
    (max_staleness 1); eval ``reward/mean`` >= 0.7 at the first eval at or
    after step 100 (the synchronous gate's bar). The JAX package's CPU run
    of this recipe: 0.517@0 ... 0.992@100. The SFT stage is the randomwalks
    phase's when that phase ran (the same recipe and seed), else its own."""
    import torch

    from scripts.torch_ppo_randomwalks import run_gate

    t0 = time.perf_counter()
    report = run_gate(pretrain_steps=300, ppo_steps=GATE_PPO_STEPS, warm_start=ctx.get("randomwalks_export"),
                      async_max_staleness=1)
    torch.cuda.synchronize()
    emit({"phase": "randomwalks_async", "card": ctx.get("smi"), "seconds": time.perf_counter() - t0, **report})
    torch.cuda.empty_cache()
    if not report["ok"] or not report.get("async_ledger"):
        raise AssertionError(f"randomwalks_async phase: below the bar: {report['gate_eval']}")


#: the resilience phase's preempt leg: 4 steps, a checkpoint every 2, and an
#: eval every step (64 rollouts are two learner batches, so an experience
#: epoch ends at every even step; the SIGTERM is sent during the eval after
#: step 1, and the flag is polled after step 2, the end of an epoch: only
#: there does the reference's resume continue the same experience). PR 14
#: halved it from 8 steps (a checkpoint every 4, an eval every 3) to keep
#: the whole script inside its time limit.
RES_STEPS, RES_CKPT_EVERY, RES_EVAL_EVERY = 4, 2, 1
#: new tokens per rollout and eval sample in the phases that repeat the
#: train phase's traffic at half its length (resilience, observability, the
#: stream leg, the fleet and islands trainers, async, peft_memory: TRAIN_N
#: before the script's time limit forced the cut)
SHORT_N = 64


def short_traffic(do_sample):
    """Dotted overrides cutting the train phase's traffic to SHORT_N new tokens."""
    return {"train.seq_length": TRAIN_P + SHORT_N,
            "method.gen_kwargs": dict(max_new_tokens=SHORT_N, do_sample=do_sample, top_k=0, top_p=1.0)}
#: the preempted run stops at the end of the first experience epoch
RES_STOP = RES_STEPS // 2
#: the supervisor leg's wedge timer: above a full-width produce iteration
RES_WEDGE_TIMEOUT_S = 6.0


def resilience_config(ckpt_dir, **over):
    """The train phase's model and traffic, cut to SHORT_N new tokens (64
    sampled rollouts of SHORT_N tokens, steps of 32 in 2 microbatches, bf16
    compute, f32 params and AdamW) with the optimizer saved, greedy
    evaluation (``gen_kwargs``) and
    sampled rollouts (``gen_experience_kwargs``): a greedy eval draws
    nothing from the sampling generator, so a resumed run's first eval
    leaves the stream where the uninterrupted run has it. ``over`` merges
    more dotted overrides."""
    from trlx_tpu_torch.data.configs import TRLConfig

    return TRLConfig.update(full_width_train_config(ckpt_dir), {
        "train.total_steps": RES_STEPS, "train.checkpoint_interval": RES_CKPT_EVERY,
        "train.eval_interval": RES_EVAL_EVERY, "train.save_optimizer": True,
        **short_traffic(do_sample=False),
        "method.gen_experience_kwargs": dict(max_new_tokens=SHORT_N, do_sample=True, top_k=0, top_p=1.0),
        **over})


def learner_state(trainer):
    """Device copies of the trainer's parameters and AdamW state."""
    return ({k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
            {i: {k: v.detach().clone() for k, v in s.items()}
             for i, s in trainer.optimizer.state_dict()["state"].items()})


def same_state(a, b):
    """Whether two :func:`learner_state` copies are ``torch.equal``
    tensor by tensor (and hold the same tensors)."""
    import torch

    (pa, oa), (pb, ob) = a, b
    return (pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)
            and oa.keys() == ob.keys() and all(
                oa[i].keys() == ob[i].keys() and all(torch.equal(oa[i][k], ob[i][k]) for k in oa[i]) for i in oa))


def max_rel_diff(a, b):
    """Largest |a - b| / max(|a|, 1e-12) over two stats lists of dicts."""
    worst = 0.0
    for x, y in zip(a, b):
        for k in x:
            worst = max(worst, abs(x[k] - y.get(k, float("nan"))) / max(abs(x[k]), 1e-12))
    return worst


def phase_resilience(ctx):
    """A main path: resilience and self-healing (``train.resilience``,
    ``train.self_healing``) through ``trlx_tpu_torch.train`` at gpt2 full
    width with the train phase's traffic (:func:`resilience_config`). Four
    legs:

    1. Preempt and resume: an uninterrupted run of 4 steps (a checkpoint
       every 2); the same run with resilience on (and ``reward:2``, retried),
       whose reward_fn sends a real SIGTERM to its own process during the
       eval after step 1, so the run writes a committed emergency checkpoint
       at step 2 (a blocking write through the async writer, timed against
       ``grace_period_s``) and returns; a fresh trainer auto-resumes and
       finishes to step 4. Bar: the parameters and AdamW state at step 4
       and the stats of steps 3-4 equal to the uninterrupted run's
       (``torch.equal`` / ``==``), and the interrupted run's steps 1-2
       equal to the uninterrupted run's (the retried reward faults change
       nothing). On a mismatch a second uninterrupted run tells a
       non-deterministic op (the two uninterrupted runs differ) from a
       resume fault; the leg is then held to 1e-3 relative.
    2. Async checkpoint under steps, on the resumed trainer: the learner's
       stall per save for the synchronous ``save`` (the whole 1.5 GB write),
       a synchronous ``.to("cpu")`` copy of the same state, and the async
       path (a pinned ``non_blocking`` snapshot behind a CUDA event, then a
       background commit), with a learner step taken while the commit runs
       beside one taken with none. Bar: the loaded checkpoint equals the
       parameters and AdamW state at the save (``torch.equal``). Then
       ``checkpoint:1``: the write fails, no final directory and no
       sentinel appear, the error re-raises at ``wait()``, and
       ``find_latest_committed`` returns the earlier checkpoint.
    3. Self-healing: ``nan-loss:2`` armed after step 2 (checkpoint 2
       committing through the async writer) with ``rollback_after`` 2: steps 3 and 4 report
       ``health/update_applied`` 0 and leave parameters and AdamW state
       ``torch.equal``; the guard rolls back to checkpoint 2 and the run
       finishes at step 4 with finite losses. A second run with
       ``max_rollbacks`` 0 (and ``bad-element:1``) raises
       ``TrainingHealthError`` whose diagnostics bundle exists, with
       exactly one element in the quarantine file.
    4. Producer supervisor: async rollouts under self-healing with
       ``rollout-producer:1,producer-wedge:1`` (the wedge timer at
       ``RES_WEDGE_TIMEOUT_S``), 2 steps: two restarts, the drain ledger
       balances, no producer thread is left.

    Launch counts are reset before the legs and read after them: K2 and K3
    once per layer and microbatch in every learner step (skipped steps run
    their backward too), K1 in every run. Every K1/K2/K3 call shape of the
    legs is then held against the plain versions."""
    import shutil
    import signal
    import tempfile
    import threading

    import numpy as np
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.resilience import chaos, find_latest_committed, is_committed
    from trlx_tpu_torch.resilience.checkpoint import PAYLOAD_FILE
    from trlx_tpu_torch.resilience.health import TrainingHealthError
    from trlx_tpu_torch.resilience.preemption import PreemptionHandler
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.utils.metrics import gauges

    root = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    num_mb = TRAIN_B // TRAIN_MB
    smi = ctx.get("smi")
    steps = []  # (run, stats without time/*) of every train_step call
    hooks = {}  # run -> callable(trainer, n) after its n-th step
    run = {"name": None}
    original_step = PPOTrainer.train_step

    def train_step(self, batch):
        out = original_step(self, batch)
        steps.append((run["name"], {k: v for k, v in out.items() if not k.startswith("time/")}))
        hook = hooks.get(run["name"])
        if hook is not None:
            hook(self, sum(1 for r, _ in steps if r == run["name"]))
        return out

    def train(name, cfg, chaos_spec=None, reward=byte_share_reward):
        run["name"] = name
        if chaos_spec:
            os.environ["TRLX_CHAOS"] = chaos_spec  # read by the trainer's Resilience
        try:
            return trlx_tpu_torch.train(config=cfg, reward_fn=reward, prompts=byte_prompts(64, 64, 128, SEED + 1),
                                        eval_prompts=byte_prompts(32, 64, 128, SEED + 2))
        finally:
            os.environ.pop("TRLX_CHAOS", None)
            chaos.configure(None)

    def stats_of(name):
        return [st for r, st in steps if r == name]

    report = {"phase": "resilience", "card": smi}
    checks = {}
    PPOTrainer.train_step = train_step
    seen = {}
    restore_kernels = record_kernel_shapes(seen)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t_phase = time.perf_counter()
    try:
        # ---- leg 1: preempt and resume
        t0 = time.perf_counter()
        whole = train("whole", resilience_config(os.path.join(root, "whole")))
        L = whole.model_config.num_layers
        whole_state = learner_state(whole)
        del whole
        calls = {"n": 0}

        def signalling_reward(samples, prompts, outputs, **kw):
            calls["n"] += 1
            if calls["n"] == 4:  # eval@0, 2 rollout chunks, then the eval after step 1
                if not isinstance(getattr(signal.getsignal(signal.SIGTERM), "__self__", None), PreemptionHandler):
                    raise AssertionError("SIGTERM is not trapped by the PreemptionHandler: not sending it")
                os.kill(os.getpid(), signal.SIGTERM)
            return byte_share_reward(samples, prompts, outputs)

        res_cfg = dict(enabled=True, retry_base_delay_s=0.01, retry_max_delay_s=0.02)
        ckpt = os.path.join(root, "preempt")
        first = train("first", resilience_config(ckpt, **{"train.resilience": res_cfg}), chaos_spec="reward:2",
                      reward=signalling_reward)
        emergency = {"iter": first.iter_count, "seconds": first.emergency_checkpoint_s,
                     "grace_period_s": first.config.train.resilience.grace_period_s,
                     "reason": first.resilience.preemption.reason,
                     "retries": gauges.get("resilience/retries")}
        del first
        resumed = train("resumed", resilience_config(ckpt, **{"train.resilience": res_cfg}))
        resumed_state = learner_state(resumed)
        exact = {
            f"params and AdamW at step {RES_STEPS}": same_state(whole_state, resumed_state),
            f"stats of steps {RES_STOP + 1}-{RES_STEPS}": stats_of("resumed") == stats_of("whole")[RES_STOP:],
            f"stats of steps 1-{RES_STOP} (reward:2 retried)": stats_of("first") == stats_of("whole")[:RES_STOP],
        }
        leg1 = {"leg": "preempt_resume", "seconds": time.perf_counter() - t0, "emergency_checkpoint": emergency,
                "final_iter": resumed.iter_count, "exact": exact,
                "stats_max_rel_diff_resumed": max_rel_diff(stats_of("whole")[RES_STOP:], stats_of("resumed"))}
        checks.update({
            f"a real SIGTERM stopped the run at step {RES_STOP}": emergency["iter"] == RES_STOP
            and "SIGTERM" in (emergency["reason"] or ""),
            "the emergency checkpoint is committed": is_committed(os.path.join(ckpt, f"checkpoint_{RES_STOP}")),
            "the emergency write fits the grace window": emergency["seconds"] < emergency["grace_period_s"],
            "reward:2 retried": emergency["retries"] == 2.0,
            f"the resumed run finished at step {RES_STEPS}": resumed.iter_count == RES_STEPS,
        })
        if all(exact.values()):
            checks["resume exact (torch.equal)"] = True
        else:
            again = train("whole_again", resilience_config(os.path.join(root, "whole_again")))
            leg1["uninterrupted_runs_equal"] = {
                "params and AdamW": same_state(whole_state, learner_state(again)),
                "stats": stats_of("whole_again") == stats_of("whole")}
            del again
            deterministic = all(leg1["uninterrupted_runs_equal"].values())
            # a resume fault if the card repeats itself; else the op that does not
            # is recorded and the leg is held to the trainer-parity limit
            checks["resume exact, or the card is not deterministic and within 1e-3"] = (
                not deterministic and leg1["stats_max_rel_diff_resumed"] <= 1e-3)
        emit({**report, **leg1})

        # ---- leg 2: async checkpoint under steps (the resumed trainer)
        t0 = time.perf_counter()
        batches = list(resumed.create_train_dataloader())
        writer = resumed.resilience.writer
        resumed.train_step(batches[0])
        torch.cuda.synchronize()
        at_save = learner_state(resumed)
        leg2 = {"leg": "async_checkpoint", "payload_gib": sum(
            t.numel() * t.element_size() for t in [*at_save[0].values(), *(
                t for st in at_save[1].values() for t in st.values())]) / 2 ** 30}
        t1 = time.perf_counter()
        resumed.save(os.path.join(root, "sync", "checkpoint_9"))
        leg2["sync_save_stall_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        host = {k: v.to("cpu") for k, v in resumed.model.state_dict().items()}
        host_opt = {i: {k: v.to("cpu") for k, v in s.items()} for i, s in resumed.optimizer.state_dict()["state"].items()}
        leg2["sync_to_cpu_stall_s"] = time.perf_counter() - t1
        del host, host_opt
        async_dir = os.path.join(root, "async")
        stalls, commits = [], []
        for k, name in enumerate(("checkpoint_10", "checkpoint_11")):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            resumed._save_checkpoint(os.path.join(async_dir, name))
            stalls.append(time.perf_counter() - t1)
            if k == 0:
                t1 = time.perf_counter()
                resumed.train_step(batches[1])  # steps go on while the commit runs
                torch.cuda.synchronize()
                leg2["step_during_commit_s"] = time.perf_counter() - t1
                leg2["commit_in_flight_after_the_step"] = writer.in_flight
            writer.wait()
            commits.append(gauges.get("resilience/ckpt_commit_s"))
            if k == 0:
                after_step = learner_state(resumed)
                resumed.load(os.path.join(async_dir, name))
                checks["async checkpoint == the state at its save (torch.equal)"] = same_state(
                    at_save, learner_state(resumed))
                # back to the stepped state, so the second save has new bytes
                resumed.model.load_state_dict(after_step[0])
                del after_step
        t1 = time.perf_counter()
        resumed.train_step(batches[0])
        torch.cuda.synchronize()
        leg2.update({"step_without_commit_s": time.perf_counter() - t1, "async_stall_s": stalls,
                     "async_commit_s": commits})
        chaos.configure("checkpoint:1")
        failed_dir = os.path.join(async_dir, "checkpoint_12")
        resumed._save_checkpoint(failed_dir)
        try:
            writer.wait()
            raised = False
        except RuntimeError:
            raised = True
        chaos.configure(None)
        latest = find_latest_committed(async_dir)
        checks.update({
            "checkpoint:1: the failed write re-raises at wait()": raised,
            "checkpoint:1: no final directory, no sentinel": not os.path.exists(failed_dir),
            "checkpoint:1: find_latest_committed skips it": latest is not None and latest.endswith("checkpoint_11"),
        })
        leg2.update({"seconds": time.perf_counter() - t0, "latest_committed": os.path.basename(latest or ""),
                     "payload_file_gib": os.path.getsize(os.path.join(latest, PAYLOAD_FILE)) / 2 ** 30})
        emit({**report, **leg2})
        del resumed, at_save, whole_state, resumed_state
        torch.cuda.empty_cache()

        # ---- leg 3: self-healing
        t0 = time.perf_counter()
        around = {}

        def poison_after_step_2(trainer, n):
            if n == 2:
                chaos.configure("nan-loss:2")
            if n in (2, 3):  # the state before the poisoned steps 3 and 4
                around[n + 1] = learner_state(trainer)
            if n in (3, 4):
                around[n] = same_state(around[n], learner_state(trainer))

        hooks["rollback"] = poison_after_step_2
        sh = dict(enabled=True, rollback_after=2, max_rollbacks=1)
        healed = train("rollback", resilience_config(os.path.join(root, "rollback"), **{
            "train.total_steps": 4, "train.checkpoint_interval": 2, "train.eval_interval": 100,
            "train.self_healing": sh, "train.resilience": dict(enabled=True, preemption_handling=False)}))
        applied = [st["health/update_applied"] for st in stats_of("rollback")]
        summary = healed.self_healing_summary
        finite = all(np.isfinite(st["losses/total_loss"]) for st in stats_of("rollback")[4:])
        del healed
        torch.cuda.empty_cache()
        halt_dir = os.path.join(root, "halt")
        bundle = None
        try:
            train("halt", resilience_config(halt_dir, **{
                "train.total_steps": 4, "train.eval_interval": 100,
                "train.self_healing": dict(enabled=True, rollback_after=1, max_rollbacks=0)}),
                  chaos_spec="nan-loss:1,bad-element:1")
        except TrainingHealthError as e:
            bundle = str(e).rsplit("diagnostics bundle: ", 1)[1]
        quarantine = os.path.join(halt_dir, "quarantine", "quarantine.jsonl")
        quarantined = sum(1 for _ in open(quarantine)) if os.path.exists(quarantine) else 0
        checks.update({
            "nan-loss:2: update_applied 1,1,0,0, then 1,1 after the rollback": applied == [1.0, 1.0, 0.0, 0.0, 1.0, 1.0],
            "nan-loss:2: params and AdamW torch.equal across each skipped step": around.get(3) is True
            and around.get(4) is True,
            "one rollback, two skipped updates": summary is not None and summary["rollbacks"] == 1
            and summary["skipped_updates"] == 2,
            "finite losses after the rollback": finite,
            "max_rollbacks 0: TrainingHealthError with a bundle": bundle is not None
            and os.path.isfile(os.path.join(bundle, "bundle.json")),
            "bad-element:1: exactly one element quarantined": quarantined == 1,
        })
        emit({**report, "leg": "self_healing", "seconds": time.perf_counter() - t0, "update_applied": applied,
              "grad_norm": [st["health/grad_norm"] for st in stats_of("rollback")], "summary": summary,
              "bundle": bundle, "quarantined": quarantined})

        # ---- leg 4: the producer supervisor
        t0 = time.perf_counter()
        sup = train("supervisor", resilience_config(os.path.join(root, "supervisor"), **{
            "train.total_steps": 2, "train.checkpoint_interval": 100, "train.eval_interval": 100,
            "train.self_healing": dict(enabled=True, wedge_timeout_s=RES_WEDGE_TIMEOUT_S),
            "train.async_rollouts": dict(enabled=True, max_staleness=2, publish_interval=1)}),
            chaos_spec="rollout-producer:1,producer-wedge:1")
        ledger = sup.rollout_engine_summary or {}
        alive = [t.name for t in threading.enumerate() if t.name == "rollout-producer" and t.is_alive()]
        checks.update({
            "supervisor: two restarts": ledger.get("producer_restarts") == 2
            and sup.self_healing_summary["producer_restarts"] == 2,
            "supervisor: the drain ledger balances": bool(ledger) and ledger["produced"] == (
                ledger["consumed"] + ledger["dropped_stale"] + ledger["leftover"] + ledger["dropped_shutdown"]),
            "supervisor: no producer thread left": not alive and sup._engine is None,
            "supervisor: 2 steps": sup.iter_count == 2,
        })
        emit({**report, "leg": "supervisor", "seconds": time.perf_counter() - t0, "ledger": ledger,
              "threads_alive": alive})
        del sup
    finally:
        PPOTrainer.train_step = original_step
        restore_kernels()
        os.environ.pop("TRLX_CHAOS", None)
        chaos.configure(None)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    launches = _kernels.launches()
    n_steps = len(steps)
    checks.update({
        "K2 and K3: layers x microbatches in every learner step": launches["flash_bwd_dkv"]
        == launches["flash_bwd_dq"] == n_steps * L * num_mb,
        "K1 launched": launches["flash_fwd"] > 0,
        "no paged kernel": launches["paged_decode"] == launches["paged_verify"] == 0,
    })
    ctx["resilience_launches"] = launches
    emit({**report, "seconds": time.perf_counter() - t_phase, "learner_steps": n_steps, "launches": launches,
          "kernel_shapes": kernel_shapes(seen), "checks": checks})
    torch.cuda.empty_cache()
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"resilience phase: {failed}")
    check_main_path_shapes(ctx, seen, "resilience", ("flash_fwd", "flash_bwd"))


#: the observability phase: the watchdog of the inert/on runs (far above an
#: experience phase), and the escalation leg's watchdog below the
#: supervisor's wedge timer (a full-width produce iteration takes 1-3 s)
OBS_WATCHDOG_S, OBS_ESC_WATCHDOG_S, OBS_ESC_WEDGE_S = 120.0, 5.0, 30.0
#: the torch.profiler window of the profiled run, [start, end): the window
#: closes at the top of the next step, so [0, 1) holds learner step 1 alone
#: (a later window would also hold the experience phase or the final eval
#: that follows its last step)
OBS_PROFILE_WINDOW, OBS_PROFILE_STEPS = (0, 1), 2
#: the kernels the profiled learner steps must show on the card's timeline
OBS_PROFILED_KERNELS = {"flash_fwd": "fwd_mma_kernel", "flash_bwd_dkv": "dkv_mma_kernel",
                        "flash_bwd_dq": "dq_mma_kernel"}


class _LogCapture:
    """Collect the port's log records (its root logger does not propagate)."""

    def __init__(self):
        import logging as py_logging

        self.messages = []
        capture = self

        class Handler(py_logging.Handler):
            def emit(self, record):
                capture.messages.append(record.getMessage())

        self.handler = Handler(level=py_logging.WARNING)
        self.logger = py_logging.getLogger("trlx_tpu_torch")

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def obs_config(ckpt_dir, on, profile=False, **over):
    """The train phase's model and traffic (:func:`full_width_train_config`),
    cut to SHORT_N new tokens (:func:`short_traffic`), with the jsonl
    tracker under the checkpoint dir's ``logs`` and, ``on``,
    ``train.observability`` with every output: the span trace, the series
    and Prometheus exports, memory gauges every step, the watchdog at
    ``OBS_WATCHDOG_S`` and MFU's peak detected from the card's name;
    ``profile`` adds the torch.profiler window ``OBS_PROFILE_WINDOW``."""
    from trlx_tpu_torch.data.configs import TRLConfig

    train = {"train.tracker": "jsonl", "train.run_name": "obs"}
    if on:
        train["train.observability"] = dict(
            enabled=True, trace_path="trace.json", series_path="series.jsonl", prom_path="metrics.prom",
            memory_interval=1, watchdog_timeout_s=OBS_WATCHDOG_S)
    if profile:
        train.update({"train.profile_dir": os.path.join(ckpt_dir, "profile"),
                      "train.profile_start_step": OBS_PROFILE_WINDOW[0],
                      "train.profile_end_step": OBS_PROFILE_WINDOW[1]})
    return TRLConfig.update(full_width_train_config(ckpt_dir), {**short_traffic(do_sample=True), **train, **over})


def profiled_learn_kernels(profile_dir):
    """Count, in the torch.profiler trace under ``profile_dir``, the CUDA
    kernel events of K1/K2/K3 whose start lies inside a ``learn`` range
    (the span's ``record_function`` range, on the host or the device
    timeline). Returns (trace path, bytes, counts, learn ranges)."""
    import glob

    [path] = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == "learn" and e.get("cat") in ("user_annotation", "gpu_user_annotation")
              and "dur" in e]
    counts = {k: 0 for k in OBS_PROFILED_KERNELS}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for kind, sub in OBS_PROFILED_KERNELS.items():
            if sub in e.get("name", "") and any(t0 <= e["ts"] <= t1 for t0, t1 in ranges):
                counts[kind] += 1
    return path, os.path.getsize(path), counts, len(ranges)


def phase_observability(ctx):
    """A main path: ``train.observability`` and ``train.profile_dir`` through
    ``trlx_tpu_torch.train`` at gpt2 full width with the train phase's model
    and traffic at SHORT_N new tokens (64 sampled rollouts of 64 tokens, 4
    steps of 32 in 2 microbatches, bf16 compute, f32 params and AdamW).
    Three legs:

    1. Inert, then on: two 4-step runs (off, then on; four in turns until
       PR 14 cut them for time). Bar: every ``losses/*`` stat ``==`` across
       the two runs, step for step;
       with the layer on, the span, step-time, throughput and memory stats
       present (``mfu`` in (0, 1] and ``model_tflops_per_sec / mfu`` the
       table's peak for the card's name), no host RSS, the accountant's
       parameter count the trained module's, ``trace.json`` with
       ``generate``, ``learn`` and ``score``, the series and Prometheus
       files readable, and no stall logged.
    2. Flights: the train_serving run (block 16, spec_k 4, prefill_chunk 64)
       for 2 steps with the layer on: every request's flight ends in
       exactly one terminal event, its engine phases sum to
       ``Request.latency_s`` within 1e-9 s, the ``obs/flight/*`` gauges are
       in the step stats and no KV block is left after a generation.
    3. Escalation: 2 async steps under the producer supervisor with
       ``producer-wedge:1``, the watchdog at ``OBS_ESC_WATCHDOG_S`` below
       the supervisor's ``OBS_ESC_WEDGE_S``: the one restart is the
       watchdog's escalation, the drain ledger balances, no thread is left.
    4. Profile: leg 1's "on" run cut to ``OBS_PROFILE_STEPS`` steps with
       the torch.profiler window ``OBS_PROFILE_WINDOW`` over learner step 1,
       last, because a process ran slower after a profiler window: its
       losses equal leg 1's first steps, its obs stats as leg 1's, and the
       trace under ``profile_dir`` holds K1, K2 and K3 kernel events inside
       ``learn``.

    Launch counts are set to 0 just before each run and read just after
    it; the path's counts are the sum over the runs with the layer on (the
    "off" runs are phase ``train``'s path): K2 and K3 once per layer and
    microbatch in every learner step of those runs, K1 and K5 launched;
    every recorded K1/K2/K3/K5 shape is replayed against the plain
    versions."""
    import gc
    import shutil
    import tempfile
    import threading

    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.obs import Observability, flight, read_jsonl_series, read_prometheus
    from trlx_tpu_torch.obs.flight import ENGINE_PHASES, TERMINAL_EVENTS
    from trlx_tpu_torch.obs.throughput import detect_peak_tflops, param_count
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.resilience import chaos
    from trlx_tpu_torch.rollout import ProducerSupervisor
    from trlx_tpu_torch.serving import ServingEngine
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    smi, kind = ctx.get("smi"), torch.cuda.get_device_name(0)
    peak = detect_peak_tflops(kind)
    root = tempfile.mkdtemp(prefix="chip_smoke_observability_")
    L, num_mb = 12, TRAIN_B // TRAIN_MB
    rec = {"run": None}
    runs = {}  # run -> {"steps": [...], "obs": [...], "experience_s": [...], ...}
    originals = {"train_step": PPOTrainer.train_step, "make_experience": PPOTrainer.make_experience,
                 "_serving_generate": PPOTrainer._serving_generate, "step_stats": Observability.step_stats,
                 "run": ServingEngine.run, "_restart": ProducerSupervisor._restart,
                 "start": ProducerSupervisor.start}

    def cur():
        return runs.setdefault(rec["run"], {"steps": [], "learn_s": [], "obs": [], "obs_s": [], "experience_s": [],
                                            "blocks_after_generate": [], "done": {}, "restarts": []})

    def train_step(self, batch):  # host clock: the step ends in its stats' host transfer
        t0 = time.perf_counter()
        out = originals["train_step"](self, batch)
        cur()["learn_s"].append(time.perf_counter() - t0)
        cur()["steps"].append(dict(out))
        return out

    def make_experience(self, *a, **kw):
        t0 = time.perf_counter()
        out = originals["make_experience"](self, *a, **kw)
        cur()["experience_s"].append(time.perf_counter() - t0)
        return out

    def serving_generate(self, *a, **kw):
        out = originals["_serving_generate"](self, *a, **kw)
        cur()["blocks_after_generate"].append(self._serving_engine.allocator.blocks_in_use)
        return out

    def step_stats(self, *a, **kw):  # host clock: the layer's own per-step cost
        t0 = time.perf_counter()
        out = originals["step_stats"](self, *a, **kw)
        cur()["obs_s"].append(time.perf_counter() - t0)
        cur()["obs"].append(dict(out))
        return out

    def engine_run(self, *a, **kw):
        out = originals["run"](self, *a, **kw)
        cur()["done"].update(out)
        return out

    def restart(self, reason, cause=None):
        cur()["restarts"].append((reason, time.perf_counter()))
        return originals["_restart"](self, reason, cause)

    def supervisor_start(self):
        cur()["supervisor_started"] = time.perf_counter()
        return originals["start"](self)

    def train(name, cfg, chaos_spec=None):
        rec["run"] = name
        cur()
        if chaos_spec:
            os.environ["TRLX_CHAOS"] = chaos_spec
        gc.collect()  # a dropped trainer holds reference cycles (its step closure)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runs[name]["start_gib"] = torch.cuda.memory_allocated() / 2 ** 30  # what earlier phases still hold
        t0 = time.perf_counter()
        _kernels.reset_launches()  # this run's launches alone, read just after it
        try:
            trainer = trlx_tpu_torch.train(config=cfg, reward_fn=byte_share_reward,
                                           prompts=byte_prompts(64, 64, 128, SEED + 1),
                                           eval_prompts=byte_prompts(32, 64, 128, SEED + 2))
        finally:
            runs[name]["launches"] = _kernels.launches()
            os.environ.pop("TRLX_CHAOS", None)
            chaos.configure(None)
        runs[name]["wall_s"] = time.perf_counter() - t0
        return trainer

    def losses_of(name):
        return [{k: v for k, v in st.items() if k.startswith("losses/")} for st in runs[name]["steps"]]

    mem_keys = ("mem/bytes_in_use_max_gb", "mem/peak_bytes_in_use_max_gb", "mem/bytes_limit_gb", "mem/utilization")

    def obs_checks(names):
        """The obs stats of runs with the layer on (step 1 has no step time)."""
        every = [st for name in names for st in runs[name]["obs"]]
        later = [st for name in names for st in runs[name]["obs"][1:]]
        return {
            "spans generate, score, reward, learn": {"time/span/generate", "time/span/score", "time/span/reward",
                                                     "time/span/learn"} <= set().union(*every)
            and all("time/span/learn" in st for st in every),
            "time/step_p50 and _p95 from step 2": bool(later) and all(
                "time/step_p50" in st and "time/step_p95" in st for st in later),
            "tokens/s, model TFLOP/s and mfu from step 2": all(
                k in st for st in later for k in ("throughput/tokens_per_sec", "throughput/model_tflops_per_sec",
                                                  "throughput/mfu")),
            "mfu in (0, 1]": all(0 < st["throughput/mfu"] <= 1 for st in later),
            "model TFLOP/s / mfu = the card's data-sheet peak": peak is not None and all(
                abs(st["throughput/model_tflops_per_sec"] / st["throughput/mfu"] - peak) <= 1e-9 * peak
                for st in later),
            "mem/* from the CUDA allocator every step": all(k in st for st in every for k in mem_keys),
            "no host RSS": not any("mem/host_rss_gb" in st for st in every),
        }

    def kind_of(step):  # what the wall time since the previous step_stats spans
        return {2: "learner only", 3: "an experience phase", 4: "the final eval"}.get(step)

    def emit_steps(name, leg):
        for i, st in enumerate(runs[name]["obs"] or [{}] * len(runs[name]["steps"])):
            emit({"phase": "observability", "leg": leg, "run": name, "step": i + 1, "card": smi,
                  "spans": kind_of(i + 1), "learn_s": runs[name]["learn_s"][i],
                  **{k: st.get(k) for k in ("time/step", "throughput/mfu", "throughput/tokens_per_sec",
                                            "throughput/model_tflops_per_sec", "throughput/total_tokens",
                                            "mem/peak_bytes_in_use_max_gb", "mem/bytes_in_use_max_gb")}})

    def run_summary(names):
        return {"learn_s": {n: runs[n]["learn_s"] for n in names},
                "experience_s": {n: runs[n]["experience_s"] for n in names},
                "wall_s": {n: runs[n]["wall_s"] for n in names},
                "start_gib": {n: runs[n]["start_gib"] for n in names},
                "step_stats_ms": {n: [1e3 * x for x in runs[n]["obs_s"]] for n in names if runs[n]["obs_s"]},
                "peak_gib": {n: runs[n]["obs"][-1]["mem/peak_bytes_in_use_max_gb"] for n in names if runs[n]["obs"]}}

    def mfu_by_kind(names):
        return {k: [st["throughput/mfu"] for n in names for i, st in enumerate(runs[n]["obs"]) if kind_of(i + 1) == k]
                for k in ("learner only", "an experience phase", "the final eval")}

    PPOTrainer.train_step, PPOTrainer.make_experience = train_step, make_experience
    PPOTrainer._serving_generate, Observability.step_stats = serving_generate, step_stats
    ServingEngine.run, ProducerSupervisor._restart, ProducerSupervisor.start = engine_run, restart, supervisor_start
    seen = {}
    restore_kernels = record_kernel_shapes(seen)
    checks, report = {}, {"phase": "observability", "card": smi, "device_kind": kind, "peak_tflops": peak}
    t_phase = time.perf_counter()
    try:
        # ---- leg 1: inert, then on (off, on; cut from off, on, on, off in
        # PR 14 to keep the whole script inside its time limit)
        t0 = time.perf_counter()
        order = ("off_1", "on_1")
        with _LogCapture() as logs:
            for name in order:
                trainer = train(name, obs_config(os.path.join(root, name), name.startswith("on")))
                if name == "on_1":
                    n_params, accountant = param_count(trainer.model), trainer.obs.accountant
                    n_module = sum(p.numel() for p in trainer.model.parameters())
                del trainer  # the next run's memory gauges read its own trainer alone
        logs_dir = os.path.join(root, "on_1", "logs")
        with open(os.path.join(logs_dir, "trace.json")) as f:
            span_names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
        series = read_jsonl_series(os.path.join(logs_dir, "series.jsonl"))
        prom = read_prometheus(os.path.join(logs_dir, "metrics.prom"))
        checks.update({
            "2 runs of 4 steps": all(len(runs[name]["steps"]) == 4 for name in order),
            "losses/* equal across off, on": all(losses_of(name) == losses_of("off_1") for name in order)
            and all(losses_of("off_1")),
            "off: no obs stats asked": runs["off_1"]["obs"] == [],
            **obs_checks(("on_1",)),
            "accountant's parameter count = the trained module's": accountant is not None
            and accountant.n_params == n_params == n_module,
            "trace.json: generate, learn, score": {"generate", "learn", "score"} <= span_names,
            "series and Prometheus files read back": bool(series) and "obs/flight/completed" in prom,
            "no stall logged": not any("STALL DETECTED" in m for m in logs.messages),
        })
        for name in order:
            emit_steps(name, "inert_then_on")
        emit({**report, "leg": "inert_then_on", "seconds": time.perf_counter() - t0, "order": order,
              "n_params": n_params, **run_summary(order), "mfu": mfu_by_kind(("on_1",)),
              "tokens_per_sec_learner_only": [runs["on_1"]["obs"][1]["throughput/tokens_per_sec"]],
              "bytes_limit_gib": runs["on_1"]["obs"][-1]["mem/bytes_limit_gb"],
              "span_names": sorted(span_names), "series_keys": len(series), "losses_step_1": losses_of("off_1")[0]})

        # ---- leg 2: flights through the serving engine
        t0 = time.perf_counter()
        cfg = obs_config(os.path.join(root, "flights"), True, **{
            "train.total_steps": 2,
            "train.serving": {"enabled": True, "block_size": 16, "spec_k": 4, "prefill_chunk": 64}})
        train("flights", cfg)  # the trainer is not kept: its flights are in the recorder
        r = runs["flights"]
        flights = {uid: flight.get(uid) for uid in r["done"]}
        terminal = {uid: sum(fl.counts.get(e, 0) for e in TERMINAL_EVENTS) if fl is not None else 0
                    for uid, fl in flights.items()}
        gaps = [abs(sum(fl.phases[p] for p in ENGINE_PHASES) - r["done"][uid].latency_s)
                for uid, fl in flights.items() if fl is not None]
        pct = flight.phase_percentiles((0.5, 0.95))
        checks.update({
            "flights: requests served": len(r["done"]) >= 64,
            "flights: exactly one terminal event each": bool(terminal) and set(terminal.values()) == {1},
            "flights: none left active": flight.active_count() == 0,
            "flights: engine phases sum to latency_s within 1e-9 s": bool(gaps) and max(gaps) <= 1e-9,
            "flights: obs/flight/* gauges in the step stats": all(
                st.get("obs/flight/completed", 0) > 0 for st in r["obs"]),
            "flights: no KV block left after each generation": bool(r["blocks_after_generate"])
            and all(b == 0 for b in r["blocks_after_generate"]),
        })
        emit({**report, "leg": "flights", "seconds": time.perf_counter() - t0, "requests": len(r["done"]),
              "max_latency_gap_s": max(gaps) if gaps else None,
              "percentiles_s": {k: v for k, v in pct.items() if k.split("_p")[0] in (
                  "queue_wait", "prefill", "decode", "store_wait")},
              "blocks_after_generate": r["blocks_after_generate"]})

        # ---- leg 3: the watchdog's escalation restarts a wedged producer
        t0 = time.perf_counter()
        cfg = obs_config(os.path.join(root, "escalation"), True, **{
            "train.total_steps": 2,
            "train.observability.watchdog_timeout_s": OBS_ESC_WATCHDOG_S,
            "train.self_healing": dict(enabled=True, wedge_timeout_s=OBS_ESC_WEDGE_S),
            "train.async_rollouts": dict(enabled=True, max_staleness=2, publish_interval=1)})
        sup = train("escalation", cfg, chaos_spec="producer-wedge:1")
        ledger = sup.rollout_engine_summary or {}
        alive = [t.name for t in threading.enumerate() if t.name == "rollout-producer" and t.is_alive()]
        reasons = [reason for reason, _ in runs["escalation"]["restarts"]]
        restart_after = [t - runs["escalation"].get("supervisor_started", t) for _, t in runs["escalation"]["restarts"]]
        checks.update({
            "escalation: one restart, by the watchdog": reasons == ["watchdog escalation: stale producer heartbeat"],
            "escalation: the drain ledger balances": bool(ledger) and ledger["produced"] == (
                ledger["consumed"] + ledger["dropped_stale"] + ledger["leftover"] + ledger["dropped_shutdown"]),
            "escalation: no producer thread left": not alive and sup._engine is None,
            "escalation: 2 steps": sup.iter_count == 2,
        })
        emit({**report, "leg": "escalation", "seconds": time.perf_counter() - t0, "restarts": reasons,
              "restart_after_supervisor_start_s": restart_after, "watchdog_timeout_s": OBS_ESC_WATCHDOG_S,
              "wedge_timeout_s": OBS_ESC_WEDGE_S, "ledger": ledger, "threads_alive": alive,
              "wall_s": runs["escalation"]["wall_s"]})
        del sup

        # ---- leg 4: leg 1's "on" run with the profiler window, last: after a
        # torch.profiler window the process ran slower (PERF.md §6)
        t0 = time.perf_counter()
        train("profiled", obs_config(os.path.join(root, "profiled"), True, profile=True,
                                     **{"train.total_steps": OBS_PROFILE_STEPS}))
        trace_path, trace_bytes, in_learn, learn_ranges = profiled_learn_kernels(
            os.path.join(root, "profiled", "profile"))
        checks.update({
            f"profiled: {OBS_PROFILE_STEPS} steps": len(runs["profiled"]["steps"]) == OBS_PROFILE_STEPS,
            "profiled: losses/* equal to the unprofiled runs'":
                losses_of("profiled") == losses_of("off_1")[:OBS_PROFILE_STEPS],
            **{f"profiled: {k}": v for k, v in obs_checks(("profiled",)).items()},
            "profiler trace: K1, K2, K3 inside learn": all(n > 0 for n in in_learn.values()),
        })
        emit_steps("profiled", "profile")
        emit({**report, "leg": "profile", "seconds": time.perf_counter() - t0, "window": OBS_PROFILE_WINDOW,
              **run_summary(("profiled",)), "profile_trace": os.path.basename(trace_path),
              "profile_trace_mib": trace_bytes / 2 ** 20, "profile_learn_ranges": learn_ranges,
              "kernels_inside_learn": in_learn})
    finally:
        PPOTrainer.train_step, PPOTrainer.make_experience = originals["train_step"], originals["make_experience"]
        PPOTrainer._serving_generate, Observability.step_stats = originals["_serving_generate"], originals["step_stats"]
        ServingEngine.run, ProducerSupervisor._restart = originals["run"], originals["_restart"]
        ProducerSupervisor.start = originals["start"]
        restore_kernels()
        shutil.rmtree(root, ignore_errors=True)
    on_runs = [name for name in runs if not name.startswith("off")]  # the "off" runs are phase train's path
    launches = {k: sum(runs[name]["launches"][k] for name in on_runs) for k in runs["on_1"]["launches"]}
    n_steps = sum(len(runs[name]["steps"]) for name in on_runs)
    checks.update({
        "K2 and K3: layers x microbatches in every learner step": launches["flash_bwd_dkv"]
        == launches["flash_bwd_dq"] == n_steps * L * num_mb,
        "K1 launched": launches["flash_fwd"] > 0,
        "K5 launched (flights leg)": launches["paged_verify"] > 0,
        "no K4": launches["paged_decode"] == 0,
    })
    ctx["observability_launches"] = launches
    emit({**report, "seconds": time.perf_counter() - t_phase, "runs_counted": on_runs, "learner_steps": n_steps,
          "launches": launches, "launches_by_run": {name: runs[name]["launches"] for name in runs},
          "kernel_shapes": kernel_shapes(seen), "checks": checks})
    torch.cuda.empty_cache()
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"observability phase: {failed}")
    check_main_path_shapes(ctx, seen, "observability", ("flash_fwd", "flash_bwd", "paged_verify"))


#: the device of the production_serving legs (the card)
PS_DEVICE = "cuda"
#: phase production_serving, leg resilience_parity: f32 gpt2 at full width,
#: 32 greedy requests through 8 slots (prompts 16..48 tokens, budgets 32..63),
#: block 16; the tight pool (24 usable blocks against 8 x 7 worst case) must
#: preempt, and a lone request (7 blocks) always fits
PS_PARITY_REQ, PS_PARITY_SLOTS, PS_PARITY_BLOCKS = 32, 8, 25
#: leg serving_chaos: the card sizes of the JAX package's chaos leg
#: (bench.py:_serving_chaos_perf): S slots, prompts of 1..P-1 tokens,
#: budgets N/4..N-1, 8 S requests, block 16
PS_CHAOS_S, PS_CHAOS_P, PS_CHAOS_N = 64, 128, 64
#: leg tenant_scenario: the card sizes of bench.py:_serving_tenant_perf
PS_TEN_S, PS_TEN_P, PS_TEN_N, PS_TEN_LO, PS_TEN_HI = 16, 64, 32, 64, 32
#: every serving chaos site armed (both scenario legs)
PS_CHAOS_SPEC = "serving-prefill:1,serving-decode:1,serving-alloc:2,serving-wedge:1"
#: the wedge timer of the scenario legs (s): a wedged round is aborted after it
PS_WEDGE_S = 2.0
#: the stream_overlap leg's reward stand-in sleeps this long a sample
#: (bench.py:_serving_overlap_perf's reward-RPC stand-in)
PS_REWARD_SLEEP_S = 0.03


def ps_cpu_config():
    """The CPU reference model of the scenario legs: gpt2 cut to 2 layers of
    hidden 64 (4 heads of 16), vocab 50257, f32. Scheduling there does not
    depend on the tokens (no eos: every length is its budget), so the
    reference's scheduling facts must equal the card's."""
    import torch

    from trlx_tpu_torch.models.presets import PRESETS

    return PRESETS["gpt2"].replace(num_layers=2, hidden_size=64, num_heads=4, intermediate_size=256,
                                   compute_dtype=torch.float32, param_dtype=torch.float32, attention_impl="flash")


def ps_drive(srv, uids):
    """Step ``srv`` (an engine or a supervisor) until every uid is terminal;
    fails when a uid reaches a second terminal state or the engine runs out
    of work first. Returns {uid: Request}."""
    terminal = {}

    def collect():
        for uid, req in srv.scheduler.pop_finished().items():
            if uid in terminal:
                raise AssertionError(f"uid {uid} reached a second terminal state")
            terminal[uid] = req

    collect()
    while not set(uids) <= set(terminal):
        if not srv.scheduler.has_work:
            raise AssertionError(f"engine ran out of work with {set(uids) - set(terminal)} unaccounted")
        srv.step()
        collect()
    return terminal


def ps_warm(factory, prompt):
    """One small pass on a fresh engine of the leg's build (kernels loaded,
    caches warm) before any wall-clock check: the wedge timers count seconds."""
    eng = factory()
    eng.run([eng.submit(prompt[:16], 4)])
    eng.close()


def ps_resilience_parity(ctx):
    """Leg resilience_parity (f32 on the card): the plain engine on a roomy
    pool is the reference; the policy with no fault must give its tokens
    (``==``); preemption under KV pressure and ``serving-prefill:1,
    serving-decode:1`` under the supervisor must give them too, except at a
    near tie (the reference prefers its token by <= TIE_GAP f32)."""
    import numpy as np
    import torch

    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.resilience.chaos import chaos
    from trlx_tpu_torch.serving import ServingEngine, ServingResiliencePolicy, ServingSupervisor

    cfg = gpt2_config(12, torch.float32)
    state = TransformerLM(cfg, device=PS_DEVICE).init_params(SEED).state_dict()
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(16, 49))).astype(np.int32).tolist()
               for _ in range(PS_PARITY_REQ)]
    budgets = [32 + i for i in range(PS_PARITY_REQ)]

    def engine(policy=None, num_blocks=0):
        return ServingEngine(TransformerLM(cfg, device=PS_DEVICE), state, num_slots=PS_PARITY_SLOTS, max_seq_len=112,
                             block_size=16, num_blocks=num_blocks, gen_kwargs=dict(do_sample=False), seed=SEED,
                             policy=policy, device=PS_DEVICE)

    def run(srv):
        t0 = time.perf_counter()
        uids = [srv.submit(p, n) for p, n in zip(prompts, budgets)]
        done = ps_drive(srv, uids)
        torch.cuda.synchronize()
        return {"rows": [list(done[u].generated) for u in uids], "reasons": [done[u].finish_reason for u in uids],
                "wall_s": time.perf_counter() - t0, "blocks_in_use": srv.allocator.blocks_in_use,
                "outcome_counts": srv.scheduler.outcome_counts()}

    ps_warm(engine, prompts[0])
    plain = engine()
    runs = {"plain": run(plain)}
    eng = engine(ServingResiliencePolicy(preemption=True))
    runs["policy_no_fault"] = run(eng)
    eng.close()
    eng = engine(ServingResiliencePolicy(preemption=True), num_blocks=PS_PARITY_BLOCKS)
    runs["kv_pressure"] = run(eng)
    eng.allocator.check_invariants()
    eng.close()
    sup = ServingSupervisor(lambda: engine(ServingResiliencePolicy(preemption=True)), max_restarts=4,
                            backoff_base_s=0.01, wedge_timeout_s=None)
    chaos.configure("serving-prefill:1,serving-decode:1")
    try:
        runs["supervised_chaos"] = run(sup)
    finally:
        chaos.configure(None)
        sup.close()
    sup.allocator.check_invariants()
    runs["supervised_chaos"]["restarts"] = sup.restarts
    sup.engine.close()
    ref = runs["plain"]["rows"]
    splits = {k: tie_aware_splits(plain.trunk, prompts, runs[k]["rows"], ref) for k in ("kv_pressure",
                                                                                          "supervised_chaos")}
    plain.close()
    emit({"phase": "production_serving", "leg": "resilience_parity", "card": ctx.get("smi"), "dtype": "float32",
          "requests": PS_PARITY_REQ, "slots": PS_PARITY_SLOTS, "tight_pool_blocks": PS_PARITY_BLOCKS,
          "runs": {k: {kk: vv for kk, vv in r.items() if kk != "rows"} for k, r in runs.items()},
          "splits": splits, "tie_gap": TIE_GAP["float32"]})
    checks = {
        "policy without faults == plain, token for token": runs["policy_no_fault"]["rows"] == ref,
        "every request ran its whole budget": all(len(r) == n for r, n in zip(ref, budgets)),
        "kv pressure preempted": runs["kv_pressure"]["outcome_counts"]["preempted"] >= 1,
        "supervised run restarted": runs["supervised_chaos"]["restarts"] >= 1,
        "no block in use at the end": all(r["blocks_in_use"] == 0 for r in runs.values()),
        "every split a near tie": all(near_tie(s, "float32") for ss in splits.values() for s in ss),
    }
    failed = [k for k, ok in checks.items() if not ok]
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"production_serving resilience_parity: {failed}")


def ps_chaos_traffic(vocab):
    """bench.py:_serving_chaos_perf's traffic: 8 S prompts of 1..P-1 tokens
    from seed 7, budgets N/4..N-1 rising with the index."""
    import numpy as np

    S, P, N = PS_CHAOS_S, PS_CHAOS_P, PS_CHAOS_N
    n_req = 8 * S
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, vocab, 1 + int(rng.integers(0, P - 1))).astype(np.int32).tolist()
               for _ in range(n_req)]
    budgets = [N // 4 + (i * (3 * N // 4)) // n_req for i in range(n_req)]
    return prompts, budgets


def ps_serving_chaos_run(cfg, device, diag_dir):
    """One run of leg serving_chaos on ``device``: the JAX chaos leg's engine
    (S slots, block 16, a pool of about half the worst case, the policy
    with max_pending 4 S, watermarks 1.0 / 0.5, preemption, a 300 s TTL)
    under the supervisor (wedge timer PS_WEDGE_S) with every chaos site
    armed, all 8 S requests submitted at once."""
    import numpy as np

    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.resilience.chaos import chaos
    from trlx_tpu_torch.serving import ServingEngine, ServingResiliencePolicy, ServingSupervisor

    S, P, N = PS_CHAOS_S, PS_CHAOS_P, PS_CHAOS_N
    prompts, budgets = ps_chaos_traffic(cfg.vocab_size)
    state = TransformerLM(cfg, device=device).init_params(SEED).state_dict()
    policy = ServingResiliencePolicy(request_ttl_s=300.0, max_pending=4 * S, high_watermark=1.0, low_watermark=0.5,
                                     preemption=True)

    def factory():
        return ServingEngine(TransformerLM(cfg, device=device), state, num_slots=S, max_seq_len=P + N, block_size=16,
                             num_blocks=1 + max(2 * S, S * -(-(P + N) // 16) // 2), gen_kwargs=dict(do_sample=False),
                             seed=SEED, policy=policy, device=device)

    ps_warm(factory, prompts[0])
    sup = ServingSupervisor(factory, max_restarts=8, backoff_base_s=0.01, wedge_timeout_s=PS_WEDGE_S,
                            diagnostics_dir=diag_dir)
    chaos.configure(PS_CHAOS_SPEC)
    try:
        t0 = time.perf_counter()
        uids = [sup.submit(p, n) for p, n in zip(prompts, budgets)]
        done = ps_drive(sup, uids)
        wall = time.perf_counter() - t0
    finally:
        chaos.configure(None)
        sup.close()
    sup.allocator.check_invariants()
    out = {"reasons": [done[u].finish_reason for u in uids], "outcome_counts": sup.scheduler.outcome_counts(),
           "restarts": sup.restarts, "blocks_in_use": sup.allocator.blocks_in_use, "wall_s": wall,
           "latency_s": np.array([done[u].latency_s for u in uids], np.float64),
           "delivered_tokens": sum(len(done[u].generated) for u in uids), "n_req": len(uids)}
    sup.engine.close()
    return out


def ps_tenant_run(cfg, device, diag_dir):
    """One run of leg tenant_scenario on ``device``: bench.py:_serving_tenant_perf
    through ``run_scenario`` with every chaos site armed."""
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.serving import (
        ServingEngine,
        ServingResiliencePolicy,
        TenantRegistry,
        TenantTraffic,
        run_scenario,
    )

    S, P, N, n_lo, n_hi = PS_TEN_S, PS_TEN_P, PS_TEN_N, PS_TEN_LO, PS_TEN_HI
    bs = 16
    max_len = P + N + 4  # +4: pro1 prepends a shared prefix
    blocks_per_req = -(-max_len // bs)
    state = TransformerLM(cfg, device=device).init_params(SEED).state_dict()
    reg = TenantRegistry(class_ttl_s={0: 8.0, 1: 16.0})
    reg.register("free1", slo_class=0, kv_block_quota=blocks_per_req)
    reg.register("free2", slo_class=0, kv_block_quota=blocks_per_req)
    reg.register("pro1", slo_class=1)
    reg.register("pro2", slo_class=1)
    policy = ServingResiliencePolicy(max_pending=8, high_watermark=0.75, low_watermark=0.5, preemption=True)

    def factory(tenants=reg):
        return ServingEngine(TransformerLM(cfg, device=device), state, num_slots=S, max_seq_len=max_len,
                             block_size=bs, num_blocks=1 + 2 * S * blocks_per_req // 3, eos_token_id=None,
                             pad_token_id=0, gen_kwargs=dict(do_sample=False), seed=SEED, policy=policy,
                             prefix_caching=True, tenants=tenants, device=device)

    V = cfg.vocab_size
    traffic = [
        TenantTraffic("free1", num_requests=n_lo, arrivals_per_round=2.0, prompt_len=(4, P - 2), max_new=(4, N),
                      vocab=V),
        TenantTraffic("free2", num_requests=n_lo, arrivals_per_round=2.0, prompt_len=(4, P - 2), max_new=(4, N),
                      vocab=V),
        TenantTraffic("pro1", num_requests=n_hi, arrivals_per_round=0.5, prompt_len=(4, P - 2), max_new=(4, N),
                      vocab=V, shared_prefix=4),
        TenantTraffic("pro2", num_requests=n_hi, arrivals_per_round=0.5, prompt_len=(4, P - 2), max_new=(4, N),
                      vocab=V),
    ]
    ps_warm(lambda: factory(None), list(range(1, 17)))
    t0 = time.perf_counter()
    report = run_scenario(factory, reg, traffic, chaos_spec=PS_CHAOS_SPEC, dt_s=0.05, max_rounds=800, seed=7,
                          wedge_timeout_s=PS_WEDGE_S, diagnostics_dir=diag_dir)
    return report, time.perf_counter() - t0


def ps_tenant_facts(report):
    """The scheduling facts of a ScenarioReport that the card must share with
    the CPU reference (p99 on the scenario's virtual clock)."""
    return {"terminal": {int(k): v for k, v in report.terminal.items()}, "shed_by_class": dict(report.shed_by_class),
            "restarts": report.restarts, "p99_by_class": dict(report.p99_by_class),
            "outcome_counts": dict(report.outcome_counts)}


def ps_scenario_legs(ctx, cpu_refs):
    """Legs serving_chaos and tenant_scenario on the card (bf16, gpt2 full
    width), held against ``cpu_refs``: the same legs by the port on the CPU."""
    import tempfile

    import numpy as np
    import torch

    from trlx_tpu_torch.serving.scheduler import FINISH_SHED

    cfg = gpt2_config(12, torch.bfloat16)
    diag = tempfile.mkdtemp(prefix="chip_smoke_ps_diag_")
    card = ps_serving_chaos_run(cfg, PS_DEVICE, diag)
    ref = cpu_refs["serving_chaos"]
    lat = card["latency_s"]
    shed = card["reasons"].count(FINISH_SHED)
    emit({"phase": "production_serving", "leg": "serving_chaos", "card": ctx.get("smi"), "dtype": "bfloat16",
          "slots": PS_CHAOS_S, "requests": card["n_req"], "p50_latency_s": float(np.percentile(lat, 50)),
          "p99_latency_s": float(np.percentile(lat, 99)), "shed_rate": shed / card["n_req"],
          "preempted": card["outcome_counts"]["preempted"], "restarts": card["restarts"],
          "req_s": card["n_req"] / card["wall_s"], "delivered_tok_s": card["delivered_tokens"] / card["wall_s"],
          "wall_s": card["wall_s"], "outcome_counts": card["outcome_counts"],
          "cpu_reference": {"outcome_counts": ref["outcome_counts"], "restarts": ref["restarts"],
                            "wall_s": ref["wall_s"]}})
    chaos_checks = {
        "one terminal state per uid (ps_drive) and no block leaked": card["blocks_in_use"] == 0,
        "terminal reasons == the CPU reference's, uid for uid": card["reasons"] == ref["reasons"],
        "outcome counts == the CPU reference's": card["outcome_counts"] == ref["outcome_counts"],
        "restarts == the CPU reference's": card["restarts"] == ref["restarts"] >= 3,
        "no request expired (300 s TTL)": card["outcome_counts"]["expired"] == 0,
    }

    report, wall = ps_tenant_run(cfg, PS_DEVICE, diag)
    facts, ref_facts = ps_tenant_facts(report), cpu_refs["tenant_scenario"]
    by_class = {}
    for req in report.requests.values():
        by_class[req.slo_class] = by_class.get(req.slo_class, 0) + 1
    emit({"phase": "production_serving", "leg": "tenant_scenario", "card": ctx.get("smi"), "dtype": "bfloat16",
          "slots": PS_TEN_S, "submitted": report.submitted, "rounds": report.rounds, "restarts": report.restarts,
          "quota_violations": report.quota_violations, "fairness_jain": report.fairness_jain,
          "p99_by_class_virtual_s": report.p99_by_class,
          "shed_rate_by_class": {c: report.shed_by_class.get(c, 0) / n for c, n in sorted(by_class.items())},
          "outcome_counts": report.outcome_counts, "req_s": report.submitted / wall, "wall_s": wall,
          "cpu_reference_equal": {k: facts[k] == ref_facts[k] for k in facts}})
    tenant_checks = {
        "quota_violations == 0": report.quota_violations == 0,
        "one terminal state per uid": set(report.terminal) == set(report.requests),
        "p99 ordering by class": report.p99_ordering_ok(),
        "no block leaked": report.gauges.get("serving/blocks_in_use") == 0.0,
        "scheduling facts == the CPU reference's": facts == ref_facts,
        "restarted under chaos": report.restarts >= 1,
    }
    failed = [f"serving_chaos: {k}" for k, ok in chaos_checks.items() if not ok]
    failed += [f"tenant_scenario: {k}" for k, ok in tenant_checks.items() if not ok]
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"production_serving: {failed}")


def ps_stream_overlap(ctx):
    """Leg stream_overlap: train_serving's trainer (gpt2 full width, bf16
    compute, 64 greedy rollouts of SHORT_N tokens, spec_k 4, prefill_chunk 64,
    block 16) with ``stream_overlap`` (2 reward workers, microbuckets of
    chunk_size) and ``serving_resilience`` (the supervisor wraps the
    engine), the reward stand-in sleeping PS_REWARD_SLEEP_S a sample. A
    warm-up phase (prepare_learning), then a serial and a streamed
    experience phase on the same weights and prompts, a serialized phase
    (TRLX_OVERLAP_SEED_REGRESSION=serialize), a streamed phase under
    ``serving-decode:1,producer-wedge:1``, and one PPO epoch consuming the
    staged learner batches of that phase."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.resilience.chaos import chaos
    from trlx_tpu_torch.utils.loading import get_trainer

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ps_overlap_")
    cfg = TRLConfig.update(full_width_train_config(ckpt_dir), {
        "train.serving": {"enabled": True, "block_size": 16, "spec_k": 4, "prefill_chunk": 64,
                          "stream_overlap": True, "overlap_reward_workers": 2, "overlap_microbucket": 0},
        "train.serving_resilience": {"enabled": True, "max_restarts": 4},
        **short_traffic(do_sample=False)})
    calls, lock = [], threading.Lock()

    def reward_fn(samples, prompts, outputs, **kw):
        time.sleep(PS_REWARD_SLEEP_S * len(samples))  # a reward-model call
        with lock:
            calls.extend(samples)
        return byte_share_reward(samples, prompts, outputs)

    trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device=PS_DEVICE)
    prompts = PromptPipeline(byte_prompts(64, 64, 128, SEED + 1), TRAIN_P, trainer.tokenizer)
    n = cfg.method.num_rollouts
    trainer.add_prompt_pipeline(prompts)
    try:
        trainer.prepare_learning()  # resolves the supervised engine; a streamed warm-up phase
        runs = []

        def experience(label, stream, chaos_spec=None, serialize=False):
            trainer.config.train.serving.stream_overlap = stream
            trainer.add_prompt_pipeline(prompts)  # the same prompts in every run
            trainer.store.clear_history()
            calls.clear()
            if serialize:
                os.environ["TRLX_OVERLAP_SEED_REGRESSION"] = "serialize"
            chaos.configure(chaos_spec)
            restarts0 = trainer._serving_engine.restarts
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                trainer.make_experience(n, trainer.iter_count)
                torch.cuda.synchronize()
            finally:
                chaos.configure(None)
                os.environ.pop("TRLX_OVERLAP_SEED_REGRESSION", None)
            run = {"label": label, "stream": stream, "experience_s": time.perf_counter() - t0,
                   "rows": list(trainer.store.history), "calls": sorted(calls),
                   "restarts": trainer._serving_engine.restarts - restarts0,
                   "overlap": dict(trainer.last_overlap) if stream else None,
                   "phase_time": dict(trainer._phase_time),
                   "blocks_in_use": trainer._serving_engine.allocator.blocks_in_use}
            runs.append(run)
            return run

        # one serial and one streamed phase (in turns with a repeat of each
        # until PR 14 cut them for the script's time limit)
        serial = experience("serial", False)
        streamed = experience("streamed", True)
        serialized = experience("serialize", True, serialize=True)
        chaotic = experience("chaos", True, chaos_spec="serving-decode:1,producer-wedge:1")
        # one PPO epoch over the chaos phase's store, consuming its staged batches
        staged0 = len(trainer._staged_learn)
        pops, pop = [], trainer._pop_staged_learn
        trainer._pop_staged_learn = lambda batch: pops.append(pop(batch)) or pops[-1]
        steps = []
        t0 = time.perf_counter()
        for batch in trainer.create_train_dataloader():
            steps.append(trainer.train_step(batch))
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
    finally:
        trainer.on_learn_end()
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    def dump(run):
        return [(np.asarray(e.query_tensor).tolist(), np.asarray(e.response_tensor).tolist()) for e in run["rows"]]

    def close(a, b):
        return all(np.all(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))
                          <= 2e-2 * np.maximum(1.0, np.abs(np.asarray(y, np.float64))))
                   for ea, eb in zip(a["rows"], b["rows"]) for x, y in ((ea.logprobs, eb.logprobs),
                                                                      (ea.values, eb.values)))

    ref = dump(serial)
    differing = sum(1 for a, b in zip(dump(chaotic), ref) if a != b)
    for run in runs:
        ov = run["overlap"] or {}
        emit({"phase": "production_serving", "leg": "stream_overlap", "run": run["label"], "card": ctx.get("smi"),
              "experience_s": run["experience_s"], "decode_busy_s": ov.get("decode_busy_s"),
              "overlapped_s": ov.get("overlapped_s"), "overlap_fraction": ov.get("fraction"),
              "bubble_s": (ov["work_s"] - ov["overlapped_s"]) if ov else None,
              "phase_time": run["phase_time"], "restarts": run["restarts"], "reward_calls": len(run["calls"])})
    losses = [v for st in steps for k, v in st.items() if k.startswith("losses/")]
    emit({"phase": "production_serving", "leg": "stream_overlap", "card": ctx.get("smi"), "epoch_s": epoch_s,
          "learner_steps": len(steps), "staged_batches": staged0, "consumed_from_stage": sum(p is not None for p in pops),
          "chaos_rows_differing_from_serial": differing, "losses": {k: v for k, v in steps[-1].items()
                                                                    if k.startswith("losses/")}})
    frac = [streamed["overlap"]["fraction"]]
    checks = {
        "streamed tokens and store order == serial": dump(streamed) == ref,
        "raw scores == serial": streamed["calls"] == serial["calls"] and len(serial["calls"]) == n,
        "logprobs and values within 2e-2 x max(1, |ref|)": close(streamed, serial),
        "serialize: fraction below the streamed runs' and 0.5": serialized["overlap"]["fraction"] < min(
            min(frac), 0.5),
        "chaos: reward_fn once per rollout": len(chaotic["calls"]) == len(set(chaotic["calls"])) == n,
        "chaos: store whole, in submission order": [q for q, _ in dump(chaotic)] == [q for q, _ in ref],
        "chaos: the supervisor restarted": chaotic["restarts"] >= 1,
        "no block in use after a phase": all(r["blocks_in_use"] == 0 for r in runs),
        "every first-epoch batch from the stage": staged0 == len(steps) == n // TRAIN_B and all(
            p is not None for p in pops),
        "losses finite": bool(losses) and all(np.isfinite(v) for v in losses),
    }
    failed = [k for k, ok in checks.items() if not ok]
    del trainer
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"production_serving stream_overlap: {failed}")


def phase_production_serving(ctx):
    """A main path: production serving on one engine (:func:`ps_resilience_parity`,
    :func:`ps_scenario_legs`, :func:`ps_stream_overlap`). The CPU references
    of the two scenario legs run first; then launch counts are set to 0,
    the four card legs run, and the counts are read: K1 (prefill waves,
    scoring, the learner's loss forward), K2/K3 (the PPO epoch), K4 (the
    resilience and scenario engines) and K5 (the trainer's spec engine)
    must all have launched, and every recorded shape is held against the
    plain versions."""
    import tempfile

    from trlx_tpu_torch.ops import _kernels

    cpu = ps_cpu_config()
    diag = tempfile.mkdtemp(prefix="chip_smoke_ps_cpu_diag_")
    t0 = time.perf_counter()
    report, _ = ps_tenant_run(cpu, "cpu", diag)
    cpu_refs = {"serving_chaos": ps_serving_chaos_run(cpu, "cpu", diag), "tenant_scenario": ps_tenant_facts(report)}
    emit({"phase": "production_serving", "cpu_references_s": time.perf_counter() - t0})
    seen = {}
    restore_kernels = record_kernel_shapes(seen)
    legs = {}
    _kernels.reset_launches()
    try:
        for name, leg in (("resilience_parity", lambda: ps_resilience_parity(ctx)),
                          ("scenarios", lambda: ps_scenario_legs(ctx, cpu_refs)),
                          ("stream_overlap", lambda: ps_stream_overlap(ctx))):
            before, t1 = dict(_kernels.launches()), time.perf_counter()
            leg()
            legs[name] = {"s": time.perf_counter() - t1,
                          "launches": {k: _kernels.launches()[k] - before[k] for k in before}}
    finally:
        restore_kernels()
    launches = _kernels.launches()
    ctx["production_serving_launches"] = launches
    emit({"phase": "production_serving", "legs": legs, "launches": launches, "kernel_shapes": kernel_shapes(seen)})
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"production_serving phase: kernels never launched on the path: {missing}")
    check_main_path_shapes(ctx, seen, "production_serving", ("flash_fwd", "flash_bwd", "paged_decode",
                                                             "paged_verify"))


#: phase serving_fleet, leg fleet_of_one: the first SF_ONE_REQ requests of
#: serving_traffic through SF_ONE_SLOTS slots, a bare engine against a fleet
#: of one replica
SF_ONE_REQ, SF_ONE_SLOTS = 128, 64
#: leg fleet_scenario: the card sizes of the JAX package's fleet leg
#: (bench.py:_fleet_perf): S slots a replica, prompts 4..P-2 tokens, budgets
#: 4..N, LO requests per free tenant and HI per pro tenant, block 16
SF_S, SF_P, SF_N, SF_LO, SF_HI = 16, 64, 32, 64, 32
#: the fleet chaos of that leg: one replica kill, two mis-routes
SF_CHAOS_SPEC = "fleet-replica-kill:1,fleet-route:2"
#: leg online_fleet: replicas x slots serving the online_grpo traffic
SF_ONLINE_REPLICAS, SF_ONLINE_SLOTS = 2, 64
#: leg islands_bubble: slots of the saturated engine, each request's budget,
#: the measured window (s), chunk_layers and the pause between chunks (s)
SF_BUBBLE_SLOTS, SF_BUBBLE_N, SF_BUBBLE_WINDOW_S, SF_BUBBLE_CHUNKS, SF_BUBBLE_PAUSE_S = 64, 64, 2.0, 2, 0.002
#: leg islands_trainer and fleet_trainer: learner steps
SF_ISLAND_STEPS, SF_FLEET_STEPS = 4, 2
#: after each leg, device memory must be back within this many bytes of
#: where the leg started (a retired replica drops its trunk and KV pools)
SF_MEM_SLACK = 64 * 2 ** 20


class SfRuns:
    """The launch counts of phase serving_fleet's runs on its path (a router,
    a fleet trainer, an island): each run is counted from 0, the counts set
    to 0 just before it and read just after, and the path's launches are the
    sum over its runs. A leg's references (bare engines, the single-engine
    trainer, warm-ups) run outside every window and count for no path."""

    def __init__(self):
        self.runs = {}

    @contextlib.contextmanager
    def count(self, name):
        from trlx_tpu_torch.ops import _kernels

        _kernels.reset_launches()
        try:
            yield
        finally:
            self.runs[name] = _kernels.launches()

    def total(self, names=None):
        names = list(self.runs) if names is None else names
        return {k: sum(self.runs[n][k] for n in names) for k in next(iter(self.runs.values()))}


def sf_memory():
    """Allocated device bytes once garbage is collected (cycles between an
    engine and its island are freed only by the collector)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def sf_fleet_of_one(ctx, runs):
    """Leg fleet_of_one: a ``FleetRouter`` of one replica and a bare
    ``ServingEngine`` (gpt2 full width, bf16, greedy, 64 slots) on the same
    128 requests of ``serving_traffic``: uids, tokens and finish reasons
    ``==`` (seat 0 counts uids from 0 and samples from the engine's seed),
    after a second bare engine has repeated the first token for token."""
    import torch

    from trlx_tpu_torch.fleet import FleetRouter

    prompts, budgets = serving_traffic(gpt2_config(12, torch.bfloat16).vocab_size)
    prompts, budgets = prompts[:SF_ONE_REQ], budgets[:SF_ONE_REQ]

    def run(srv):
        t0 = time.perf_counter()
        uids = [srv.submit(p, n) for p, n in zip(prompts, budgets)]
        done = ps_drive(srv, uids)
        torch.cuda.synchronize()
        return {"uids": uids, "rows": [list(done[u].generated) for u in uids],
                "reasons": [done[u].finish_reason for u in uids], "wall_s": time.perf_counter() - t0}

    bare, state = full_width_engine(False, num_slots=SF_ONE_SLOTS)
    ref = run(bare)
    ref["blocks_in_use"] = bare.allocator.blocks_in_use
    bare.close()
    # a second bare engine: the engine repeats itself on the card (each
    # shared prefix slot is written once a wave, engine.pack_targets)
    again = full_width_engine(False, state, num_slots=SF_ONE_SLOTS)[0]
    repeat = run(again)
    again.close()
    with runs.count("fleet_of_one"):
        router = FleetRouter(lambda seat: full_width_engine(False, state, num_slots=SF_ONE_SLOTS)[0], 1,
                             wedge_timeout_s=None)
        got = run(router)
        got["blocks_in_use"] = sum(h.supervisor.engine.allocator.blocks_in_use for h in router._live_handles())
        summary = router.summary()
        router.close()
    tokens = sum(len(r) for r in got["rows"])
    emit({"phase": "serving_fleet", "leg": "fleet_of_one", "card": ctx.get("smi"), "requests": SF_ONE_REQ,
          "slots": SF_ONE_SLOTS, "bare_wall_s": [ref["wall_s"], repeat["wall_s"]], "fleet_wall_s": got["wall_s"],
          "rows_off_the_bare_engine": sum(a != b for a, b in zip(got["rows"], ref["rows"])),
          "bare_tok_s": tokens / ref["wall_s"], "fleet_tok_s": tokens / got["wall_s"],
          "fleet_routed": summary["fleet_routed"]})
    return {
        "a second bare engine repeats the first, token for token": repeat["rows"] == ref["rows"],
        "uids == the bare engine's": got["uids"] == ref["uids"] == list(range(SF_ONE_REQ)),
        "tokens == the bare engine's": got["rows"] == ref["rows"],
        "finish reasons == the bare engine's": got["reasons"] == ref["reasons"],
        "no block in use": got["blocks_in_use"] == ref["blocks_in_use"] == 0,
    }


def sf_scenario_run(cfg, device, diag_dir, runs=None):
    """One run of leg fleet_scenario on ``device``: bench.py:_fleet_perf through
    ``run_fleet_scenario`` (3 replicas of SF_S slots, 4 tenants in 2 classes,
    SF_CHAOS_SPEC, the autoscaler between 1 and 4 replicas, seed 7, the
    wedge timer PS_WEDGE_S). Replica i samples from seed i. With ``runs``
    the scenario (not its warm-up) is counted as run ``fleet_scenario``.
    Returns (report, wall seconds)."""
    from trlx_tpu_torch.fleet import run_fleet_scenario
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.serving import ServingEngine, ServingResiliencePolicy, TenantRegistry, TenantTraffic

    S, P, N, n_lo, n_hi = SF_S, SF_P, SF_N, SF_LO, SF_HI
    bs = 16
    max_len = P + N + 4  # +4: the pro tenants prepend a shared prefix
    blocks_per_req = -(-max_len // bs)
    state = TransformerLM(cfg, device=device).init_params(SEED).state_dict()
    reg = TenantRegistry(class_ttl_s={0: 8.0, 1: 16.0})
    reg.register("free1", slo_class=0, kv_block_quota=blocks_per_req)
    reg.register("free2", slo_class=0, kv_block_quota=blocks_per_req)
    reg.register("pro1", slo_class=1)
    reg.register("pro2", slo_class=1)
    policy = ServingResiliencePolicy(max_pending=16, high_watermark=1.0, low_watermark=0.5, preemption=True)

    def factory(seat, tenants=reg):
        return ServingEngine(TransformerLM(cfg, device=device), state, num_slots=S, max_seq_len=max_len,
                             block_size=bs, num_blocks=1 + 2 * S * blocks_per_req // 3, eos_token_id=None,
                             pad_token_id=0, gen_kwargs=dict(do_sample=False), seed=seat, policy=policy,
                             prefix_caching=True, tenants=tenants, device=device)

    V = cfg.vocab_size
    traffic = [TenantTraffic(t, num_requests=n, arrivals_per_round=rate, prompt_len=(4, P - 2), max_new=(4, N),
                             vocab=V, shared_prefix=prefix)
               for t, n, rate, prefix in (("free1", n_lo, 2.0, 0), ("free2", n_lo, 2.0, 0), ("pro1", n_hi, 0.5, 4),
                                          ("pro2", n_hi, 0.5, 4))]
    ps_warm(lambda: factory(0, None), list(range(1, 17)))
    t0 = time.perf_counter()
    with runs.count("fleet_scenario") if runs is not None else contextlib.nullcontext():
        report = run_fleet_scenario(factory, reg, traffic, num_replicas=3, chaos_spec=SF_CHAOS_SPEC, dt_s=0.05,
                                    max_rounds=800, seed=7, wedge_timeout_s=PS_WEDGE_S, diagnostics_dir=diag_dir,
                                    autoscale=True, min_replicas=1, max_replicas=4, scale_down_occupancy=0.3,
                                    breach_rounds=3, cooldown_rounds=4, idle_tail_rounds=30)
    return report, time.perf_counter() - t0


def sf_scenario_facts(report):
    """The scheduling facts of a fleet scenario that the card must share with
    the CPU reference: each uid's terminal reason and accepting seat (its uid
    block), kills, re-routes, restarts, autoscale events, the affinity hit
    rate and its random baseline, quota violations, outcome counts, the
    fleet's size, and p99 by class on the scenario's virtual clock. (At
    these sizes both hit rates are 0: the pro tenants' 4-token shared prefix
    fills no 16-token block, so no replica ever holds a warm prefix block.)"""
    from trlx_tpu_torch.fleet import UID_STRIDE

    return {"terminal": {int(u): [r, int(u) // UID_STRIDE] for u, r in report.terminal.items()},
            "replica_kills": report.replica_kills, "reroutes": report.reroutes, "restarts": report.restarts,
            "autoscale_events": [list(e) for e in report.autoscale_events],
            "affinity_hit_rate": report.affinity_hit_rate, "random_hit_rate": report.random_hit_rate,
            "quota_violations": report.quota_violations, "outcome_counts": dict(report.outcome_counts),
            "replicas_peak": report.replicas_peak, "replicas_final": report.replicas_final,
            "p99_by_class": dict(report.p99_by_class)}


def sf_fleet_scenario(ctx, cpu_facts, runs):
    """Leg fleet_scenario on the card (bf16, gpt2 full width), held against
    ``cpu_facts``: the same leg by the port on the CPU (2 layers, hidden 64)."""
    import tempfile

    import torch

    report, wall = sf_scenario_run(gpt2_config(12, torch.bfloat16), PS_DEVICE,
                                   tempfile.mkdtemp(prefix="chip_smoke_sf_diag_"), runs)
    facts = sf_scenario_facts(report)
    tokens = sum(len(r.generated) for r in report.requests.values())
    # each live replica's own pool (its per-tenant census gauges keep a
    # tenant's last non-zero count, as the reference's do)
    blocks = {k: v for k, v in report.gauges.items()
              if k.startswith("serving/replica/") and k.count("/") == 3 and k.endswith("/blocks_in_use")}
    emit({"phase": "serving_fleet", "leg": "fleet_scenario", "card": ctx.get("smi"), "dtype": "bfloat16",
          "slots_per_replica": SF_S, "submitted": report.submitted, "rounds": report.rounds,
          "req_s": report.submitted / wall, "delivered_tok_s": tokens / wall, "wall_s": wall,
          "p99_by_class_virtual_s": report.p99_by_class, "affinity_hit_rate": report.affinity_hit_rate,
          "random_hit_rate": report.random_hit_rate, "sticky_hit_rate": report.sticky_hit_rate,
          "replica_kills": report.replica_kills, "reroutes": report.reroutes, "restarts": report.restarts,
          "autoscale_events": report.autoscale_events, "replicas_peak": report.replicas_peak,
          "replicas_final": report.replicas_final, "quota_violations": report.quota_violations,
          "outcome_counts": report.outcome_counts, "fairness_jain": report.fairness_jain,
          "cpu_reference_equal": {k: facts[k] == cpu_facts[k] for k in facts}})
    return {
        "scheduling facts == the CPU reference's": facts == cpu_facts,
        "one terminal state per accepted uid": set(report.terminal) == set(report.requests)
        and len(report.terminal) == report.submitted - report.rejected,
        "one replica killed, its requests re-routed": report.replica_kills == 1 and report.reroutes >= 1,
        "autoscaled (an up or a drain)": bool(report.autoscale_events),
        "quota_violations == 0": report.quota_violations == 0,
        "p99 ordering by class": report.p99_ordering_ok(),
        "no block left on a replica": bool(blocks) and all(v == 0.0 for v in blocks.values()),
    }


def sf_fleet_trainer(ctx, runs):
    """Leg fleet_trainer: train_serving's trainer (gpt2 full width, 64 greedy
    rollouts of SHORT_N tokens, spec_k 4, prefill_chunk 64, block 16) with
    ``train.serving_fleet`` (2 replicas, autoscale on, at most 2, no
    tenant stickiness) and ``serving_resilience``, through
    ``trlx_tpu_torch.train`` for 2 steps.
    Its first experience phase is set beside a single-engine trainer's at
    the same seed (greedy): rows that differ are reported with their
    tie-aware splits (replicas batch differently), not held.
    Before it, the same trainer at the fleet's default weights takes its
    first experience phase: with one tenant, stickiness (0.25 per recent
    route) outgrows the load term (2.0 per ``num_slots`` requests), so every
    route lands on seat 0, as in the reference
    (tests/test_torch_serving_fleet.py)."""
    import collections
    import shutil
    import tempfile

    import numpy as np
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.fleet import FleetRouter
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.utils.loading import get_trainer

    prompts = byte_prompts(64, 64, 128, SEED + 1)

    def config(fleet, **weights):
        ckpt = tempfile.mkdtemp(prefix="chip_smoke_sf_trainer_")
        over = {"train.serving": {"enabled": True, "block_size": 16, "spec_k": 4, "prefill_chunk": 64},
                **short_traffic(do_sample=False), "train.total_steps": SF_FLEET_STEPS}
        if fleet:
            over.update({"train.serving_fleet": dict(enabled=True, num_replicas=2, autoscale=True, max_replicas=2,
                                                     **weights),
                         "train.serving_resilience": dict(enabled=True, max_restarts=4)})
        return TRLConfig.update(full_width_train_config(ckpt), over)

    def first_experience(cfg):
        """A trainer's first experience phase only; returns its trainer and rows."""
        trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=byte_share_reward, device=PS_DEVICE)
        trainer.add_prompt_pipeline(PromptPipeline(prompts, TRAIN_P, trainer.tokenizer))
        trainer.prepare_learning()
        rows = list(trainer.store.history)
        trainer.on_learn_end()
        trainer.resilience.close()  # what learn() would release
        trainer.obs.close()
        return trainer, rows

    # the single-engine reference, outside every counted run
    ref_cfg = config(False)
    ref, ref_rows = first_experience(ref_cfg)
    default_cfg = config(True)

    routes, popped, phases, gens, steps, routers = [], [], [], [], [], []
    originals = {"submit": FleetRouter.submit, "_pop_finished": FleetRouter._pop_finished,
                 "push_to_store": PPOTrainer.push_to_store, "_serving_generate": PPOTrainer._serving_generate,
                 "train_step": PPOTrainer.train_step, "on_learn_end": PPOTrainer.on_learn_end}

    def submit(self, *a, **kw):
        uid = originals["submit"](self, *a, **kw)
        routes.append((uid, self.replica_of(uid)))
        return uid

    def pop_finished(self):
        out = originals["_pop_finished"](self)
        popped.extend(out)
        return out

    def push_to_store(self, data):
        phases.append(list(data))
        return originals["push_to_store"](self, data)

    def serving_generate(self, *a, **kw):
        out = originals["_serving_generate"](self, *a, **kw)
        gens.append(sum(h.supervisor.engine.allocator.blocks_in_use for h in self._serving_engine._live_handles()))
        return out

    def train_step(self, batch):
        before = dict(_kernels.launches())
        out = originals["train_step"](self, batch)
        steps.append((out, {k: _kernels.launches()[k] - before[k] for k in before}))
        return out

    def on_learn_end(self):
        routers.append(self._serving_engine)
        return originals["on_learn_end"](self)

    FleetRouter.submit, FleetRouter._pop_finished = submit, pop_finished
    PPOTrainer.push_to_store, PPOTrainer._serving_generate = push_to_store, serving_generate
    PPOTrainer.train_step, PPOTrainer.on_learn_end = train_step, on_learn_end
    # tenant_weight 0 for the trained run, so that both seats take rollouts
    cfg = config(True, tenant_weight=0.0)
    try:
        with runs.count("fleet_trainer_default_weights"):
            first_experience(default_cfg)
        default_routes, default_popped = list(routes), collections.Counter(popped)
        for recorded in (routes, popped, phases, gens, steps, routers):
            recorded.clear()
        t0 = time.perf_counter()
        with runs.count("fleet_trainer"):
            trlx_tpu_torch.train(reward_fn=byte_share_reward, prompts=prompts,
                                 eval_prompts=byte_prompts(32, 64, 128, SEED + 2), config=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        FleetRouter.submit, FleetRouter._pop_finished = originals["submit"], originals["_pop_finished"]
        for name in ("push_to_store", "_serving_generate", "train_step", "on_learn_end"):
            setattr(PPOTrainer, name, originals[name])
        for c in (cfg, ref_cfg, default_cfg):
            shutil.rmtree(c.train.checkpoint_dir, ignore_errors=True)

    def dump(rows):
        return [(np.asarray(e.query_tensor).tolist(), np.asarray(e.response_tensor).tolist()) for e in rows]

    got, want = dump(phases[0]), dump(ref_rows)
    splits = tie_aware_splits(ref.model.transformer, [q for q, _ in want], [r for _, r in got],
                              [r for _, r in want])
    router = routers[0]
    engines_released = all(h.supervisor.engine.trunk is None for h in router._all_handles())
    summary = {k: v for k, v in steps[-1][0].items() if k.startswith("fleet/")}
    L, num_mb = 12, TRAIN_B // TRAIN_MB
    counts = collections.Counter(popped)
    finite = all(np.isfinite(v) for out, _ in steps for k, v in out.items() if k.startswith("losses/"))
    emit({"phase": "serving_fleet", "leg": "fleet_trainer", "card": ctx.get("smi"), "wall_s": wall,
          "steps": len(steps), "experience_phases": len(phases), "routes_by_seat": dict(collections.Counter(
              s for _, s in routes)), "default_weights_routes_by_seat": dict(collections.Counter(
              s for _, s in default_routes)), "fleet_gauges_last_step": summary,
          "rows_differing_from_single_engine": len(splits), "splits": splits,
          "losses": {k: v for k, v in steps[-1][0].items() if k.startswith("losses/")}})
    return {
        f"{SF_FLEET_STEPS} optimizer steps, losses finite": len(steps) == SF_FLEET_STEPS and finite,
        "one terminal state per uid": bool(routes) and set(counts) == {u for u, _ in routes}
        and set(counts.values()) == {1},
        "both seats receive routes (tenant_weight 0)": {s for _, s in routes} == {0, 1},
        "default weights: every route on seat 0, as the reference": len(default_routes) == 64
        and {s for _, s in default_routes} == {0},
        "default weights: one terminal state per uid": set(default_popped) == {u for u, _ in default_routes}
        and set(default_popped.values()) == {1},
        "store whole and in order": len(got) == len(want) == 64 and [q for q, _ in got] == [q for q, _ in want],
        "no KV block left on any replica after a generation": bool(gens) and all(b == 0 for b in gens),
        "K2 and K3 per step": all(d["flash_bwd_dkv"] == d["flash_bwd_dq"] == L * num_mb for _, d in steps),
        "fleet gauges in the step stats": summary.get("fleet/routed", 0) > 0,
        "every replica released after learn()": engines_released,
    }


def sf_online_fleet(ctx, runs):
    """Leg online_fleet: phase online_grpo's traffic (4 waves of 32 prompts x
    4, 64-byte prompts, 40 sampled tokens) through a ``FleetRouter`` of 2
    replicas x 64 slots (gpt2 full width, bf16, block 16), harvested by a
    ``PreferenceCollector`` with ``harvest(router)``; ``fleet-replica-kill:1``
    fires during wave 2. A ``GRPOTrainer`` takes 4 steps on the drained
    groups, ``router.set_params`` republishes its trunk to every live
    replica, and one more wave is banked at ``policy_version=1``."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_grpo_config
    from trlx_tpu_torch.fleet import FleetRouter
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.online import OnlineExperienceBuffer, PreferenceCollector
    from trlx_tpu_torch.resilience.chaos import chaos
    from trlx_tpu_torch.serving import ServingEngine
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.update(default_grpo_config(), {
        "model.model_path": "gpt2", "model.model_overrides": {"attention_impl": "flash"},
        "mesh.compute_dtype": "bfloat16", "mesh.param_dtype": "float32", "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": ONLINE_PROMPT_BYTES + GRPO_N, "train.batch_size": GRPO_B,
        "train.minibatch_size": GRPO_MB, "train.total_steps": 4, "train.eval_interval": 100,
        "train.checkpoint_interval": 100, "train.save_best": False, "train.save_optimizer": False,
        "train.tracker": None, "train.checkpoint_dir": tempfile.mkdtemp(prefix="chip_smoke_sf_online_"),
        "train.seed": SEED, "method.num_rollouts": GRPO_PROMPTS * GRPO_G,
        "method.chunk_size": GRPO_PROMPTS * GRPO_G, "method.ppo_epochs": 1,
        "train.online": dict(enabled=True, group_size=GRPO_G, buffer_capacity=256, max_staleness=4),
    })
    trainer = get_trainer("GRPOTrainer")(config=cfg, device=PS_DEVICE)
    vocab = trainer.model_config.vocab_size
    state = trainer.model.transformer.state_dict()

    def factory(seat):
        return ServingEngine(TransformerLM(gpt2_config(12, torch.bfloat16)), state, num_slots=SF_ONLINE_SLOTS,
                             max_seq_len=ONLINE_PROMPT_BYTES + GRPO_N, block_size=16,
                             eos_token_id=trainer.tokenizer.eos_token_id, pad_token_id=0,
                             gen_kwargs=dict(do_sample=True), seed=SEED + seat, device=PS_DEVICE)

    def reward_fn(prompt, completions):
        return [float(np.mean(c)) / vocab for c in completions]

    with runs.count("online_fleet"):  # the router's build to its close, the GRPO steps between
        router = FleetRouter(factory, SF_ONLINE_REPLICAS, wedge_timeout_s=None, backoff_base_s=0.01)
        buffer = OnlineExperienceBuffer(capacity=256, max_staleness=4)
        collector = PreferenceCollector(buffer, group_size=GRPO_G, reward_fn=reward_fn)
        prompts = [trainer.tokenizer.encode(p) for p in byte_prompts(GRPO_PROMPTS, ONLINE_PROMPT_BYTES,
                                                                     ONLINE_PROMPT_BYTES, SEED + 40)]
        delivered = {}
        pop = router._pop_finished

        def recorded_pop():
            out = pop()
            delivered.update(out)
            return out

        router._pop_finished = recorded_pop  # the collector's harvest(router) pops through here
        routes_by_seat = {}

        def wave(version, kill=False):
            uids = [router.submit(p, GRPO_N) for p in prompts for _ in range(GRPO_G)]
            for uid in uids:
                seat = router.replica_of(uid)
                routes_by_seat[seat] = routes_by_seat.get(seat, 0) + 1
            got = 0
            if kill:
                router.step()
                chaos.configure("fleet-replica-kill:1")
            try:
                while router.scheduler.has_work:
                    router.step()
                    got += collector.harvest(router, policy_version=version)
            finally:
                chaos.configure(None)
            router.export_gauges()
            return got + collector.harvest(router, policy_version=version), uids

        steps = []
        t0 = time.perf_counter()
        try:
            waves = [wave(0, kill=(i == 1)) for i in range(ONLINE_WAVES)]
            torch.cuda.synchronize()
            harvest_s = time.perf_counter() - t0
            kills = router.ledger.summary()["fleet_replica_kills"]
            first_pass = collector.stats()
            replay = collector.harvest(dict(delivered), policy_version=0)
            trainer.attach_online(buffer)
            original = trainer.train_step

            def recorded(batch):
                out = original(batch)
                steps.append(out)
                return out

            trainer.train_step = recorded
            t1 = time.perf_counter()
            trainer.learn()
            torch.cuda.synchronize()
            learn_s = time.perf_counter() - t1
            router.set_params(trainer.model.transformer.state_dict())
            trunk = {k: v.to(torch.bfloat16) for k, v in trainer.model.transformer.state_dict().items()}
            republished = [all(torch.equal(v, trunk[k]) for k, v in h.supervisor.engine.trunk.state_dict().items())
                           for h in router._live_handles()]
            post, _ = wave(1)
            drained = buffer.drain(256, learner_version=1)
            burn = router.ledger.burn_rates()
            blocks = sum(h.supervisor.engine.allocator.blocks_in_use for h in router._live_handles())
            summary = router.summary()
            stats = collector.stats()
        finally:
            router.close()
        shutil.rmtree(cfg.train.checkpoint_dir, ignore_errors=True)
    labels = ONLINE_WAVES * GRPO_PROMPTS * GRPO_G
    emit({"phase": "serving_fleet", "leg": "online_fleet", "card": ctx.get("smi"),
          "harvested_per_wave": [g for g, _ in waves], "post_publish": post, "replica_kills": kills,
          "replay_harvested": replay, "collector_before_replay": first_pass, "collector": stats,
          "routes_by_seat": routes_by_seat, "online_labels_per_s": labels / harvest_s,
          "harvest_s": harvest_s, "learn_s": learn_s, "steps": len(steps), "burn_rates": burn,
          "fleet": {k: summary[k] for k in ("fleet_routed", "fleet_reroutes", "fleet_affinity_hit_rate",
                                            "fleet_random_hit_rate", "replicas")}})
    per_wave = GRPO_PROMPTS * GRPO_G
    all_uids = [u for _, uids in waves for u in uids]
    return {
        "every uid harvested exactly once": [g for g, _ in waves] == [per_wave] * ONLINE_WAVES
        and set(delivered) >= set(all_uids) and first_pass["duplicates_dropped"] == 0.0
        and first_pass["labels_harvested"] == len(set(all_uids)),
        "a replica killed in wave 2": kills == 1,
        "a replay of the delivered stream harvests 0": replay == 0,
        "slo_held (no SLO burn)": burn["firing"] == 0.0,
        "4 GRPO steps on the drained groups": len(steps) == 4 and steps[0].get("online/groups_consumed") == 32.0
        and all(np.isfinite(s["losses/total_loss"]) for s in steps),
        "set_params republished to every live replica": bool(republished) and all(republished),
        "next wave banked at policy_version 1": post == per_wave
        and [g.policy_version for g in drained][-GRPO_PROMPTS:] == [1] * GRPO_PROMPTS,
        "no KV block left": blocks == 0,
        # every prompt goes out GRPO_G times a wave, so warm prefixes exist
        "prefix affinity beats the random baseline": summary["fleet_affinity_hit_rate"]
        > summary["fleet_random_hit_rate"],
    }


def sf_bubble_run(engine, learner_state, prompts, mode, chaos_check=False):
    """One islands_bubble window: ``engine`` (saturated by a driver thread)
    as a ``GenerationIsland``, a learner thread alternating an in-place
    x0.999 update of ``learner_state`` (synced through a CUDA event) with a
    chunked publish through the island's gate. ``mode`` "blocking" sets
    TRLX_ISLAND_SEED_REGRESSION=blocking_broadcast for the publisher.
    Returns the run's numbers and checks."""
    import threading

    import torch

    from trlx_tpu_torch.resilience.chaos import ChaosInjectedError, chaos
    from trlx_tpu_torch.rollout import ChunkedParameterPublisher
    from trlx_tpu_torch.serving import GenerationIsland
    from trlx_tpu_torch.utils.metrics import gauges

    island = GenerationIsland(engine)
    if mode == "blocking":
        os.environ["TRLX_ISLAND_SEED_REGRESSION"] = "blocking_broadcast"
    try:
        pub = ChunkedParameterPublisher(chunk_layers=SF_BUBBLE_CHUNKS, chunk_pause_s=SF_BUBBLE_PAUSE_S,
                                        round_gate=island.round_gate)
    finally:
        os.environ.pop("TRLX_ISLAND_SEED_REGRESSION", None)
    island.bind_publisher(pub)
    installed = []
    poll = island.poll_swap

    def poll_swap(last_seen):
        upd = poll(last_seen)
        if upd is not None:
            installed[:] = [upd]  # the committed snapshot the engine is about to install
        return upd

    island.poll_swap = poll_swap
    flushes = []
    flush = engine.allocator.flush_prefix_cache
    engine.allocator.flush_prefix_cache = lambda: (flushes.append(1), flush())[1]
    pub.publish(learner_state)
    live, stop, errors = set(), threading.Event(), []

    def drive():
        i = 0
        try:
            while not stop.is_set():
                while len(live) < SF_BUBBLE_SLOTS:
                    live.add(engine.submit(prompts[i % len(prompts)], SF_BUBBLE_N))
                    i += 1
                engine.step()
                for uid in engine.scheduler.pop_finished():
                    engine.scheduler.pop_request(uid)
                    live.discard(uid)
        except BaseException as e:  # surfaced by the caller after join
            errors.append(e)

    def learn():
        try:
            with torch.no_grad():
                while not stop.is_set():
                    t0 = time.monotonic()
                    torch._foreach_mul_(list(learner_state.values()), 0.999)
                    done = torch.cuda.Event()
                    done.record()
                    done.synchronize()
                    island.note_learn(t0, time.monotonic())
                    t1 = time.monotonic()
                    pub.publish(learner_state)
                    island.note_learn(t1, time.monotonic())
        except BaseException as e:
            errors.append(e)

    driver = threading.Thread(target=drive, name="sf-bubble-decode", daemon=True)
    driver.start()
    time.sleep(0.5)  # warm: slots full, the first version installed
    island.open_window()
    learner = threading.Thread(target=learn, name="sf-bubble-learn", daemon=True)
    learner.start()
    time.sleep(SF_BUBBLE_WINDOW_S)
    summary = island.summary()
    stop.set()
    learner.join(timeout=60)
    driver.join(timeout=60)
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    stats = pub.stats()
    version = engine.serving_version
    last_version, last_params = installed[0]
    trunk = engine.trunk.state_dict()
    out = {"mode": mode, **summary, "bytes_s": stats["last_bytes_s"], "broadcast_s": stats["last_broadcast_s"],
           "published": stats["version"] + 1, "chunks": pub.manifest().num_chunks,
           "chunk_bytes": pub.manifest().total_bytes, "flushes": len(flushes),
           "threads_alive": driver.is_alive() or learner.is_alive()}
    checks = {
        "swaps >= 1": summary["swaps"] >= 1,
        "serving the committed snapshot of its serving_version (no torn version)": version == last_version
        and all(torch.equal(trunk[k], last_params[k]) for k in trunk),
        "one prefix flush per swap": len(flushes) == island.summary()["swaps"],
        "no thread left": not out["threads_alive"],
    }
    if chaos_check:
        engine.step()  # installs the newest committed version
        v0 = engine.serving_version
        chaos.configure("broadcast-chunk:1")
        try:
            pub.publish(learner_state)
            aborted_raised = False
        except ChaosInjectedError:
            aborted_raised = True
        finally:
            chaos.configure(None)
        aborted = gauges.get("rollout/broadcast/aborted")
        engine.step()
        kept = engine.serving_version == v0 == pub.version and all(
            torch.equal(v, pub.latest()[1][k]) for k, v in engine.trunk.state_dict().items())
        burned = pub.publish(learner_state) == v0 + 2
        checks.update({"broadcast-chunk:1 aborts the publish": aborted_raised and aborted == 1.0,
                       "the engine keeps serving the previous version": kept,
                       "the aborted version number is burned": burned})
        out["chaos"] = {"aborted_gauge": aborted, "version_kept": v0}
    for uid in list(live):
        engine.cancel(uid)
    engine.run()
    for uid in engine.scheduler.pop_finished():
        engine.scheduler.pop_request(uid)
    island.close()
    engine.allocator.flush_prefix_cache = flush
    return out, checks


def sf_islands_bubble(ctx, runs):
    """Leg islands_bubble (bench.py:_island_perf at full width): a saturated
    64-slot engine (gpt2, bf16, greedy, budgets of 64) driven by one thread as
    a ``GenerationIsland``; a learner thread alternating an in-place x0.999
    update of a clone of the trunk's state with a chunked publish
    (chunk_layers 2, 2 ms pauses) through the island's gate; a 3 s window
    after warm-up, in turns: chunked, blocking_broadcast, chunked,
    blocking_broadcast. The last run also publishes under
    ``broadcast-chunk:1``. On one CUDA stream the broadcast's copies queue
    behind decode work: ``broadcast_hidden_frac`` is the host-clock overlap."""
    results, failed = [], []
    with runs.count("islands_bubble"):
        engine, _ = full_width_engine(False, num_slots=SF_BUBBLE_SLOTS)
        learner_state = {k: v.clone() for k, v in engine.trunk.state_dict().items()}
        prompts, _ = serving_traffic(engine.trunk.config.vocab_size, seed=SEED + 50)
        for i, mode in enumerate(("chunked", "blocking", "chunked", "blocking")):
            out, checks = sf_bubble_run(engine, learner_state, prompts, mode, chaos_check=i == 3)
            out["checks"] = checks
            results.append(out)
            emit({"phase": "serving_fleet", "leg": "islands_bubble", "card": ctx.get("smi"), "run": i + 1, **out})
            failed += [f"run {i + 1} ({mode}): {k}" for k, ok in checks.items() if not ok]
        engine.close()
    emit({"phase": "serving_fleet", "leg": "islands_bubble", "card": ctx.get("smi"),
          "gen_idle_frac": {r["mode"]: [x["gen_idle_frac"] for x in results if x["mode"] == r["mode"]]
                            for r in results}})
    return {**{k: False for k in failed}, "every run's checks": not failed}


def sf_islands_trainer(ctx, runs):
    """Leg islands_trainer: the async phase's trainer (gpt2 full width, 64
    sampled rollouts of SHORT_N tokens, max_staleness 2, publish_interval 1) with
    train_serving's engine (spec_k 4, prefill_chunk 64) and ``train.islands``
    (chunk_layers 2), 4 steps through ``trlx_tpu_torch.train``: the producer
    thread generates through the engine while the learner publishes chunked
    broadcasts the engine swaps at its round boundaries."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.rollout import ChunkedParameterPublisher
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.utils.metrics import gauges

    threads0 = {t.ident for t in threading.enumerate()}
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_sf_islands_")
    cfg = TRLConfig.update(full_width_train_config(ckpt), {
        **short_traffic(do_sample=True), "train.total_steps": SF_ISLAND_STEPS,
        "train.async_rollouts": dict(enabled=True, max_staleness=2, publish_interval=1, staleness_correction=True),
        "train.serving": {"enabled": True, "block_size": 16, "spec_k": 4, "prefill_chunk": 64},
        "train.islands": dict(enabled=True, chunk_layers=2)})
    seen, steps = {}, []
    originals = {name: getattr(PPOTrainer, name) for name in ("_start_async_engine", "on_learn_end", "train_step")}

    def start(self):
        originals["_start_async_engine"](self)
        pub = self._engine.publisher
        seen.update(island=self._island is not None, chunked=type(pub) is ChunkedParameterPublisher,
                    shared_gate=self._island is not None and pub._gate is self._island.round_gate,
                    attached=self._island is not None and self._serving_engine._island is self._island,
                    seed_version=pub.version, chunks=list(pub.manifest().chunk_names))

    def on_learn_end(self):
        if self._island is not None:
            seen.update(summary=self._island.summary(), serving_version=self._serving_engine.serving_version,
                        param_ref_untouched=self._serving_param_ref is None, published=self._policy_version)
        originals["on_learn_end"](self)
        seen.update(island_gauges=gauges.snapshot("serving/island/"), broadcast_gauges=gauges.snapshot(
            "rollout/broadcast/"))

    def train_step(self, batch):
        before = dict(_kernels.launches())
        out = originals["train_step"](self, batch)
        steps.append((out, {k: _kernels.launches()[k] - before[k] for k in before}))
        return out

    PPOTrainer._start_async_engine, PPOTrainer.on_learn_end = start, on_learn_end
    PPOTrainer.train_step = train_step
    t0 = time.perf_counter()
    try:
        with runs.count("islands_trainer"):
            trlx_tpu_torch.train(reward_fn=byte_share_reward, prompts=byte_prompts(64, 64, 128, SEED + 1),
                                 eval_prompts=byte_prompts(32, 64, 128, SEED + 2), config=cfg)
    finally:
        for name, fn in originals.items():
            setattr(PPOTrainer, name, fn)
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    left = [t.name for t in threading.enumerate() if t.ident not in threads0 and t.is_alive()]
    finite = all(np.isfinite(out["losses/total_loss"]) for out, _ in steps)
    L, num_mb = 12, TRAIN_B // TRAIN_MB
    stale = [out.get("rollout/batch_staleness_max") for out, _ in steps]
    emit({"phase": "serving_fleet", "leg": "islands_trainer", "card": ctx.get("smi"), "wall_s": wall,
          "steps": len(steps), "island": seen.get("summary"), "serving_version": seen.get("serving_version"),
          "learner_version": seen.get("published"), "chunks": seen.get("chunks"), "batch_staleness_max": stale,
          "island_gauges_in_steps": {k: v for k, v in steps[-1][0].items() if k.startswith("serving/island/")},
          "threads_left": left})
    return {
        f"{SF_ISLAND_STEPS} optimizer steps, losses finite": len(steps) == SF_ISLAND_STEPS and finite,
        "a ChunkedParameterPublisher sharing the island's gate": seen.get("island") and seen.get("chunked")
        and seen.get("shared_gate") and seen.get("attached"),
        "the seed version committed": seen.get("seed_version") == 0,
        "_serving_param_ref untouched": seen.get("param_ref_untouched") is True,
        "serving_version advanced": (seen.get("serving_version") or -1) >= 1,
        "island and broadcast gauges empty after on_learn_end": seen.get("island_gauges") == {}
        and seen.get("broadcast_gauges") == {},
        "K2 and K3 per step": all(d["flash_bwd_dkv"] == d["flash_bwd_dq"] == L * num_mb for _, d in steps),
        "no thread left": not left,
    }


def sf_lora_islands(ctx, runs):
    """Leg lora_islands: LoRA PPO (``peft_memory``'s adapters) at gpt2 full
    width under ``train.islands`` (async rollouts, max_staleness 1, through
    the plain engine as the generation island, chunk_layers 2), 2 steps
    (:func:`async_ppo_leg`); the island's and the broadcast's gauges empty
    after."""
    import shutil

    from trlx_tpu_torch.utils.metrics import gauges

    tr = pm_trainer("sf_lora_islands", {"model.peft_config": PM_LORA,
                                        "train.async_rollouts": {"enabled": True, "max_staleness": 1},
                                        "train.serving": {"enabled": True, "block_size": 16},
                                        "train.islands": {"enabled": True, "chunk_layers": 2}})
    with runs.count("lora_islands"):
        checks, report = async_ppo_leg(tr)
    checks["the engine served as the generation island"] = report["island"]
    checks["island and broadcast gauges empty after"] = (gauges.snapshot("serving/island/") == {}
                                                         and gauges.snapshot("rollout/broadcast/") == {})
    emit({"phase": "serving_fleet", "leg": "lora_islands", "card": ctx.get("smi"), **report})
    shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    return checks


def phase_serving_fleet(ctx):
    """A main path: serving across engines at gpt2 full width
    (:func:`sf_fleet_of_one`, :func:`sf_fleet_scenario`,
    :func:`sf_fleet_trainer`, :func:`sf_online_fleet`,
    :func:`sf_islands_bubble`, :func:`sf_islands_trainer`,
    :func:`sf_lora_islands`). The CPU
    reference of the fleet scenario runs first. Each run on the path (a
    router, a fleet trainer, an island) is counted from 0 (:class:`SfRuns`);
    a leg's references (bare engines, the single-engine trainer, warm-ups)
    run between the windows. Over the runs' sum K1 (prefill waves, scoring,
    loss forwards), K2/K3 (the trainers and the GRPO learner), K4 (the
    replicas' and the island engine's decode rounds) and K5 (the trainers'
    spec engines) must all have launched, and every recorded shape is held
    against the plain versions. Device memory must be back within 64 MiB of
    its start after every leg."""
    import tempfile

    t0 = time.perf_counter()
    cpu_report, _ = sf_scenario_run(ps_cpu_config(), "cpu", tempfile.mkdtemp(prefix="chip_smoke_sf_cpu_diag_"))
    cpu_facts = sf_scenario_facts(cpu_report)
    emit({"phase": "serving_fleet", "cpu_reference_s": time.perf_counter() - t0,
          "cpu_reference": {k: v for k, v in cpu_facts.items() if k != "terminal"}})
    seen = {}
    restore_kernels = record_kernel_shapes(seen)
    legs, failed, runs = {}, [], SfRuns()
    try:
        for name, leg in (("fleet_of_one", lambda: sf_fleet_of_one(ctx, runs)),
                          ("fleet_scenario", lambda: sf_fleet_scenario(ctx, cpu_facts, runs)),
                          ("fleet_trainer", lambda: sf_fleet_trainer(ctx, runs)),
                          ("online_fleet", lambda: sf_online_fleet(ctx, runs)),
                          ("islands_bubble", lambda: sf_islands_bubble(ctx, runs)),
                          ("islands_trainer", lambda: sf_islands_trainer(ctx, runs)),
                          ("lora_islands", lambda: sf_lora_islands(ctx, runs))):
            mem0 = sf_memory()
            counted, t1 = set(runs.runs), time.perf_counter()
            checks = leg()  # its engines, routers and trainers are garbage once it returns
            legs[name] = {"s": time.perf_counter() - t1,
                          "launches": runs.total([n for n in runs.runs if n not in counted])}
            mem1 = sf_memory()
            legs[name].update(memory_before_b=mem0, memory_after_b=mem1)
            checks["device memory back within 64 MiB"] = abs(mem1 - mem0) <= SF_MEM_SLACK
            emit({"phase": "serving_fleet", "leg": name, "checks": checks})
            failed += [f"{name}: {k}" for k, ok in checks.items() if not ok]
    finally:
        restore_kernels()
    launches = runs.total()
    ctx["serving_fleet_launches"] = launches
    emit({"phase": "serving_fleet", "legs": legs, "launches": launches, "launches_by_run": runs.runs,
          "kernel_shapes": kernel_shapes(seen)})
    if failed:
        raise AssertionError(f"serving_fleet phase: {failed}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"serving_fleet phase: kernels never launched on the path: {missing}")
    check_main_path_shapes(ctx, seen, "serving_fleet", ("flash_fwd", "flash_bwd", "paged_decode", "paged_verify"))


# ------------------------------------------------ families and seq2seq (the optimizers, bloom, T5, the sweep)

#: the optimizer legs: each registry name with its kwargs beside lr
FS_OPTIMIZERS = {"sgd": dict(momentum=0.9, weight_decay=0.01), "lion": {}, "adafactor": {}, "rmsprop": {}}
FS_OPT_LR = 1e-5
#: the bloom leg: 8 prompts of <= 32 bytes, 32 new tokens, 2 steps of 4 rows in 2 microbatches
FS_BLOOM_PROMPTS, FS_BLOOM_NEW, FS_BLOOM_B, FS_BLOOM_MB = 8, 32, 4, 2
#: the narrow bloom of the card-against-CPU check
FS_NARROW_BLOOM = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=1024, max_position_embeddings=128)
#: the T5 legs: t5-small widths (T5Config()), bytes tokenizer
FS_T5_PROMPTS, FS_T5_NEW, FS_T5_B, FS_T5_MB = 16, 32, 8, 4
#: the T5 of the card-against-CPU check: 2 + 2 layers, f32
FS_NARROW_T5 = dict(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_decoder_layers=2, num_heads=4,
                    relative_attention_num_buckets=8)


def fs_state_bytes_formula(name, params):
    """The optimizer state's bytes from the trained parameters' shapes (f32
    state): SGD with momentum, Lion and RMSprop one moment per parameter;
    Adafactor a row and a column factor (numel / largest dim + numel /
    second-largest dim) for every tensor whose two largest dims are both
    >= 128, a full second moment for every other."""
    total = 0
    for p in params:
        n = p.numel()
        if name == "adafactor":
            dims = sorted(p.shape)
            total += n // dims[-1] + n // dims[-2] if len(dims) >= 2 and dims[-2] >= 128 else n
        else:
            total += n
    return 4 * total


def fs_optimizer_runs(ctx, device="cuda"):
    """The train phase's gpt2 trainer at full width: one experience phase
    (64 rollouts of 128 sampled tokens), then for each optimizer of
    ``FS_OPTIMIZERS`` the initial weights restored, the optimizer block
    replaced and ``setup_optimizer`` rebuilding the optimizer and its
    schedule, and 2 learner steps of 32 rollouts in 2 microbatches on the
    phase's first two batches (each optimizer ran its own experience phase
    until PR 14, which shared it to keep the whole script inside its time
    limit). Launch counts from 0 over each optimizer's steps, the experience
    phase's with the first. Returns {name: (report, checks, launches)}."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from trlx_tpu_torch.data.configs import OptimizerConfig
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer
    from trlx_tpu_torch.utils.optim import state_bytes

    first = next(iter(FS_OPTIMIZERS))
    cfg = with_optimizer(full_width_train_config(tempfile.mkdtemp(prefix="chip_smoke_fs_optimizers_")), first,
                         dict(lr=FS_OPT_LR, **FS_OPTIMIZERS[first]))
    trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=byte_share_reward, device=device)
    trainer.add_prompt_pipeline(PromptPipeline(byte_prompts(64, 64, 128, SEED + 1), TRAIN_P, trainer.tokenizer))
    state0 = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    trainer.prepare_learning()
    sync()
    experience_s = time.perf_counter() - t0
    batches = list(trainer.create_train_dataloader())[:2]
    L, num_mb = trainer.model_config.num_layers, TRAIN_B // TRAIN_MB
    out = {}
    for name, kwargs in FS_OPTIMIZERS.items():
        if name != first:
            _kernels.reset_launches()
            trainer.model.load_state_dict(state0)
            trainer.config.optimizer = OptimizerConfig(name=name, kwargs=dict(lr=FS_OPT_LR, **kwargs))
            trainer.setup_optimizer()
            trainer._train_step_fn = None
        params0 = [p.detach().clone() for p in trainer.trainable_params]
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        stats, step_s = [], []
        for batch in batches:
            t1 = time.perf_counter()
            stats.append(trainer.train_step(batch))
            sync()
            step_s.append(time.perf_counter() - t1)
        launches = _kernels.launches()
        got_bytes, want_bytes = state_bytes(trainer.optimizer), fs_state_bytes_formula(name, trainer.trainable_params)
        report = {
            "optimizer": name, "kwargs": dict(lr=FS_OPT_LR, **kwargs), "card": ctx.get("smi"),
            "experience_s": experience_s if name == first else None, "step_s": step_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None,
            "state_bytes": got_bytes, "state_bytes_formula": want_bytes,
            "trained_params": sum(p.numel() for p in trainer.trainable_params),
            "losses": [{k: v for k, v in s.items() if k.startswith("losses/")} for s in stats], "launches": launches,
        }
        checks = {
            "2 learner steps": len(stats) == 2,
            "losses finite": all(np.isfinite(v) for s in stats for k, v in s.items() if k.startswith("losses/")),
            "params moved": any(not torch.equal(a, p.detach()) for a, p in zip(params0, trainer.trainable_params)),
            "state bytes == formula": got_bytes == want_bytes,
            "K2 and K3 once per layer and microbatch":
                launches["flash_bwd_dkv"] == launches["flash_bwd_dq"] == 2 * L * num_mb,
            "K1 launched": launches["flash_fwd"] > 0,
            "no paged kernel": launches["paged_decode"] == launches["paged_verify"] == 0,
        }
        out[name] = (report, checks, launches)
    shutil.rmtree(cfg.train.checkpoint_dir, ignore_errors=True)
    del trainer
    if on_card:
        torch.cuda.empty_cache()
    return out


def fs_optimizers(ctx):
    """Leg ``optimizers``: :func:`fs_optimizer_runs` for sgd (momentum 0.9,
    decay 0.01), lion, adafactor and rmsprop, every recorded K1/K2/K3 shape
    held against the plain versions, then each on the card against the CPU
    (``train_parity``'s 2-layer f32 trainer at lr 1e-3: tokens identical,
    experience within 1e-4, losses/* within 1e-3 relative)."""
    seen, checks, launches = {}, {}, {}
    restore = record_kernel_shapes(seen)
    try:
        for name, (report, run_checks, run_launches) in fs_optimizer_runs(ctx).items():
            emit({"phase": "families_seq2seq", "leg": "optimizers", **report})
            checks.update({f"{name}: {k}": ok for k, ok in run_checks.items()})
            launches = {k: launches.get(k, 0) + v for k, v in run_launches.items()}
    finally:
        restore()
    check_main_path_shapes(ctx, seen, "families_seq2seq", ("flash_fwd", "flash_bwd"))
    for name, kwargs in FS_OPTIMIZERS.items():
        report, ok = train_parity_report({}, optimizer=(name, dict(lr=1e-3, **kwargs)))
        emit({"phase": "families_seq2seq", "leg": "optimizers", "check": f"{name} card against CPU", **report})
        checks[f"{name}: card against CPU (tokens, experience 1e-4, losses 1e-3)"] = ok
    return checks, launches


def fs_bloom_config(ckpt_dir, model_path="bigscience/bloom-560m", overrides=None):
    """PPO on bloom: the preset's widths (24 layers, hidden 1024, 16 heads,
    vocab 250880) unless ``overrides``, flash attention asked for (ALiBi
    keeps it off the kernel), bf16 compute, f32 params, the bytes tokenizer."""
    return ppo_config(**{
        "model.model_path": model_path, "model.model_overrides": {"attention_impl": "flash", **(overrides or {})},
        "mesh.compute_dtype": "bfloat16", "mesh.param_dtype": "float32", "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": 32 + FS_BLOOM_NEW, "train.batch_size": FS_BLOOM_B, "train.minibatch_size": FS_BLOOM_MB,
        "train.total_steps": 2, "train.eval_interval": 100, "train.checkpoint_interval": 100,
        "train.save_best": False, "train.save_optimizer": False, "train.tracker": None,
        "train.checkpoint_dir": ckpt_dir, "train.seed": SEED,
        "method.num_rollouts": FS_BLOOM_PROMPTS, "method.chunk_size": FS_BLOOM_PROMPTS, "method.ppo_epochs": 1,
        "method.gen_kwargs": dict(max_new_tokens=FS_BLOOM_NEW, do_sample=True, top_k=0, top_p=1.0),
    })


def async_ppo_leg(trainer, steps=2):
    """An async-rollouts PPO run, cut short: ``prepare_learning`` (the
    producer thread starts and the first store fills at version 0), then
    ``steps`` learner steps, then ``on_learn_end`` (the producer drained and
    joined). Returns (checks, report): the run completed on the card with
    finite experience and losses, and the drain ledger balances."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    try:
        trainer.prepare_learning()
        producer = trainer._producer_model
        island = trainer._island is not None
        stats = [trainer.train_step(b) for b in list(trainer.create_train_dataloader())[:steps]]
        torch.cuda.synchronize()
    finally:
        trainer.on_learn_end()
    elements = list(trainer.store.history)
    ledger = trainer.rollout_engine_summary or {}
    balanced = ledger.get("produced") == sum(ledger.get(k, 0) for k in (
        "consumed", "dropped_stale", "leftover", "dropped_shutdown"))
    report = {"s": time.perf_counter() - t0, "elements": len(elements), "ledger": ledger, "island": island,
              "producer": type(producer).__name__,
              "losses": [{k: v for k, v in s.items() if k.startswith("losses/")} for s in stats]}
    checks = {
        f"{steps} steps, finite losses": len(stats) == steps and all(
            np.isfinite(v) for s in stats for k, v in s.items() if k.startswith("losses/")),
        "the store filled by the producer at version 0, finite": len(elements) == trainer.method.num_rollouts
        and all(e.policy_version == 0 and all(np.isfinite(getattr(e, f)).all() for f in ("logprobs", "values",
                                                                                          "rewards"))
                for e in elements),
        "the drain ledger balances": balanced and trainer._engine is None,
    }
    return checks, report


def fs_drive_ppo(trainer, prompts, steps=2, sync=None):
    """prepare_learning (one experience phase) on ``prompts``, then
    ``steps`` learner steps; returns (stats, seconds)."""
    from trlx_tpu_torch.pipeline import PromptPipeline

    trainer.add_prompt_pipeline(PromptPipeline(prompts, 64, trainer.tokenizer))
    t0 = time.perf_counter()
    trainer.prepare_learning()
    stats = [trainer.train_step(b) for b in list(trainer.create_train_dataloader())[:steps]]
    if sync is not None:
        sync()
    return stats, time.perf_counter() - t0


def fs_bloom(ctx, device="cuda", model_path="bigscience/bloom-560m", overrides=None):
    """Leg ``bloom``: PPO on bloom-560m (seed-0 random init) for 2 learner
    steps through the padded generate; ``save_pretrained`` then
    ``load_pretrained`` gives logits ``torch.equal`` to the trained trunk's;
    no kernel launches (ALiBi runs on the plain path, as the JAX package
    routes it); then a narrow f32 bloom on the card against the CPU: greedy
    tokens identical, logits within 1e-5."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from trlx_tpu_torch.models.hf_loading import load_pretrained
    from trlx_tpu_torch.models.presets import PRESETS
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.ops.generation import generate, left_pad_batch
    from trlx_tpu_torch.utils.loading import get_trainer

    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fs_bloom_")
    _kernels.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = get_trainer("PPOTrainer")(config=fs_bloom_config(tmp + "/ckpts", model_path, overrides),
                                        reward_fn=byte_share_reward, device=device)
    build_s = time.perf_counter() - t0
    params0 = [p.detach().clone() for p in trainer.trainable_params[:4]]
    stats, run_s = fs_drive_ppo(trainer, byte_prompts(FS_BLOOM_PROMPTS, 8, 32, SEED + 7), sync=sync)
    t1 = time.perf_counter()
    trainer.save_pretrained(tmp + "/hf")
    cfg2, state2, family = load_pretrained(tmp + "/hf", {"compute_dtype": trainer.compute_dtype,
                                                          "attention_impl": "flash"})
    with torch.device(device):
        reloaded = TransformerLM(cfg2)
    reloaded.load_state_dict(state2)
    ids, mask = left_pad_batch([np.asarray(trainer.tokenizer(p).input_ids, np.int32)
                                for p in byte_prompts(4, 8, 32, SEED + 8)], trainer.tokenizer.pad_token_id, 32)
    ids_t, mask_t = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
    with torch.no_grad():
        same_logits = torch.equal(reloaded(ids_t, mask_t)[0], trainer.model.transformer(ids_t, mask_t)[0])
    export_s = time.perf_counter() - t1
    launches = _kernels.launches()
    report = {"model": "bloom-560m widths" if overrides is None else overrides, "card": ctx.get("smi"),
              "params": sum(p.numel() for p in trainer.model.parameters()), "build_s": build_s,
              "experience_and_2_steps_s": run_s, "export_reload_s": export_s,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None,
              "losses": [{k: v for k, v in s.items() if k.startswith("losses/")} for s in stats],
              "launches": launches, "family": family}
    checks = {
        "2 learner steps, losses finite": len(stats) == 2 and all(
            np.isfinite(v) for s in stats for k, v in s.items() if k.startswith("losses/")),
        "params moved": any(not torch.equal(a, p.detach()) for a, p in zip(params0, trainer.trainable_params)),
        "exported bloom reloads (model_type bloom, ALiBi)": family == "bloom" and cfg2.pos_embedding == "alibi",
        "reloaded logits torch.equal": same_logits,
        "K1-K5 launched 0 times": not any(launches.values()),
    }
    del trainer, reloaded
    shutil.rmtree(tmp, ignore_errors=True)

    # the narrow bloom: card against the CPU, f32, the same weights
    cfg = PRESETS["bloom"].replace(**FS_NARROW_BLOOM, compute_dtype=torch.float32, attention_impl="flash")
    cpu = TransformerLM(cfg).init_params(SEED)
    cpu.load_state_dict({k: v * 3 for k, v in cpu.state_dict().items()})  # sharper logits: no greedy near-ties
    with torch.device(device):
        card = TransformerLM(cfg)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(4, 17))).astype(np.int32) for _ in range(8)]
    ids, mask = left_pad_batch(prompts, 0, 16)
    outs, logits = [], []
    for model, dev in ((cpu, "cpu"), (card, device)):
        def step(i, m, pos, cache, model=model):
            out, hidden, _, cache = model(i, m, pos, cache)
            return out, hidden, cache

        ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
        out = generate(step, lambda b, s, model=model: model.init_cache(b, s), ids_t, mask_t, None, 16,
                       do_sample=False, pad_token_id=0)
        outs.append(out["sequences"].cpu())
        with torch.no_grad():
            logits.append(model(ids_t, mask_t)[0].cpu())
    valid = torch.from_numpy(mask).bool()
    err = (logits[0] - logits[1])[valid].abs().max().item()
    checks.update({"narrow bloom: greedy tokens identical": torch.equal(outs[0], outs[1]),
                   "narrow bloom: logits within 1e-5": err <= 1e-5})
    report["narrow_bloom"] = {"max_abs_err": err, "tokens": list(outs[1].shape)}
    launches = _kernels.launches()
    checks["K1-K5 launched 0 times (narrow bloom too)"] = not any(launches.values())
    emit({"phase": "families_seq2seq", "leg": "bloom", **report})
    return checks, launches


def fs_t5_config(base, ckpt_dir, overrides=None, compute="bfloat16", **over):
    """A seq2seq (T5) config: t5-small widths from the seed unless
    ``overrides``, bf16 compute (``compute``), f32 params, the bytes
    tokenizer."""
    from trlx_tpu_torch.data.configs import TRLConfig

    return TRLConfig.update(base, {
        "model.model_path": "t5-small", "model.model_arch_type": "seq2seq", "model.num_layers_unfrozen": -1,
        "model.model_overrides": overrides, "mesh.compute_dtype": compute, "mesh.param_dtype": "float32",
        "tokenizer.tokenizer_path": "bytes", "train.seq_length": 128, "train.batch_size": FS_T5_B,
        "train.minibatch_size": FS_T5_MB, "train.total_steps": 4, "train.eval_interval": 100,
        "train.checkpoint_interval": 100, "train.save_best": False, "train.save_optimizer": False,
        "train.tracker": None, "train.checkpoint_dir": ckpt_dir, "train.seed": SEED, **over,
    })


def fs_t5_ppo(ctx, device, n_unfrozen, overrides=None, compute="bfloat16", state=None, lr=1e-5, greedy=False):
    """A seq2seq PPOTrainer (``state`` replaces its initial weights), one
    experience phase of FS_T5_PROMPTS prompts and FS_T5_NEW new tokens, 2
    learner steps. Returns (trainer, stats, seconds, initial params)."""
    import tempfile

    import torch

    from trlx_tpu_torch.data.default_configs import default_ppo_config
    from trlx_tpu_torch.models.policy import t5_branch_param_subtree
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = fs_t5_config(default_ppo_config(), tempfile.mkdtemp(prefix="chip_smoke_fs_t5ppo_"), overrides, compute, **{
        "model.num_layers_unfrozen": n_unfrozen, "method.num_rollouts": FS_T5_PROMPTS,
        "method.chunk_size": FS_T5_PROMPTS, "method.ppo_epochs": 1,
        "method.gen_kwargs": dict(max_new_tokens=FS_T5_NEW, do_sample=not greedy, top_k=0, top_p=1.0),
        "optimizer.kwargs": dict(lr=lr, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6),
    })
    trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=byte_share_reward, device=device)
    if state is not None:
        trainer.model.load_state_dict(state)
        if trainer.frozen_branch is not None:
            trainer.frozen_branch.load_state_dict(t5_branch_param_subtree(
                trainer.model.t5.state_dict(), trainer.branch_start, trainer.model_config))
        else:
            trainer.ref_model.load_state_dict(trainer.model.t5.state_dict())
    params0 = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    sync = torch.cuda.synchronize if device != "cpu" else None
    stats, seconds = fs_drive_ppo(trainer, byte_prompts(FS_T5_PROMPTS, 16, 64, SEED + 11), sync=sync)
    return trainer, stats, seconds, params0


def fs_seq2seq(ctx, device="cuda", overrides=None):
    """Leg ``seq2seq`` at t5-small widths (seed-0 random init, bf16
    compute): seq2seq SFT 4 steps, exported (``save_pretrained`` -> the T5
    HF layout) and reloaded to logits ``torch.equal`` to the trained
    model's; PPO 2 steps with a full frozen reference, then 2 with
    ``num_layers_unfrozen=1`` (the decoder-top branch: the encoder, the
    embedding, the lower decoder blocks and the branch bit-identical after),
    and 2 under ``train.async_rollouts`` (:func:`async_ppo_leg`); ILQL 4
    steps; greedy decode with the int8 decoder KV cache against
    bf16 (every row that differs splits at a near tie of the bf16 model:
    <= 2e-2 x max(1, |logit|)); then PPO at 2 + 2 layers f32 on the card
    against the CPU (tokens identical, experience 1e-4, losses 1e-3
    relative). No kernel launches anywhere (T5 attends on the plain path)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from trlx_tpu_torch.data.default_configs import default_ilql_config, default_sft_config
    from trlx_tpu_torch.models.hf_loading import load_pretrained_seq2seq
    from trlx_tpu_torch.models.t5 import T5LM
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.ops.generation import generate_seq2seq, left_pad_batch
    from trlx_tpu_torch.utils.loading import get_trainer

    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    finite = lambda stats: all(np.isfinite(v) for s in stats for k, v in s.items() if k.startswith("losses/"))
    losses = lambda stats: [{k: v for k, v in s.items() if k.startswith("losses/")} for s in stats]
    _kernels.reset_launches()
    report, checks = {"card": ctx.get("smi")}, {}

    # SFT, 4 steps, then the export round trip
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fs_t5_")
    sft = get_trainer("SFTTrainer")(config=fs_t5_config(default_sft_config(), tmp + "/sft", overrides, **{
        "optimizer.kwargs": dict(lr=1e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6)}), device=device)
    t0 = time.perf_counter()
    sft.make_experience(byte_dialogues(48, SEED + 12), sft.config.train.seq_length)
    sft.prepare_learning()
    stats = []
    while len(stats) < 4:
        for batch in sft.create_train_dataloader():
            stats.append(sft.train_step(batch))
            if len(stats) == 4:
                break
    sync()
    report["sft"] = {"s": time.perf_counter() - t0, "losses": losses(stats),
                     "params": sum(p.numel() for p in sft.model.parameters())}
    sft.save_pretrained(tmp + "/hf")
    cfg2, state2 = load_pretrained_seq2seq(tmp + "/hf", {"compute_dtype": sft.compute_dtype})
    with torch.device(device):
        reloaded = T5LM(cfg2)
    reloaded.load_state_dict(state2)
    ids, mask = left_pad_batch([np.asarray(sft.tokenizer(p).input_ids, np.int32)
                                for p in byte_prompts(4, 8, 32, SEED + 13)], 0, 32)
    ids_t, mask_t = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
    dec = ids_t[:, :16]
    with torch.no_grad():
        same = torch.equal(reloaded(ids_t, mask_t, dec)[0], sft.model.t5(ids_t, mask_t, dec)[0])
    checks.update({"sft: 4 steps, losses finite": len(stats) == 4 and finite(stats),
                   "sft: exported T5 reloads to torch.equal logits": same})
    del sft, reloaded
    shutil.rmtree(tmp, ignore_errors=True)

    # PPO, full frozen reference then the decoder-top branch
    for n_unfrozen in (-1, 1):
        trainer, stats, seconds, params0 = fs_t5_ppo(ctx, device, n_unfrozen, overrides)
        state = trainer.model.state_dict()
        moved = [k for k in state if not torch.equal(params0[k], state[k])]
        report[f"ppo_unfrozen_{n_unfrozen}"] = {"s": seconds, "losses": losses(stats), "moved_tensors": len(moved),
                                                "reference": "decoder-top branch" if trainer.frozen_branch
                                                is not None else "full copy"}
        checks[f"ppo (num_layers_unfrozen {n_unfrozen}): 2 steps, losses finite"] = len(stats) == 2 and finite(stats)
        checks[f"ppo (num_layers_unfrozen {n_unfrozen}): params moved"] = bool(moved)
        if n_unfrozen > 0:
            L = trainer.model_config.num_decoder_layers
            trained = [k for k in state if k.startswith((f"t5.decoder_blocks_{L - 1}.", "t5.decoder_ln.",
                                                         "v_head_mlp."))]
            checks["ppo hydra: exactly the top block, the final norm and the value head moved"] = (
                sorted(moved) == sorted(k for k in trained if k in moved) and bool(moved))
            checks["ppo hydra: the branch is decoder block L-1, the norm and the tied head"] = (
                trainer.branch_start == L - 1 and trainer.ref_model is None)
        del trainer

    # PPO under train.async_rollouts: the producer thread's copy of the T5 policy
    from trlx_tpu_torch.data.default_configs import default_ppo_config
    from trlx_tpu_torch.pipeline import PromptPipeline

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fs_t5async_")
    trainer = get_trainer("PPOTrainer")(config=fs_t5_config(default_ppo_config(), tmp, overrides, **{
        "method.num_rollouts": FS_T5_PROMPTS, "method.chunk_size": FS_T5_PROMPTS // 2, "method.ppo_epochs": 1,
        "method.gen_kwargs": dict(max_new_tokens=FS_T5_NEW, do_sample=True, top_k=0, top_p=1.0),
        "train.async_rollouts": dict(enabled=True, max_staleness=1)}), reward_fn=byte_share_reward, device=device)
    trainer.add_prompt_pipeline(PromptPipeline(byte_prompts(FS_T5_PROMPTS, 16, 64, SEED + 11), 64, trainer.tokenizer))
    async_checks, report["ppo_async"] = async_ppo_leg(trainer)
    checks.update({f"ppo async: {k}": ok for k, ok in async_checks.items()})
    checks["ppo async: the producer holds a T5 policy"] = report["ppo_async"]["producer"] == "Seq2SeqLMWithValueHead"
    del trainer
    shutil.rmtree(tmp, ignore_errors=True)

    # ILQL, 4 steps
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fs_t5ilql_")
    ilql = get_trainer("ILQLTrainer")(config=fs_t5_config(default_ilql_config(), tmp, overrides, **{
        "method.steps_for_target_q_sync": 2,
        "method.gen_kwargs": dict(max_new_tokens=FS_T5_NEW, top_k=20, beta=4.0, temperature=1.0)}), device=device)
    rng = np.random.default_rng(SEED + 14)
    t0 = time.perf_counter()
    ilql.make_experience(byte_dialogues(32, SEED + 15), rng.normal(size=32).tolist(), ilql.config.train.seq_length)
    ilql.prepare_learning()
    stats = []
    while len(stats) < 4:
        for batch in ilql.create_train_dataloader():
            stats.append(ilql.train_step(batch))
            ilql.iter_count += 1
            ilql.post_backward_callback()
            if len(stats) == 4:
                break
    samples, resp_mask, pad_len = ilql.generate([np.asarray(ilql.tokenizer(p).input_ids, np.int32)
                                                 for p in byte_prompts(8, 8, 32, SEED + 16)], eval_mode=True)
    sync()
    report["ilql"] = {"s": time.perf_counter() - t0, "losses": losses(stats), "eval_tokens": int(resp_mask.sum())}
    checks["ilql: 4 steps, losses finite"] = len(stats) == 4 and finite(stats)
    checks["ilql: advantage-shaped eval decode, start token first"] = bool(
        pad_len == 1 and (samples[:, 0] == ilql.decoder_start_token_id).all() and resp_mask.sum() > 0)
    del ilql
    shutil.rmtree(tmp, ignore_errors=True)

    # the int8 decoder KV cache against bf16, greedy, the same weights
    from trlx_tpu_torch.models.t5 import T5Config

    base = T5Config(compute_dtype=torch.bfloat16) if overrides is None else T5Config(**overrides)
    with torch.device(device):
        bf = T5LM(base).init_params(SEED)
        q8 = T5LM(base.replace(kv_cache_quant=True))
    q8.load_state_dict(bf.state_dict())
    rng = np.random.default_rng(SEED + 17)
    prompts = [rng.integers(3, 259, int(rng.integers(8, 33))).astype(np.int32) for _ in range(16)]
    ids, mask = left_pad_batch(prompts, 0, 32)
    ids_t, mask_t = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
    rows, step_logits = [], []
    for model, record in ((bf, True), (q8, False)):
        seen_logits = []

        def keep(hidden, logits, prev, seen_logits=seen_logits, record=record):
            if record:
                seen_logits.append(logits.float())
            return logits

        out = generate_seq2seq(model.encode, model.precompute_cross_kv, model.decode, model.init_cache, ids_t, mask_t,
                               None, FS_T5_NEW, do_sample=False, logits_processor=keep)
        rows.append(out["sequences"].cpu().numpy())
        step_logits.append(seen_logits)
    differ = [int(b) for b in np.nonzero((rows[0] != rows[1]).any(axis=1))[0]]
    splits = []
    for b in differ:
        j = int(np.nonzero(rows[0][b] != rows[1][b])[0][0])  # slot j = decode step j - 1
        lg = step_logits[0][j - 1][b]
        a, c = int(rows[0][b, j]), int(rows[1][b, j])
        gap = float(lg[a] - lg[c])
        splits.append({"row": b, "position": j, "gap": gap, "tol": 2e-2 * max(1.0, abs(float(lg[a])))})
    report["int8_kv"] = {"rows": len(prompts), "rows_differing": len(differ), "splits": splits}
    checks["int8 KV: every differing row splits at a near tie"] = all(s["gap"] <= s["tol"] for s in splits)
    del bf, q8

    # PPO at 2 + 2 layers f32: the card against the CPU from the same weights
    from trlx_tpu_torch.models.policy import Seq2SeqLMWithValueHead

    narrow = dict(FS_NARROW_T5, compute_dtype="float32")
    # T5's init already gives logits of std ~1 (the embedding's std is 1); scaling
    # it up as the gpt2 parity does would put scores at ~1e3 (no 1/sqrt(d)), where
    # f32's summation order alone moves the softmax by 1e-4
    state = Seq2SeqLMWithValueHead(T5Config(**FS_NARROW_T5, compute_dtype=torch.float32)).init_params(SEED).state_dict()
    runs = {}
    for dev in (device, "cpu"):
        trainer, stats, _, _ = fs_t5_ppo(ctx, dev, -1, narrow, "float32", state=state, lr=1e-3, greedy=True)
        runs[dev] = (list(trainer.store.history), stats)
        del trainer
    (ce, cs), (pe, ps) = runs[device], runs["cpu"]
    same_tokens = len(ce) == len(pe) and all(np.array_equal(a.response_tensor, b.response_tensor)
                                             for a, b in zip(ce, pe))
    elem_err = max((float(np.abs(getattr(a, f) - getattr(b, f)).max()) for a, b in zip(ce, pe)
                    for f in ("logprobs", "values", "rewards")), default=float("nan")) if same_tokens else None
    loss_ok = same_tokens and len(cs) == len(ps) == 2 and all(
        abs(x[k] - y[k]) <= 1e-3 * abs(y[k]) + 1e-6 for x, y in zip(cs, ps) for k in y if k.startswith("losses/"))
    report["card_vs_cpu"] = {"identical_tokens": same_tokens, "max_element_abs_err": elem_err,
                             "losses_card": losses(cs), "losses_cpu": losses(ps)}
    checks.update({"card vs CPU (2+2 layers, f32): greedy tokens identical": same_tokens,
                   "card vs CPU: experience within 1e-4": elem_err is not None and elem_err <= 1e-4,
                   "card vs CPU: losses within 1e-3 relative": loss_ok})
    launches = _kernels.launches()
    checks["K1-K5 launched 0 times"] = not any(launches.values())
    report["launches"] = launches
    emit({"phase": "families_seq2seq", "leg": "seq2seq", **report})
    if on_card:
        torch.cuda.empty_cache()
    return checks, launches


#: the sweep leg's 2-trial grid; each trial is the randomwalks recipe, cut short
FS_SWEEP_GRID = """tune_config:
  mode: "max"
  metric: "reward/mean"
  search_alg: "grid"
method.init_kl_coef:
  strategy: "choice"
  values: [0.0, 0.01]
pretrain_steps:
  strategy: "choice"
  values: [2]
train.total_steps:
  strategy: "choice"
  values: [2]
train.eval_interval:
  strategy: "choice"
  values: [2]
train.tracker:
  strategy: "choice"
  values: [null]
train.checkpoint_dir:
  strategy: "choice"
  values: ["{ckpt}"]
"""


def fs_sweep(ctx, device="cuda"):
    """Leg ``sweep``: ``python -m trlx_tpu_torch.sweep
    scripts/torch_ppo_randomwalks.py`` over a 2-trial grid (2 SFT steps, 2
    PPO steps, evals at 0 and 2: cut for the script's time limit), one
    trial at a time on the card: the
    results jsonl holds both trials, each with rc 0 and its reward/mean, and
    the markdown report is written."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fs_sweep_")
    grid = FS_SWEEP_GRID.replace("{ckpt}", tmp + "/ckpts")
    if device == "cpu":
        grid += 'device:\n  strategy: "choice"\n  values: ["cpu"]\n'
    with open(tmp + "/grid.yml", "w") as f:
        f.write(grid)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "trlx_tpu_torch.sweep", "scripts/torch_ppo_randomwalks.py", "--config",
         tmp + "/grid.yml", "--output", tmp + "/results.jsonl"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    records = []
    if os.path.exists(tmp + "/results.jsonl"):
        with open(tmp + "/results.jsonl") as f:
            records = [json.loads(line) for line in f]
    report_written = os.path.exists(tmp + "/results.md")
    emit({"phase": "families_seq2seq", "leg": "sweep", "card": ctx.get("smi"), "s": seconds,
          "returncode": proc.returncode, "records": records, "stdout_tail": proc.stdout[-1500:],
          "stderr_tail": proc.stderr[-1500:] if proc.returncode else ""})
    shutil.rmtree(tmp, ignore_errors=True)
    checks = {
        "sweep exits 0": proc.returncode == 0,
        "both trials recorded, rc 0, with reward/mean": len(records) == 2 and all(
            r["returncode"] == 0 and "reward/mean" in r.get("metrics", {}) for r in records),
        "each trial reported its evals": len(records) == 2 and all(r["num_reports"] >= 2 for r in records),
        "the report is written": report_written,
    }
    return checks, {}


def phase_families_seq2seq(ctx):
    """A main path: the optimizers, ALiBi and bloom, seq2seq and the sweep
    (:func:`fs_optimizers`, :func:`fs_bloom`, :func:`fs_seq2seq`,
    :func:`fs_sweep`). Each leg counts launches from 0: K1, K2 and K3 in
    the optimizer legs (the gpt2 trainer), exactly 0 of every kernel in the
    bloom and T5 legs."""
    from trlx_tpu_torch.ops import _kernels

    legs, failed, total = {}, [], {name: 0 for name in _kernels.launches()}
    for name, leg in (("optimizers", fs_optimizers), ("bloom", fs_bloom), ("seq2seq", fs_seq2seq),
                      ("sweep", fs_sweep)):
        t0 = time.perf_counter()
        checks, launches = leg(ctx)
        legs[name] = {"s": time.perf_counter() - t0, "launches": launches}
        total = {k: total[k] + launches.get(k, 0) for k in total}
        emit({"phase": "families_seq2seq", "leg": name, "checks": checks})
        failed += [f"{name}: {k}" for k, ok in checks.items() if not ok]
    ctx["families_seq2seq_launches"] = total
    emit({"phase": "families_seq2seq", "legs": legs, "launches": total, "card": ctx.get("smi")})
    if failed:
        raise AssertionError(f"families_seq2seq phase: {failed}")


# --------------------------------------------------------------- peft_memory

#: ``examples/ppo_sentiments_peft.py``'s adapter config, and prefix / prompt tuning
PM_LORA = {"peft_type": "LORA", "r": 8, "lora_alpha": 16, "target_modules": ["q_proj", "v_proj"]}
PM_PEFT = {"lora": PM_LORA, "prefix": {"peft_type": "PREFIX_TUNING", "num_virtual_tokens": 8},
           "prompt": {"peft_type": "PROMPT_TUNING", "num_virtual_tokens": 8}}
PM_ADAPTERS = ("lora_a", "lora_b", "prefix_k", "prefix_v", "prompt_embeddings")
PM_REMAT = ("full", "per_layer", "nothing_saveable", "dots_saveable")
#: gpt2-small's trunk: 124,439,808 f32 parameters, the full-copy reference's bytes
PM_REF_BYTES = 124_439_808 * 4
PM_8BIT = dict(lr=1e-5, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6)


def pm_trainer(tag, over, device="cuda", optimizer=None):
    """The train phase's gpt2 trainer at full width (64 rollouts of SHORT_N
    sampled tokens a phase, steps of 32 in 2 microbatches) with ``over``;
    ``optimizer`` = (name, kwargs) replaces the optimizer block."""
    import tempfile

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.update(full_width_train_config(tempfile.mkdtemp(prefix=f"chip_smoke_pm_{tag}_")),
                           {**short_traffic(do_sample=True), **over})
    if optimizer is not None:
        cfg = with_optimizer(cfg, *optimizer)
    trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=byte_share_reward, device=device)
    trainer.add_prompt_pipeline(PromptPipeline(byte_prompts(64, 64, 128, SEED + 1), TRAIN_P, trainer.tokenizer))
    return trainer


def pm_drive(trainer, steps, on_step=None):
    """prepare_learning (one experience phase), then ``steps`` learner
    steps, a new experience phase whenever the store's batches run out.
    Returns (stats, step seconds, experience seconds)."""
    import torch

    stats, step_s, exp_s = [], [], []
    t0 = time.perf_counter()
    trainer.prepare_learning()
    torch.cuda.synchronize()
    exp_s.append(time.perf_counter() - t0)
    while True:
        for batch in list(trainer.create_train_dataloader()):
            t1 = time.perf_counter()
            stats.append(trainer.train_step(batch))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            trainer.iter_count += 1
            if on_step is not None:
                on_step(trainer)
            if len(stats) == steps:
                return stats, step_s, exp_s
        t0 = time.perf_counter()
        trainer.post_epoch_callback(0)
        torch.cuda.synchronize()
        exp_s.append(time.perf_counter() - t0)


def pm_trunk(trainer):
    """Copies of the trunk's non-adapter parameters."""
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()
            if n.startswith("transformer.") and n.rsplit(".", 1)[-1] not in PM_ADAPTERS}


def pm_trunk_unchanged(trainer, trunk0):
    """The trunk ``torch.equal`` to ``trunk0``, with no gradient and no
    optimizer state."""
    import torch

    named = dict(trainer.model.named_parameters())
    return all(torch.equal(named[n], v) and named[n].grad is None and named[n] not in trainer.optimizer.state
               for n, v in trunk0.items())


def pm_finite(stats):
    import numpy as np

    return all(np.isfinite(v) for s in stats for k, v in s.items() if k.startswith("losses/"))


def pm_seeded_lora_b(state):
    """The parity runs' initial weights with every ``lora_b`` drawn from the
    seed (at init it is 0 and LoRA a no-op)."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 7)
    return {k: (torch.randn(v.shape, generator=gen) * 0.05 if k.endswith(".lora_b") else v) for k, v in state.items()}


def pm_peft_parity(ctx):
    """Leg ``peft_parity``: each peft type on the card against the CPU with
    ``train_parity``'s trainer (2 layers, f32, greedy, ``lora_b`` drawn from
    the seed): one experience phase (its forwards) and 2 steps, held to the
    hydra-parity limits. Not a main path: its launches are not counted."""
    reports, checks = {}, {}
    for kind, peft in PM_PEFT.items():
        report, ok = train_parity_report({"model.peft_config": peft}, state_fn=pm_seeded_lora_b)
        reports[kind] = report
        checks[f"{kind}: card == CPU"] = ok
    return checks, None, reports


def pm_lora_ppo(ctx):
    """Leg ``lora_ppo``: LoRA (r 8, alpha 16, q_proj and v_proj) at gpt2
    full width through ``train.serving``, 4 steps (two experience phases):
    no reference copy, the trunk ``torch.equal`` to its initial weights with
    no gradient and no optimizer state, AdamW's moments 8 B per adapter and
    head parameter; the export merges the adapters (its logits against the
    adapter forward, f32, within the f32 kernel-agreement limit) and its
    adapter file reloads ``torch.equal``."""
    import shutil
    import tempfile

    import torch

    from trlx_tpu_torch.models.hf_loading import load_adapters, load_pretrained
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.ops import _kernels

    tr = pm_trainer("lora", {"model.peft_config": PM_LORA, "train.serving": {"enabled": True, "block_size": 16}})
    trunk0 = pm_trunk(tr)
    named = dict(tr.model.named_parameters())
    n_adapter = sum(p.numel() for n, p in named.items() if n.rsplit(".", 1)[-1] in PM_ADAPTERS)
    n_head = sum(p.numel() for n, p in named.items() if not n.startswith("transformer."))
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    stats, step_s, exp_s = pm_drive(tr, 4)
    launches = _kernels.launches()
    peak = torch.cuda.max_memory_allocated() - start
    moments = sum(v.numel() * v.element_size() for st in tr.optimizer.state.values() for k, v in st.items()
                  if k in ("exp_avg", "exp_avg_sq"))
    L, num_mb = tr.model_config.num_layers, TRAIN_B // TRAIN_MB

    out = tempfile.mkdtemp(prefix="chip_smoke_pm_export_")
    t0 = time.perf_counter()
    tr.save_pretrained(out)
    save_s = time.perf_counter() - t0
    f32 = {"compute_dtype": "float32", "attention_impl": "flash"}
    config, state, _ = load_pretrained(out, f32)
    with torch.device(tr.device):
        merged = TransformerLM(config)
        adapter = TransformerLM(tr.model_config.replace(compute_dtype=torch.float32))
    merged.load_state_dict(state)
    adapter.load_state_dict(tr.model.transformer.state_dict())
    gen = torch.Generator(device=tr.device).manual_seed(SEED)
    ids = torch.randint(0, 256, (8, 96), device=tr.device, generator=gen, dtype=torch.int32)
    mask = torch.ones_like(ids)
    mask[1, :30] = 0
    with torch.no_grad():
        lm, la = merged(ids, mask)[0], adapter(ids, mask)[0]
    keep = mask.bool()
    merge_err = float((lm - la)[keep].abs().max())
    merge_limit = 1e-4 * max(1.0, float(la[keep].abs().max()))
    full = tr.model.state_dict()
    restored = load_adapters(out, {k: torch.zeros_like(v) for k, v in full.items()})
    adapters_equal = all(torch.equal(restored[k], v) for k, v in full.items() if k.rsplit(".", 1)[-1] in PM_ADAPTERS)
    shutil.rmtree(out, ignore_errors=True)
    report = {"steps": len(stats), "step_s": step_s, "experience_s": exp_s, "peak_above_start_gib": peak / 2 ** 30,
              "adapter_params": n_adapter, "head_params": n_head, "adamw_moment_bytes": moments,
              "adamw_moment_bytes_formula": 8 * (294_912 + 1_182_721), "export_s": save_s,
              "merged_vs_adapter_max_abs_err_f32": merge_err, "merge_limit": merge_limit,
              "losses": [{k: v for k, v in s.items() if k.startswith("losses/")} for s in stats],
              "serving_blocks_in_use": tr._serving_engine.allocator.blocks_in_use, "launches": launches}
    checks = {
        "4 steps, finite losses": len(stats) == 4 and pm_finite(stats),
        "no reference copy, no branch": tr.ref_model is None and tr.frozen_branch is None and tr.peft_base_ref,
        "trunk torch.equal, no grad, no state": pm_trunk_unchanged(tr, trunk0),
        "adapters 294,912 and head 1,182,721 parameters": n_adapter == 294_912 and n_head == 1_182_721,
        "AdamW moments == (294,912 + 1,182,721) x 8 B": moments == 8 * (294_912 + 1_182_721),
        "merged export == adapter forward (f32)": merge_err <= merge_limit,
        "adapters file reloads torch.equal": adapters_equal,
        "K2 and K3 once per layer and microbatch":
            launches["flash_bwd_dkv"] == launches["flash_bwd_dq"] == 4 * L * num_mb,
        "K1 and K4 launched (engine prefill and decode, scoring, loss)":
            launches["flash_fwd"] > 0 and launches["paged_decode"] > 0,
        "no block left": tr._serving_engine.allocator.blocks_in_use == 0,
    }
    tr.on_learn_end()
    shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    del tr, merged, adapter
    torch.cuda.empty_cache()
    return checks, launches, report


def pm_lora_async(ctx):
    """Leg ``lora_async``: LoRA PPO (the ``lora_ppo`` adapters) under
    ``train.async_rollouts`` at gpt2 full width, 2 steps
    (:func:`async_ppo_leg`): the producer's copy carries the adapters and
    scores its KL reference with them disabled; the trunk stays
    ``torch.equal`` to its initial weights."""
    import shutil

    import torch

    from trlx_tpu_torch.ops import _kernels

    tr = pm_trainer("lora_async", {"model.peft_config": PM_LORA,
                                   "train.async_rollouts": {"enabled": True, "max_staleness": 1}})
    trunk0 = pm_trunk(tr)
    _kernels.reset_launches()
    checks, report = async_ppo_leg(tr)
    launches = _kernels.launches()
    checks["trunk torch.equal, no grad, no state"] = pm_trunk_unchanged(tr, trunk0)
    checks["the producer's copy carries the adapters"] = any(
        n.endswith(".lora_a") for n in tr._producer_model.state_dict())
    report["launches"] = launches
    shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    del tr
    torch.cuda.empty_cache()
    return checks, launches, report


def pm_prompt_prefix(ctx):
    """Leg ``prompt_prefix``: prompt tuning and prefix tuning (8 virtual
    tokens) at gpt2 full width, 2 steps each (the padded generate: the
    engine refuses virtual rows): prompt tuning runs K1, K2 and K3 (K2 / K3
    once per layer and microbatch); under prefix tuning the policy's layers
    attend on the plain path (no K2, no K3, no K1 in generation or the
    loss), and K1 runs only in the KL reference's forward, the base model
    with its prefixes disabled, as the reference's base module runs its
    flash kernel; the trunk unchanged."""
    import shutil

    import torch

    from trlx_tpu_torch.ops import _kernels

    report, checks, total = {}, {}, None
    num_mb = TRAIN_B // TRAIN_MB
    for kind in ("prompt", "prefix"):
        tr = pm_trainer(kind, {"model.peft_config": PM_PEFT[kind]})
        L = tr.model_config.num_layers
        trunk0 = pm_trunk(tr)
        scored = []
        real_score = tr._score_device

        def counted_score(*a, _real=real_score, **k):
            scored.append(1)
            return _real(*a, **k)

        tr._score_device = counted_score
        n_trained = sum(p.numel() for p in tr.trainable_params)
        _kernels.reset_launches()
        stats, step_s, exp_s = pm_drive(tr, 2)
        launches = _kernels.launches()
        total = launches if total is None else {k: total[k] + launches[k] for k in total}
        report[kind] = {"step_s": step_s, "experience_s": exp_s, "trained_params": n_trained,
                        "launches": launches, "scoring_calls": len(scored),
                        "losses": [{k: v for k, v in s.items() if k.startswith("losses/")} for s in stats]}
        checks[f"{kind}: 2 steps, finite losses"] = len(stats) == 2 and pm_finite(stats)
        checks[f"{kind}: trunk unchanged"] = pm_trunk_unchanged(tr, trunk0)
        checks[f"{kind}: no paged kernel"] = launches["paged_decode"] == launches["paged_verify"] == 0
        if kind == "prompt":
            checks["prompt: K1 launched, K2 and K3 per layer and microbatch"] = (
                launches["flash_fwd"] > 0 and launches["flash_bwd_dkv"] == launches["flash_bwd_dq"] == 2 * L * num_mb)
        else:
            # the policy's layers attend on the plain path; the KL reference
            # is the base model (prefixes disabled), which the reference
            # runs through its flash kernel: K1 once per layer and scoring call
            checks["prefix: no K2 or K3; K1 only in the reference's scoring forward"] = (
                launches["flash_bwd_dkv"] == launches["flash_bwd_dq"] == 0
                and launches["flash_fwd"] == L * len(scored) > 0)
        shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
        del tr
        torch.cuda.empty_cache()
    return checks, total, report


def pm_set_remat(model, policy):
    """Set every block's remat policy (``run_block`` reads it per call)."""
    from trlx_tpu_torch.models.transformer import Block

    for m in model.modules():
        if isinstance(m, Block):
            m.config = m.config.replace(remat=policy)


def pm_remat(ctx):
    """Leg ``remat``: the train phase's trainer (full fine-tuning), one
    experience phase, then the same learner batch's forward and backward
    (2 microbatches, no optimizer step) under ``none`` and each policy, in
    turns (none first and last): losses and every gradient ``torch.equal``
    to ``none``'s; K1 launches, peak memory and seconds per policy."""
    import shutil

    import torch

    from trlx_tpu_torch.ops import _kernels

    tr = pm_trainer("remat", {})
    _kernels.reset_launches()
    tr.prepare_learning()
    torch.cuda.synchronize()
    launches = _kernels.launches()
    batch = list(tr.create_train_dataloader())[0].to(tr.device)
    runs, ref = [], None
    for policy in ("none",) + PM_REMAT + ("none",):
        pm_set_remat(tr.model, policy)
        tr.optimizer.zero_grad(set_to_none=True)  # the last run's gradients go
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        losses = []
        for mb in batch.split(tr.num_mb):
            loss, _ = tr.loss_fn(mb)
            loss.backward()
            losses.append(loss.detach())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        run_launches = _kernels.launches()
        launches = {k: launches[k] + run_launches[k] for k in launches}
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in tr.trainable_params]
        row = {"policy": policy, "fwd_bwd_s": seconds, "K1": run_launches["flash_fwd"],
               "K2": run_launches["flash_bwd_dkv"], "K3": run_launches["flash_bwd_dq"],
               "peak_above_start_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
        if ref is None:
            ref = ([x.clone() for x in losses], [g.detach().clone() for g in grads])
        else:
            row["losses_equal"] = all(torch.equal(a, b) for a, b in zip(ref[0], losses))
            row["grads_equal"] = all(torch.equal(a, b) for a, b in zip(ref[1], grads))
            row["grads_max_rel"] = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                                       for a, b in zip(ref[1], grads))
        runs.append(row)
        del grads, losses  # nothing but the parameters may hold the gradients into the next run
    pm_set_remat(tr.model, "none")
    L, num_mb = tr.model_config.num_layers, TRAIN_B // TRAIN_MB
    checks = {"losses and gradients torch.equal to none's":
              all(r.get("losses_equal", True) and r.get("grads_equal", True) for r in runs),
              "K1 runs again in the backward under every policy":
                  all(r["K1"] == (2 if r["policy"] != "none" else 1) * L * num_mb for r in runs),
              "K2 and K3 once per layer and microbatch": all(r["K2"] == r["K3"] == L * num_mb for r in runs)}
    shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    del tr, batch, ref
    torch.cuda.empty_cache()
    return checks, launches, {"runs": runs}


def pm_offload_ref(ctx):
    """Leg ``offload_ref``: the full-copy reference in pinned host memory,
    the experience phase streamed through the engine (``stream_overlap``):
    one upload for the phase, released before the learner steps. An upload
    raises ``memory_allocated`` by the reference's 497,759,232 B (plus the
    caching allocator's block slack, under 1 MiB a tensor) and its release
    lowers it by exactly as much (nothing keeps the copy alive); a learner
    step starts that much lower (within 16 MiB) with the reference released
    than held; the
    reference's scoring through the uploaded copy is ``torch.equal`` to a
    resident copy's."""
    import shutil

    import numpy as np
    import torch

    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.ops.generation import left_pad_batch

    tr = pm_trainer("offload", {"model.offload_ref": True, "train.serving": {
        "enabled": True, "block_size": 16, "stream_overlap": True}})
    pinned = all(v.is_pinned() for v in tr._ref_host.values())
    ref_bytes = sum(v.numel() * v.element_size() for v in tr._ref_host.values())
    # the caching allocator hands a tensor its whole block when the rest
    # would be under 1 MiB, so an upload may count up to 1 MiB a tensor more
    slack = len(tr._ref_host) * 2 ** 20
    _kernels.reset_launches()
    stats, step_s, exp_s = pm_drive(tr, 1)
    uploads_after_phase, released = tr.ref_uploads, tr._ref_dev is None

    def allocated():
        gc.collect()  # a collectable cycle freed mid-reading would blur the deltas
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def measured_step(batch):
        start = allocated()
        torch.cuda.reset_peak_memory_stats()
        stats.append(tr.train_step(batch))
        torch.cuda.synchronize()
        return start, torch.cuda.max_memory_allocated()

    batches = list(tr.create_train_dataloader())
    start_released, peak_released = measured_step(batches[0])
    launches = _kernels.launches()
    a = allocated()
    ref = tr._ref_scoring_model()
    b = allocated()
    uploaded_equal = all(torch.equal(v.cpu(), tr._ref_host[k]) for k, v in ref.state_dict().items())
    del ref
    tr._release_ref()
    c = allocated()
    # the reference's scoring: uploaded against a resident copy
    with torch.device(tr.device):
        resident = TransformerLM(tr.model_config)
    resident.load_state_dict(tr._ref_host)
    resident.requires_grad_(False)
    elems = list(tr.store.history)[:8]
    P = max(len(e.query_tensor) for e in elems)
    R = max(len(e.response_tensor) for e in elems)
    q, qm = left_pad_batch([e.query_tensor for e in elems], tr.tokenizer.pad_token_id, P)
    r = np.full((len(elems), R), tr.tokenizer.pad_token_id, np.int32)
    rm = np.zeros((len(elems), R), np.int32)
    for i, e in enumerate(elems):
        r[i, :len(e.response_tensor)] = e.response_tensor
        rm[i, :len(e.response_tensor)] = 1
    seq, mask = np.concatenate([q, r], axis=1), np.concatenate([qm, rm], axis=1)
    _, _, rlp_offload = tr.score(seq, mask, P, R)
    tr._release_ref()
    host = tr._ref_host
    tr._ref_host, tr.ref_model = None, resident
    _, _, rlp_resident = tr.score(seq, mask, P, R)
    tr._ref_host, tr.ref_model = host, None
    del resident
    # the same step with the reference held on the card
    tr._pin_ref()
    start_held, peak_held = measured_step(batches[1])
    tr._unpin_ref()
    tr._release_ref()
    report = {"upload_s": tr.ref_upload_s, "uploads": tr.ref_uploads, "step_s": step_s, "experience_s": exp_s,
              "ref_bytes": ref_bytes, "ref_tensors": len(tr._ref_host), "alloc_rise_at_upload": b - a,
              "alloc_fall_at_release": b - c,
              "step_start_alloc_gib": {"released": start_released / 2 ** 30, "held": start_held / 2 ** 30},
              "step_peak_gib": {"released": peak_released / 2 ** 30, "held": peak_held / 2 ** 30},
              "overlap": tr.last_overlap, "launches": launches}
    checks = {
        "reference held pinned on the host, none on the card": pinned and tr.ref_model is None,
        "a streamed phase uploads once and releases": uploads_after_phase == 1 and released,
        "the reference is gpt2's 124,439,808 f32 parameters": ref_bytes == PM_REF_BYTES,
        "an upload allocates the reference's bytes (+ <= 1 MiB a tensor)": ref_bytes <= b - a <= ref_bytes + slack,
        "the release frees all of it": b - c == b - a,
        "a step starts lower by the upload with the reference released (16 MiB)":
            abs(start_held - start_released - (b - a)) <= 2 ** 24,
        "uploaded copy == host copy": uploaded_equal,
        "scoring torch.equal to a resident reference": bool(np.array_equal(rlp_offload, rlp_resident)),
        "finite losses": pm_finite(stats),
        "K1, K2, K3, K4 launched": all(launches[k] > 0 for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                                                                 "paged_decode")),
    }
    tr.on_learn_end()
    shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    del tr
    torch.cuda.empty_cache()
    return checks, launches, report


def pm_decode_kernels(trainer, policy, n_prompts=8):
    """Device operations per decode step of the padded generate with
    ``policy`` (torch.profiler's CUDA events for 9 greedy tokens minus 1,
    over 8), after a warm-up."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    prompts = [np.asarray(trainer.tokenizer(p).input_ids, np.int32) for p in byte_prompts(n_prompts, 16, 32, SEED + 5)]

    def run(n):
        trainer.generate(prompts, eval_mode=True, policy=policy, max_new_tokens=n, min_new_tokens=n,
                         do_sample=False)
        torch.cuda.synchronize()

    run(9)
    counts = {}
    for n in (1, 9):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(n)
        counts[n] = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return (counts[9] - counts[1]) / 8


def pm_rollout_dtype(ctx):
    """Leg ``rollout_dtype``: ``train.rollout_param_dtype=bfloat16`` on the
    card against the CPU (``train_parity``'s trainer: tokens identical but
    at f32 near ties), then at gpt2 full width through ``train.serving``, 4
    steps: the engine's trunk in bf16, one cast per experience phase and
    none inside a step; device operations per decode step of the padded
    generate with the bf16 copy and with the f32 masters (a finding)."""
    import shutil

    import torch

    from trlx_tpu_torch.ops import _kernels

    parity, parity_ok = train_parity_report({"train.rollout_param_dtype": "bfloat16"}, tie_dtype="float32")
    tr = pm_trainer("rollout", {"train.rollout_param_dtype": "bfloat16",
                                "train.serving": {"enabled": True, "block_size": 16}})
    casts_in_steps = []

    def on_step(t):
        casts_in_steps.append((t.rollout_casts, t._rollout_model is None))

    _kernels.reset_launches()
    stats, step_s, exp_s = pm_drive(tr, 4, on_step=on_step)
    launches = _kernels.launches()
    engine_bf16 = all(p.dtype == torch.bfloat16 for p in tr._serving_engine.trunk.parameters())
    casts = tr.rollout_casts
    tr.on_learn_end()
    per_step_copy = pm_decode_kernels(tr, tr.generation_model())
    per_step_f32 = pm_decode_kernels(tr, tr.model)
    report = {"parity": parity, "casts": casts, "casts_seen_after_each_step": casts_in_steps,
              "step_s": step_s, "experience_s": exp_s,
              "device_ops_per_decode_step": {"bf16_copy": per_step_copy, "f32_masters": per_step_f32},
              "launches": launches}
    checks = {
        "card == CPU under the setting": parity_ok,
        "engine trunk bf16, masters f32": engine_bf16 and all(p.dtype == torch.float32 for p in tr.model.parameters()),
        "one cast per experience phase (2 phases)": casts == 2,
        "none inside a step, the copy dropped": [c for c, _ in casts_in_steps] == [1, 1, 2, 2] and all(
            d for _, d in casts_in_steps),
        "finite losses": pm_finite(stats),
    }
    shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    del tr
    torch.cuda.empty_cache()
    return checks, launches, report


def pm_8bit_formula(params):
    """The 8-bit AdamW's state bytes: per tensor ceil(n / 256) blocks of 256
    int8 + 4 (m's scale) + 256 uint8 + 8 (v's log range), plus the int32
    count."""
    return sum(-(-p.numel() // 256) * (256 + 4 + 256 + 8) for p in params) + 4


def pm_adamw_8bit(ctx):
    """Leg ``adamw_8bit``: the 8-bit AdamW on the card against the CPU
    (``train_parity``'s trainer, its limits), then full fine-tuning at gpt2
    full width: state bytes equal the formula (AdamW's f32 moments beside
    it), and a checkpoint after the first step resumed in a second trainer
    makes the second step ``torch.equal`` (parameters and int8 / uint8
    state)."""
    import shutil
    import tempfile

    import torch

    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.utils.optim import state_bytes

    parity, parity_ok = train_parity_report({}, optimizer=("adamw_8bit_bnb", PM_8BIT))
    over = {"train.save_optimizer": True}
    a = pm_trainer("8bit_a", over, optimizer=("adamw_8bit_bnb", PM_8BIT))
    _kernels.reset_launches()
    stats, step_s, exp_s = pm_drive(a, 1)
    batch = list(a.create_train_dataloader())[1]
    ck = tempfile.mkdtemp(prefix="chip_smoke_pm_8bit_ck_")
    t0 = time.perf_counter()
    a.save(ck)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sa = a.train_step(batch)
    torch.cuda.synchronize()
    step_s.append(time.perf_counter() - t0)
    launches = _kernels.launches()
    b = pm_trainer("8bit_b", over, optimizer=("adamw_8bit_bnb", PM_8BIT))
    b.load(ck)
    b.num_mb, b.rollout_stats = a.num_mb, a.rollout_stats
    sb = b.train_step(batch)
    got, want = state_bytes(a.optimizer), pm_8bit_formula(a.trainable_params)
    n = sum(p.numel() for p in a.trainable_params)
    same_state = all(
        torch.equal(a.optimizer.state[pa][k], b.optimizer.state[pb][k]) and
        a.optimizer.state[pa][k].dtype == b.optimizer.state[pb][k].dtype
        for pa, pb in zip(a.trainable_params, b.trainable_params) for k in ("m_q", "m_scale", "v_q", "v_scale"))
    report = {"parity": parity, "state_bytes": got, "state_bytes_formula": want, "adamw_moment_bytes": 8 * n,
              "trained_params": n, "step_s": step_s, "experience_s": exp_s, "checkpoint_s": save_s,
              "launches": launches}
    checks = {
        "card == CPU": parity_ok,
        "state bytes == formula": got == want,
        "resume torch.equal": {k: v for k, v in sa.items() if not k.startswith("time/")} == {
            k: v for k, v in sb.items() if not k.startswith("time/")} and same_state and all(
            torch.equal(pa, pb) for pa, pb in zip(a.model.parameters(), b.model.parameters())),
        "finite losses": pm_finite(stats + [sa]),
    }
    for t in (a, b):
        shutil.rmtree(t.config.train.checkpoint_dir, ignore_errors=True)
    shutil.rmtree(ck, ignore_errors=True)
    del a, b
    torch.cuda.empty_cache()
    return checks, launches, report


def phase_peft_memory(ctx):
    """A main path: peft and the training-memory options at gpt2 full width
    (:func:`pm_peft_parity`, :func:`pm_lora_ppo`, :func:`pm_lora_async`, :func:`pm_prompt_prefix`,
    :func:`pm_remat`, :func:`pm_offload_ref`, :func:`pm_rollout_dtype`,
    :func:`pm_adamw_8bit`). Each full-width leg counts launches from 0 and
    the phase's path sums them; the card-against-CPU runs are not counted.
    Every kernel call shape of the full-width legs is recorded and, after
    the counts are read, held against the plain versions
    (:func:`check_main_path_shapes`)."""
    from trlx_tpu_torch.ops import _kernels

    legs, failed, total = {}, [], {name: 0 for name in _kernels.launches()}
    seen = {}
    restore = None
    try:
        for name, leg in (("peft_parity", pm_peft_parity), ("lora_ppo", pm_lora_ppo),
                          ("lora_async", pm_lora_async), ("prompt_prefix", pm_prompt_prefix), ("remat", pm_remat), ("offload_ref", pm_offload_ref),
                          ("rollout_dtype", pm_rollout_dtype), ("adamw_8bit", pm_adamw_8bit)):
            if restore is None and name != "peft_parity":
                restore = record_kernel_shapes(seen)  # every call shape of the full-width legs
            t0 = time.perf_counter()
            checks, launches, report = leg(ctx)
            legs[name] = {"s": time.perf_counter() - t0, "launches": launches}
            if launches is not None:
                total = {k: total[k] + launches.get(k, 0) for k in total}
            emit({"phase": "peft_memory", "leg": name, "checks": checks, "report": report, "card": ctx.get("smi")})
            failed += [f"{name}: {k}" for k, ok in checks.items() if not ok]
    finally:
        if restore is not None:
            restore()
    ctx["peft_memory_launches"] = total
    emit({"phase": "peft_memory", "legs": legs, "launches": total, "kernel_shapes": kernel_shapes(seen),
          "card": ctx.get("smi")})
    # after the counts are read: each kernel at every shape the legs gave it
    try:
        check_main_path_shapes(ctx, seen, "peft_memory", ("flash_fwd", "flash_bwd", "paged_decode"))
    except AssertionError as e:
        failed.append(str(e))
    if failed:
        raise AssertionError(f"peft_memory phase: {failed}")


# ------------------------------------------------------------------ stacked

#: phase stacked: the reference's GPT-2-XL audit blueprints over stacked
#: layers (``decode_step``'s and ``spec_verify_step``'s ``xl`` specs,
#: trlx_tpu/ops/generation.py and trlx_tpu/ops/paged_attention.py)
ST_XL = dict(vocab_size=50257, hidden_size=1600, num_layers=48, num_heads=25, intermediate_size=6400,
             max_position_embeddings=1024, attention_impl="flash")
ST_B, ST_P, ST_N, ST_FWD_T = 8, 128, 16, 144
ST_NB, ST_BS, ST_MB, ST_Q = 64, 16, 16, 5
ST_SFT_B, ST_SFT_T = 4, 128
#: the stacked SFT step's peak memory against the listed one's
ST_PEAK_RATIO = 1.10
#: where the phase runs (a CPU rehearsal sets "cpu" and shrinks ST_XL)
ST_DEVICE = "cuda"


def st_models():
    """The stacked GPT-2-XL trunk (f32 parameters from the seed, bf16
    compute, flash) and its listed twin, whose parameters are
    ``unstack_layer_params`` of the stacked ones (views: no copy)."""
    import torch

    from trlx_tpu_torch.models.presets import PRESETS
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.parallel.pipeline import unstack_layer_params

    cfg = PRESETS["gpt2"].replace(compute_dtype=torch.bfloat16, param_dtype=torch.float32, scan_layers=True,
                                  **ST_XL)
    with torch.device(ST_DEVICE):
        stacked = TransformerLM(cfg).init_params(SEED)
    listed = TransformerLM(cfg.replace(scan_layers=False), device="meta")
    listed.load_state_dict(unstack_layer_params(stacked.state_dict(), cfg.num_layers), assign=True)
    return stacked, listed


def st_share(model, **over):
    """``model`` under a config with ``over`` on the same parameters."""
    from trlx_tpu_torch.models.transformer import TransformerLM

    other = TransformerLM(model.config.replace(**over), device="meta")
    other.load_state_dict(model.state_dict(), assign=True)
    return other


def st_close(a, b):
    """(max abs difference, limit): bf16 kernel agreement, 2e-2 x max(1, |b|)."""
    err = float((a.float() - b.float()).abs().max())
    return err, TOL["bfloat16"] * max(1.0, float(b.float().abs().max()))


def st_prompts(vocab, B, P, seed):
    """``B`` left-padded prompts of P/2..P tokens, the attention mask."""
    import numpy as np
    import torch

    from trlx_tpu_torch.ops.generation import left_pad_batch

    rng = np.random.default_rng(seed)
    ids, mask = left_pad_batch([rng.integers(1, vocab, int(n)).astype(np.int32)
                                for n in rng.integers(P // 2, P + 1, size=B)], 0, P)
    return torch.from_numpy(np.asarray(ids)).to(ST_DEVICE), torch.from_numpy(np.asarray(mask)).to(ST_DEVICE)


class StPath:
    """Phase stacked's path: the stacked layout's runs, each counted from 0
    (the counts set to 0 just before it, read just after) and summed. The
    listed twin's runs and the plain replays are comparisons and count for
    no path."""

    def __init__(self):
        from trlx_tpu_torch.ops import _kernels

        self.total = {name: 0 for name in _kernels.launches()}

    @contextlib.contextmanager
    def count(self):
        from trlx_tpu_torch.ops import _kernels

        _kernels.reset_launches()
        try:
            yield
        finally:
            got = _kernels.launches()
            self.total = {k: self.total[k] + got[k] for k in self.total}


def st_forward(ctx, path, stacked, listed):
    """Leg forward: one cache-free forward of B=8 x T=144 left-padded
    tokens in both layouts."""
    import torch

    ids, mask = st_prompts(ST_XL["vocab_size"], ST_B, ST_FWD_T, SEED + 31)
    with torch.no_grad():
        with path.count():
            a = stacked(ids, mask)[0]
        b = listed(ids, mask)[0]
    err, tol = st_close(a, b)
    report = {"logits_max_abs_err": err, "tol": tol, "identical": bool(torch.equal(a, b))}
    return {"stacked logits == listed (bf16 tolerance)": err <= tol and bool(torch.isfinite(a).all())}, report


def st_generate(ctx, path, stacked, listed):
    """Leg generate: greedy ``generate`` at B=8, P=128, N=16 over a bf16
    and an int8 cache in both layouts; the stacked tokens ``==`` the listed
    ones."""
    import torch

    from trlx_tpu_torch.ops.generation import generate

    ids, mask = st_prompts(ST_XL["vocab_size"], ST_B, ST_P, SEED + 32)
    checks, report = {}, {}
    for cache in ("bf16", "int8"):
        pair = (stacked, listed) if cache == "bf16" else (st_share(stacked, kv_cache_quant=True),
                                                         st_share(listed, kv_cache_quant=True))
        seqs = []
        for model, window in zip(pair, (path.count, contextlib.nullcontext)):
            def step(i, m, pos, c, model=model):
                logits, hidden, _, c = model(i, m, pos, c, last_only=True)
                return logits, hidden, c

            with torch.no_grad(), window():
                out = generate(step, model.init_cache, ids, mask, None, ST_N, pad_token_id=0, do_sample=False)
            seqs.append(out["sequences"])
        leaf = pair[0].init_cache(ST_B, ST_P + ST_N)["k"]
        report[cache] = {"tokens_equal": bool(torch.equal(seqs[0], seqs[1])), "cache_leaf": list(leaf.shape),
                         "cache_dtype": str(leaf.dtype)}
        checks[f"{cache} cache: stacked tokens == listed"] = report[cache]["tokens_equal"]
        checks[f"{cache} cache: one [L, B, Hkv, S, D] leaf"] = list(leaf.shape) == [
            ST_XL["num_layers"], ST_B, ST_XL["num_heads"], ST_P + ST_N, ST_XL["hidden_size"] // ST_XL["num_heads"]]
    return checks, report


def st_decode_launches_start():
    """Start :func:`st_decode_launches_run` in a fresh process: this
    process's profiler windows hold CUPTI's one subscriber. It counts
    launches and times nothing, so it runs beside the phase's other legs."""
    return subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke.st_decode_launches_run()"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def st_decode_launches(ctx, proc):
    """Leg decode_launches: the device launches of one decode step in each
    layout (bf16 and int8 caches), counted through CUPTI by ``proc``
    (:func:`st_decode_launches_start`). Equal counts: a stacked step writes
    and reads views of the ``[L, ...]`` leaves and restacks nothing."""
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    lines = [line for line in out.splitlines() if line.startswith('{"decode_launches"')]
    if proc.returncode != 0 or not lines:
        return {"the counting process ran": False}, {"returncode": proc.returncode, "stderr": err[-3000:]}
    report = json.loads(lines[-1])["decode_launches"]
    checks = {f"{cache} cache: a stacked decode step launches what a listed one does":
              counts["stacked"] == counts["listed"] and counts["stacked"] > 0 for cache, counts in report.items()}
    return checks, report


def st_decode_launches_run():
    """Prefill B=8 x P=128 into each layout's cache, one warm-up decode
    step, then one decode step counted through CUPTI; prints one JSON
    line."""
    import torch

    from trlx_tpu_torch.analysis.census import api_counter

    stacked, listed = st_models()
    ids, mask = st_prompts(ST_XL["vocab_size"], ST_B, ST_P, SEED + 32)
    out = {}
    for cache_kind in ("bf16", "int8"):
        pair = (stacked, listed) if cache_kind == "bf16" else (st_share(stacked, kv_cache_quant=True),
                                                              st_share(listed, kv_cache_quant=True))
        counts = {}
        for name, model in zip(("stacked", "listed"), pair):
            cache = model.init_cache(ST_B, ST_P + 2)
            full = torch.cat([mask, torch.zeros_like(mask[:, :2])], dim=1)
            tok = ids[:, -1:]
            with torch.no_grad():
                model(ids, full, None, cache, last_only=True)
                full[:, ST_P] = 1
                model(tok, full, None, cache, last_only=True)  # warm-up
                full[:, ST_P + 1] = 1
                torch.cuda.synchronize()
                with api_counter.counting() as calls:
                    model(tok, full, None, cache, last_only=True)
                    torch.cuda.synchronize()
            counts[name] = calls["launches"]
        out[cache_kind] = counts
    print(json.dumps({"decode_launches": out}), flush=True)


def st_verify(ctx, path, stacked, listed):
    """Leg verify: one ``paged_verify`` round at the ``spec_verify_step``
    ``xl`` dims (B=8, Q=5, NB=64, BS=16, MB=16) over int8 pools filled from
    quantized normals: stacked ``[L, ...]`` pools against per-layer copies.
    Logits and the written pools agree; every K5 launch of the leg is held
    against its plain version on the same inputs, and each stacked launch
    reads ``pool[l]`` at its own offset (a view, no copy)."""
    import numpy as np
    import torch

    from trlx_tpu_torch.models.transformer import quantize_kv_rows
    from trlx_tpu_torch.ops import paged_attention as paged

    sq, lq = st_share(stacked, kv_cache_quant=True), st_share(listed, kv_cache_quant=True)
    L, H = ST_XL["num_layers"], ST_XL["num_heads"]
    D = ST_XL["hidden_size"] // H
    gen = torch.Generator(device=ST_DEVICE).manual_seed(SEED + 33)
    cache = sq.init_paged_cache(ST_NB, ST_BS, ST_MB, ST_B)
    for key in ("k", "v"):
        q, s = quantize_kv_rows(torch.randn((L, ST_NB, ST_BS, H, D), generator=gen, device=ST_DEVICE))
        cache[key].copy_(q)
        cache[f"{key}_scale"].copy_(s[..., 0])
    rng = np.random.default_rng(SEED + 34)
    tables = rng.integers(ST_B + 1, ST_NB, size=(ST_B, ST_MB)).astype(np.int32)
    tables[:, 6] = np.arange(1, ST_B + 1)  # each slot writes a block of its own
    lens = (6 * ST_BS + rng.integers(0, ST_BS - ST_Q, size=ST_B)).astype(np.int32)
    cache["block_tables"] = torch.from_numpy(tables).to(ST_DEVICE)
    cache["context_lens"] = torch.from_numpy(lens).to(ST_DEVICE)
    listed_cache = {k: (v.clone() if k in ("block_tables", "context_lens") else [t.clone() for t in v.unbind(0)])
                    for k, v in cache.items()}
    toks = torch.from_numpy(rng.integers(1, ST_XL["vocab_size"], size=(ST_B, ST_Q)).astype(np.int32)).to(ST_DEVICE)
    calls = {"stacked": [], "listed": []}
    kernel = paged.paged_verify_attention_kernel

    def recording(layout):
        def run(q, k_pool, v_pool, block_tables, context_lens, **kw):
            out = kernel(q, k_pool, v_pool, block_tables, context_lens, **kw)
            calls[layout].append((q, k_pool, v_pool, block_tables, context_lens, kw, out))
            return out
        return run

    logits = []
    try:
        for layout, model, c, window in (("stacked", sq, cache, path.count),
                                         ("listed", lq, listed_cache, contextlib.nullcontext)):
            paged.paged_verify_attention_kernel = recording(layout)
            with torch.no_grad(), window():
                logits.append(model.paged_verify(toks, c)[0])
    finally:
        paged.paged_verify_attention_kernel = kernel
    err, tol = st_close(logits[0], logits[1])
    pools_equal = all(torch.equal(cache[k][l], listed_cache[k][l]) for k in ("k", "v", "k_scale", "v_scale")
                      for l in range(L))
    errs, layer_elems = ctx.setdefault("max_abs_err", {}), ST_NB * ST_BS * H * D
    errs.setdefault("paged_verify", 0.0)
    worst, in_place = 0.0, True
    for layout, recorded in calls.items():
        for l, (q, kp, vp, bt, cl, kw, out) in enumerate(recorded):
            ref = paged.paged_verify_attention_reference(q, kp, vp, bt, cl, **kw)
            e, t = st_close(out, ref)
            worst = max(worst, e / t)
            errs["paged_verify"] = max(errs["paged_verify"], e)
            if layout == "stacked":  # int8 pools: one byte an element
                in_place = in_place and kp.storage_offset() == l * layer_elems and (
                    kp.data_ptr() == cache["k"].data_ptr() + l * layer_elems)
    torch.cuda.synchronize()
    report = {"logits_max_abs_err": err, "tol": tol, "logits_identical": bool(torch.equal(logits[0], logits[1])),
              "pools_equal": pools_equal, "k5_launches": {k: len(v) for k, v in calls.items()},
              "k5_worst_err_over_tol": worst}
    checks = {
        "stacked logits == listed (bf16 tolerance)": err <= tol and bool(torch.isfinite(logits[0]).all()),
        "written pools equal": pools_equal,
        "one K5 launch a layer in each layout": all(len(v) == L for v in calls.values()),
        "every K5 launch == its plain version": worst <= 1.0,
        "each stacked K5 launch reads pool[l] in place": in_place,
    }
    return checks, report


def st_sft_trainer(scan_layers, state=None):
    """The SFT trainer at GPT-2-XL (bf16 compute, f32 parameters and
    AdamW, remat per_layer), B=4 x T=128 in one microbatch; ``state``
    replaces the trunk's initial weights."""
    import tempfile

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.update(full_width_sft_config(tempfile.mkdtemp(prefix="chip_smoke_st_sft_")), {
        "model.model_overrides": dict(ST_XL, scan_layers=scan_layers), "mesh.remat": "per_layer",
        "train.seq_length": ST_SFT_T, "train.batch_size": ST_SFT_B, "train.minibatch_size": ST_SFT_B})
    trainer = get_trainer("SFTTrainer")(config=cfg, device=ST_DEVICE)
    if state is not None:
        trainer.model.transformer.load_state_dict(state)
    trainer.make_experience(byte_dialogues(16, SEED + 35), ST_SFT_T)
    trainer.prepare_learning()
    return trainer


def st_sft_steps(trainer, window, steps=2):
    """``steps`` SFT steps from the peak-memory counter's reset, inside
    ``window``: (losses, peak bytes, launches)."""
    import torch

    from trlx_tpu_torch.ops import _kernels

    batches = list(trainer.create_train_dataloader())[:steps]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    with window():
        losses = [trainer.train_step(b)["losses/loss"] for b in batches]
        launches = _kernels.launches()
    torch.cuda.synchronize()
    return losses, torch.cuda.max_memory_allocated(), launches


def st_train(ctx, path):
    """Leg train: two SFT steps at GPT-2-XL with ``remat="per_layer"``,
    stacked then listed from the same weights and data: losses within 1e-3
    relative, each stacked gradient the stack of the listed ones (bf16
    tolerance), the stacked peak allocated memory <= 1.10 x the listed one
    (a ``select`` backward or a restack would add an ``[L, ...]`` tensor a
    layer), K2 and K3 launched equally."""
    import gc
    import shutil

    import torch

    from trlx_tpu_torch.parallel.pipeline import unstack_layer_params

    L = ST_XL["num_layers"]
    tr = st_sft_trainer(True)
    init = {k: v.detach().to("cpu", copy=True) for k, v in tr.model.transformer.state_dict().items()}
    s_losses, s_peak, s_launches = st_sft_steps(tr, path.count)
    s_grads = {n[len("transformer."):]: p.grad.detach().to("cpu", copy=True) for n, p in tr.model.named_parameters()}
    shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    tr = st_sft_trainer(False, unstack_layer_params(init, L))
    del init
    l_losses, l_peak, l_launches = st_sft_steps(tr, contextlib.nullcontext)
    l_grads = {n[len("transformer."):]: p.grad for n, p in tr.model.named_parameters()}
    worst = 0.0
    for name, g in unstack_layer_params(s_grads, L).items():
        e, t = st_close(g.to(ST_DEVICE), l_grads[name])
        worst = max(worst, e / t)
    shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    del tr, l_grads, s_grads
    gc.collect()
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(s_losses, l_losses))
    report = {"losses_stacked": s_losses, "losses_listed": l_losses, "loss_max_rel_err": rel,
              "grad_worst_err_over_tol": worst, "peak_mib_stacked": s_peak / 2 ** 20,
              "peak_mib_listed": l_peak / 2 ** 20, "launches_stacked": s_launches, "launches_listed": l_launches}
    checks = {
        "2 steps, losses within 1e-3 relative": len(s_losses) == 2 and rel <= 1e-3,
        "each stacked gradient == the stack of the listed ones": worst <= 1.0,
        f"stacked peak <= {ST_PEAK_RATIO} x listed": s_peak <= ST_PEAK_RATIO * l_peak,
        "K2 and K3 launched equally, once a layer a step": s_launches["flash_bwd_dkv"] == l_launches["flash_bwd_dkv"]
        == s_launches["flash_bwd_dq"] == l_launches["flash_bwd_dq"] == 2 * L,
    }
    return checks, report


def st_policy_unstacked(state, L):
    """A stacked policy ``state_dict`` with its trunk (``transformer.*``)
    unstacked."""
    from trlx_tpu_torch.parallel.pipeline import unstack_layer_params

    trunk = {k[len("transformer."):]: v for k, v in state.items() if k.startswith("transformer.")}
    out = {k: v for k, v in state.items() if not k.startswith("transformer.")}
    out.update({f"transformer.{k}": v for k, v in unstack_layer_params(trunk, L).items()})
    return out


def st_ppo(ctx, path):
    """Leg ppo: two PPO steps at gpt2 full width with ``scan_layers`` and
    ``num_layers_unfrozen=-1`` (the full reference copy, stacked too),
    greedy, 32 rollouts of SHORT_N tokens, against the listed run from the
    same weights: experience within 1e-4, step stats within 1e-3 relative.
    ``train.serving`` is on in the stacked run: it falls back to the padded
    generate with the JAX package's warning."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.trainer import ppo_trainer
    from trlx_tpu_torch.utils.loading import get_trainer

    def trainer(scan_layers, state=None):
        cfg = TRLConfig.update(full_width_train_config(tempfile.mkdtemp(prefix="chip_smoke_st_ppo_")), {
            "model.model_overrides": {"attention_impl": "flash", "scan_layers": scan_layers},
            "train.seq_length": TRAIN_P + SHORT_N, "train.batch_size": 16, "train.minibatch_size": 8,
            "method.num_rollouts": 32, "method.chunk_size": 32,
            "method.gen_kwargs": dict(max_new_tokens=SHORT_N, do_sample=False),
            "train.serving": {"enabled": scan_layers, "block_size": 16}})
        tr = get_trainer("PPOTrainer")(config=cfg, reward_fn=byte_share_reward, device=ST_DEVICE)
        if state is not None:
            tr.model.load_state_dict(state)
            tr.ref_model.load_state_dict(tr.model.transformer.state_dict())
        tr.add_prompt_pipeline(PromptPipeline(byte_prompts(32, 64, 128, SEED + 36), TRAIN_P, tr.tokenizer))
        return tr

    warned = []
    warning = ppo_trainer.logger.warning

    def capture(msg, *a, **kw):
        warned.append(str(msg))
        return warning(msg, *a, **kw)

    ppo_trainer.logger.warning = capture
    runs = {}
    try:
        stacked = trainer(True)
        listed = trainer(False, st_policy_unstacked(stacked.model.state_dict(), stacked.model_config.num_layers))
        for name, tr, window in (("stacked", stacked, path.count), ("listed", listed, contextlib.nullcontext)):
            _kernels.reset_launches()
            with window():
                tr.prepare_learning()
                steps = [tr.train_step(b) for b in list(tr.create_train_dataloader())[:2]]
                torch.cuda.synchronize()
                launches = _kernels.launches()
            runs[name] = (list(tr.store.history), steps, launches, tr._serving_client is None)
            shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
        del stacked, listed, tr
    finally:
        ppo_trainer.logger.warning = warning
    torch.cuda.empty_cache()
    (se, ss, s_launches, fell_back), (le, ls, l_launches, _) = runs["stacked"], runs["listed"]
    same = len(se) == len(le) == 32 and all(np.array_equal(a.query_tensor, b.query_tensor) and np.array_equal(
        a.response_tensor, b.response_tensor) for a, b in zip(se, le))
    elem_err = max((float(np.abs(getattr(a, f) - getattr(b, f)).max()) for a, b in zip(se, le)
                    for f in ("logprobs", "values", "rewards")), default=float("nan")) if same else None
    keys = [k for k in ls[0] if k.split("/")[0] in ("losses", "values", "returns", "policy", "ratio")]
    stat_err = max((abs(a[k] - b[k]) / max(abs(b[k]), 1e-3) for a, b in zip(ss, ls) for k in keys), default=None)
    report = {"identical_tokens": same, "max_element_abs_err": elem_err, "max_stat_rel_err": stat_err,
              "stats_compared": len(keys), "launches_stacked": s_launches, "launches_listed": l_launches,
              "fallback_warning": [w for w in warned if "stacked" in w]}
    checks = {
        "greedy tokens identical": same,
        "experience within 1e-4": elem_err is not None and elem_err <= 1e-4,
        "step stats within 1e-3 relative": bool(keys) and len(ss) == 2 and all(
            abs(a[k] - b[k]) <= 1e-3 * abs(b[k]) + 1e-6 for a, b in zip(ss, ls) for k in keys),
        "train.serving fell back with the JAX package's warning": fell_back and any(
            "stacked/pipelined layouts keep the contiguous cache" in w for w in warned),
        "launches equal between layouts": s_launches == l_launches,
    }
    return checks, report


def phase_stacked(ctx):
    """A main path: the stacked layer layout on one device (``scan_layers``)
    at GPT-2-XL width (gpt2 width for PPO), each leg against the listed
    layout on the same weights (:func:`st_forward`, :func:`st_generate`,
    :func:`st_verify`, :func:`st_train`, :func:`st_ppo`, and
    :func:`st_decode_launches`, whose process runs beside the others).
    Every stacked run counts from 0 and the path's
    launches are their sum (:class:`StPath`); K1, K2, K3 and K5 must launch
    on it. Every kernel call shape of the legs is held against the plain
    versions after the counts are read."""
    import gc

    import torch

    path, legs, failed, seen = StPath(), {}, [], {}
    counting = st_decode_launches_start()
    restore = record_kernel_shapes(seen)
    try:
        models = st_models()
        plan = [("forward", lambda: st_forward(ctx, path, *models)),
                ("generate", lambda: st_generate(ctx, path, *models)),
                ("verify", lambda: st_verify(ctx, path, *models)),
                ("train", lambda: st_train(ctx, path)),
                ("ppo", lambda: st_ppo(ctx, path)),
                ("decode_launches", lambda: st_decode_launches(ctx, counting))]
        for name, leg in plan:
            if name == "train":  # the XL pair's 6.2 GB go before the trainers
                del models
                gc.collect()
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            checks, report = leg()
            torch.cuda.synchronize()
            legs[name] = {"s": time.perf_counter() - t0, "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
            emit({"phase": "stacked", "leg": name, **legs[name], "checks": checks, "report": report,
                  "card": ctx.get("smi")})
            failed += [f"{name}: {k}" for k, ok in checks.items() if not ok]
    finally:
        restore()
        if counting.poll() is None:
            counting.kill()
            counting.communicate()
    ctx["stacked_launches"] = path.total
    emit({"phase": "stacked", "legs": legs, "launches": path.total, "kernel_shapes": kernel_shapes(seen),
          "card": ctx.get("smi")})
    missing = [k for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "paged_verify") if path.total[k] == 0]
    if missing:
        failed.append(f"kernels never launched on the path: {missing}")
    try:
        check_main_path_shapes(ctx, seen, "stacked", ("flash_fwd", "flash_bwd", "paged_verify"))
    except AssertionError as e:
        failed.append(str(e))
    if failed:
        raise AssertionError(f"stacked phase: {failed}")


AN_SEED_REGRESSION = "extra_item"


def an_data_plane(ctx):
    """Leg ``data_plane``: the C++ host data plane held against its numpy
    versions on the train phase's main path (gpt2 full width, 64 sampled
    rollouts of 128 tokens, 4 steps of 32, stop sequences on): every
    prompt padding, collate and stop scan that run made was recorded
    (:func:`record_data_plane`) and is recomputed here by the ``plain_*``
    versions on the same inputs (exact), and the library's call counts
    show the run went through it. Needs phase ``train`` in the same run."""
    import numpy as np

    from trlx_tpu_torch import native

    rec = ctx.get("train_data_plane")
    if rec is None:
        return {"phase train ran before (its data plane calls are held here)": False}, {}
    seen, calls = rec["seen"], rec["calls"]
    plain = {"pad_collate_i32": native.plain_pad_collate_i32, "pad_collate_f32": native.plain_pad_collate_f32,
             "find_stop_positions": native.plain_find_stop_positions}
    mismatches = []
    for name, records in seen.items():
        for i, (args, kwargs, out) in enumerate(records):
            want = plain[name](*args, **kwargs)
            got, want = (out, want) if isinstance(out, tuple) else ((out,), (want,))
            if not all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want)):
                mismatches.append(f"{name} call {i}")
    report = {"library": native.lib_path().name, "calls": calls, "mismatches": mismatches,
              "recorded": {n: len(r) for n, r in seen.items()},
              "rows_collated": sum(len(a[0]) for a, _, _ in seen["pad_collate_i32"]),
              "stop_rows_scanned": sum(int(a[0].shape[0]) for a, _, _ in seen["find_stop_positions"]),
              "out_shapes": {n: sorted({str(list((o[0] if isinstance(o, tuple) else o).shape)) for _, _, o in r})
                             for n, r in seen.items()}}
    checks = {
        "the run's collate and stop scan went through the library": all(calls[n] > 0 for n in calls),
        "every call recorded on the path counted by the library": all(
            calls[n] >= len(seen[n]) for n in calls),
        "library == numpy on every recorded call": not mismatches and all(seen.values()),
    }
    return checks, report


def an_census_start(device="cuda", run="an_census_run"):
    """Start :func:`an_census_run` (or :func:`an_mesh_census_run`) in a
    fresh process, as ``python -m trlx_tpu_torch.analysis.census`` measured
    the committed budget: the census counts launches through CUPTI's one
    subscriber, which this process's earlier ``torch.profiler`` windows
    hold. The process leads its own group, so :func:`stop_group` stops
    the rank processes it starts with it."""
    return subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke.{run}({device!r})"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def stop_group(proc) -> None:
    """Kill ``proc``'s process group (it and what it started) and reap it."""
    import signal

    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.communicate()


def _census_result(proc, what):
    try:
        out, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        stop_group(proc)
        return {f"the {what} process ran": False}, {"error": "timed out after 900 s"}
    lines = [line for line in out.splitlines() if line.startswith('{"checks"')]
    if proc.returncode != 0 or not lines:
        return {f"the {what} process ran": False}, {"returncode": proc.returncode, "stderr": err[-3000:]}
    result = json.loads(lines[-1])
    return result["checks"], result["report"]


def an_census(ctx, device="cuda"):
    """Leg ``census``: the results of :func:`an_mesh_census_run`'s process
    and :func:`an_census_run`'s, the ones :func:`main` started beside
    phases ``stacked`` and ``scale_out`` (the census counts per process and
    times nothing, so another process's work leaves its counts alone), or
    new ones."""
    mesh = ctx.pop("mesh_census_result", None)
    proc = ctx.pop("census_proc", None) or an_census_start(device)
    if mesh is None:
        mesh = _census_result(ctx.pop("mesh_census_proc", None) or an_census_start(device, "an_mesh_census_run"),
                              "mesh census")
    checks, report = _census_result(proc, "census")
    report["mesh"] = mesh[1]
    checks.update(mesh[0])
    return checks, report


def an_census_run(device="cuda"):
    """The census of every registered one-device entry at gpt2 full width
    on the card, held to the committed ``name@cuda`` budget entries; then
    one seeded regression (``TRLX_CENSUS_SEED_REGRESSION=extra_item``: a
    host read in every decode iteration) must fail the same gate. Prints
    the checks and the report as one JSON line."""
    from trlx_tpu_torch.analysis.census import budget as census_budget
    from trlx_tpu_torch.analysis.census import cli as census_cli
    from trlx_tpu_torch.analysis.census import seeds as census_seeds
    from trlx_tpu_torch.analysis.census.entrypoints import load_all

    shared = {}
    try:
        measured = census_cli.run_census(device, shared=shared)
        committed = census_budget.load()
        violations = census_budget.compare(measured, committed)
        os.environ[census_seeds.ENV_VAR] = AN_SEED_REGRESSION
        try:
            seeded = census_cli.run_census(device, ["decode_step"], shared=shared)
        finally:
            del os.environ[census_seeds.ENV_VAR]
        seeded_violations = census_budget.compare(seeded, committed)
    finally:
        shared.clear()
        import torch

        if device == "cuda":
            torch.cuda.empty_cache()
    per_entry = {key: {"launches": m.get("launches"), "launch_apis": m.get("launch_apis"),
                       "round_trips": m["round_trips"], "syncs": m.get("syncs"),
                       "peak_mib": m.get("peak_bytes", 0) / 2 ** 20, "warmup_shapes": m["warmup_shapes"],
                       "steady_new_shapes": m["steady_new_shapes"], "ops": m["ops"],
                       "heavy_f32": m["heavy_f32"], "kernel_launches": m.get("kernel_launches")}
                 for key, m in measured.items()}
    report = {"census": per_entry, "violations": violations,
              "seeded": {"seed": AN_SEED_REGRESSION, "violations": seeded_violations}}
    checks = {
        "every registered one-device entry measured": len(measured) == sum(
            ep.mesh is None for ep in load_all().values()),
        "the census within the committed cuda entries": not violations,
        f"seeded {AN_SEED_REGRESSION} fails closed": any("round_trips" in v for v in seeded_violations),
    }
    print(json.dumps({"checks": checks, "report": report}), flush=True)


#: the mesh census's seeded regression: the overlapped step's reduce-scatter as a full-gradient all-reduce
AN_MESH_SEED = "allreduce_under_fsdp"
#: the hand-written kernels every rank of a mesh learner step launches
AN_MESH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def an_mesh_census_run(device="cuda"):
    """The ``--mesh`` census on the card: ``ppo_train_step_overlap`` and its
    memory comparator ``ppo_train_step_unsharded_opt`` on ``data=2 x
    fsdp=2``, four rank processes on the one card over gloo (collectives
    staged through host memory), gpt2 full width, each rank counting its
    own launches through CUPTI; then :data:`AN_MESH_SEED` in the same ranks.
    The checks: within the committed ``@cuda`` entries, the ranks counting
    alike, K1-K3 launched on every rank, the overlap entry's peak below the
    comparator's on every rank, the seed failing closed; a rank that fails
    fails them (its log in the report). Prints the checks and the report as
    one JSON line."""
    from trlx_tpu_torch.analysis.census import budget as census_budget
    from trlx_tpu_torch.analysis.census import cli as census_cli
    from trlx_tpu_torch.analysis.census import ranks as census_ranks

    committed = census_budget.load()

    keys = [f"ppo_train_step_overlap@{device}", f"ppo_train_step_unsharded_opt@{device}"]
    t0 = time.perf_counter()
    try:
        measured, seeded = census_cli.run_mesh_census(device, seeded=[("ppo_train_step_overlap", AN_MESH_SEED)])
        differ = None
    except census_ranks.RanksDiffer as e:
        measured, seeded, differ = {}, {}, str(e)
    except RuntimeError as e:  # a rank failed: its log is the report
        print(json.dumps({"checks": {"the mesh census's ranks ran": False}, "report": {"error": str(e)[-4000:]}}),
              flush=True)
        return
    seconds = time.perf_counter() - t0
    violations = census_budget.compare(measured, committed)
    seeded_violations = census_budget.compare(seeded.get(AN_MESH_SEED, {}), committed)
    report = {"seconds": seconds, "ranks_differ": differ, "violations": violations,
              "seeded": {"seed": AN_MESH_SEED, "violations": seeded_violations}, "entries": {
                  key: {"collectives": m["collectives"], "staged": m["staged"], "launches": m.get("launches"),
                        "syncs": m.get("syncs"), "round_trips": m["round_trips"], "ops": m["ops"],
                        "kernel_launches": m.get("kernel_launches"), "state_bytes": m.get("state_bytes"),
                        "peak_mib_per_rank": [b / 2 ** 20 for b in m.get("peak_bytes", [])],
                        "seconds": m["seconds"]}
                  for key, m in measured.items()}}
    overlap, comparator = (measured.get(k, {}) for k in keys)
    peaks = list(zip(overlap.get("peak_bytes", []), comparator.get("peak_bytes", [])))
    checks = {
        "every rank's counts are ==": differ is None,
        "the mesh entries within the committed cuda entries": sorted(measured) == sorted(keys) and not violations,
        "K1-K3 launched on every rank": all(
            (m.get("kernel_launches") or {}).get(n, 0) > 0 for m in (overlap, comparator) for n in AN_MESH_KERNELS),
        "the overlap entry's peak below the comparator's on every rank": len(peaks) == 4 and all(
            o < c for o, c in peaks),
        "the overlap entry's optimizer state below the comparator's": overlap.get("state_bytes", 1) < comparator.get(
            "state_bytes", 0),
        f"seeded {AN_MESH_SEED} fails closed": any("NEW collective all-reduce:fsdp" in v for v in seeded_violations),
    }
    print(json.dumps({"checks": checks, "report": report}), flush=True)


def phase_analysis(ctx):
    """The host data plane on the train phase's run and the census of the
    hot entrypoints (:func:`an_data_plane`, :func:`an_census`), last."""
    failed = []
    for name, leg in (("data_plane", an_data_plane), ("census", an_census)):
        t0 = time.perf_counter()
        checks, report = leg(ctx)
        emit({"phase": "analysis", "leg": name, "s": time.perf_counter() - t0, "checks": checks, "report": report,
              "card": ctx.get("smi")})
        failed += [f"{name}: {k}" for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"analysis phase: {failed}")


# ------------------------------------------------------------------ scale-out

#: the scale-out runs' shape: 8 greedy rollouts of 16 tokens after prompts of
#: 16..32 bytes, 2 steps of 8 rows in 2 microbatches, gpt2 full width in f32
SO_B, SO_N, SO_MB, SO_STEPS = 8, 16, 4, 2
#: group (c)'s rollouts: 15 tokens, so the learner's and the scorer's
#: length (the 32-byte prompt bucket + 15 + the appended eos = 48) divides
#: model=2 and the sequence path runs
SO_N_EVEN = 15
#: the per-rank bytes bar at fsdp=2, and at pipe=2, against one rank's
SO_FSDP_BYTES = 0.55
SO_PIPE_BYTES = 0.70
#: the stats (b) is held to, against (a)
SO_STAT_KEYS = ("losses/", "values/", "old_values/", "returns/", "policy/", "ratio", "padding_percentage")


#: group (d)'s two-rank runs: (label, leg, mesh); the first three in one
#: group of two ranks, the rest in another
SO_D_RUNS = [("lora_fsdp2", "lora", {"fsdp": 2}), ("lora_model2", "lora", {"model": 2}),
             ("t5_model2", "t5", {"model": 2}), ("offload_ref_fsdp2", "offload_ref", {"fsdp": 2}),
             ("adamw8bit_fsdp2", "adamw8bit", {"fsdp": 2}), ("adafactor_fsdp2", "adafactor", {"fsdp": 2})]
#: how many of SO_D_RUNS the first (d) group runs
SO_D1 = 3
#: gpt2's trunk in f32: the reference's bytes (phase ``peft_memory``'s offload leg)
GPT2_TRUNK_BYTES = 497_759_232
#: the legs with a one-rank baseline in (a), in this order (the store's first)
SO_D_ONE_RANK = ("lora", "t5", "adamw8bit", "adafactor")


def so_d_legs(store):
    """Group (d)'s settings (``so_config``'s ``extra``), by leg: the store,
    LoRA r 8 on q and v, t5-small's published widths (random weights), the
    offloaded and the resident reference, 8-bit AdamW and Adafactor (optax's
    defaults at the PPO rate)."""
    return {
        "store": {"model.model_path": store},
        "lora": {"model.peft_config": PM_LORA},
        # sampled: greedy rollouts of a random T5 repeat one token, so that the decoder self-attention's
        # query and key get a zero gradient and AdamW (eps 1e-8) steps on its rounding noise
        "t5": {"model.model_path": "t5-small", "model.model_arch_type": "seq2seq", "model.model_overrides": {},
               "method.gen_kwargs": dict(max_new_tokens=SO_N, do_sample=True, top_k=0, top_p=1.0)},
        "offload_ref": {"model.offload_ref": True},
        "adamw8bit": {"optimizer.name": "adamw_8bit_bnb"},
        "adafactor": {"optimizer": {"name": "adafactor", "kwargs": {"lr": 3e-5}}},
    }


def so_d_job(label, leg, mesh, store, tmp):
    """A (d) run's job: the optimizers' runs save their parameters, LoRA's
    export its initial adapters; none writes an end-of-run checkpoint."""
    job = {"kind": "ppo", "label": label, "mesh": mesh, "extra": so_d_legs(store)[leg], "checkpoint": False}
    if leg in ("adamw8bit", "adafactor"):
        job["save"] = os.path.join(tmp, f"{label}.pt")
    if leg == "lora":
        job["export"] = os.path.join(tmp, f"{label}.adapters")
    return job


def so_d_checks(tmp, ones, d1, d2, two):
    """Group (d)'s checks and report from the one-rank baselines (``ones``,
    in :data:`SO_D_ONE_RANK`'s order), the two groups' ranks, and (b)'s
    ranks (``fsdp2_overlap``: the resident sharded reference)."""
    import math

    import torch

    import types

    from trlx_tpu_torch.models import safetensors_io
    from trlx_tpu_torch.models.hf_loading import ADAPTERS_FILE
    from trlx_tpu_torch.parallel.sharding import make_param_specs, spec_dim
    from trlx_tpu_torch.utils.optim import factored_dims

    base = dict(zip(SO_D_ONE_RANK, ones))
    checks, report = {}, {"runs": {}}
    for r in ones:
        report["runs"][r["run"]] = {"step_s": r["step_s"], "opt_state_bytes": r["opt_state_bytes"],
                                    "peak_mem_bytes": r["peak_mem_bytes"]}
    for i, mesh in enumerate(({"fsdp": 2}, {"model": 2})):
        for rank in (0, 1):
            r = d1[rank][i]
            name = f"(d) native_store {'fsdp2' if 'fsdp' in mesh else 'model2'} rank {rank}"
            checks[f"{name}: blocks torch.equal to the whole's slices"] = r["equal"] and r["sharded_leaves"] > 0
            report[f"{name} bytes_read"], report[f"{name} restore_s"] = r["bytes_read"], r["restore_s"]
    runs = {label: (d1, j + 2) if j < SO_D1 else (d2, j - SO_D1) for j, (label, _, _) in enumerate(SO_D_RUNS)}
    for label, leg, mesh in SO_D_RUNS:
        group, j = runs[label]
        r0, r1 = group[0][j], group[1][j]
        report["runs"][label] = {"step_s": [r0["step_s"], r1["step_s"]], "peak_mem_bytes": [
            r0["peak_mem_bytes"], r1["peak_mem_bytes"]], "opt_state_bytes": [r0["opt_state_bytes"],
                                                                             r1["opt_state_bytes"]],
            "staged_bytes": r0["staged_bytes"], "ref_host_bytes": [r0["ref_host_bytes"], r1["ref_host_bytes"]]}
        checks[f"(d) {label}: gloo on the shared card"] = r0["backend"] == r1["backend"] == "gloo"
        checks[f"(d) {label}: both ranks report the same stats"] = r0["steps"] == r1["steps"]
        if leg in ("lora", "t5"):
            ok, bad = so_close(r0["steps"], base[leg]["steps"])
            checks[f"(d) {label}: within 1e-3 of the one-rank run"] = ok
            if bad:
                emit({"phase": "scale_out", "run": label, "stats_off": bad[:20]})
        if leg == "lora":
            checks[f"(d) {label}: the trunk torch.equal its initial blocks"] = (
                r0["trunk_equal"] and r1["trunk_equal"] and base["lora"]["trunk_equal"])
            mine = safetensors_io.load_file(os.path.join(tmp, f"{label}.adapters", ADAPTERS_FILE))
            one = safetensors_io.load_file(os.path.join(tmp, "one_rank_lora.adapters", ADAPTERS_FILE))
            checks[f"(d) {label}: the adapter export torch.equal the one-rank export"] = (
                set(mine) == set(one) and len(one) > 0 and all(torch.equal(mine[k], one[k]) for k in one))
    off = runs["offload_ref_fsdp2"]
    for rank in (0, 1):
        # (b)'s fsdp2 run scores its first phase with the same sharded policy and a resident reference
        o, r = off[0][rank][off[1]], two[rank][1]
        checks[f"(d) offload_ref_fsdp2 rank {rank}: scoring == the resident sharded reference"] = (
            len(o["experience"]) >= SO_B and o["experience"][:SO_B] == r["experience"][:SO_B])
        checks[f"(d) offload_ref_fsdp2 rank {rank}: host bytes ~ half the reference's"] = (
            0.45 * GPT2_TRUNK_BYTES <= o["ref_host_bytes"] <= 0.55 * GPT2_TRUNK_BYTES and o["ref_uploads"] >= 1)
        report[f"offload_ref_fsdp2 rank {rank} host_bytes_ratio"] = o["ref_host_bytes"] / GPT2_TRUNK_BYTES
    param_err = {}
    for leg, label in (("adamw", "data2"), ("adamw8bit", "adamw8bit_fsdp2"), ("adafactor", "adafactor_fsdp2")):
        want = torch.load(os.path.join(tmp, f"one_rank_{leg}.pt"))
        got = torch.load(os.path.join(tmp, f"{label}.pt"))
        # a key bias shifts all of a query's scores alike: softmax cancels it, its gradient is rounding,
        # and Adam (eps 1e-8) steps it by up to the rate: held to two steps' worth of it
        noise = {k for k in want if k.endswith("attn.k_proj.bias")}
        if leg == "adamw8bit":
            # the moments' codes against the one-rank run's, counted (v's log-space codes resolve the
            # rounding of small gradients that the ranks sum in another order)
            c_one, c_two = (torch.load(os.path.join(tmp, f"{n}.pt.codes")) for n in (f"one_rank_{leg}", label))
            n_codes = n_off = 0
            worst, by_leaf = {"m_q": 0, "v_q": 0}, {}
            for k in want:
                d = torch.zeros(want[k].numel(), dtype=torch.int64)
                for code in ("m_q", "v_q"):
                    diff = (c_two[k][code].long() - c_one[k][code].long()).abs().reshape(-1)
                    worst[code] = max(worst[code], int(diff.max()))
                    d = torch.maximum(d, diff[:want[k].numel()])
                n_codes, n_off = n_codes + 2 * d.numel(), n_off + int((d > 0).sum())
                by_leaf[k] = (int((d > 0).sum()), d.numel(), int(d.max()))
            report[f"{label} codes_off_by_leaf"] = sorted(by_leaf.items(), key=lambda kv: -kv[1][0])[:8]
            report[f"{label} codes_off"], report[f"{label} codes"], report[f"{label} worst_code_diff"] = (
                n_off, n_codes, worst)
        diffs = {k: float((got[k] - want[k]).abs().max()) for k in want}
        param_err[leg] = err = max(v for k, v in diffs.items() if k not in noise)
        report[f"{label} max_abs_param_diff"] = err
        report[f"{label} max_abs_key_bias_diff"] = max((diffs[k] for k in noise), default=0.0)
        if leg == "adamw":
            f32 = {k: (got[k] - want[k]).abs() for k in want}
            continue
        if leg == "adamw8bit":
            # Adam's step is m / sqrt(v): an element whose gradient is a small sum of large terms moves by
            # the rate's order when the ranks sum its terms in another order, in f32 AdamW as in 8-bit, so
            # the trainers' parameters are held to f32 AdamW's own two-rank difference ((b)'s data2); the
            # elements f32 AdamW's two ranks agree on to 1e-6 are reported, and the optimizer itself is held
            # on the same gradient and state below
            checks[f"(d) {label}: parameters as close to one rank as f32 AdamW's on two ranks (or 1e-5)"] = (
                set(got) == set(want) and err <= max(1e-5, 2 * param_err["adamw"]))
            settled = {k: f32[k] < 1e-6 for k in want if k not in noise}
            report[f"{label} settled_elements"] = sum(int(m.sum()) for m in settled.values())
            report[f"{label} settled_max_abs_param_diff"] = max(
                float((got[k] - want[k]).abs()[m].max()) if m.any() else 0.0 for k, m in settled.items())
        elif leg == "adafactor":
            checks[f"(d) {label}: parameters within 1e-5 of the one-rank run"] = set(got) == set(want) and (
                err <= 1e-5 and all(diffs[k] <= 4 * 3e-5 for k in noise))
        group, j = runs[label]
        for rank in (0, 1):
            same = group[rank][j]["same_grads"]
            report[f"{label} rank {rank} same_grads"] = same
            # one step of a rate of 3e-5 moves an element by up to about 3e-5: 1e-6 is a few f32 ulps of
            # the weights, and a wrong block range, scale or gather moves elements by the step's order
            checks[f"(d) {label} rank {rank}: the whole-leaf step within 1e-6 of the plain step on the same "
                   f"gradient and state"] = same["max_abs_param_diff"] <= 1e-6
            if leg == "adamw8bit":
                checks[f"(d) {label} rank {rank}: its codes within 1 of the plain step's, at most 0.1% differ"] = (
                    same["codes"] > 0 and same["worst_code_diff"] <= 1 and same["codes_off"] <= 1e-3 * same["codes"])
        shapes = [tuple(v.shape) for v in want.values()]
        if leg == "adamw8bit":
            nbs = [math.ceil(math.prod(s) / 256) for s in shapes]
            formula = sum(524 * (nb // 2 if nb % 2 == 0 else nb) for nb in nbs) + 4
            one_formula = sum(524 * nb for nb in nbs) + 4
        else:
            def fbytes(s, local):
                # factored by the whole shape, held as this rank's block (the fsdp dim halved)
                dims = factored_dims(s, True, 128)
                n = math.prod(local)
                return 4 * (n // local[dims[1]] + n // local[dims[0]]) if dims else 4 * n

            fsdp2 = types.SimpleNamespace(shape={"data": 1, "fsdp": 2, "pipe": 1, "model": 1})
            specs = make_param_specs({k: v.shape for k, v in want.items()}, fsdp2)
            blocks = [tuple(n // 2 if i == spec_dim(specs[k], "fsdp") else n for i, n in enumerate(v.shape))
                      for k, v in want.items()]
            formula = sum(fbytes(s, loc) for s, loc in zip(shapes, blocks))
            one_formula = sum(fbytes(s, s) for s in shapes)
        got_bytes = [group[rank][j]["opt_state_bytes"] for rank in (0, 1)]
        report[f"{label} state_bytes_per_rank"], report[f"{label} state_bytes_formula"] = got_bytes, formula
        checks[f"(d) {label}: state bytes per rank = the formula"] = (
            got_bytes == [formula, formula] and base[leg]["opt_state_bytes"] == one_formula)
        checks[f"(d) {label}: the whole-leaf step ran"] = all(group[rank][j]["whole_leaf"] for rank in (0, 1))
    return checks, report


def so_config(ckpt_dir, mesh, minibatch=SO_MB, overlap=False, model_overrides=None, new_tokens=SO_N, extra=None):
    """The scale-out PPO run: gpt2 at full width, flash attention (or
    ``model_overrides``), f32 compute and params, the bytes tokenizer, a
    full-copy reference, ``SO_B`` greedy rollouts of ``new_tokens``,
    ``SO_STEPS`` steps on ``mesh`` (its ``pipe`` in 2 microbatches,
    ``sequence_shard``); ``extra``: dotted keys replaced, not merged
    (group (d)'s model, peft, optimizer and reference settings)."""
    from trlx_tpu_torch.data.configs import TRLConfig

    cfg = ppo_config(**{
        "model.model_path": "gpt2", "model.model_overrides": {"attention_impl": "flash", **(model_overrides or {})},
        "mesh.compute_dtype": "float32", "mesh.param_dtype": "float32",
        "mesh.data": mesh.get("data", 1), "mesh.fsdp": mesh.get("fsdp", 1), "mesh.model": mesh.get("model", 1),
        "mesh.pipe": mesh.get("pipe", 1), "mesh.pipeline_microbatches": 2,
        "mesh.sequence_shard": mesh.get("sequence_shard", False),
        "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": 32 + new_tokens, "train.batch_size": SO_B, "train.minibatch_size": minibatch,
        "train.total_steps": SO_STEPS, "train.eval_interval": 100, "train.checkpoint_interval": 100,
        "train.save_best": False, "train.save_optimizer": False, "train.tracker": None,
        "train.checkpoint_dir": ckpt_dir, "train.seed": SEED, "train.learner_overlap.enabled": overlap,
        "method.num_rollouts": SO_B, "method.chunk_size": SO_B, "method.ppo_epochs": 1,
        "method.gen_kwargs": dict(max_new_tokens=new_tokens, do_sample=False),
    })
    if not extra:
        return cfg
    d = cfg.to_dict()
    for key, value in extra.items():
        node = d
        *path, leaf = key.split(".")
        for k in path:
            node = node[k]
        node[leaf] = value
    return TRLConfig.from_dict(d)


def so_parity_steps(device):
    """``train_parity``'s trainer on ``device`` from its shared weights (the
    seeded init x3): one experience phase, 2 steps; the step stats."""
    import shutil

    cpu = parity_trainer("cpu")
    state = {k: v * 3 if v.is_floating_point() else v for k, v in cpu.model.state_dict().items()}
    shutil.rmtree(cpu.config.train.checkpoint_dir, ignore_errors=True)
    tr = parity_trainer(device, state)
    tr.prepare_learning()
    steps = [tr.train_step(batch) for batch in list(tr.create_train_dataloader())[:2]]
    shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    return [{k: v for k, v in st.items() if not k.startswith("time/")} for st in steps]


def so_run(label, mesh, minibatch=SO_MB, overlap=False, model_overrides=None, new_tokens=SO_N, extra=None,
           save=None, export=None, checkpoint=True):
    """One scale-out PPO run on this rank through ``trlx_tpu_torch.train``:
    launch counts reset just before and read just after, each kernel call
    shape recorded, then every shape held against the plain versions. Its
    step stats and seconds, parameter plus optimizer bytes, peak memory,
    backend, staged collectives (point-to-point included), the sequence
    scatters and ring rotations, and (group (d)) the experience's
    logprobs, values and rewards, the trunk's equality with its initial
    blocks, the reference's host bytes, the optimizer's state bytes, and
    after a whole-leaf optimizer's run its same-gradient check
    (:func:`so_whole_leaf_same_grads`); with
    ``save``, process 0 writes the gathered parameters (and 8-bit moment
    codes) to ``save``, with ``export`` the adapter file of the initial
    weights to that directory; ``checkpoint=False`` skips the end-of-run
    checkpoint (group (d): the save path runs in (a)-(c))."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    import trlx_tpu_torch
    from trlx_tpu_torch.models.hf_loading import ADAPTER_PARAM_NAMES, save_adapters
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.parallel import collectives as coll
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.utils.optim import state_bytes

    ckpt = tempfile.mkdtemp(prefix=f"chip_smoke_so_{label}_")
    cfg = so_config(ckpt, mesh, minibatch, overlap, model_overrides, new_tokens, extra)
    steps, seconds, experience, trunk0 = [], [], [], {}
    original, original_push, original_prepare = PPOTrainer.train_step, PPOTrainer.push_to_store, \
        PPOTrainer.prepare_learning

    def timed(self, batch):
        t0 = time.perf_counter()
        out = original(self, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        steps.append({k: v for k, v in out.items() if not k.startswith("time/")})
        return out

    def push(self, data):
        experience.extend([[x.tolist() for x in (e.logprobs, e.values, e.rewards)] for e in data])
        return original_push(self, data)

    def prepare(self):
        # the trunk's blocks before any step, and the initial adapters' export
        trunk0.update({n: p.detach().clone() for n, p in so_local_params(self).items()
                       if n.split(".", 1)[0] in ("transformer", "t5")
                       and n.rsplit(".", 1)[-1] not in ADAPTER_PARAM_NAMES})
        if export:
            state = self.model_state_dict()
            if self.is_main_process:
                os.makedirs(export, exist_ok=True)
                save_adapters(export, state)
        return original_prepare(self)

    seen = {}
    original_ckpt = PPOTrainer._save_checkpoint
    PPOTrainer.train_step, PPOTrainer.push_to_store, PPOTrainer.prepare_learning = timed, push, prepare
    if not checkpoint:
        PPOTrainer._save_checkpoint = lambda self, *a, **k: None
    restore = record_kernel_shapes(seen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    coll.reset_counts()
    _kernels.reset_launches()
    try:
        trainer = trlx_tpu_torch.train(config=cfg, reward_fn=byte_share_reward,
                                       prompts=byte_prompts(SO_B, 16, 32, SEED + 1),
                                       eval_prompts=byte_prompts(SO_B, 16, 32, SEED + 2))
    finally:
        PPOTrainer.train_step, PPOTrainer.push_to_store, PPOTrainer.prepare_learning = \
            original, original_push, original_prepare
        PPOTrainer._save_checkpoint = original_ckpt
        restore()
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    launches = _kernels.launches()
    local = so_local_params(trainer)
    trunk_equal = bool(trunk0) and all(torch.equal(local[n], v) for n, v in trunk0.items())
    whole_leaf = getattr(trainer, "whole_leaf", None)
    if save:
        state = trainer.model_state_dict()
        codes = so_moment_codes(trainer)
        if trainer.is_main_process:
            torch.save({k: v.cpu() for k, v in state.items()}, save)
            if codes:
                torch.save(codes, save + ".codes")
    staged = coll.staged()
    seq = coll.sequence_counts()
    out = {
        "run": label, "rank": trainer.mesh.rank, "mesh": {k: v for k, v in trainer.mesh.shape.items()},
        "device": str(trainer.device), "backend": dist.get_backend() if dist.is_initialized() else None,
        "overlap": trainer.overlap, "steps": steps, "step_s": seconds,
        "param_opt_bytes": sum(p.numel() * p.element_size() for p in trainer.trainable_params)
        + state_bytes(trainer.optimizer),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
        "staged_collectives": staged["calls"], "staged_bytes": staged["bytes"],
        "collectives": coll.collective_calls(), "kernel_shapes": kernel_shapes(seen),
        "seq_scatters": seq["scatters"], "ring_rotations": seq["rotations"],
        "pipe": getattr(trainer.model_config, "pipeline_stages", 1),
        "sequence_sharding": getattr(trainer.model_config, "sequence_sharding", False),
        "attention_impl": getattr(trainer.model_config, "attention_impl", "t5"),
        "experience": experience, "trunk_equal": trunk_equal, "ref_host_bytes": trainer.ref_host_bytes,
        "ref_uploads": trainer.ref_uploads, "opt_state_bytes": state_bytes(trainer.optimizer),
        "whole_leaf": whole_leaf is not None,
        "block_sharded": sum(whole_leaf.block_sharded) if whole_leaf is not None else 0,
    }
    if whole_leaf is not None:
        out["same_grads"] = so_whole_leaf_same_grads(trainer)
    del trainer, local
    torch.cuda.empty_cache()
    local = {}
    try:
        # ring attention bypasses the flash kernels, as the reference's routing does, and T5 runs on none
        kinds = () if out["attention_impl"] in ("ring", "t5") else ("flash_fwd", "flash_bwd")
        if seen or kinds:
            check_main_path_shapes(local, seen, f"scale_out {label}", kinds)
        out["holds_ok"] = True
    except AssertionError as e:
        out["holds_ok"], out["holds_error"] = False, str(e)[:2000]
    out["max_abs_err"] = local.get("max_abs_err", {})
    return out


def so_whole_leaf_same_grads(trainer):
    """The whole-leaf step held against the plain optimizer on the same
    input, after the run (its parameters already saved): every rank makes
    the same seeded whole gradient of each trained leaf on the card; the
    whole-leaf optimizer steps this rank's blocks from the run's state, and
    a plain optimizer of the same class steps the whole leaves from that
    state gathered whole (the checkpoint layout), on each rank. The largest
    parameter difference and, for 8-bit, the moment codes that differ and
    by how much (a collective)."""
    import torch

    from trlx_tpu_torch.utils import get_optimizer_class

    wl, sh = trainer.whole_leaf, trainer.shards
    kwargs = dict(trainer.config.optimizer.kwargs)
    kwargs.pop("lr", None)
    kwargs.pop("max_grad_norm", None)
    sd = wl.optimizer.state_dict()
    # copies: a plain tensor of the live state would be stepped twice
    sd["state"] = {i: {k: wl.gather_state(i, k, v.clone()) if torch.is_tensor(v) else v for k, v in st.items()}
                   for i, st in sd["state"].items()}
    ref_params = [torch.nn.Parameter(sh.full_tensor(leaf, leaf.master.data).clone()) for leaf in wl.leaves]
    ref = get_optimizer_class(str(trainer.config.optimizer.name).lower())(ref_params, learning_rate=1.0, **kwargs)
    ref.load_state_dict(sd)
    gen = torch.Generator(device=trainer.device).manual_seed(SEED)
    for leaf, p in zip(wl.leaves, ref_params):
        g = 1e-3 * torch.randn(p.shape, generator=gen, device=p.device)
        leaf.master.grad, p.grad = sh.local_block(leaf, g).clone(), g
    wl.step()
    ref.step()
    out = {"lr": sd["param_groups"][0]["lr"], "max_abs_param_diff": max(
        float((sh.full_tensor(leaf, leaf.master.data) - p).abs().max()) for leaf, p in zip(wl.leaves, ref_params)),
        "codes": 0, "codes_off": 0, "worst_code_diff": 0}
    for i, (proxy, p) in enumerate(zip(wl.proxies, ref_params)):
        st, want = wl.optimizer.state[proxy], ref.state[p]
        for code in ("m_q", "v_q"):
            if code in want:
                diff = (wl.gather_state(i, code, st[code]).long() - want[code].long()).abs().reshape(-1)[:p.numel()]
                out["codes"] += diff.numel()
                out["codes_off"] += int((diff > 0).sum())
                out["worst_code_diff"] = max(out["worst_code_diff"], int(diff.max()))
    return out


def so_moment_codes(trainer):
    """The 8-bit moments' codes (``m_q``, ``v_q``) of every trained leaf,
    whole (gathered over ``fsdp`` where the blocks are split; a collective),
    by name; {} for another optimizer."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    if trainer.shards is not None:
        names.update({id(leaf.master): leaf.name for leaf in trainer.shards.leaves})
    wl = trainer.whole_leaf
    if wl is not None:
        pairs = [(leaf.name, proxy, i) for i, (leaf, proxy) in enumerate(zip(wl.leaves, wl.proxies))]
        opt = wl.optimizer
    else:
        pairs = [(names[id(p)], p, None) for p in trainer.trainable_params]
        opt = trainer.optimizer
    out = {}
    for name, p, i in pairs:
        st = opt.state.get(p, {})
        if "m_q" in st:
            out[name] = {k: (wl.gather_state(i, k, st[k]) if i is not None else st[k]).cpu() for k in ("m_q", "v_q")}
    return out


def so_local_params(trainer):
    """The policy's tensors as this rank holds them (each leaf's master: its
    block), by ``state_dict`` name."""
    if trainer.shards is None:
        return dict(trainer.model.named_parameters())
    return {leaf.name: leaf.master for leaf in trainer.shards.leaves
            if not leaf.name.startswith(("ref_model.", "frozen_branch."))}


def so_store_shards(store, mesh):
    """A rank's restore of its blocks of ``store`` onto its device under
    ``mesh`` (``fsdp=2`` or ``model=2``): each block ``torch.equal`` to its
    slice of the whole restore, the chunk bytes read and the seconds."""
    import torch

    from trlx_tpu_torch.checkpointing import restore_native
    from trlx_tpu_torch.parallel.mesh import make_mesh, process_index
    from trlx_tpu_torch.parallel.sharding import make_param_specs, shard_tensor

    m = make_mesh(data=mesh.get("data", 1), fsdp=mesh.get("fsdp", 1), model=mesh.get("model", 1))
    stats = {}
    _, blocks, _ = restore_native(store, mesh=m, device=torch.device("cuda", 0), stats=stats)
    _, whole, _ = restore_native(store)
    specs = make_param_specs(whole, m)
    equal = all(torch.equal(blocks[n].cpu(), shard_tensor(whole[n], specs[n], m)) for n in whole)
    sharded = sum(blocks[n].numel() < whole[n].numel() for n in whole)
    return {"run": "store_shards", "mesh": mesh, "rank": process_index(), "equal": equal, "sharded_leaves": sharded,
            "bytes_read": stats["bytes_read"], "restore_s": stats["seconds"],
            "block_bytes": sum(b.numel() * b.element_size() for b in blocks.values())}


def so_store_of_card_init(tmp):
    """The store (d)'s PPO and block legs read: the PPO trainer's seed-0
    trunk as it initialises it on the card, written by the port's writer
    (``save_native``), so that PPO from the store can be held ``==`` to
    (a)'s PPO from the same weights in memory."""
    import torch

    from trlx_tpu_torch.checkpointing import save_native
    from trlx_tpu_torch.models.presets import get_preset
    from trlx_tpu_torch.models.transformer import TransformerLM

    config = get_preset("gpt2")
    with torch.device("cuda"):
        model = TransformerLM(config)
    model.init_params(SEED)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    t0 = time.perf_counter()
    path = save_native(os.path.join(tmp, "store_card_init"), state, config, "gpt2", "gpt2")
    return path, time.perf_counter() - t0, state


def so_convert_start(tmp):
    """The CLI's conversion of gpt2 from seed 0 in bf16 (``--dtype``), in
    the background (its seconds overlap (a)-(d); the f32 store is the card
    init's, :func:`so_store_of_card_init`)."""
    path = os.path.join(tmp, "store_bfloat16")
    cmd = [sys.executable, "-m", "trlx_tpu_torch.checkpointing", "convert", "gpt2", path, "--allow-random",
           "--dtype", "bfloat16"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    return {"path": path, "proc": proc, "t0": time.perf_counter()}


def so_convert_finish(conv, store, card_state):
    """Wait for the bf16 conversion; restore it and the f32 store onto
    ``cuda:0``, each against the weights it was written from (the port's
    seed-0 initialisation on the host for the CLI's, the card's for the
    f32 store), and ``inspect`` the bf16 store."""
    import torch

    from trlx_tpu_torch.checkpointing import restore_native, store_bytes
    from trlx_tpu_torch.models.presets import get_preset
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.store import zstd

    out, checks = {"libzstd": zstd.version()}, {}
    rc = conv["proc"].wait(timeout=600)
    out["bfloat16_convert_s"] = time.perf_counter() - conv["t0"]  # an upper bound: waited for after (a)-(d)
    checks["native_store: the CLI converts in bf16"] = rc == 0
    host = TransformerLM(get_preset("gpt2")).init_params(SEED).state_dict()
    sources = {"float32": (store, card_state)}
    if rc == 0:
        sources["bfloat16"] = (conv["path"], {k: v.bfloat16() for k, v in host.items()})
    for dtype, (path, want) in sources.items():
        out[f"{dtype}_store_bytes"] = store_bytes(path)
        stats = {}
        _, state, model_type = restore_native(path, device=torch.device("cuda", 0), stats=stats)
        out[f"{dtype}_restore_s"], out[f"{dtype}_bytes_read"] = stats["seconds"], stats["bytes_read"]
        checks[f"native_store {dtype}: restored onto cuda:0 torch.equal to the source"] = (
            model_type == "gpt2" and set(state) == set(want)
            and all(state[k].device.type == "cuda" and torch.equal(state[k].cpu(), want[k]) for k in want))
    shown = subprocess.run([sys.executable, "-m", "trlx_tpu_torch.checkpointing", "inspect", conv["path"]],
                           cwd=ROOT, capture_output=True, text=True, timeout=300).stdout
    print(shown, flush=True)
    checks["native_store: inspect prints the metadata"] = '"model_type": "gpt2"' in shown and (
        '"dtype": "bfloat16"' in shown and '"hidden_size": 768' in shown)
    return out, checks


def so_rank_main(jobs_path, out_path):
    """A scale-out rank's body (started by :func:`phase_scale_out`): TF32
    off, then every job of the list in order, the results as JSON."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from trlx_tpu_torch.parallel.mesh import initialize_distributed, process_index

    initialize_distributed()
    with open(jobs_path) as f:
        jobs = json.load(f)
    results = []
    for job in jobs:
        if job["kind"] == "parity":
            results.append({"run": "parity", "steps": so_parity_steps("cuda")})
        elif job["kind"] == "store_shards":
            results.append(so_store_shards(job["store"], job["mesh"]))
        else:
            results.append(so_run(job["label"], job["mesh"], job.get("minibatch", SO_MB), job.get("overlap", False),
                                  job.get("model_overrides"), job.get("new_tokens", SO_N), job.get("extra"),
                                  job.get("save"), job.get("export"), job.get("checkpoint", True)))
    with open(f"{out_path}.{process_index()}.json", "w") as f:
        json.dump(results, f)


class SoRanks:
    """``n`` rank processes running ``jobs`` (:func:`so_rank_main`) with the
    ``TRLX_*`` launch contract on 127.0.0.1; :meth:`results` waits for them
    (their results by rank) and :meth:`stop` ends any still running."""

    def __init__(self, n, jobs, tmp, timeout, tag=None):
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        self.n, self.tmp, self.deadline = n, tmp, time.perf_counter() + timeout
        self.tag = tag or str(n)
        jobs_path, self.out_path = os.path.join(tmp, f"jobs{self.tag}.json"), os.path.join(tmp, f"out{self.tag}")
        with open(jobs_path, "w") as f:
            json.dump(jobs, f)
        code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
                f"chip_smoke.so_rank_main({jobs_path!r}, {self.out_path!r})")
        self.procs = []
        try:
            for rank in range(n):
                env = dict(os.environ, TRLX_NUM_PROCESSES=str(n), TRLX_PROCESS_ID=str(rank),
                           TRLX_DIST_TIMEOUT_S="300")
                if n > 1:
                    env["TRLX_COORDINATOR"] = f"127.0.0.1:{port}"
                with open(self.log(rank), "w") as log:
                    self.procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, stdout=log,
                                                       stderr=subprocess.STDOUT, cwd=ROOT))
        except BaseException:
            self.stop()
            raise

    def log(self, rank):
        return os.path.join(self.tmp, f"rank{self.tag}.{rank}.log")

    def results(self):
        try:
            for rank, p in enumerate(self.procs):
                rc = p.wait(timeout=max(1.0, self.deadline - time.perf_counter()))
                self.done_s = time.perf_counter()
                if rc != 0:
                    with open(self.log(rank)) as f:
                        tail = f.read()[-4000:]
                    raise AssertionError(f"scale_out: rank {rank} of {self.n} exited {rc}:\n{tail}")
        finally:
            self.stop()
        out = []
        for rank in range(self.n):
            with open(f"{self.out_path}.{rank}.json") as f:
                out.append(json.load(f))
        return out

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def so_close(a, b):
    """|a - b| <= 1e-3 |b| + 1e-6 over the compared stats of two step lists."""
    bad = []
    for i, (x, y) in enumerate(zip(a, b)):
        for k, v in y.items():
            if k.startswith(SO_STAT_KEYS) and not abs(x[k] - v) <= 1e-3 * abs(v) + 1e-6:
                bad.append((i + 1, k, x[k], v))
    return len(a) == len(b) == SO_STEPS and not bad, bad


def phase_scale_out(ctx):
    """(a) one rank over NCCL and, at the same time, (b) two ranks sharing
    the card over gloo (``data=2``, ``fsdp=2`` + ``train.learner_overlap``,
    ``model=2``) and (c) two more (``pipe=2``, ``model=2`` with
    ``mesh.sequence_shard``, ``model=2`` with ring attention); the module
    docstring's entry 35 has the checks. The kernels are built here first,
    so no two ranks build them at once."""
    import shutil
    import tempfile

    from trlx_tpu_torch.ops import _kernels

    _kernels.build()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scale_out_")
    t0 = time.perf_counter()
    groups = []
    try:
        # (d)'s store first: the one-rank run from it starts with (a); the CLI's conversions meanwhile
        converts = so_convert_start(tmp)
        store, store_write_s, card_state = so_store_of_card_init(tmp)
        card = so_parity_steps("cuda")
        # (a) and (b) share the card at the same time: their step seconds
        # include each other's load
        groups.append(SoRanks(1, [{"kind": "parity"},
                                  {"kind": "ppo", "label": "one_rank", "mesh": {"data": -1},
                                   "save": os.path.join(tmp, "one_rank_adamw.pt")},
                                  {"kind": "ppo", "label": "one_rank_half_mb", "mesh": {"data": -1},
                                   "minibatch": SO_MB // 2},
                                  # (c)'s baselines at its lengths: the same stacked trunk on one
                                  # rank, and flash
                                  {"kind": "ppo", "label": "one_rank_stacked", "mesh": {"data": -1},
                                   "model_overrides": {"pipeline_stages": 2}, "new_tokens": SO_N_EVEN},
                                  {"kind": "ppo", "label": "one_rank_even", "mesh": {"data": -1},
                                   "new_tokens": SO_N_EVEN},
                                  # (d): PPO from the store, against one_rank
                                  {"kind": "ppo", "label": "one_rank_store", "mesh": {"data": -1},
                                   "extra": {"model.model_path": store}}], tmp, timeout=700))
        # (d)'s other one-rank baselines, a second process beside (a)
        groups.append(SoRanks(1, [so_d_job(f"one_rank_{leg}", leg, {"data": -1}, store, tmp)
                                  for leg in SO_D_ONE_RANK], tmp, timeout=700, tag="a2"))
        groups.append(SoRanks(2, [{"kind": "ppo", "label": "data2", "mesh": {"data": 2},
                                   "save": os.path.join(tmp, "data2.pt")},
                                  {"kind": "ppo", "label": "fsdp2_overlap", "mesh": {"data": 1, "fsdp": 2},
                                   "overlap": True},
                                  {"kind": "ppo", "label": "model2", "mesh": {"data": 1, "model": 2}}],
                          tmp, timeout=600))
        groups.append(SoRanks(2, [{"kind": "ppo", "label": "pipe2", "mesh": {"data": 1, "pipe": 2},
                                   "new_tokens": SO_N_EVEN},
                                  {"kind": "ppo", "label": "seq_model2",
                                   "mesh": {"data": 1, "model": 2, "sequence_shard": True}, "new_tokens": SO_N_EVEN},
                                  {"kind": "ppo", "label": "ring_model2", "mesh": {"data": 1, "model": 2},
                                   "model_overrides": {"attention_impl": "ring"}, "new_tokens": SO_N_EVEN}],
                          tmp, timeout=600, tag="c"))
        # (d): the store's blocks, LoRA, T5, the offloaded reference, the
        # whole-leaf optimizers, over two groups of two ranks
        groups.append(SoRanks(2, [{"kind": "store_shards", "store": store, "mesh": {"fsdp": 2}},
                                  {"kind": "store_shards", "store": store, "mesh": {"model": 2}}]
                              + [so_d_job(label, leg, mesh, store, tmp) for label, leg, mesh in SO_D_RUNS[:SO_D1]],
                              tmp, timeout=700, tag="d1"))
        groups.append(SoRanks(2, [so_d_job(label, leg, mesh, store, tmp) for label, leg, mesh in SO_D_RUNS[SO_D1:]],
                              tmp, timeout=700, tag="d2"))
        (one,) = groups[0].results()
        t_a = time.perf_counter() - t0
        (ones,) = groups[1].results()
        two = groups[2].results()
        three = groups[3].results()
        d1, d2 = groups[4].results(), groups[5].results()
        # when each group's results were collected (in this order: an upper bound on when it ended)
        group_s = {g.tag: g.done_s - t0 for g in groups}
        store_out, store_checks = so_convert_finish(converts, store, card_state)
        del card_state
        store_out["card_init_write_s"] = store_write_s
        d_checks, d_report = so_d_checks(tmp, ones, d1, d2, two)
    finally:
        for g in groups:
            g.stop()
        if "converts" in locals() and converts["proc"].poll() is None:
            converts["proc"].kill()
        shutil.rmtree(tmp, ignore_errors=True)
    parity, a, a_half, a_stacked, a_even, a_store = one
    runs = {"data2": a, "fsdp2_overlap": a_half, "model2": a}
    checks = {
        "(a) NCCL on one rank": a["backend"] == "nccl",
        "(a) stats == train_parity's card trainer": parity["steps"] == card,
        **store_checks, **d_checks,
        "(d) native_store: PPO from the store == PPO from the same weights in memory": a_store["steps"] == a["steps"],
    }
    launches = {k: 0 for k in a["launches"]}
    errs = ctx.setdefault("max_abs_err", {})
    d_runs = [a_store] + ones + [x for rank in d1 + d2 for x in rank if x["run"] != "store_shards"]
    for r in [a, a_half, a_stacked, a_even] + [x for rank in two + three for x in rank] + d_runs:
        emit({"phase": "scale_out", "card": ctx.get("smi"),
              **{k: v for k, v in r.items() if k not in ("steps", "experience")},
              "losses": [{k: v for k, v in st.items() if k.startswith("losses/")} for st in r["steps"]]})
        for k, v in r["launches"].items():
            launches[k] += v
        for k, v in r["max_abs_err"].items():
            errs[k] = max(errs.get(k, 0.0), v)
        if r["attention_impl"] == "ring":
            # the reference keeps ring attention off the flash kernels
            checks[f"{r['run']} rank {r['rank']}: the ring ran, no flash launch"] = r["ring_rotations"] > 0 and not any(
                r["launches"][k] for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
        elif r["attention_impl"] == "t5":
            # T5 attention runs on no kernel in either package
            checks[f"{r['run']} rank {r['rank']}: no kernel launch"] = not any(r["launches"].values())
        else:
            checks[f"{r['run']} rank {r['rank']}: K1, K2 and K3 launched"] = all(
                r["launches"][k] > 0 for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
        checks[f"{r['run']} rank {r['rank']}: kernels hold at its shapes"] = r["holds_ok"]
    for i, label in enumerate(("data2", "fsdp2_overlap", "model2")):
        r0, r1 = two[0][i], two[1][i]
        ok, bad = so_close(r0["steps"], runs[label]["steps"])
        checks[f"(b) {label}: gloo on the shared card"] = r0["backend"] == r1["backend"] == "gloo" and (
            r0["device"] == r1["device"] == "cuda:0")
        checks[f"(b) {label}: both ranks report the same stats"] = r0["steps"] == r1["steps"]
        checks[f"(b) {label}: within 1e-3 of (a)"] = ok
        if bad:
            emit({"phase": "scale_out", "run": label, "stats_off": bad[:20]})
        flash = [sh for sh in r0["kernel_shapes"] if sh["kernel"] in ("flash_fwd", "flash_bwd")]
        if label == "model2":
            checks["(b) model2: 6 of gpt2's 12 heads per rank"] = bool(flash) and all(sh["q"][1] == 6 for sh in flash)
        else:
            checks[f"(b) {label}: half a microbatch's rows per rank"] = {
                sh["q"][0] for sh in flash if sh["kernel"] == "flash_bwd"} == {SO_MB // 2}
    bases = {"pipe2": a_stacked, "seq_model2": a_even, "ring_model2": a_even}
    even_T = {sh["q"][2] for sh in a_even["kernel_shapes"] if sh["kernel"] == "flash_fwd"}
    for i, label in enumerate(("pipe2", "seq_model2", "ring_model2")):
        r0, r1 = three[0][i], three[1][i]
        ok, bad = so_close(r0["steps"], bases[label]["steps"])
        checks[f"(c) {label}: gloo on the shared card"] = r0["backend"] == r1["backend"] == "gloo" and (
            r0["device"] == r1["device"] == "cuda:0")
        checks[f"(c) {label}: both ranks report the same stats"] = r0["steps"] == r1["steps"]
        checks[f"(c) {label}: within 1e-3 of its one-rank baseline"] = ok
        if bad:
            emit({"phase": "scale_out", "run": label, "stats_off": bad[:20]})
    pipe_ratio = max(three[r][0]["param_opt_bytes"] for r in (0, 1)) / a_stacked["param_opt_bytes"]
    checks["(c) pipe2: two stages"] = all(three[r][0]["pipe"] == 2 for r in (0, 1))
    checks[f"(c) pipe2: parameter + optimizer bytes <= {SO_PIPE_BYTES} x one rank's"] = pipe_ratio <= SO_PIPE_BYTES
    for r in (0, 1):
        sp, ring = three[r][1], three[r][2]
        checks[f"(c) seq_model2 rank {r}: sequence scatters > 0"] = sp["sequence_sharding"] and sp["seq_scatters"] > 0
        checks[f"(c) ring_model2 rank {r}: ring rotations > 0"] = ring["ring_rotations"] > 0
        flash = [sh for sh in sp["kernel_shapes"] if sh["kernel"] in ("flash_fwd", "flash_bwd")]
        # under SP the kernels see the gathered T and this rank's heads
        checks[f"(c) seq_model2 rank {r}: K1-K3 at 6 heads and the whole T"] = bool(flash) and all(
            sh["q"][1] == 6 for sh in flash) and {sh["q"][2] for sh in flash
                                                   if sh["kernel"] == "flash_fwd"} == even_T
    fsdp = two[0][1]
    ratio = fsdp["param_opt_bytes"] / a["param_opt_bytes"]
    checks["(b) fsdp2: overlapped step"] = fsdp["overlap"] is True and two[1][1]["overlap"] is True
    checks[f"(b) fsdp2: parameter + optimizer bytes <= {SO_FSDP_BYTES} x one rank's"] = all(
        two[r][1]["param_opt_bytes"] <= SO_FSDP_BYTES * a["param_opt_bytes"] for r in (0, 1))
    ctx["scale_out_launches"] = launches
    emit({"phase": "scale_out", "group": "d", "card": ctx.get("smi"), "native_store": store_out, "group_s": group_s,
          **d_report})
    emit({"phase": "scale_out", "card": ctx.get("smi"), "one_rank_s": t_a, "seconds": time.perf_counter() - t0,
          "fsdp2_bytes_ratio": ratio, "pipe2_bytes_ratio": pipe_ratio, "launches": launches, "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"scale_out phase: {failed}")


def record_kernel_shapes(seen, dead_rows=None):
    """Wrap the CUDA entry points of K1 (``attention._flash_cuda``) and K2/K3
    (``_flash_bwd_cuda``) and the wrappers of K4 and K5 so that every
    distinct call shape of a main path is recorded in ``seen`` with its call
    count and the first mask (K4, K5: block tables and lens) passed at that
    shape. ``dead_rows``, where given, is a host-side flag (a callable) that
    is true while the path may pass a fully masked batch row: K1/K2/K3 then
    also keep a copy of each mask at that shape, and :func:`pick_dead_rows`
    finds the first with such a row after the run. No wrapper syncs the
    device. The wrappers only record; the launches and their counts are the
    kernels' own. Returns the function that restores the entry points."""
    from trlx_tpu_torch.ops import attention as attn
    from trlx_tpu_torch.ops import paged_attention as paged

    cuda_fwd, cuda_bwd = attn._flash_cuda, attn._flash_bwd_cuda
    decode, verify = paged.paged_attention_kernel, paged.paged_verify_attention_kernel

    def record(key, **first):
        entry = seen.setdefault(key, {"calls": 0, **{k: v.clone() for k, v in first.items()}})
        entry["calls"] += 1
        valid = first.get("kv_valid")
        if dead_rows is not None and valid is not None and dead_rows():
            entry.setdefault("dead_row_candidates", []).append(valid.clone())

    def fwd(q, k, v, kv_valid, causal, scale, return_lse):
        record(("flash_fwd", tuple(q.shape), k.shape[1], k.shape[2], q.dtype, causal, scale, return_lse),
               kv_valid=kv_valid)
        return cuda_fwd(q, k, v, kv_valid, causal, scale, return_lse)

    def bwd(q, k, v, kv_valid, out, lse, g, causal, scale):
        record(("flash_bwd", tuple(q.shape), k.shape[1], k.shape[2], q.dtype, causal, scale), kv_valid=kv_valid)
        return cuda_bwd(q, k, v, kv_valid, out, lse, g, causal, scale)

    def paged_wrapper(kind, fn):
        def run(q, k_pool, v_pool, block_tables, context_lens, *, k_scale=None, v_scale=None, scale=None):
            record((kind, tuple(q.shape), tuple(k_pool.shape), q.dtype, k_pool.dtype, scale),
                   block_tables=block_tables, context_lens=context_lens)
            return fn(q, k_pool, v_pool, block_tables, context_lens, k_scale=k_scale, v_scale=v_scale, scale=scale)

        return run

    attn._flash_cuda, attn._flash_bwd_cuda = fwd, bwd
    paged.paged_attention_kernel = paged_wrapper("paged_decode", decode)
    paged.paged_verify_attention_kernel = paged_wrapper("paged_verify", verify)

    def restore():
        attn._flash_cuda, attn._flash_bwd_cuda = cuda_fwd, cuda_bwd
        paged.paged_attention_kernel, paged.paged_verify_attention_kernel = decode, verify

    return restore


def pick_dead_rows(seen):
    """After the run: the first mask of each shape's ``dead_row_candidates``
    (:func:`record_kernel_shapes`) with a fully masked batch row becomes
    ``kv_valid_dead_row``; the candidates are dropped."""
    for entry in seen.values():
        for valid in entry.pop("dead_row_candidates", []):
            if bool((valid == 0).all(dim=1).any()):
                entry["kv_valid_dead_row"] = valid
                break


def kernel_shapes(seen):
    """The recorded call shapes (:func:`record_kernel_shapes`) as JSON."""
    out = []
    for key, e in seen.items():
        if key[0] in ("paged_decode", "paged_verify"):
            out.append({"kernel": key[0], "q": list(key[1]), "pool": list(key[2]), "dtype": str(key[3]),
                        "kv": str(key[4]), "calls": e["calls"]})
        else:
            out.append({"kernel": key[0], "q": list(key[1]), "kv_heads": key[2], "S": key[3], "dtype": str(key[4]),
                        "lse": key[7] if len(key) > 7 else None, "calls": e["calls"],
                        "dead_row_mask": "kv_valid_dead_row" in e})
    return out


def check_main_path_shapes(ctx, seen, phase, kinds):
    """Each kernel against its plain version at every shape the phase's main
    path gave it (:func:`record_kernel_shapes`), in the run's dtype and in
    f32, on seeded normal inputs: K1, K2 and K3 with the first mask the run
    passed at that shape (left-padded prompts, right-padded responses, a
    wave's padding), K5 with the first block tables and PRE-append lens (idle
    and mid-prefill slots included) over pools of the run's shape and layout
    (int8 pools quantized from normals). Tolerances as in the kernels phase.
    Fails when a kernel of ``kinds`` was never recorded."""
    import torch

    missing = [k for k in kinds if not any(key[0] == k for key in seen)]
    if missing:
        raise AssertionError(f"{phase} phase: no call of {missing} was recorded")
    first = next(iter(seen.values()))
    dev = (first["kv_valid"] if "kv_valid" in first else first["context_lens"]).device
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    errs = ctx.setdefault("max_abs_err", {})
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "paged_decode", "paged_verify"):
        errs.setdefault(name, 0.0)
    results = []
    for key, entry in seen.items():
        if key[0] in ("paged_decode", "paged_verify"):
            results += replay_paged(torch, gen, key, entry, errs)
            continue
        kind, (B, H, T, D), Hkv, S, run_dtype, causal, scale = key[:7]
        masks = [("", entry["kv_valid"], False)]
        if "kv_valid_dead_row" in entry:
            masks.append((", a fully masked row", entry["kv_valid_dead_row"], True))
        for label, valid, zero_row in masks:
            case = f"{phase}: {kind} B={B} T={T} S={S}, {entry['calls']} calls{label}"
            for dtype in dict.fromkeys((run_dtype, torch.float32)):
                q, k, v, g, _ = bwd_case(torch, gen, B, H, Hkv, T, S, D, (), dtype, dev)
                if kind == "flash_fwd":
                    results.append(compare_fwd(torch, case, q, k, v, valid, errs, zero_row=zero_row,
                                               causal=causal, scale=scale))
                else:
                    results += compare_bwd(torch, case, q, k, v, g, valid, errs, zero_row=zero_row,
                                           causal=causal, scale=scale)
    for r in results:
        emit({"phase": phase, "check": "kernel at a main-path shape", **r})
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{phase} phase: kernel disagrees with its plain version at a main-path shape: {bad}")


def replay_paged(torch, gen, key, entry, errs):
    """K4 or K5 against its plain version at one recorded main-path shape:
    the run's block tables and lens, seeded pools of the run's shape (int8
    from quantized normals, else the run's dtype), q in the run's dtype and
    in f32 (f32 pools with it unless int8)."""
    from trlx_tpu_torch.models.transformer import quantize_kv_rows
    from trlx_tpu_torch.ops import paged_attention as paged

    kind, q_shape, pool_shape, run_dtype, kv_dtype, scale = key
    kernel, plain = {"paged_decode": (paged.paged_attention_kernel, paged.paged_attention_reference),
                     "paged_verify": (paged.paged_verify_attention_kernel,
                                      paged.paged_verify_attention_reference)}[kind]
    tables, lens = entry["block_tables"], entry["context_lens"]
    dev = lens.device
    kf = torch.randn(*pool_shape, generator=gen, device=dev)
    vf = torch.randn(*pool_shape, generator=gen, device=dev)
    results = []
    for dtype in dict.fromkeys((run_dtype, torch.float32)):
        case = dict(q=torch.randn(*q_shape, generator=gen, device=dev).to(dtype), block_tables=tables,
                    context_lens=lens)
        if kv_dtype == torch.int8:
            (kq, ks), (vq, vs) = quantize_kv_rows(kf), quantize_kv_rows(vf)
            case.update(k_pool=kq, v_pool=vq, k_scale=ks[..., 0].contiguous(), v_scale=vs[..., 0].contiguous())
        else:
            case.update(k_pool=kf.to(dtype), v_pool=vf.to(dtype))
        out = paged_call(lambda *a, **kw: kernel(*a, **kw, scale=scale), case)
        ref = paged_call(lambda *a, **kw: plain(*a, **kw, scale=scale), case)
        torch.cuda.synchronize()
        # the plain decode averages over a slot at len 0 where the kernel writes 0
        live = lens > 0 if kind == "paged_decode" else torch.ones_like(lens, dtype=torch.bool)
        err = (out.float() - ref.float())[live].abs().max().item()
        tol = TOL[str(dtype).split(".")[-1]] * max(1.0, ref.float()[live].abs().max().item())
        ok = err <= tol and bool(torch.isfinite(out.float()).all())
        if kind == "paged_decode":
            ok = ok and bool((out[~live] == 0).all())
        shape_txt = f"B={q_shape[0]}" + (f" Q={q_shape[1]}" if kind == "paged_verify" else "")
        results.append({"kernel": kind, "case": f"{shape_txt} MB={tables.shape[1]}, {entry['calls']} calls, "
                                                f"lens {int(lens.min())}..{int(lens.max())}",
                        "dtype": str(dtype), "kv": str(kv_dtype).split(".")[-1], "max_abs_err": err, "tol": tol,
                        "ok": ok})
        errs[kind] = max(errs[kind], err)
    return results


def kernel_table(ctx):
    """One row per ported TPU kernel; ``launches`` is the count from the main
    path that runs it (the engine for K1 and K4, the trainer for K2 and K3,
    the speculative engine for K5), with every main path's count beside it
    in ``launches_by_path``; ``head_dims`` the dims its wrapper launches for
    (f32 and bf16; the paged f32 body takes any D), and ``d256`` its timing
    at GPT-J's head dim with its launches in phase ``gptj``."""
    from trlx_tpu_torch.ops.attention import FLASH_HEAD_DIMS
    from trlx_tpu_torch.ops.paged_attention import PAGED_MMA_HEAD_DIMS

    t, errs, t256 = ctx["timings"], ctx["max_abs_err"], ctx["timings_d256"]
    paths = {"engine": ctx["main_path_launches"], "engine_spec": ctx["spec_path_launches"],
             "train": ctx["train_launches"], "train_serving": ctx["serving_train_launches"],
             "sft": ctx["sft_launches"], "hydra": ctx["hydra_launches"], "ilql": ctx["ilql_launches"],
             "rft": ctx["rft_launches"], "grpo": ctx["grpo_launches"], "online_grpo": ctx["online_grpo_launches"],
             "async": ctx["async_launches"], "resilience": ctx["resilience_launches"],
             "observability": ctx["observability_launches"],
             "production_serving": ctx["production_serving_launches"],
             "serving_fleet": ctx["serving_fleet_launches"],
             "families_seq2seq": ctx["families_seq2seq_launches"],
             "peft_memory": ctx["peft_memory_launches"], "stacked": ctx["stacked_launches"],
             "scale_out": ctx["scale_out_launches"], "gptj": ctx["gptj_launches"]}
    rows = [
        ("flash_fwd", "trlx_tpu_torch/csrc/flash_fwd.cu", "trlx_tpu/ops/attention.py:72", "engine"),
        ("flash_bwd_dkv", "trlx_tpu_torch/csrc/flash_bwd.cu", "trlx_tpu/ops/attention.py:263", "train"),
        ("flash_bwd_dq", "trlx_tpu_torch/csrc/flash_bwd.cu", "trlx_tpu/ops/attention.py:338", "train"),
        ("paged_decode", "trlx_tpu_torch/csrc/paged_decode.cu", "trlx_tpu/ops/paged_attention.py:183", "engine"),
        ("paged_verify", "trlx_tpu_torch/csrc/paged_decode.cu", "trlx_tpu/ops/paged_attention.py:244",
         "engine_spec"),
    ]
    table = []
    for name, src, rep, path in rows:
        table.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                      "launches": paths[path][name], "max_abs_err": errs[name],
                      "ms": t[name]["ms"], "plain_ms": t[name]["plain_ms"], "bound_ms": t[name]["bound_ms"],
                      "bound_by": t[name]["bound_by"], "library_ms": t[name]["library_ms"],
                      "launches_by_path": {p: counts[name] for p, counts in paths.items()},
                      "head_dims": list(PAGED_MMA_HEAD_DIMS if name.startswith("paged") else FLASH_HEAD_DIMS),
                      "d256": {"shape": t256[name]["shape"], "launches": paths["gptj"][name],
                               **{k: t256[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                             "library_ms")}}})
    return {"kernels": table, "not_yet_ported": []}


def gates_start(ctx, gates):
    """Start the learning gates ``gates`` in order in a child process
    (``--gates-child``: this script, its output to files); :func:`gates_finish`
    reads it. Their SFT export lives in the child."""
    import tempfile

    out = tempfile.mkdtemp(prefix="chip_smoke_gates_")
    log = open(os.path.join(out, "stdout"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gates-child", "--phases", ",".join(gates)],
                            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    ctx["gates"] = {"proc": proc, "dir": out, "names": gates, "t0": time.perf_counter()}


def gates_finish(ctx):
    """Wait for the gates' child: print its gate reports, take its phase
    seconds (the wait beside them is ``gates_wait``), and fail as a gate
    phase would when the child failed."""
    import shutil

    gates = ctx.pop("gates")
    t0 = time.perf_counter()
    try:
        rc = gates["proc"].wait(timeout=900)
    finally:
        if gates["proc"].poll() is None:
            gates["proc"].kill()
            gates["proc"].wait()
    with open(os.path.join(gates["dir"], "stdout")) as f:
        lines = f.read().splitlines()
    shutil.rmtree(gates["dir"], ignore_errors=True)
    ctx["phase_seconds"]["gates_wait"] = time.perf_counter() - t0
    ctx["phase_seconds"]["gates_child"] = time.perf_counter() - gates["t0"]
    for ln in lines:
        try:
            rec = json.loads(ln) if ln.startswith("{") else {}
        except ValueError:
            rec = {}
        if rec.get("phase") in gates["names"]:
            print(ln, flush=True)
        elif "phase_seconds" in rec:
            ctx["phase_seconds"].update(rec["phase_seconds"])
    if rc != 0:
        tail = "\n".join(lines[-40:])
        raise AssertionError(f"the gates' child exited {rc}:\n{tail}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--gates-child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 1
    import trlx_tpu_torch  # noqa: F401  (fails in a directory without the package)

    ctx = {"phase_seconds": {}}
    runners = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
               "timing": phase_timing, "parity": phase_parity, "engine": phase_engine,
               "spec_parity": phase_spec_parity, "engine_spec": phase_engine_spec,
               "train_parity": phase_train_parity, "train": phase_train,
               "train_serving": phase_train_serving, "sft_parity": phase_sft_parity, "sft": phase_sft,
               "randomwalks": phase_randomwalks, "hydra_parity": phase_hydra_parity, "hydra": phase_hydra,
               "gptj": phase_gptj,
               "ilql_parity": phase_ilql_parity, "ilql": phase_ilql, "rft": phase_rft,
               "randomwalks_hydra": phase_randomwalks_hydra, "randomwalks_ilql": phase_randomwalks_ilql,
               "randomwalks_rft": phase_randomwalks_rft, "grpo_parity": phase_grpo_parity, "grpo": phase_grpo,
               "online_grpo": phase_online_grpo, "async": phase_async, "grpo_synthetic": phase_grpo_synthetic,
               "randomwalks_async": phase_randomwalks_async, "resilience": phase_resilience,
               "observability": phase_observability, "production_serving": phase_production_serving,
               "serving_fleet": phase_serving_fleet, "families_seq2seq": phase_families_seq2seq,
               "peft_memory": phase_peft_memory, "stacked": phase_stacked, "scale_out": phase_scale_out,
               "analysis": phase_analysis}
    phase_env(ctx)
    # a run with more than the gates runs them in a child beside the phases after them
    gates = [] if args.gates_child else [p for p in phases if p in GATE_PHASES]
    try:
        for name in phases:
            if name in gates:
                if "gates" not in ctx and len(gates) < len(phases):
                    gates_start(ctx, gates)
                if "gates" in ctx:
                    continue
            if name in ("peft_memory", "stacked") and "analysis" in phases and "mesh_census_proc" not in ctx:
                # the mesh census's process runs beside phases peft_memory and
                # stacked: after every phase that times a kernel, beside none
                # that holds a time to a bar, and it times nothing itself
                ctx["mesh_census_proc"] = an_census_start(run="an_mesh_census_run")
            if name == "scale_out" and "mesh_census_proc" in ctx:
                # its four ranks end before scale_out's need the card's memory
                # (beside them, the card ran out); the one-device census runs
                # beside scale_out
                t0 = time.perf_counter()
                ctx["mesh_census_result"] = _census_result(ctx.pop("mesh_census_proc"), "mesh census")
                ctx["phase_seconds"]["mesh_census_wait"] = time.perf_counter() - t0
                ctx["census_proc"] = an_census_start()
            if name != "env":
                t0 = time.perf_counter()
                runners[name](ctx)
                ctx["phase_seconds"][name] = time.perf_counter() - t0
        if "gates" in ctx:
            gates_finish(ctx)
    finally:
        if "gates" in ctx and ctx["gates"]["proc"].poll() is None:  # a phase failed beside the gates
            ctx["gates"]["proc"].kill()
            ctx["gates"]["proc"].wait()
        for key in ("census_proc", "mesh_census_proc"):  # a phase failed before the census leg
            census = ctx.pop(key, None)
            if census is not None:
                stop_group(census)
        if "randomwalks_export" in ctx:  # the randomwalks SFT export, shared by the later gates
            import shutil

            shutil.rmtree(os.path.dirname(ctx["randomwalks_export"]), ignore_errors=True)
    emit({"phase_seconds": ctx["phase_seconds"], "card": ctx.get("smi")})
    if set(phases) != set(PHASES):
        return 0
    emit(kernel_table(ctx))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
