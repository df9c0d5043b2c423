"""Seeded set-ups shared by the census factories.

Three sizes: ``tiny`` (2 layers, hidden 32, the bytes tokenizer's 259 ids:
seconds on the CPU), ``full`` (the gpt2 preset at its published widths:
12 layers, hidden 768, 12 heads, vocab 50257, on the card, at the shapes of
``chip_smoke.py``'s main paths: see ``SIZES``) and ``xl`` (on the card: the
reference's GPT-2-XL audit blueprints, ``decode_step``'s and
``spec_verify_step``'s ``xl`` specs in ``trlx_tpu/ops/generation.py`` and
``trlx_tpu/ops/paged_attention.py``: hidden 1600, 48 stacked layers, 25
heads, vocab 50257; those two entries only). All compute in
bf16 with flash attention, the trainers over f32 parameters (their main
path) and the engines over bf16 ones (a serving deployment); weights are
random from seed 0 and decoding is greedy. Trainers and
engines are memoized in the factories' ``shared`` dict, so the entries of one
census run share them.

On a mesh (``shared["mesh"]``: axis sizes, set by
:mod:`~trlx_tpu_torch.analysis.census.ranks`) the trainers run on it, over
the process group the rank launcher joined; ``tiny`` then takes
:data:`MESH_ROWS` times its learner rows, so that each microbatch splits
over the four batch ranks (``full``'s 32 rows in microbatches of 16 already
do: 4 rows a rank a microbatch).
"""

import tempfile
from typing import Any, Dict

import numpy as np
import torch

SEED = 0

#: per size: model overrides of the gpt2 preset, and the shapes of each step
SIZES: Dict[str, Dict[str, Any]] = {
    "tiny": dict(
        model=dict(vocab_size=259, hidden_size=32, num_layers=2, num_heads=2, max_position_embeddings=256,
                   attention_impl="flash"),
        decode=dict(B=4, lo=4, hi=8, N=6),
        train=dict(B=4, MB=2, P=8, R=8),
        ilql=dict(B=4, T=16, A=8),
        engine=dict(slots=4, block=4, max_len=64, prompt=(5, 12), spec_k=2, chunk=8),
        score=dict(B=2, P=8, max_new=64),
    ),
    # chip_smoke.py's main paths. decode: the train phase's generate (TRAIN_B
    # prompts of 64-128 bytes), 8 of its TRAIN_N new tokens (a decode
    # iteration is one program, the same at every position); train: TRAIN_B,
    # TRAIN_MB, TRAIN_P, TRAIN_N; ilql: ILQL_B, ILQL_MB, ILQL_SEQ, half of it
    # actions; engine: SLOTS, block 16, PROMPT_CAP + MAX_NEW, serving_traffic's
    # prompt lengths, train_serving's spec_k and prefill_chunk; score: the
    # train phase's rows, prompt bucket and new tokens
    "full": dict(
        model=dict(attention_impl="flash"),
        decode=dict(B=32, lo=64, hi=128, N=8),
        train=dict(B=32, MB=16, P=128, R=128),
        ilql=dict(B=32, T=256, A=128),
        engine=dict(slots=256, block=16, max_len=256, prompt=(65, 128), spec_k=4, chunk=64),
        score=dict(B=32, P=128, max_new=128),
    ),
    # the reference's xl blueprints: decode B=8, P=128, N=16 (the trainer's
    # batch of 8 rollouts); verify over stacked int8 pools, NB=64, BS=16,
    # MB=16, spec_k=4
    "xl": dict(
        model=dict(vocab_size=50257, hidden_size=1600, num_layers=48, num_heads=25, intermediate_size=6400,
                   max_position_embeddings=1024, attention_impl="flash", scan_layers=True),
        decode=dict(B=8, lo=128, hi=128, N=16),
        train=dict(B=8, MB=8, P=128, R=16),
        verify=dict(B=8, num_blocks=64, block_size=16, max_blocks=16, spec_k=4),
    ),
}

#: the entries the ``xl`` size measures
XL_ENTRIES = ("decode_step", "spec_verify_step")
#: per size, the factor of the learner rows (batch and microbatch) on a mesh
MESH_ROWS = {"tiny": 2, "full": 1}


def shapes(size: str, part: str) -> Dict[str, Any]:
    return SIZES[size][part]


def _config(kind: str, size: str, mesh=None, overlap: bool = False):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_grpo_config, default_ilql_config, default_ppo_config

    base = {"ppo": default_ppo_config, "grpo": default_grpo_config, "ilql": default_ilql_config}[kind]()
    base.model.num_layers_unfrozen = -1
    if kind == "ilql":
        t = dict(B=shapes(size, "ilql")["B"], MB=shapes(size, "ilql")["B"] // 2)
    else:
        t = shapes(size, "train")
    if mesh:
        t = dict(B=t["B"] * MESH_ROWS[size], MB=t["MB"] * MESH_ROWS[size])
    over = {
        "model.model_path": "gpt2", "model.model_overrides": dict(SIZES[size]["model"]),
        "mesh.compute_dtype": "bfloat16", "mesh.param_dtype": "float32",
        "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": 256, "train.batch_size": t["B"], "train.minibatch_size": t["MB"],
        "train.total_steps": 100, "train.tracker": None, "train.seed": SEED,
        "train.checkpoint_dir": tempfile.mkdtemp(prefix="census_"),
    }
    if kind != "ilql":
        over.update({"method.num_rollouts": t["B"], "method.chunk_size": t["B"], "method.ppo_epochs": 1})
    if mesh:
        over.update({f"mesh.{axis}": n for axis, n in mesh.items()})
        over["train.learner_overlap.enabled"] = overlap
    return TRLConfig.update(base, over)


def trainer(kind: str, device, size: str, shared: Dict, overlap: bool = False):
    """The memoized ``PPOTrainer`` / ``GRPOTrainer`` / ``ILQLTrainer`` of
    ``size`` on ``device``, on ``shared["mesh"]`` when it is set (with
    ``train.learner_overlap`` when ``overlap``)."""
    mesh = shared.get("mesh")
    key = ("trainer", kind, str(device), size, tuple(sorted((mesh or {}).items())), overlap)
    if key not in shared:
        from trlx_tpu_torch.utils.loading import get_trainer

        name = {"ppo": "PPOTrainer", "grpo": "GRPOTrainer", "ilql": "ILQLTrainer"}[kind]
        kw = {} if kind == "ilql" else {"reward_fn": lambda samples, **_: [0.0] * len(samples)}
        tr = get_trainer(name)(config=_config(kind, size, mesh, overlap), device=device, **kw)
        bs = tr.config.train.batch_size
        tr.num_mb = max(1, bs // (tr.config.train.minibatch_size or bs))  # as prepare_learning sets it
        shared[key] = tr
    return shared[key]


def engine(device, size: str, shared: Dict, spec: bool):
    """A memoized ``ServingEngine`` over a seeded gpt2 trunk in bf16 (one
    trunk for both engines of a size, as the ``engine`` phase of
    ``chip_smoke.py`` serves), every slot admitted and decoding: the plain
    engine (one-token decode, whole-prompt prefill) or the speculative one
    (``spec_k`` drafts, chunked prefill)."""
    key = ("engine", spec, str(device), size)
    if key in shared:
        return shared[key]
    from trlx_tpu_torch.models.presets import PRESETS
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.serving import ServingEngine

    tkey = ("trunk", str(device), size)
    if tkey not in shared:
        over = {k: v for k, v in SIZES[size]["model"].items()}
        cfg = PRESETS["gpt2"].replace(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16, **over)
        shared[tkey] = TransformerLM(cfg, device=device).init_params(SEED)
    e = shapes(size, "engine")
    eng = ServingEngine(
        shared[tkey], device=device, num_slots=e["slots"], max_seq_len=e["max_len"], block_size=e["block"],
        eos_token_id=None, pad_token_id=0, gen_kwargs=dict(do_sample=False), seed=SEED, prefix_caching=False,
        spec_k=e["spec_k"] if spec else 0, prefill_chunk=e["chunk"] if spec else 0,
    )
    rng = np.random.default_rng(SEED)
    lo, hi = e["prompt"]
    for _ in range(e["slots"]):
        eng.submit(rng.integers(1, 200, size=int(rng.integers(lo, hi + 1))).tolist(), 32)
    while eng._prefilling.any() or any(r is None for r in eng.scheduler.slots):
        eng.step()
    shared[key] = eng
    return eng


def tokens(k: int, shape, vocab: int, device) -> torch.Tensor:
    """Content variant ``k`` of an int32 token tensor (seeded by ``k``)."""
    g = np.random.default_rng(1000 + k)
    return torch.tensor(g.integers(1, min(vocab, 250), size=shape), dtype=torch.int32, device=device)


def ppo_batches(size: str, tr, n: int = 4):
    """Content variants 0..n-1 of a learner batch of trainer ``tr``'s rows,
    collated by its own ``ppo_collate_fn`` from seeded rollouts: the same
    query and response lengths in every variant (one bucketed shape), other
    tokens, logprobs, values and rewards."""
    from trlx_tpu_torch.data.ppo_types import PPORLElement
    from trlx_tpu_torch.pipeline.ppo_pipeline import ppo_collate_fn

    t, B, pad_token_id = shapes(size, "train"), tr.config.train.batch_size, tr.tokenizer.pad_token_id
    rng = np.random.default_rng(SEED)
    q_lens = rng.integers(t["P"] // 2, t["P"] + 1, size=B)
    r_lens = rng.integers(t["R"] // 2, t["R"] + 1, size=B)
    q_lens[0], r_lens[0] = t["P"], t["R"]
    out = {}
    for k in range(n):
        g = np.random.default_rng(300 + k)
        elems = [PPORLElement(
            query_tensor=g.integers(1, 250, size=int(p)).astype(np.int32),
            response_tensor=g.integers(1, 250, size=int(r)).astype(np.int32),
            logprobs=-g.random(int(r)).astype(np.float32),
            values=g.normal(size=int(r)).astype(np.float32),
            rewards=g.normal(scale=0.1, size=int(r)).astype(np.float32),
        ) for p, r in zip(q_lens, r_lens)]
        out[k] = ppo_collate_fn(pad_token_id, elems)
    return out


def ilql_batches(size: str, tr, n: int = 4):
    """Content variants of an ILQL learner batch of trainer ``tr``'s rows
    (right-padded, the same lengths in every variant)."""
    from trlx_tpu_torch.data.ilql_types import ILQLBatch

    s = shapes(size, "ilql")
    B, T, A = tr.config.train.batch_size, s["T"], s["A"]
    out = {}
    for k in range(n):
        g = np.random.default_rng(400 + k)
        out[k] = ILQLBatch(
            input_ids=g.integers(1, 250, (B, T)).astype(np.int32),
            attention_mask=np.ones((B, T), np.int32),
            rewards=g.normal(size=(B, A)).astype(np.float32),
            states_ixs=np.tile(np.arange(T - A - 1, T, dtype=np.int32), (B, 1)),
            actions_ixs=np.tile(np.arange(T - A - 1, T - 1, dtype=np.int32), (B, 1)),
            dones=np.concatenate([np.ones((B, A), np.int32), np.zeros((B, 1), np.int32)], axis=1),
        )
    return out
