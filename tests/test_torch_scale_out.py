"""Scale-out parity: the port's PPO, SFT and ILQL trainers on N gloo ranks
against the JAX package's on a mesh of the same shape (the first N of the
conftest's virtual CPU devices), from the same initial parameters, at a
tiny width (2 layers, hidden 32, ``char://`` vocab, f32, greedy rollouts).
Checked: every rollout element (tokens identical; logprobs, values and
rewards within 1e-4), every step's stats (rtol 1e-3, atol 1e-5), the
gathered parameters after 2 steps (within 1e-5), and every rank's stats
``==`` each other's.

This file runs ``data=2`` and the checks around it: sampled rollouts that
do not depend on the rank count, ``reward_fn`` on process 0 only under
``reward_on_process_zero``, a 2-rank resume equal to the uninterrupted
run, and what a multi-rank run refuses or runs (async rollouts, the serving
engine and async checkpointing fall back with the reference's warnings; T5
and peft build and take a step). ``fsdp=2``, ``model=2`` and
``data=2 x fsdp=2`` have a file each (:func:`shape_fixture`).
"""

import contextlib
import logging

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import run_ranks

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]
SFT_SAMPLES = [["ab", "cd ef"], "hhh a", ["gh", "a b c"], "bad cafe", ["e", "fg ab"], "dead beef", ["a", "bb"],
               ["ef", "gh"]]
ILQL_SAMPLES = [["ab", "cd"], ["ef", "gh"], ["a", "bc"], ["de", "fg"], ["hh", "a"], ["b", "cde"],
                ["cc", "ddd"], ["g", "a"]]
ILQL_REWARDS = [1.0, 0.5, -0.5, 0.25, 0.75, -1.0, 0.0, 2.0]
ELEMENT_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_TOL = dict(rtol=1e-3, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = ("ppo", "sft", "ilql")

_REWARD_CALLS = [0]


def reward_fn(samples, **kw):
    _REWARD_CALLS[0] += 1
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


def metric_fn(samples, **kw):
    return {"a_share": [s.count("a") / max(len(s), 1) for s in samples]}


def patched(d, patch):
    """``d`` with each dotted key of ``patch`` replaced (not merged)."""
    for key, value in (patch or {}).items():
        node = d
        *path, leaf = key.split(".")
        for k in path:
            node = node[k]
        node[leaf] = value
    return d


def config_dict(kind, mesh, ckpt_dir, do_sample=False, patch=None):
    model = dict(model_path="gpt2", num_layers_unfrozen=-1, model_overrides=dict(
        vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
        max_position_embeddings=64, attention_impl="flash"))
    train = dict(seq_length=16, epochs=4, total_steps=2, batch_size=8, minibatch_size=4, checkpoint_interval=100,
                 eval_interval=100, checkpoint_dir=str(ckpt_dir), pipeline="PromptPipeline", tracker=None, seed=2,
                 save_best=False)
    if kind == "ppo":
        method = dict(name="PPOConfig", num_rollouts=8, chunk_size=8, ppo_epochs=1, init_kl_coef=0.05, target=6.0,
                      horizon=1000, gen_kwargs=dict(max_new_tokens=5, do_sample=do_sample))
        train.update(trainer="PPOTrainer")
    elif kind == "sft":
        method = dict(name="SFTConfig", gen_kwargs=dict(max_new_tokens=4, do_sample=False))
        train.update(trainer="SFTTrainer", seq_length=12, seed=3)
    else:
        method = dict(name="ILQLConfig", steps_for_target_q_sync=1, two_qs=True, alpha=0.1, beta=0.5,
                      gen_kwargs=dict(max_new_tokens=4, top_k=4, beta=1.0, do_sample=False))
        train.update(trainer="ILQLTrainer")
    return patched(dict(
        method=method, train=train, model=model, tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), eps=1e-6, weight_decay=1e-4,
                                                  max_grad_norm=1.0)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(compute_dtype="float32", **mesh),
    ), patch)


def _drive(trainer, kind, pipeline_cls):
    """Attach the data, record every experience phase and step, learn."""
    rec = {"steps": [], "phases": []}
    if kind == "ppo":
        trainer.add_prompt_pipeline(pipeline_cls(PROMPTS, 11, trainer.tokenizer))
        trainer.add_eval_pipeline(pipeline_cls(PROMPTS[:4], 11, trainer.tokenizer))
        push = trainer.push_to_store

        def push_to_store(data):
            rec["phases"].append([tuple(np.asarray(x) for x in (e.query_tensor, e.response_tensor, e.logprobs,
                                                               e.values, e.rewards)) for e in data])
            return push(data)

        trainer.push_to_store = push_to_store
    elif kind == "sft":
        trainer.make_experience(SFT_SAMPLES, trainer.config.train.seq_length)
        trainer.add_eval_pipeline(pipeline_cls(PROMPTS[:4], 8, trainer.tokenizer))
    else:
        trainer.make_experience(ILQL_SAMPLES, ILQL_REWARDS, trainer.config.train.seq_length)
        trainer.add_eval_pipeline(pipeline_cls(PROMPTS[:4], 12, trainer.tokenizer))
        trainer.metric_fn = metric_fn
    step = trainer.train_step

    def train_step(batch):
        out = step(batch)
        rec["steps"].append({k: v for k, v in out.items() if not k.startswith("time/")})
        return out

    trainer.train_step = train_step
    rec["results"] = trainer.learn()
    return rec


def port_train(kind, mesh, init, ckpt_dir, overrides=None, do_sample=False, patch=None, probe=None):
    """A rank's run of one trainer (a :func:`run_ranks` job): the recorded
    phases and steps, the gathered parameters, its reward_fn calls
    (``patch``: config keys replaced, as :func:`config_dict`; ``probe``:
    ``"module:function"`` called with the trainer after learning, its
    result under ``"probe"``)."""
    import importlib

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.update(TRLConfig.from_dict(config_dict(kind, mesh, ckpt_dir, do_sample, patch)), overrides or {})
    kw = dict(reward_fn=reward_fn) if kind == "ppo" else {}
    _REWARD_CALLS[0] = 0
    trainer = get_trainer(cfg.train.trainer)(config=cfg, device="cpu", **kw)
    if init is not None:
        trainer.load_full_params({k: torch.from_numpy(v) for k, v in init.items()})
    from trlx_tpu_torch.parallel import collectives as coll

    coll.reset_counts()
    rec = _drive(trainer, kind, PromptPipeline)
    rec["seq_counts"] = coll.sequence_counts()
    rec["params"] = {k: v.numpy() for k, v in trainer.model_state_dict().items()}
    rec["reward_calls"] = _REWARD_CALLS[0]
    rec["iter_count"] = trainer.iter_count
    if probe is not None:
        module, fn = probe.split(":")
        rec["probe"] = getattr(importlib.import_module(module), fn)(trainer)
    return rec


@contextlib.contextmanager
def jax_mesh_of(n):
    """JAX trainers build their mesh over the first ``n`` virtual devices."""
    import jax

    from trlx_tpu.parallel import mesh as mesh_lib

    real = mesh_lib.make_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh_lib, "mesh_from_config", lambda cfg, devices=None: real(
            data=cfg.data, fsdp=cfg.fsdp, model=cfg.model, pipe=cfg.pipe, devices=jax.devices()[:n]))
        yield


#: peft leaves, re-drawn non-zero in the JAX trainer before anything runs
ADAPTERS = ("lora_a", "lora_b", "prefix_k", "prefix_v", "prompt_embeddings")


def _seeded_adapters(tree, seed=5):
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: (walk(v) if isinstance(v, dict) else
                    ((0.3 * rng.standard_normal(np.shape(v))).astype(np.float32) if k in ADAPTERS else v))
                for k, v in t.items()}

    return walk(tree)


def jax_trainer(kind, mesh, n, ckpt_dir, patch=None):
    """(JAX trainer, its initial parameters in the port's names; PPO's
    reference as ``ref_model.*`` and a T5 decoder branch as
    ``frozen_branch.*``). peft adapters are re-drawn non-zero from a seed
    first, so the adapters act from the first forward."""
    import jax
    import jax.numpy as jnp

    import trlx_tpu.methods  # noqa: F401  (registers the method configs)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer
    from trlx_tpu_torch.models.convert import params_from_jax, policy_params_from_jax, t5_params_from_jax
    from trlx_tpu_torch.models.presets import PRESETS

    cd = config_dict(kind, mesh, ckpt_dir, patch=patch)
    with jax_mesh_of(n):
        kw = dict(reward_fn=reward_fn) if kind == "ppo" else {}
        jt = jax_get_trainer(cd["train"]["trainer"])(config=JaxConfig.from_dict(cd), **kw)
    params = jax.tree.map(np.asarray, jax.device_get(jt.params))
    if cd["model"].get("peft_config"):
        params = _seeded_adapters(params)
        jt.params = jax.tree.map(lambda new, old: jax.device_put(jnp.asarray(new), old.sharding), params, jt.params)
    seq2seq = cd["model"].get("model_arch_type") == "seq2seq"
    trunk = "t5" if seq2seq else "transformer"
    if seq2seq:
        from trlx_tpu_torch.models.t5 import T5Config

        cfg = T5Config(**cd["model"]["model_overrides"], compute_dtype=torch.float32,
                       **{k: getattr(jt.model_config, k) for k in ("lora_r", "lora_alpha", "lora_targets")})
    else:
        # the JAX trainer's layout: stacked on a pipe axis
        cfg = PRESETS["gpt2"].replace(**{**cd["model"]["model_overrides"], "compute_dtype": torch.float32, **{
            k: getattr(jt.model_config, k) for k in ("pipeline_stages", "scan_layers", "lora_r", "lora_alpha",
                                                     "lora_targets", "peft_type", "num_virtual_tokens")}})
    if kind == "sft":
        conv = t5_params_from_jax if seq2seq else params_from_jax
        init = {f"{trunk}.{k}": v for k, v in conv(params[trunk], cfg).items()}
    else:
        init = policy_params_from_jax(params, cfg)
    if kind == "ppo":
        init.update({f"ref_model.{k[len(trunk) + 1:]}": v for k, v in init.items() if k.startswith(trunk + ".")})
        start = getattr(jt, "branch_start", None)
        if seq2seq and start is not None:
            from trlx_tpu_torch.models.policy import t5_branch_param_subtree

            trunk_state = {k[len(trunk) + 1:]: v for k, v in init.items() if k.startswith(trunk + ".")}
            init.update({f"frozen_branch.{k}": v
                         for k, v in t5_branch_param_subtree(trunk_state, start, cfg).items()})
    return jt, {k: v.numpy() for k, v in init.items()}


def jax_params_in_port_names(jt):
    import jax

    from trlx_tpu_torch.models.convert import _flatten

    return {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, jax.device_get(jt.params))).items()}


def compare(kind, jrec, jt, ranks, noise=(), slack=None):
    """The port's ranks against the JAX run. ``noise``: parameter names
    whose gradient is zero in exact arithmetic on this data, so that AdamW
    turns rounding noise into steps of ``lr |g| / eps``: they are held to
    two steps' worth of the rate instead of 1e-5. ``slack``: per parameter,
    an elementwise bound added to the 1e-5 (the JAX package's own
    difference between two layouts of the same run)."""
    prec = ranks[0]
    assert len(prec["steps"]) == len(jrec["steps"]) == 2
    for r in ranks[1:]:  # every rank reports the same numbers
        assert r["steps"] == prec["steps"]
        assert r["results"] == prec["results"]
    if kind == "ppo":
        assert len(prec["phases"]) == len(jrec["phases"]) >= 1
        for jphase, pphase in zip(jrec["phases"], prec["phases"]):
            assert len(pphase) == len(jphase) == 8
            for je, pe in zip(jphase, pphase):
                np.testing.assert_array_equal(pe[0], je[0])
                np.testing.assert_array_equal(pe[1], je[1])
                for i, field in ((2, "logprobs"), (3, "values"), (4, "rewards")):
                    np.testing.assert_allclose(pe[i], je[i], err_msg=field, **ELEMENT_TOL)
    for i, (js, ps) in enumerate(zip(jrec["steps"], prec["steps"])):
        keys = [k for k in js if not k.startswith("time/") and k in ps]
        assert len(keys) >= (20 if kind == "ppo" else 2)
        for key in keys:
            np.testing.assert_allclose(ps[key], js[key], err_msg=f"step {i + 1} {key}", **STAT_TOL)
    want = jax_params_in_port_names(jt)
    lr = jt.config.optimizer.kwargs["lr"]
    for name, value in prec["params"].items():
        if name in noise:
            assert np.abs(value - want[name]).max() <= 2 * lr, name
            continue
        if slack is not None and name in slack:
            bound = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want[name]) + slack[name]
            assert np.all(np.abs(value - want[name]) <= bound), name
            continue
        np.testing.assert_allclose(value, want[name], err_msg=name, **PARAM_TOL)
    for r in ranks[1:]:
        for name, value in r["params"].items():
            np.testing.assert_array_equal(value, prec["params"][name], err_msg=name)


def shape_fixture(mesh, n):
    """A module fixture: the three JAX trainers on the shape, the port's
    three runs started on ``n`` ranks in one process group meanwhile."""

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("scale_out")
        jts, jobs = {}, []
        for kind in KINDS:
            jts[kind], init = jax_trainer(kind, mesh, n, tmp / f"jax_{kind}")
            jobs.append(("tests.test_torch_scale_out:port_train",
                         dict(kind=kind, mesh=mesh, init=init, ckpt_dir=str(tmp / f"port_{kind}"))))
        handle = run_ranks(n, jobs, tmp / "ranks", wait=False)
        yield jts, handle
        handle.kill()

    return runs


def check_kind(runs, kind):
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline

    jts, handle = runs
    jrec = _drive(jts[kind], kind, JaxPipeline)
    ranks = [r[KINDS.index(kind)] for r in handle.results()]
    compare(kind, jrec, jts[kind], ranks)
    if kind == "ppo":  # reward_on_process_zero is on by default across ranks
        assert ranks[0]["reward_calls"] > 0 and all(r["reward_calls"] == 0 for r in ranks[1:])
    if kind != "sft":
        assert ranks[0]["results"] == jrec["results"]


data2 = shape_fixture(dict(data=2), 2)


@pytest.mark.parametrize("kind", KINDS)
def test_trainers_match_jax_on_data2(data2, kind):
    check_kind(data2, kind)


def refusals(tmp):
    """What a 2-rank run refuses or falls back from (a job)."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.parallel.mesh import make_mesh
    from trlx_tpu_torch.utils.loading import get_trainer

    out = {}
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep()
    logging.getLogger("trlx_tpu_torch").addHandler(handler)
    try:
        def build(**over):
            cfg = TRLConfig.update(TRLConfig.from_dict(config_dict("ppo", dict(data=2), tmp)), over)
            return get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu")

        t = build(**{"train.async_rollouts.enabled": True})
        out["async"] = t._resolve_async_config() is None
        t = build(**{"train.serving.enabled": True})
        t._resolve_serving()
        out["serving"] = t._serving_client is None
        t = build(**{"train.resilience.enabled": True, "train.resilience.async_checkpointing": True})
        out["async_ckpt"] = t.resilience.writer is None
        # T5 and peft build and run on data=2 (they raised naming their slice until it was ported)
        from trlx_tpu_torch.pipeline import PromptPipeline

        for key, patch in (("t5", {"model.model_path": "t5", "model.model_arch_type": "seq2seq",
                                   "model.model_overrides": dict(
                                       vocab_size=12, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                                       num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8)}),
                           ("peft", {"model.peft_config": {"peft_type": "LORA", "r": 4}})):
            cfg = TRLConfig.update(TRLConfig.from_dict(config_dict("ppo", dict(data=2), f"{tmp}/{key}", patch=patch)),
                                   {"train.total_steps": 1})
            t = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu")
            t.add_prompt_pipeline(PromptPipeline(PROMPTS, 11, t.tokenizer))
            t.add_eval_pipeline(PromptPipeline(PROMPTS[:2], 11, t.tokenizer))
            t.learn()
            out[key] = t.iter_count
        try:
            make_mesh(data=4)
            out["mismatch"] = "built"
        except ValueError as e:
            out["mismatch"] = str(e)
    finally:
        logging.getLogger("trlx_tpu_torch").removeHandler(handler)
    out["log"] = records
    return out


def test_data2_sampling_reward_on_process_zero_resume_and_refusals(tmp_path):
    """One 2-rank group: sampled PPO rollouts (the 1-rank port run's tokens),
    ``reward_fn`` on process 0 alone, a resume from the step-1 checkpoint
    equal to the uninterrupted run, and the refusals."""
    mesh = dict(data=2)
    over = {"train.checkpoint_interval": 1}
    resume = {"train.resume_from_checkpoint": str(tmp_path / "full" / "checkpoint_1")}
    jobs = [
        ("tests.test_torch_scale_out:port_train",
         dict(kind="ppo", mesh=mesh, init=None, ckpt_dir=str(tmp_path / "full"), overrides=over, do_sample=True)),
        ("tests.test_torch_scale_out:port_train",
         dict(kind="ppo", mesh=mesh, init=None, ckpt_dir=str(tmp_path / "resumed"), overrides=resume,
              do_sample=True)),
        ("tests.test_torch_scale_out:refusals", dict(tmp=str(tmp_path / "refusals"))),
    ]
    handle = run_ranks(2, jobs, tmp_path / "ranks", wait=False)
    try:
        # the 1-rank run, here, while the ranks work
        one = port_train("ppo", dict(data=1), None, str(tmp_path / "one"), do_sample=True)
    finally:
        ranks = handle.results()
    full, resumed, refused = ranks[0]
    assert full["reward_calls"] > 0 and ranks[1][0]["reward_calls"] == 0
    assert ranks[1][0]["steps"] == full["steps"]
    # sampled rollouts do not depend on the rank count
    assert len(full["phases"]) == len(one["phases"])
    for p2, p1 in zip(full["phases"], one["phases"]):
        for e2, e1 in zip(p2, p1):
            np.testing.assert_array_equal(e2[1], e1[1])
            np.testing.assert_allclose(e2[2], e1[2], **ELEMENT_TOL)
    for s2, s1 in zip(full["steps"], one["steps"]):
        for key in s1:
            np.testing.assert_allclose(s2[key], s1[key], err_msg=key, **STAT_TOL)
    # the resumed run took step 2 only, and ends where the uninterrupted one does
    assert resumed["iter_count"] == full["iter_count"] == 2 and len(resumed["steps"]) == 1
    for key in resumed["steps"][0]:
        np.testing.assert_allclose(resumed["steps"][0][key], full["steps"][1][key], err_msg=key, **STAT_TOL)
    for name, value in full["params"].items():
        np.testing.assert_allclose(resumed["params"][name], value, err_msg=name, **PARAM_TOL)
    for r in ranks:
        _, _, ref = r
        assert ref["async"] and ref["serving"] and ref["async_ckpt"]
        assert ref["t5"] == ref["peft"] == 1
        assert ref["mismatch"] == "Mesh [4, 1, 1, 1] does not match device count 2"
    log = "\n".join(refused["log"])  # the library logs on process 0
    assert "async_rollouts is single-process only" in log
    assert "train.serving disabled for this run: multi-device mesh" in log
    assert "async_checkpointing is single-process only" in log
