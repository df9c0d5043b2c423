"""Port parity for GRPO: trlx_tpu_torch's ``GRPOConfig`` and ``GRPOTrainer``
against trlx_tpu's on the same inputs (made from numpy seeds) and the same
initial weights (carried with ``policy_params_from_jax``).

- the method math (``group_normalize``, ``get_advantages_and_returns``,
  ``loss`` with and without staleness, values and gradients) within 1e-6,
  a constant group giving exactly 0, and GRPO's loss equal to PPO's
  ``policy_loss``;
- config validation, the registries, ``default_grpo_config`` round trips;
- ``GRPOTrainer`` against the JAX ``GRPOTrainer`` on the tiny config of
  ``tests/test_torch_trainer.py`` over 3 steps, the port replaying the JAX
  trainer's sampled generations (the packages' random streams differ):
  experience within 1e-4, stats within 1e-3 relative, whole adjacent
  groups; at ``weight_decay=0.1`` the value head, which the GRPO loss never
  reads, decays as optax decays it (within 1e-5);
- ``train(environment=...)`` dispatch and its errors;
- the GRPO gate of ``scripts/torch_grpo_synthetic.py``: the example's
  config, and a bar that the JAX runs clear and a run that does not learn
  misses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu.methods import grpo as jgrpo
from trlx_tpu_torch.methods import grpo as tgrpo
from trlx_tpu_torch.methods import ppo as tppo
from trlx_tpu_torch.models.convert import policy_params_from_jax

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-6, atol=1e-6)
ELEMENT_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_TOL = dict(rtol=1e-3, atol=1e-5)
ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]


def _methods(**kw):
    base = dict(name="GRPOConfig", num_rollouts=8, chunk_size=4, group_size=4)
    base.update(kw)
    return jgrpo.GRPOConfig(**base), tgrpo.GRPOConfig(**base)


def _arrays(seed, B=6, T=7):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    for i in range(B):
        mask[i, rng.integers(1, T + 1):] = 0.0
    draw = lambda scale=1.0: (rng.normal(size=(B, T)) * scale).astype(np.float32)  # noqa: E731
    return dict(logprobs=draw(0.5) - 2, values=draw(), old_logprobs=draw(0.5) - 2, old_values=draw(),
                advantages=draw(), returns=draw(), mask=mask)


# ------------------------------------------------------------- group math


@pytest.mark.parametrize("seed", [0, 1])
def test_group_normalize_matches_jax(seed):
    jm, tm = _methods()
    scores = np.random.default_rng(seed).normal(size=16).astype(np.float32) * 3
    np.testing.assert_allclose(tm.group_normalize(scores), jm.group_normalize(scores), **TOL)
    grouped = tm.group_normalize(scores).reshape(-1, 4)
    np.testing.assert_allclose(grouped.mean(axis=1), 0.0, atol=1e-6)


def test_constant_group_gives_exactly_zero():
    jm, tm = _methods()
    scores = np.array([3.7] * 4 + [0.0, 1.0, 2.0, 3.0], np.float32)
    adv = tm.group_normalize(scores)
    assert np.all(adv[:4] == 0.0)  # exact, not approx
    np.testing.assert_array_equal(adv, jm.group_normalize(scores))
    with pytest.raises(ValueError, match="multiple of group_size"):
        tm.group_normalize(np.ones(6, np.float32))


@pytest.mark.parametrize("whiten", [False, True])
def test_advantages_and_returns_match_jax(whiten):
    jm, tm = _methods(gamma=0.9, whiten_advantages=whiten)
    a = _arrays(3)
    rewards = a["advantages"]
    jadv, jret = jm.get_advantages_and_returns(jnp.asarray(a["values"]), jnp.asarray(rewards),
                                               jnp.asarray(a["mask"]))
    tadv, tret = tm.get_advantages_and_returns(torch.from_numpy(a["values"]), torch.from_numpy(rewards),
                                               torch.from_numpy(a["mask"]))
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), **TOL)
    assert float(tret.abs().max()) == 0.0 and float(jnp.abs(jret).max()) == 0.0


def _loss_both(jm, tm, a, staleness=None, clip=None):
    """(port loss, port stats, port grads, jax loss, jax stats, jax grads)
    with gradients taken w.r.t. logprobs and values."""
    extra_j = {} if staleness is None else dict(staleness=jnp.asarray(staleness), is_ratio_clip=clip)
    extra_t = {} if staleness is None else dict(staleness=torch.from_numpy(staleness), is_ratio_clip=clip)
    rest = ("old_logprobs", "old_values", "advantages", "returns", "mask")

    def jloss(lp, v):
        return jm.loss(lp, v, *[jnp.asarray(a[k]) for k in rest], **extra_j)

    (jl, js), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(a["logprobs"]), jnp.asarray(a["values"]))
    lp = torch.from_numpy(a["logprobs"]).requires_grad_(True)
    v = torch.from_numpy(a["values"]).requires_grad_(True)
    tl, ts = tm.loss(lp, v, *[torch.from_numpy(a[k]) for k in rest], **extra_t)
    tg = torch.autograd.grad(tl, (lp, v), allow_unused=True)
    return tl, ts, tg, jl, js, jg


def _flat(stats, prefix=""):
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = float(np.asarray(v.detach() if hasattr(v, "detach") else v))
    return out


@pytest.mark.parametrize("stale", ["none", "fresh", "mixed"])
def test_loss_matches_jax(stale):
    jm, tm = _methods(cliprange=0.2)
    a = _arrays(4)
    staleness = {"none": None, "fresh": np.zeros(6, np.int32), "mixed": np.array([0, 1, 0, 2, 3, 0], np.int32)}[stale]
    tl, ts, tg, jl, js, jg = _loss_both(jm, tm, a, staleness, None if staleness is None else 2.0)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[0]), **TOL)
    # the values never reach the loss: no gradient in either package
    assert tg[1] is None and float(jnp.abs(jg[1]).max()) == 0.0
    tflat, jflat = _flat(ts), _flat(js)
    assert set(tflat) == set(jflat)
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], err_msg=k, **TOL)
    assert ("staleness/mean" in tflat) == (staleness is not None)


def test_zero_staleness_loss_is_bit_identical():
    _, tm = _methods()
    a = {k: torch.from_numpy(v) for k, v in _arrays(5).items()}
    base, _ = tm.loss(**a)
    fresh, stats = tm.loss(**a, staleness=torch.zeros(6, dtype=torch.int32), is_ratio_clip=2.0)
    assert base.numpy().tobytes() == fresh.numpy().tobytes()
    assert float(stats["staleness"]["is_weight_mean"]) == 1.0


def test_grpo_loss_is_ppo_policy_loss():
    _, tm = _methods(cliprange=0.2)
    a = {k: torch.from_numpy(v) for k, v in _arrays(6).items()}
    g_loss, g_stats = tm.loss(**a)
    _, p_stats = tppo.PPOConfig(cliprange=0.2).loss(**a)
    assert g_loss.numpy().tobytes() == p_stats["losses"]["policy_loss"].numpy().tobytes()
    assert float(g_stats["policy"]["approx_kl"]) == float(p_stats["policy"]["approx_kl"])
    assert float(g_stats["losses"]["value_loss"]) == 0.0


def test_zero_advantage_is_a_noop_update():
    _, tm = _methods()
    a = {k: torch.from_numpy(v) for k, v in _arrays(7).items()}
    a["advantages"] = torch.zeros_like(a["advantages"])
    lp = a.pop("logprobs").requires_grad_(True)
    loss, _ = tm.loss(lp, **a)
    (grad,) = torch.autograd.grad(loss, (lp,))
    assert float(loss) == 0.0 and float(grad.abs().max()) == 0.0


# ------------------------------------------------------ config / registry


def test_grpo_config_validation():
    with pytest.raises(ValueError, match="group_size"):
        tgrpo.GRPOConfig(group_size=1)
    with pytest.raises(ValueError, match="num_rollouts"):
        tgrpo.GRPOConfig(num_rollouts=6, chunk_size=4, group_size=4)
    with pytest.raises(ValueError, match="chunk_size"):
        tgrpo.GRPOConfig(num_rollouts=8, chunk_size=6, group_size=4)


def test_registry_and_default_config_round_trip():
    from trlx_tpu.data.default_configs import default_grpo_config as jax_default
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_grpo_config
    from trlx_tpu_torch.data.method_configs import get_method
    from trlx_tpu_torch.utils.loading import get_trainer

    assert get_method("GRPOConfig") is tgrpo.GRPOConfig
    assert get_trainer("GRPOTrainer").__name__ == "GRPOTrainer"
    config = default_grpo_config()
    assert isinstance(config.method, tgrpo.GRPOConfig) and config.train.trainer == "GRPOTrainer"
    restored = TRLConfig.from_dict(config.to_dict())
    assert isinstance(restored.method, tgrpo.GRPOConfig)
    # the JAX package's default config, field for field
    assert config.to_dict() == jax_default().to_dict()


# ------------------------------------------------------------ the trainer


def _config_dict(tmp_path, weight_decay=1e-4):
    """tests/test_torch_trainer.py's tiny config with the GRPO method: 8
    rollouts in groups of 2, sampled; 3 steps of 4 in 2 microbatches."""
    return dict(
        method=dict(
            name="GRPOConfig", num_rollouts=8, chunk_size=4, group_size=2, ppo_epochs=1, init_kl_coef=0.05,
            target=6.0, horizon=1000, gen_kwargs=dict(max_new_tokens=5, do_sample=True),
        ),
        train=dict(
            seq_length=16, epochs=2, total_steps=3, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="GRPOTrainer", tracker=None, seed=2, save_best=False,
        ),
        model=dict(
            model_path="gpt2", num_layers_unfrozen=-1,
            model_overrides=dict(
                vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=64, attention_impl="flash",
            ),
        ),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-2, betas=(0.9, 0.95), weight_decay=weight_decay,
                                                  max_grad_norm=1.0)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    )


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


def _record(trainer):
    """Capture each step's stats and each experience phase's elements."""
    rec = {"steps": [], "phases": []}
    step, push = trainer.train_step, trainer.push_to_store

    def train_step(batch):
        out = step(batch)
        rec["steps"].append(dict(out))
        return out

    def push_to_store(data):
        rec["phases"].append(list(data))
        return push(data)

    trainer.train_step, trainer.push_to_store = train_step, push_to_store
    return rec


@pytest.fixture(scope="module")
def grpo_runs(tmp_path_factory):
    """Both packages' GRPOTrainer through learn() from the same weights at
    weight_decay=0.1; the port replays the JAX trainer's generations."""
    import trlx_tpu.methods  # noqa: F401  (registers GRPOConfig)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.parallel import mesh as mesh_lib
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    tmp = tmp_path_factory.mktemp("grpo")
    real = mesh_lib.make_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh_lib, "mesh_from_config",
                   lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]))
        jcfg = JaxConfig.from_dict(_config_dict(tmp / "jax", weight_decay=0.1))
        jt = jax_get_trainer("GRPOTrainer")(config=jcfg, reward_fn=reward_fn)
        cfg = TRLConfig.from_dict(_config_dict(tmp / "port", weight_decay=0.1))
        pt = get_trainer("GRPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu")
        for tr, pipe, c in ((jt, JaxPipeline, jcfg), (pt, PromptPipeline, cfg)):
            max_prompt = c.train.seq_length - c.method.gen_kwargs["max_new_tokens"]
            tr.add_prompt_pipeline(pipe(PROMPTS, max_prompt, tr.tokenizer))
            tr.add_eval_pipeline(pipe(PROMPTS[:4], max_prompt, tr.tokenizer))
        init = jax.tree.map(np.asarray, jax.device_get(jt.params))
        pt.model.load_state_dict(policy_params_from_jax(init, pt.model_config))
        pt.ref_model.load_state_dict(pt.model.transformer.state_dict())

        generated, jgen = [], jt.generate

        def jax_generate(prompts, eval_mode=False, **kw):
            out = jgen(prompts, eval_mode=eval_mode, **kw)
            generated.append(([np.asarray(p).tolist() for p in prompts], [np.asarray(x) for x in out[:2]], out[2]))
            return out

        replayed = iter(generated)

        def port_generate(prompts, eval_mode=False, **kw):
            want, (seqs, mask), P = next(replayed)
            assert [np.asarray(p).tolist() for p in prompts] == want
            return seqs, mask, P

        jt.generate, pt.generate = jax_generate, port_generate
        jrec, prec = _record(jt), _record(pt)
        jres = jt.learn()
        pres = pt.learn()
        final = jax.tree.map(np.asarray, jax.device_get(jt.params))
    return dict(jt=jt, pt=pt, jrec=jrec, prec=prec, jres=jres, pres=pres, init=init, final=final)


def test_grpo_trainer_matches_jax(grpo_runs):
    jrec, prec = grpo_runs["jrec"], grpo_runs["prec"]
    assert len(prec["phases"]) == len(jrec["phases"]) == 2
    for jphase, pphase in zip(jrec["phases"], prec["phases"]):
        assert len(pphase) == len(jphase) == 8
        for je, pe in zip(jphase, pphase):
            np.testing.assert_array_equal(np.asarray(pe.query_tensor), np.asarray(je.query_tensor))
            np.testing.assert_array_equal(np.asarray(pe.response_tensor), np.asarray(je.response_tensor))
            for field in ("logprobs", "values", "rewards"):
                np.testing.assert_allclose(getattr(pe, field), np.asarray(getattr(je, field)), err_msg=field,
                                           **ELEMENT_TOL)
        # whole adjacent groups: each pair shares its query
        for i in range(0, len(pphase), 2):
            np.testing.assert_array_equal(pphase[i].query_tensor, pphase[i + 1].query_tensor)
        assert len({tuple(e.response_tensor.tolist()) for e in pphase}) > 1  # sampled, not all equal
    assert len(prec["steps"]) == len(jrec["steps"]) == 3
    for i, (js, ps) in enumerate(zip(jrec["steps"], prec["steps"])):
        compared = [k for k in js if k.split("/")[0] in (
            "losses", "policy", "group", "ratio", "padding_percentage", "learning_rate_group_0",
            "rollout_scores", "kl_ctl_value")]
        assert len(compared) >= 14
        for key in compared:
            np.testing.assert_allclose(ps[key], js[key], err_msg=f"step {i + 1} {key}", **STAT_TOL)
        assert ps["losses/value_loss"] == 0.0
        assert "online/group_adv_std" not in ps  # no online buffer: no online/* gauges
    assert grpo_runs["pres"]["reward/mean"] == grpo_runs["jres"]["reward/mean"]


def test_value_head_decays_as_optax_does(grpo_runs):
    """The GRPO loss never reads the value head, so its gradient is zero;
    the optimizer step still decays it (optax's adamw over every trained
    parameter). The JAX head moves by more than the tolerance, so a port
    that skipped it would fail here."""
    pt, init, final = grpo_runs["pt"], grpo_runs["init"], grpo_runs["final"]
    jinit = policy_params_from_jax(init, pt.model_config)
    jfinal = policy_params_from_jax(final, pt.model_config)
    head = [k for k in jfinal if k.startswith("v_head.")]
    assert len(head) == 4
    state = pt.model.state_dict()
    moved = max(float((jfinal[k] - jinit[k]).abs().max()) for k in head)
    assert moved > 1e-4
    for k in head:
        np.testing.assert_allclose(state[k].numpy(), jfinal[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


# ----------------------------------------------------------- the dispatch


def test_train_environment_row_runs_grpo(tmp_path):
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.online import SyntheticEnvironment
    from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer

    d = _config_dict(tmp_path)
    d["train"].update(total_steps=1, epochs=1)
    env = SyntheticEnvironment(vocab_size=len(ALPHABET) + 3, prompt_len=4, target_token=3)
    trainer = trlx_tpu_torch.train(environment=env, prompts=PROMPTS, config=TRLConfig.from_dict(d), device="cpu")
    assert isinstance(trainer, GRPOTrainer) and trainer.iter_count == 1


def test_train_environment_errors():
    import trlx_tpu_torch
    from trlx_tpu_torch.online import SyntheticEnvironment

    with pytest.raises(ValueError, match="mutually exclusive"):
        trlx_tpu_torch.train(reward_fn=lambda **kw: [0.0], environment=SyntheticEnvironment(), device="cpu")
    with pytest.raises(ValueError, match="environment"):
        trlx_tpu_torch.train(device="cpu")


def test_grpo_synthetic_gate_is_the_examples_recipe():
    """The gate's config is ``examples/grpo_synthetic.py``'s on every key the
    two packages share, its environment draws the example's prompts, and
    its recorded JAX curves run every 20 steps to its step budget."""
    from examples.grpo_synthetic import build_config as jax_build_config
    from scripts import torch_grpo_synthetic as gate
    from trlx_tpu.online import SyntheticEnvironment as JaxEnvironment

    port, ref = gate.build_config(), jax_build_config()
    for section in ("train", "method", "model", "tokenizer"):
        theirs = ref.to_dict()[section]
        mine = port.to_dict()[section]
        assert {k: mine[k] for k in theirs if k in mine} == {k: theirs[k] for k in theirs if k in mine}, section
    env = JaxEnvironment(vocab_size=12, prompt_len=4, target_token=3, max_turns=1, seed=7)
    np.testing.assert_array_equal(np.asarray(gate.environment().reset(4)), np.asarray(env.reset(4)))
    assert gate.EVAL_PROMPTS == gate.PROMPTS * 8
    interval = ref.train.eval_interval
    assert all(len(c) == gate.STEPS // interval + 1 for c in gate.JAX_CURVES.values())
    assert sorted(gate.JAX_CURVES) == list(gate.SEEDS)


def test_grpo_synthetic_gate_has_power():
    """The JAX runs clear the gate with room to spare; a run that does not
    learn (its evals at its step-0 level) and a run that rises two fifths as
    far as the JAX runs both miss it."""
    from scripts.torch_grpo_synthetic import JAX_CURVES, gate

    jax_curves = list(JAX_CURVES.values())
    assert gate(jax_curves)["ok"]
    flat = [[c[0]] * len(c) for c in jax_curves]
    report = gate(flat)
    assert not report["ok"] and not any(report["checks"].values())
    halved = [[c[0] + (r - c[0]) / 2.5 for r in c] for c in jax_curves]
    assert not gate(halved)["ok"]
