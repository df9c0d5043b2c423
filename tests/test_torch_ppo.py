"""Port parity for the PPO numerics: GAE, whitening, logprobs, running
moments, both KL controllers, ``PPOConfig.loss`` with its whole flattened
stats tree (with and without the staleness importance weights), the
optimizer with its learning-rate schedules, and the learn
loop's shuffle — the port (torch, CPU) against trlx_tpu (JAX, CPU) on the
same numpy arrays. f32 throughout; tolerance 1e-5 (rtol and atol) unless a
test states otherwise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

import trlx_tpu.methods.ppo as jppo
import trlx_tpu.utils as jutils
import trlx_tpu.utils.modeling as jmod
import trlx_tpu_torch.methods.ppo as tppo
import trlx_tpu_torch.utils as tutils
import trlx_tpu_torch.utils.modeling as tmod

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)


def _rollout(B=6, T=11, seed=0):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(B, T)).astype(np.float32)
    rewards = rng.normal(size=(B, T)).astype(np.float32) * 0.3
    lens = rng.integers(1, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.int32)
    return values, rewards, mask


@pytest.mark.parametrize("whitening", [True, False])
@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.99, 0.9)])
def test_gae_matches_jax(gamma, lam, whitening):
    values, rewards, mask = _rollout()
    ja, jr = jppo.gae_advantages_and_returns(
        jnp.asarray(values), jnp.asarray(rewards), jnp.asarray(mask), gamma, lam, whitening
    )
    ta, tr = tppo.gae_advantages_and_returns(
        torch.from_numpy(values), torch.from_numpy(rewards), torch.from_numpy(mask), gamma, lam, whitening
    )
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
    assert not ta.requires_grad


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("shift_mean", [True, False])
def test_whiten_and_masked_stats_match_jax(masked, shift_mean):
    values, _, mask = _rollout(seed=1)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    got = tmod.whiten(torch.from_numpy(values), shift_mean, tm)
    ref = jmod.whiten(jnp.asarray(values), shift_mean, jm)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        tmod.masked_var(torch.from_numpy(values), torch.from_numpy(mask)).numpy(),
        np.asarray(jmod.masked_var(jnp.asarray(values), jnp.asarray(mask))), **TOL,
    )
    np.testing.assert_allclose(
        tmod.masked_mean(torch.from_numpy(values), torch.from_numpy(mask), axis=1).numpy(),
        np.asarray(jmod.masked_mean(jnp.asarray(values), jnp.asarray(mask), axis=1)), **TOL,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logprobs_of_labels_matches_jax(dtype):
    """Log-softmax in f32 whatever the logits' dtype (bf16 logits are the
    same bf16 values in both frameworks)."""
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    got = tmod.logprobs_of_labels(tl, torch.from_numpy(labels))
    ref = jmod.logprobs_of_labels(jl, jnp.asarray(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_running_moments_match_jax():
    rng = np.random.default_rng(3)
    jm, tm = jmod.RunningMoments(), tmod.RunningMoments()
    for n in (5, 1, 17, 8):
        xs = rng.normal(size=n).astype(np.float32) * 3 + 1
        assert tm.update(xs) == pytest.approx(jm.update(xs), rel=1e-12)
        for attr in ("mean", "std", "var", "count"):
            assert getattr(tm, attr) == pytest.approx(getattr(jm, attr), rel=1e-12)


def test_kl_controllers_match_jax():
    ja = jppo.AdaptiveKLController(0.05, 6.0, 10000)
    ta = tppo.AdaptiveKLController(0.05, 6.0, 10000)
    jf, tf = jppo.FixedKLController(0.1), tppo.FixedKLController(0.1)
    for kl in (0.0, 3.0, 6.5, 40.0, 1e-3):
        for j, t in ((ja, ta), (jf, tf)):
            j.update(kl, 32)
            t.update(kl, 32)
            assert t.value == j.value
    assert tppo.PPOConfig(target=None).kl_controller().value == 0.05
    assert isinstance(tppo.PPOConfig().kl_controller(), tppo.AdaptiveKLController)


def test_ppo_config_fields_and_defaults_match_jax():
    from dataclasses import asdict

    assert asdict(tppo.PPOConfig()) == asdict(jppo.PPOConfig())


@pytest.mark.parametrize("seed", [0, 1])
def test_ppo_loss_and_stats_match_jax(seed):
    values, rewards, mask = _rollout(seed=seed)
    rng = np.random.default_rng(10 + seed)
    B, T = values.shape
    logprobs = (rng.normal(size=(B, T)) * 0.5 - 2).astype(np.float32)
    old_logprobs = (logprobs + rng.normal(size=(B, T)) * 0.3).astype(np.float32)
    new_values = (values + rng.normal(size=(B, T)) * 0.4).astype(np.float32)
    cfg = dict(cliprange=0.2, cliprange_value=0.2, vf_coef=0.7)
    jcfg, tcfg = jppo.PPOConfig(**cfg), tppo.PPOConfig(**cfg)
    jadv, jret = jcfg.get_advantages_and_returns(jnp.asarray(values), jnp.asarray(rewards), jnp.asarray(mask))
    tadv, tret = tcfg.get_advantages_and_returns(
        torch.from_numpy(values), torch.from_numpy(rewards), torch.from_numpy(mask)
    )
    jloss, jstats = jcfg.loss(
        jnp.asarray(logprobs), jnp.asarray(new_values), jnp.asarray(old_logprobs),
        jnp.asarray(values), jadv, jret, jnp.asarray(mask),
    )
    tloss, tstats = tcfg.loss(
        torch.from_numpy(logprobs), torch.from_numpy(new_values), torch.from_numpy(old_logprobs),
        torch.from_numpy(values), tadv, tret, torch.from_numpy(mask),
    )
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    jflat, tflat = jmod.flatten_dict(jstats), tmod.flatten_dict(tstats)
    assert sorted(tflat) == sorted(jflat)
    for key in jflat:
        np.testing.assert_allclose(float(tflat[key]), float(jflat[key]), err_msg=key, **TOL)


def test_ppo_loss_gradient_matches_jax():
    """d loss / d (logprobs, values): the clipped surrogate's gradient."""
    import jax

    values, rewards, mask = _rollout(seed=4)
    rng = np.random.default_rng(14)
    logprobs = (rng.normal(size=values.shape) * 0.5 - 2).astype(np.float32)
    old_logprobs = (logprobs + rng.normal(size=values.shape) * 0.3).astype(np.float32)
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    jadv, jret = cfg_j.get_advantages_and_returns(jnp.asarray(values), jnp.asarray(rewards), jnp.asarray(mask))
    jg = jax.grad(
        lambda lp, v: cfg_j.loss(lp, v, jnp.asarray(old_logprobs), jnp.asarray(values), jadv, jret,
                                 jnp.asarray(mask))[0],
        argnums=(0, 1),
    )(jnp.asarray(logprobs), jnp.asarray(values) + 0.1)
    lp = torch.from_numpy(logprobs).requires_grad_(True)
    v = (torch.from_numpy(values) + 0.1).requires_grad_(True)
    tadv, tret = cfg_t.get_advantages_and_returns(
        torch.from_numpy(values), torch.from_numpy(rewards), torch.from_numpy(mask)
    )
    loss, _ = cfg_t.loss(lp, v, torch.from_numpy(old_logprobs), torch.from_numpy(values), tadv, tret,
                         torch.from_numpy(mask))
    tg = torch.autograd.grad(loss, (lp, v))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("rows", ["fresh", "stale", "mixed"])
def test_staleness_branch_matches_jax(rows):
    """The staleness importance-weight branch of the loss: loss, stats tree
    and d loss / d (logprobs, values) against trlx_tpu's on fresh, stale
    and mixed rows (the clip at 2.0 reached by the log-ratios)."""
    import jax

    values, rewards, mask = _rollout(seed=5)
    rng = np.random.default_rng(15)
    logprobs = (rng.normal(size=values.shape) * 0.5 - 2).astype(np.float32)
    old_logprobs = (logprobs + rng.normal(size=values.shape) * 0.8).astype(np.float32)
    staleness = {"fresh": np.zeros(6, np.int32), "stale": np.full(6, 2, np.int32),
                 "mixed": np.array([0, 1, 0, 3, 2, 0], np.int32)}[rows]
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    jadv, jret = cfg_j.get_advantages_and_returns(jnp.asarray(values), jnp.asarray(rewards), jnp.asarray(mask))
    (jloss, jstats), jg = jax.value_and_grad(
        lambda lp, v: cfg_j.loss(lp, v, jnp.asarray(old_logprobs), jnp.asarray(values), jadv, jret,
                                 jnp.asarray(mask), staleness=jnp.asarray(staleness), is_ratio_clip=2.0),
        argnums=(0, 1), has_aux=True,
    )(jnp.asarray(logprobs), jnp.asarray(values) + 0.1)
    lp = torch.from_numpy(logprobs).requires_grad_(True)
    v = (torch.from_numpy(values) + 0.1).requires_grad_(True)
    tadv, tret = cfg_t.get_advantages_and_returns(
        torch.from_numpy(values), torch.from_numpy(rewards), torch.from_numpy(mask)
    )
    tloss, tstats = cfg_t.loss(lp, v, torch.from_numpy(old_logprobs), torch.from_numpy(values), tadv, tret,
                               torch.from_numpy(mask), staleness=torch.from_numpy(staleness), is_ratio_clip=2.0)
    tg = torch.autograd.grad(tloss, (lp, v))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jflat, tflat = jmod.flatten_dict(jstats), tmod.flatten_dict(tstats)
    assert sorted(tflat) == sorted(jflat) and "staleness/is_weight_mean" in tflat
    for key in jflat:
        np.testing.assert_allclose(float(tflat[key].detach()), float(jflat[key]), err_msg=key, **TOL)


SCHEDULES = {
    "cosine_annealing": dict(T_max=7, eta_min=1e-4),
    "linear": dict(total_steps=6, end_value=1e-5),
    "constant": dict(),
    "cosine_warmup": dict(warmup_steps=3, total_steps=9, eta_min=5e-5),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_optax(name):
    lr = 1e-3
    jsched = jutils.get_scheduler_class(name)(learning_rate=lr, **SCHEDULES[name])
    tsched = tutils.get_scheduler_class(name)(learning_rate=lr, **SCHEDULES[name])
    for step in range(14):
        assert tsched(step) == pytest.approx(float(jsched(step)), rel=1e-5, abs=1e-10), step


@pytest.mark.parametrize("warmup,total", [(10, 10), (10, 5)], ids=["total_eq_warmup", "total_lt_warmup"])
def test_cosine_warmup_without_decay_steps_raises_at_build_as_optax(warmup, total):
    """optax refuses a warmup cosine with no decay step left when the schedule
    is built; the port raises the same ValueError there, not mid-run."""
    kw = dict(learning_rate=1e-3, warmup_steps=warmup, total_steps=total, eta_min=5e-5)
    with pytest.raises(ValueError) as jerr:
        jutils.get_scheduler_class("cosine_warmup")(**kw)
    with pytest.raises(ValueError) as terr:
        tutils.get_scheduler_class("cosine_warmup")(**kw)
    assert str(terr.value) == str(jerr.value)
    assert f"decay_steps={total - warmup}" in str(terr.value)


@pytest.mark.parametrize(
    "opt,opt_kwargs",
    [
        ("adamw", dict(betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)),
        ("adamw", dict()),
        ("adam", dict(betas=(0.8, 0.99), eps=1e-6)),
    ],
)
def test_optimizer_with_cosine_schedule_matches_optax(opt, opt_kwargs):
    """N steps of the port's optimizer under LambdaLR against optax's
    transform under the same cosine schedule, on one tensor fed the same
    gradients; the rate reported per step is the schedule's value before
    the update, as the JAX step reports it."""
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(9)]
    lr = 1e-2
    jsched = jutils.get_scheduler_class("cosine_annealing")(learning_rate=lr, T_max=6, eta_min=1e-3)
    tx = jutils.get_optimizer_class(opt)(learning_rate=jsched, **opt_kwargs)
    jp = jnp.asarray(p0)
    state = tx.init(jp)

    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = tutils.get_optimizer_class(opt)([tp], learning_rate=1.0, **opt_kwargs)
    tsched = tutils.make_lr_scheduler(
        topt, tutils.get_scheduler_class("cosine_annealing")(learning_rate=lr, T_max=6, eta_min=1e-3)
    )
    for i, g in enumerate(grads):
        assert topt.param_groups[0]["lr"] == pytest.approx(float(jsched(i)), rel=1e-6)
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        topt.step()
        tsched.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6, err_msg=f"step {i}")


def test_unported_optimizers_raise_naming_their_slice():
    """Every registry name resolves: the 8-bit AdamW since the
    training-memory slice (tests/test_torch_training_memory.py), the others
    since the optimizers slice (tests/test_torch_optimizers.py)."""
    from trlx_tpu_torch.ops.quantized_adam import AdamW8bit

    for name in ("adamw_8bit_bnb", "adam_8bit_bnb"):
        opt = tutils.get_optimizer_class(name)([torch.nn.Parameter(torch.zeros(3))], learning_rate=1.0)
        assert isinstance(opt, AdamW8bit)
    for name in ("sgd", "lion", "adafactor", "rmsprop"):
        assert callable(tutils.get_optimizer_class(name))


def test_rollout_loader_draws_the_jax_permutation():
    """The learn loop's ``store.create_loader(shuffle=True, seed=...)`` draws
    the same order as the JAX package's NumpyLoader, epoch after epoch."""
    from trlx_tpu.pipeline import NumpyLoader as JaxLoader
    from trlx_tpu_torch.pipeline import NumpyLoader

    data = list(range(23))
    jl = JaxLoader(data, 5, list, shuffle=True, drop_last=True, seed=1003)
    tl = NumpyLoader(data, 5, list, shuffle=True, drop_last=True, seed=1003)
    for _ in range(3):
        assert list(tl) == list(jl)
