"""Port parity for the optimizers beside AdamW: ``sgd`` (momentum and
decay), ``lion``, ``adafactor`` and ``rmsprop`` of
``trlx_tpu_torch.utils.get_optimizer_class`` against the JAX registry's
optax transforms, 5 steps on a parameter tree with a factored [256, 192]
matrix, a [3, 130, 128] tensor, a [64] vector and a scalar, under a
constant and a warmup schedule (tolerance 1e-5 x max(1, |ref|)); and each
through ``PPOTrainer`` against the JAX ``PPOTrainer``, 2 optimizer steps
from the same weights (experience within 1e-4, stats within rtol 1e-3)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import trlx_tpu.utils as jutils
import trlx_tpu_torch.utils as tutils
from trlx_tpu_torch.utils.optim import factored_dims, state_bytes

pytestmark = pytest.mark.torch_port

SHAPES = {"matrix": (256, 192), "tensor": (3, 130, 128), "vector": (64,), "scalar": ()}
OPTIMIZERS = {
    "sgd": dict(momentum=0.9, weight_decay=0.01),
    "lion": dict(weight_decay=0.01),
    "adafactor": {},
    "rmsprop": {},
}
SCHEDULES = {
    "constant": ("constant", dict(learning_rate=3e-3)),
    "warmup": ("cosine_warmup", dict(learning_rate=3e-3, warmup_steps=3, total_steps=8, eta_min=1e-4)),
}


def _trees(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(rng.normal(size=s) * (0.5 if k != "vector" else 1e-4), np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: np.asarray(rng.normal(size=s), np.float32) for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name, schedule):
    """The vector starts at RMS 1e-4, under adafactor's parameter-scale
    floor of 1e-3; the scalar is neither factored nor clipped away."""
    params, grads = _trees()
    sched_name, sched_kwargs = SCHEDULES[schedule]
    jsched = jutils.get_scheduler_class(sched_name)(**sched_kwargs)
    tx = jutils.get_optimizer_class(name)(learning_rate=jsched, **OPTIMIZERS[name])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = tutils.get_optimizer_class(name)(list(tp.values()), learning_rate=1.0, **OPTIMIZERS[name])
    tsched = tutils.make_lr_scheduler(topt, tutils.get_scheduler_class(sched_name)(**sched_kwargs))
    for i, g in enumerate(grads):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        tsched.step()
        for k, p in tp.items():
            ref = np.asarray(jp[k])
            err = np.abs(p.detach().numpy() - ref)
            assert (err <= 1e-5 * np.maximum(1.0, np.abs(ref))).all(), f"{name} {schedule} step {i} {k}: {err.max()}"


def test_adafactor_factors_as_optax_and_state_bytes():
    """Factored dims and the state's shapes and bytes: row and column
    factors for the two big tensors, a full second moment for the rest."""
    assert factored_dims((256, 192), True, 128) == (1, 0)
    assert factored_dims((3, 130, 128), True, 128) == (2, 1)
    assert factored_dims((64,), True, 128) is None and factored_dims((1536, 1), True, 128) is None
    params, grads = _trees()
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in params.values()]
    opt = tutils.get_optimizer_class("adafactor")(tp, learning_rate=1e-3)
    for p, g in zip(tp, grads[0].values()):
        p.grad = torch.from_numpy(g)
    opt.step()
    shapes = [{k: tuple(v.shape) for k, v in opt.state[p].items() if torch.is_tensor(v)} for p in tp]
    assert shapes == [{"v_row": (192,), "v_col": (256,)}, {"v_row": (3, 128), "v_col": (3, 130)},
                      {"v": (64,)}, {"v": ()}]
    assert state_bytes(opt) == 4 * (256 + 192 + 3 * 128 + 3 * 130 + 64 + 1)


@pytest.mark.parametrize("name", ["sgd", "lion", "rmsprop"])
def test_one_moment_per_parameter(name):
    p = torch.nn.Parameter(torch.ones(5, 7))
    opt = tutils.get_optimizer_class(name)([p], learning_rate=1e-3, **OPTIMIZERS[name])
    opt.step()  # no gradient: steps with zeros, as optax
    assert state_bytes(opt) == 4 * 35
    if name != "rmsprop":  # decay moves it even with a zero gradient
        assert not torch.equal(p.detach(), torch.ones(5, 7))


# ------------------------------------------------------------- through PPO

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


def _config_dict(tmp_path, name):
    return dict(
        method=dict(name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05,
                    target=None, gen_kwargs=dict(max_new_tokens=5, do_sample=False)),
        train=dict(seq_length=16, epochs=2, total_steps=2, batch_size=4, minibatch_size=2,
                   checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
                   pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False),
        model=dict(model_path="gpt2", num_layers_unfrozen=-1, model_overrides=dict(
            vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=64, attention_impl="flash")),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name=name, kwargs=dict(lr=3e-3, max_grad_norm=1.0, **OPTIMIZERS[name])),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    )


@pytest.fixture
def single_device_mesh(monkeypatch):
    """Pin JAX trainer meshes to the first of conftest's 8 virtual CPU devices."""
    from trlx_tpu.parallel import mesh as mesh_lib

    real = mesh_lib.make_mesh
    monkeypatch.setattr(
        mesh_lib, "mesh_from_config",
        lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]),
    )


def _drive(trainer):
    trainer.prepare_learning()
    batches = list(trainer.create_train_dataloader())[:2]
    return list(trainer.store.history), [trainer.train_step(b) for b in batches]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_ppo_trainer_with_optimizer_matches_jax(tmp_path, single_device_mesh, name):
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.models.convert import policy_params_from_jax
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    jt = jax_get_trainer("PPOTrainer")(config=JaxConfig.from_dict(_config_dict(tmp_path / "jax", name)),
                                       reward_fn=reward_fn)
    pt = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path / "port", name)),
                                   reward_fn=reward_fn, device="cpu")
    for tr, cls in ((jt, JaxPipeline), (pt, PromptPipeline)):
        tr.add_prompt_pipeline(cls(PROMPTS, 11, tr.tokenizer))
    pt.model.load_state_dict(policy_params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params)),
                                                    pt.model_config))
    pt.ref_model.load_state_dict(pt.model.transformer.state_dict())

    (je, js), (pe, ps) = _drive(jt), _drive(pt)
    assert len(pe) == len(je) == 8 and len(ps) == len(js) == 2
    for a, b in zip(je, pe):
        np.testing.assert_array_equal(b.response_tensor, np.asarray(a.response_tensor))
        for field in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(getattr(b, field), np.asarray(getattr(a, field)), rtol=1e-4, atol=1e-4)
    for i, (a, b) in enumerate(zip(js, ps)):
        for k in a:
            if k.split("/")[0] in ("losses", "values", "returns", "policy", "ratio", "learning_rate_group_0"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-3, atol=1e-5, err_msg=f"{name} step {i} {k}")
    final = jax.tree.map(np.asarray, jax.device_get(jt.params))
    for k, v in policy_params_from_jax(final, pt.model_config).items():
        if k.endswith("k_proj.bias"):
            # its exact gradient is 0 (the softmax ignores a per-query shift), so
            # float noise sets lion's sign and adafactor's scale there
            continue
        np.testing.assert_allclose(pt.model.state_dict()[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-5, err_msg=k)
