"""Port parity for RFT: trlx_tpu_torch's ``RFTTrainer`` against trlx_tpu's
on the tiny config of ``test_torch_sft.py`` (2 layers, hidden 32, char
tokenizer, f32, flash attention: the JAX kernels in interpret mode, the
port's plain versions), from the same weights carried by ``params_from_jax``,
with greedy generations so that neither package's sampling stream enters.
Through ``learn()``: two improve steps (generate, score, filter) with the
percentile band rising from 0.25 to 0.75, and the SFT steps on the
survivors. Checked: the kept (prompt, output) set of every filter, equal;
the logged ``rft/*`` stats and every step's stats within rtol 1e-3, atol
1e-5. Also the trainer and config are reachable through ``train()``.
"""

import numpy as np
import pytest

import jax

from trlx_tpu_torch.models.convert import params_from_jax

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd e", "gh", "a b", "hhh", "bad", "e", "fg a"]
STAT_TOL = dict(rtol=1e-3, atol=1e-5)


def reward_fn(samples, prompts, outputs, **kw):
    return [float(o.count("a")) - 0.5 * o.count("h") + 0.1 * len(o) for o in outputs]


def _config_dict(tmp_path):
    return dict(
        method=dict(name="RFTConfig", n_generations_per_prompt=2, n_improve_steps=2, start_percentile=0.25,
                    end_percentile=0.75, gen_kwargs=dict(max_new_tokens=5, do_sample=False)),
        train=dict(
            seq_length=12, epochs=4, total_steps=8, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="RFTTrainer", tracker=None, seed=3, save_best=False,
        ),
        model=dict(
            model_path="gpt2", num_layers_unfrozen=-1,
            model_overrides=dict(
                vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=64, attention_impl="flash",
            ),
        ),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4,
                                                  max_grad_norm=1.0)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=8, eta_min=1e-4)),
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


def _record(trainer):
    """Capture every step's stats, every logged ``rft/*`` dict and every
    filter's kept set (the store's rows after each make_experience)."""
    rec = {"steps": [], "rft": [], "kept": []}
    step, log, make = trainer.train_step, trainer.tracker.log, trainer.make_experience

    def train_step(batch):
        out = step(batch)
        rec["steps"].append(dict(out))
        return out

    def tracker_log(stats, it):
        if any(k.startswith("rft/") for k in stats):
            rec["rft"].append(dict(stats))
        return log(stats, it)

    def make_experience():
        make()
        rec["kept"].append(sorted(tuple(np.asarray(x["input_ids"]).tolist()) for x in trainer.store.history))

    trainer.train_step, trainer.tracker.log, trainer.make_experience = train_step, tracker_log, make_experience
    return rec


def test_rft_trainer_matches_jax(tmp_path, single_device_mesh):
    import trlx_tpu.methods  # noqa: F401  (registers RFTConfig)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    jt = jax_get_trainer("RFTTrainer")(config=JaxConfig.from_dict(_config_dict(tmp_path / "jax")),
                                       reward_fn=reward_fn)
    pt = get_trainer("RFTTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path / "port")),
                                   reward_fn=reward_fn, device="cpu")
    leaves, treedef = jax.tree.flatten(jt.params)
    rng = np.random.default_rng(1)
    # sharper than the 0.02 init, so greedy outputs differ between prompts
    leaves = [jax.device_put(np.asarray(x) * 4 + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
                             x.sharding) for x in leaves]
    jt.params = jax.tree.unflatten(treedef, leaves)
    pt.model.transformer.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jt.params)["transformer"], pt.model_config))
    for tr, pipe in ((jt, JaxPipeline), (pt, PromptPipeline)):
        tr.add_prompt_pipeline(pipe(PROMPTS, 7, tr.tokenizer))
        tr.add_eval_pipeline(pipe(PROMPTS[:4], 7, tr.tokenizer))
    jrec, prec = _record(jt), _record(pt)
    jres, pres = jt.learn(), pt.learn()

    # prepare_learning + one filter per epoch; generation on epochs 0 and 2
    assert len(prec["kept"]) == len(jrec["kept"]) >= 3
    assert prec["kept"] == jrec["kept"]
    assert len(set(map(tuple, prec["kept"]))) > 1  # the rising band changed the kept set
    # the filter runs before the epoch count advances (as the reference): epoch 0 filters twice
    assert [r["rft/percentile"] for r in prec["rft"]][:4] == [0.25, 0.25, 0.5, 0.25]
    for jr, pr in zip(jrec["rft"], prec["rft"]):
        assert sorted(pr) == sorted(jr)
        for k in jr:
            np.testing.assert_allclose(pr[k], jr[k], err_msg=k, **STAT_TOL)
    assert len(prec["steps"]) == len(jrec["steps"]) == 8
    for i, (js, ps) in enumerate(zip(jrec["steps"], prec["steps"])):
        assert sorted(ps) == sorted(js) == ["learning_rate_group_0", "losses/loss"]
        for key in js:
            np.testing.assert_allclose(ps[key], js[key], err_msg=f"step {i + 1} {key}", **STAT_TOL)
    assert pres["reward/mean"] == pytest.approx(jres["reward/mean"], rel=1e-6)


def test_train_with_reward_fn_and_rft_config_runs_rft(tmp_path):
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_rft_config
    from trlx_tpu_torch.methods.rft import RFTConfig
    from trlx_tpu_torch.trainer.rft_trainer import RFTTrainer

    cfg = TRLConfig.update(TRLConfig.from_dict(_config_dict(tmp_path)), {"train.total_steps": 2})
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=PROMPTS[:2], config=cfg,
                                   device="cpu")
    assert isinstance(trainer, RFTTrainer) and trainer.iter_count == 2
    default = default_rft_config()
    assert isinstance(default.method, RFTConfig) and default.train.trainer == "RFTTrainer"
    sft = _config_dict(tmp_path)
    sft["method"] = dict(name="SFTConfig")
    with pytest.raises(ValueError, match="RFTConfig"):
        RFTTrainer(config=TRLConfig.from_dict(sft), device="cpu")
