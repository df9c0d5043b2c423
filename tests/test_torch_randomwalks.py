"""The randomwalks recipe's hand-off across packages, tiny and on the CPU:
the JAX package SFTs the randomwalks model (the example's widths, 2 layers)
for a few steps and exports it in HF format; both packages then run PPO
from that one directory with greedy rollouts. The port's trunk and
reference load bit-identical to the JAX trainer's; the value head (seed
init in each package) is carried across with ``policy_params_from_jax``.
Two experience phases and three optimizer steps: every rollout element
(tokens identical; logprobs, values and rewards within 1e-4) and every
step's stats (rtol 1e-3, atol 1e-5)."""

import numpy as np
import pytest
import torch

import jax

from trlx_tpu_torch.models.convert import params_from_jax, policy_params_from_jax

pytestmark = pytest.mark.torch_port

ELEMENT_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture
def single_device_mesh(monkeypatch):
    """Pin JAX trainer meshes to the first of conftest's 8 virtual CPU devices."""
    from trlx_tpu.parallel import mesh as mesh_lib

    real = mesh_lib.make_mesh
    monkeypatch.setattr(
        mesh_lib, "mesh_from_config",
        lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]),
    )


def _ppo_overrides(tmp_path, hf_dir):
    return {
        "model.model_path": hf_dir, "model.model_overrides": None,
        "train.total_steps": 3, "train.batch_size": 4, "train.minibatch_size": 2, "train.eval_interval": 100,
        "train.tracker": None, "train.checkpoint_dir": str(tmp_path), "train.save_best": False,
        "method.num_rollouts": 8, "method.chunk_size": 8, "method.ppo_epochs": 1,
        "method.gen_kwargs": dict(max_new_tokens=9, do_sample=False),
    }


def _record(trainer):
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


def test_ppo_from_one_sft_export_matches_jax(tmp_path, single_device_mesh):
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer

    from examples.randomwalks import generate_random_walks
    from examples.randomwalks.ppo_randomwalks import default_config
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    metric_fn, prompts, walks, _, alphabet = generate_random_walks(seed=1002)
    base = default_config(alphabet).to_dict()
    base["model"]["model_overrides"]["num_layers"] = 2

    # the JAX package's SFT warm start and export (ppo_randomwalks.pretrain_on_walks, cut to 3 steps)
    sft_method = dict(name="SFTConfig", gen_kwargs=dict(max_new_tokens=9, top_k=1))
    sft = JaxConfig.update({**base, "method": sft_method}, {
        "train.trainer": "SFTTrainer", "train.total_steps": 3, "train.batch_size": 16,
        "train.eval_interval": 100, "train.tracker": None, "train.checkpoint_dir": str(tmp_path / "sft"),
        "optimizer.kwargs": dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6),
    })
    sft_trainer = jax_get_trainer("SFTTrainer")(config=sft)
    sft_trainer.make_experience(walks[:48], sft.train.seq_length)
    sft_trainer.prepare_learning()
    for batch, _ in zip(sft_trainer.create_train_dataloader(), range(3)):
        sft_trainer.train_step(batch)
    hf_dir = str(tmp_path / "sft_model")
    sft_trainer.save_pretrained(hf_dir)

    def reward_fn(samples, **kw):
        return metric_fn(samples)["optimality"]

    jcfg = JaxConfig.update(base, _ppo_overrides(tmp_path / "jax", hf_dir))
    pcfg = TRLConfig.update(TRLConfig.from_dict(base), _ppo_overrides(tmp_path / "port", hf_dir))
    assert jcfg.mesh.compute_dtype == pcfg.mesh.compute_dtype == "float32"
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)

    jt = jax_get_trainer("PPOTrainer")(config=jcfg, reward_fn=reward_fn)
    pt = get_trainer("PPOTrainer")(config=pcfg, reward_fn=reward_fn, device="cpu")
    jparams = jax.tree.map(np.asarray, jax.device_get(jt.params))
    trunk = params_from_jax(jparams["transformer"], pt.model_config)
    for name, value in pt.model.transformer.state_dict().items():
        assert torch.equal(value, trunk[name]), name
        assert torch.equal(pt.ref_model.state_dict()[name], trunk[name]), name
    pt.model.load_state_dict(policy_params_from_jax(jparams, pt.model_config))

    max_prompt = pcfg.train.seq_length - 9
    for tr, pipe in ((jt, JaxPipeline), (pt, PromptPipeline)):
        tr.add_prompt_pipeline(pipe(prompts, max_prompt, tr.tokenizer))
        tr.add_eval_pipeline(pipe(prompts, max_prompt, tr.tokenizer))
    jrec, prec = _record(jt), _record(pt)
    jres, pres = jt.learn(), pt.learn()

    assert len(prec["phases"]) == len(jrec["phases"]) == 2
    for jphase, pphase in zip(jrec["phases"], prec["phases"]):
        assert len(pphase) == len(jphase) == 8
        for je, pe in zip(jphase, pphase):
            np.testing.assert_array_equal(np.asarray(pe.query_tensor), np.asarray(je.query_tensor))
            np.testing.assert_array_equal(np.asarray(pe.response_tensor), np.asarray(je.response_tensor))
            for field in ("logprobs", "values", "rewards"):
                np.testing.assert_allclose(getattr(pe, field), np.asarray(getattr(je, field)), err_msg=field,
                                           **ELEMENT_TOL)
    assert len(prec["steps"]) == len(jrec["steps"]) == 3
    for i, (js, ps) in enumerate(zip(jrec["steps"], prec["steps"])):
        compared = [k for k in js if k.split("/")[0] in (
            "losses", "values", "old_values", "returns", "policy", "ratio", "learning_rate_group_0",
            "rollout_scores")]
        assert len(compared) >= 15
        for key in compared:
            np.testing.assert_allclose(ps[key], js[key], err_msg=f"step {i + 1} {key}", **STAT_TOL)
    assert pres["reward/mean"] == pytest.approx(jres["reward/mean"], abs=1e-6)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and k != "model_overrides" and not k.endswith("kwargs"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_gate_config_is_the_examples(tmp_path):
    """``scripts/torch_ppo_randomwalks.py`` rebuilds the example's
    ``default_config`` on the port's TRLConfig: every key both packages'
    configs have holds the example's value, and the gate's PPO stage departs
    from it in ``GATE_OVERRIDES`` alone."""
    from examples.randomwalks import generate_random_walks
    from examples.randomwalks.ppo_randomwalks import default_config as example_config
    from scripts.torch_ppo_randomwalks import GATE_OVERRIDES, default_config, gate_config

    alphabet = generate_random_walks(seed=1002)[-1]
    example = _flat(example_config(alphabet).to_dict())
    port = _flat(default_config(alphabet).to_dict())
    shared = set(example) & set(port)
    assert {"method.gen_kwargs", "model.model_overrides", "optimizer.kwargs", "train.epochs"} <= shared
    assert {k: port[k] for k in shared} == {k: example[k] for k in shared}
    gate = _flat(gate_config(alphabet, str(tmp_path), 120).to_dict())
    assert {k for k in port if gate[k] != port[k]} == set(GATE_OVERRIDES)
    assert (gate["train.epochs"], gate["train.total_steps"], gate["train.tracker"]) == (100, 120, None)


def _example_and_gate(method):
    """(example config, the port script's copy of it, the gate's config,
    the gate's GATE_OVERRIDES) for the ILQL and RFT recipes."""
    from examples.randomwalks import generate_random_walks

    if method == "ilql":
        from examples.randomwalks.ilql_randomwalks import default_config as example_config
        from scripts.torch_ilql_randomwalks import GATE_OVERRIDES, default_config, gate_config

        alphabet = generate_random_walks(seed=1002)[-1]
        return (example_config(alphabet), default_config(alphabet), gate_config(alphabet, "out"),
                GATE_OVERRIDES)
    from examples.randomwalks.rft_randomwalks import build_config as example_config
    from scripts.torch_rft_randomwalks import GATE_OVERRIDES, build_config, gate_config

    alphabet = generate_random_walks(seed=1000)[-1]
    return example_config(alphabet), build_config(alphabet), gate_config(alphabet, "out", 100), GATE_OVERRIDES


@pytest.mark.parametrize("method", ["ilql", "rft"])
def test_ilql_and_rft_gate_configs_are_the_examples(method):
    """``scripts/torch_{ilql,rft}_randomwalks.py`` rebuild their example's
    config on the port's TRLConfig: every key both packages have holds the
    example's value, and the gate departs from it in ``GATE_OVERRIDES``
    alone."""
    example, port, gate, overrides = (c if isinstance(c, tuple) else _flat(c.to_dict())
                                      for c in _example_and_gate(method))
    shared = set(example) & set(port)
    assert {"method.gen_kwargs", "model.model_overrides", "optimizer.kwargs", "train.trainer"} <= shared
    assert {k: port[k] for k in shared} == {k: example[k] for k in shared}
    assert port["method.name"] == {"ilql": "ILQLConfig", "rft": "RFTConfig"}[method]
    assert {k for k in port if gate[k] != port[k]} == set(overrides)
    if method == "ilql":
        assert gate["method.gen_kwargs"] == {**port["method.gen_kwargs"], "top_k": 1}


def test_hydra_gate_departs_in_num_layers_unfrozen(tmp_path):
    """The hydra gate is the PPO gate with the example's hparam
    ``model.num_layers_unfrozen=2``."""
    from examples.randomwalks import generate_random_walks
    from scripts.torch_ppo_randomwalks import GATE_OVERRIDES, gate_config

    alphabet = generate_random_walks(seed=1002)[-1]
    full = _flat(gate_config(alphabet, str(tmp_path), 120).to_dict())
    hydra = _flat(gate_config(alphabet, str(tmp_path), 120, num_layers_unfrozen=2).to_dict())
    assert {k for k in full if full[k] != hydra[k]} == {"model.num_layers_unfrozen"}
    assert (full["model.num_layers_unfrozen"], hydra["model.num_layers_unfrozen"]) == (-1, 2)
    assert "model.num_layers_unfrozen" not in GATE_OVERRIDES
