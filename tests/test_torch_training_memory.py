"""Port parity for the training-memory options: ``mesh.remat``
(``models/transformer.py::run_block``), ``model.offload_ref`` with the
full-copy reference (``PPOTrainer._setup_ref_offload`` and the pinned
window of a streamed phase), ``train.rollout_param_dtype``
(``MeshRLTrainer.generation_model``, and the engine's low-precision trunk)
and the 8-bit AdamW (``ops/quantized_adam.py``), against trlx_tpu on the
CPU.

Tolerances: remat's losses and gradients are ``torch.equal`` to the
policy ``none`` (recomputation repeats the same operations) and within
1e-5 of the JAX remat run; offload's experience equals the resident
reference's exactly and the JAX offload run's within 1e-4; the bf16 rollout
copy's tokens are identical to the JAX trainer's under the same setting;
the 8-bit state's codes are within one of the JAX module's (f32 ``log`` /
``exp`` may differ by an ulp at a code boundary), its f32 scales within
rtol 1e-5 and the parameters within 1e-5 over 5 steps."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu_torch.models.convert import params_from_jax, policy_params_from_jax

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]
ELEMENT_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_TOL = dict(rtol=1e-3, atol=1e-5)
POLICIES = ["full", "per_layer", "nothing_saveable", "dots_saveable"]
T = torch.from_numpy


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


def _config_dict(tmp_path, **model):
    return dict(
        method=dict(name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05, target=None,
                    gen_kwargs=dict(max_new_tokens=5, do_sample=False)),
        train=dict(seq_length=16, epochs=2, total_steps=3, batch_size=4, minibatch_size=2,
                   checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
                   pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False),
        model={**dict(model_path="gpt2", num_layers_unfrozen=-1, model_overrides=dict(
            vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=64, attention_impl="flash")), **model},
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4, max_grad_norm=1.0)),
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


def _port(tmp_path, overrides=None, **model):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.update(TRLConfig.from_dict(_config_dict(tmp_path, **model)), overrides or {})
    tr = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu")
    tr.add_prompt_pipeline(PromptPipeline(PROMPTS, 11, tr.tokenizer))
    return tr


def _jax(tmp_path, overrides=None, **model):
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu.utils.loading import get_trainer

    cfg = JaxConfig.update(JaxConfig.from_dict(_config_dict(tmp_path, **model)), overrides or {})
    tr = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn)
    tr.add_prompt_pipeline(PromptPipeline(PROMPTS, 11, tr.tokenizer))
    return tr


def _untimed(stats):
    return [{k: v for k, v in s.items() if not k.startswith("time/")} for s in stats]


def _same_elements(got, want, tol=None):
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.query_tensor), np.asarray(w.query_tensor))
        np.testing.assert_array_equal(np.asarray(g.response_tensor), np.asarray(w.response_tensor))
        for field in ("logprobs", "values", "rewards"):
            a, b = getattr(g, field), np.asarray(getattr(w, field))
            if tol is None:
                np.testing.assert_array_equal(a, b, err_msg=field)
            else:
                np.testing.assert_allclose(a, b, err_msg=field, **tol)


# ------------------------------------------------------------------- remat


def _remat_pair(policy):
    from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
    from trlx_tpu.models.transformer import TransformerLM as JaxLM
    from trlx_tpu_torch.models.presets import PRESETS
    from trlx_tpu_torch.models.transformer import TransformerLM

    dims = dict(vocab_size=32, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=32,
                attention_impl="flash")
    jm = JaxLM(JAX_PRESETS["gpt2"].replace(**dims, compute_dtype=jnp.float32, remat=policy))
    ones = jnp.ones((1, 4), jnp.int32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), ones, ones)["params"])
    models = {}
    for p in ("none", policy):
        cfg = PRESETS["gpt2"].replace(**dims, compute_dtype=torch.float32, remat=p)
        models[p] = TransformerLM(cfg)
        models[p].load_state_dict(params_from_jax(params, cfg))
    return jm, params, models


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_losses_and_gradients_equal_none_and_jax(policy, monkeypatch):
    from trlx_tpu_torch.ops import attention

    jm, params, models = _remat_pair(policy)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 32, (3, 9)).astype(np.int32)
    mask = np.ones((3, 9), np.int32)
    mask[1, :3] = 0

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask))[0]
        return jnp.sum(jnp.where(jnp.asarray(mask)[..., None] > 0, logits, 0.0) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))
    jflat = {".".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}

    calls = {"n": 0}
    real = attention._flash_forward

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(attention, "_flash_forward", counting)
    out = {}
    for p, model in models.items():
        calls["n"] = 0
        logits = model(T(ids), T(mask))[0]
        loss = (torch.where(T(mask)[..., None] > 0, logits, torch.zeros_like(logits)) ** 2).sum()
        loss.backward()
        out[p] = (loss.detach(), {n: q.grad for n, q in model.named_parameters()}, calls["n"])
    (l0, g0, c0), (l1, g1, c1) = out["none"], out[policy]
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
        np.testing.assert_allclose(g1[name].numpy(), jflat[name], rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(l1), float(jl), rtol=1e-5)
    # the flash forward runs again in the backward under every policy (it is
    # no matrix product), once per layer
    assert c0 == 2 and c1 == 4


def test_remat_in_the_trainer_steps_as_none(tmp_path):
    runs = []
    for policy in ("none", "dots_saveable"):
        tr = _port(tmp_path / policy, {"mesh.remat": policy})
        assert tr.model_config.remat == policy
        tr.prepare_learning()
        batch = list(tr.create_train_dataloader())[0]
        stats = tr.train_step(batch)
        runs.append((stats, [p.detach().clone() for p in tr.model.parameters()]))
    (s0, p0), (s1, p1) = runs
    assert _untimed([s0]) == _untimed([s1])
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


# ------------------------------------------------------------- offload_ref


def test_offload_ref_equals_resident_and_jax(tmp_path, single_device_mesh):
    jt = _jax(tmp_path / "jax", offload_ref=True)
    resident = _port(tmp_path / "resident")
    off = _port(tmp_path / "offload", offload_ref=True)
    state = policy_params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params)), resident.model_config)
    assert off.ref_model is None and off._ref_host is not None and off._ref_dev is None
    for tr in (resident, off):
        tr.model.load_state_dict(state)
    resident.ref_model.load_state_dict(resident.model.transformer.state_dict())
    off._setup_ref_offload(off.model.transformer.state_dict())
    runs = []
    for tr in (jt, resident, off):
        tr.prepare_learning()
        batches = list(tr.create_train_dataloader())[:2]
        runs.append((list(tr.store.history), [tr.train_step(b) for b in batches]))
    # one upload for the phase, released before the learner steps
    assert off.ref_uploads == 1 and len(off.ref_upload_s) == 1 and off._ref_dev is None
    _same_elements(runs[2][0], runs[1][0])
    assert _untimed(runs[2][1]) == _untimed(runs[1][1])
    _same_elements(runs[2][0], runs[0][0], ELEMENT_TOL)
    for js, ps in zip(runs[0][1], runs[2][1]):
        for k in [k for k in js if k.split("/")[0] in ("losses", "policy", "ratio")]:
            np.testing.assert_allclose(ps[k], js[k], err_msg=k, **STAT_TOL)
    off.make_experience(8, 1)
    assert off.ref_uploads == 2 and off._ref_dev is None


def test_offload_ref_pinned_for_a_streamed_window(tmp_path):
    serving = {"train.serving.enabled": True, "train.serving.num_slots": 3, "train.serving.block_size": 4,
               "train.serving.stream_overlap": True}
    stores = []
    for name, model in (("resident", {}), ("offload", dict(offload_ref=True))):
        tr = _port(tmp_path / name, serving, **model)
        tr._resolve_serving()
        calls = []
        if tr._ref_host is not None:
            real = tr._ref_scoring_model

            def counted(_real=real):
                calls.append(tr._ref_pinned)
                return _real()

            tr._ref_scoring_model = counted
        tr.make_experience(8, 0)
        stores.append(list(tr.store.history))
        if tr._ref_host is not None:
            # pinned: one upload for the whole window (the first call pins),
            # released at the drain
            assert tr.ref_uploads == 1 and len(calls) >= 2 and all(calls)
            assert tr._ref_dev is None and not tr._ref_pinned
        tr.on_learn_end()
    _same_elements(stores[1], stores[0])


def test_offload_ref_is_ignored_with_peft_or_hydra(tmp_path):
    for model in (dict(offload_ref=True, peft_config={"r": 2}), dict(offload_ref=True, num_layers_unfrozen=1)):
        tr = _port(tmp_path / str(len(model)), **model)
        assert tr._ref_host is None and tr.ref_model is None


# --------------------------------------------------------- rollout dtype


def test_rollout_param_dtype_tokens_equal_jax(tmp_path, single_device_mesh):
    over = {"train.rollout_param_dtype": "bfloat16"}
    jt = _jax(tmp_path / "jax", over)
    pt = _port(tmp_path / "port", over)
    pt.model.load_state_dict(policy_params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params)),
                                                    pt.model_config))
    pt.ref_model.load_state_dict(pt.model.transformer.state_dict())
    for tr in (jt, pt):
        tr.prepare_learning()
    assert pt.rollout_casts == 1
    copy = pt._rollout_model
    assert all(p.dtype == torch.bfloat16 for p in copy.parameters())
    assert copy.transformer.ln_f.scale.dtype == torch.bfloat16  # the norms too
    assert all(p.dtype == torch.float32 for p in pt.model.parameters())  # masters stay f32
    for je, pe in zip(jt.store.history, pt.store.history):
        np.testing.assert_array_equal(np.asarray(pe.response_tensor), np.asarray(je.response_tensor))
    for tr in (jt, pt):
        tr.train_step(list(tr.create_train_dataloader())[0])
    jt._rollout_params = None  # the JAX learn loop drops its copy there, before the step
    assert pt._rollout_model is None and pt.rollout_casts == 1  # dropped before the step, none cast in it
    for prompts in ([PROMPTS[:4]], [PROMPTS[4:]]):
        ids = [np.asarray(pt.tokenizer(p).input_ids, np.int32) for p in prompts[0]]
        np.testing.assert_array_equal(pt.generate(ids, eval_mode=True)[0],
                                      np.asarray(jt.generate(ids, eval_mode=True)[0]))
    assert pt.rollout_casts == 2  # one cast, then cached for the second generate


def test_rollout_param_dtype_engine_trunk(tmp_path):
    over = {"train.rollout_param_dtype": "bfloat16", "train.serving.enabled": True,
            "train.serving.num_slots": 4, "train.serving.block_size": 4}
    tr = _port(tmp_path, over)
    tr.prepare_learning()  # the engine, then the first experience phase
    assert all(p.dtype == torch.bfloat16 for p in tr._serving_engine.trunk.parameters())
    assert tr.rollout_casts == 1  # one install (the cast) for the phase
    tr.train_step(list(tr.create_train_dataloader())[0])
    tr.make_experience(8, 1)
    assert tr.rollout_casts == 2
    tr.on_learn_end()


# ------------------------------------------------------------------ 8-bit


def test_adamw_8bit_matches_jax_quantized_adam():
    from trlx_tpu.ops.quantized_adam import adamw_8bit
    from trlx_tpu_torch.ops.quantized_adam import AdamW8bit

    rng = np.random.default_rng(0)
    shapes = {"a": (300,), "b": (17, 33), "c": (256,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.uniform(-3, 1, size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    tx = adamw_8bit(1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = AdamW8bit(list(tp.values()), lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01)
    for i, g in enumerate(grads):
        updates, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        assert int(opt.param_groups[0]["count"]) == int(js["count"]) == i + 1
        for k, p in tp.items():
            st, jst = opt.state[p], js["moments"][k]
            for code in ("m_q", "v_q"):
                assert st[code].dtype == (torch.int8 if code == "m_q" else torch.uint8)
                diff = np.abs(st[code].numpy().astype(np.int32) - np.asarray(jst[code]).astype(np.int32))
                assert diff.max() <= 1, (i, k, code)
            for scale in ("m_scale", "v_scale"):
                np.testing.assert_allclose(st[scale].numpy(), np.asarray(jst[scale]), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i} {k}")


def test_adam_8bit_converges_and_shrinks_state():
    from trlx_tpu_torch import utils as tutils
    from trlx_tpu_torch.utils.optim import state_bytes

    target = torch.from_numpy(np.random.default_rng(0).normal(size=(300,)).astype(np.float32))

    def run(name):
        w = torch.nn.Parameter(torch.zeros(300))
        opt = tutils.get_optimizer_class(name)([w], learning_rate=0.05)
        for _ in range(300):
            opt.zero_grad()
            ((w - target) ** 2).sum().backward()
            opt.step()
        return float(((w - target) ** 2).sum()), state_bytes(opt)

    loss32, bytes32 = run("adam")
    loss8, bytes8 = run("adam_8bit_bnb")
    assert loss8 < 1e-3, loss8
    nb = math.ceil(300 / 256)
    assert bytes8 == nb * (256 + 4 + 256 + 8) + 4  # codes, scales and the count
    assert bytes8 < 0.45 * bytes32
    opt = tutils.get_optimizer_class("adam_8bit_bnb")([torch.nn.Parameter(torch.zeros(2))], learning_rate=1.0,
                                                      weight_decay=0.5)
    assert opt.param_groups[0]["weight_decay"] == 0.0  # dropped, as the JAX registry drops it


def test_adamw_8bit_composes_with_the_frozen_trunk_and_resumes_exactly(tmp_path):
    """Under peft the 8-bit state covers the adapters and the heads only
    (the JAX test's multi_transform freeze), and a checkpoint restores its
    int8 / uint8 state exactly: the next step is identical."""
    from trlx_tpu_torch.utils.optim import state_bytes

    over = {"optimizer.name": "adamw_8bit_bnb"}
    a = _port(tmp_path / "a", over, peft_config={"r": 2})
    a.prepare_learning()
    batches = list(a.create_train_dataloader())
    a.train_step(batches[0])
    trained = {id(p) for p in a.trainable_params}
    assert {id(p) for p in a.optimizer.state} == trained
    assert state_bytes(a.optimizer) == sum(math.ceil(p.numel() / 256) * 524 for p in a.trainable_params) + 4
    assert all(not p.requires_grad for n, p in a.model.named_parameters()
               if n.startswith("transformer.") and "lora_" not in n)
    a.iter_count = 1
    a.save(str(tmp_path / "ck"))
    b = _port(tmp_path / "b", over, peft_config={"r": 2})
    b.load(str(tmp_path / "ck"))
    for pa, pb in zip(a.trainable_params, b.trainable_params):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        for key in ("m_q", "m_scale", "v_q", "v_scale"):
            assert sa[key].dtype == sb[key].dtype and torch.equal(sa[key], sb[key]), key
    assert torch.equal(a.optimizer.param_groups[0]["count"], b.optimizer.param_groups[0]["count"])
    b.num_mb, b.rollout_stats = a.num_mb, a.rollout_stats
    assert a.train_step(batches[1]) == b.train_step(batches[1])
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)


def test_check_port_config_accepts_the_memory_rows(tmp_path):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.mesh_trainer import check_port_config

    base = TRLConfig.from_dict(_config_dict(tmp_path))
    for over in ({"mesh.remat": p} for p in POLICIES):
        check_port_config(TRLConfig.update(base, over))
    for over in ({"model.offload_ref": True}, {"train.rollout_param_dtype": "bfloat16"},
                 {"optimizer.name": "adamw_8bit_bnb"}, {"optimizer.name": "adam_8bit_bnb"}):
        check_port_config(TRLConfig.update(base, over))
    # the data / fsdp / model axes and the overlapped step are ported (the
    # mesh checks the world size when it is built)
    for over in ({"train.learner_overlap.enabled": True}, {"mesh.fsdp": 2}):
        check_port_config(TRLConfig.update(base, over))
    # so are the pipe axis and the sequence dimension (scale-out part two)
    for over in ({"mesh.pipe": 2}, {"mesh.sequence_shard": True}):
        check_port_config(TRLConfig.update(base, over))
