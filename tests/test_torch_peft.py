"""Port parity for peft at the model level: trlx_tpu_torch's LoRA, prefix
and prompt tuning (``models/transformer.py``) and T5 LoRA (``models/t5.py``)
against trlx_tpu's on the same weights (carried across by
``params_from_jax``), f32 on the CPU. Every adapter is drawn non-zero from a
seed before it is carried (LoRA's ``lora_b`` starts at zero, which would
make the adapter a no-op and hide a wrong ``alpha / r`` or a transposed
factor). Checked, after ``tests/test_peft.py``: LoRA is a no-op at init,
gradients reach only the adapters under the trainers' mask, the adapter
forward and the disabled-adapter forward equal the JAX module's and its
base module's (logits within 1e-5; the flash path within 1e-4, the JAX
kernel running in interpret mode), cached greedy generation equals the
naive forward and the JAX ``generate``, the adapter file round-trips
exactly, the LoRA merge equals the JAX merge and the adapter forward, and
the serving engine refuses prompt and prefix tuning."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
from trlx_tpu.models.transformer import TransformerLM as JaxLM
from trlx_tpu_torch.models.convert import params_from_jax, t5_params_from_jax
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM, disable_adapters, merge_lora_state

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_TOL = dict(rtol=1e-4, atol=1e-4)
ADAPTERS = ("lora_a", "lora_b", "prefix_k", "prefix_v", "prompt_embeddings")
TINY = dict(vocab_size=32, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=32)
PEFT = {
    "lora": dict(lora_r=4, lora_alpha=8.0, lora_targets=("q_proj", "v_proj", "up_proj")),
    "prefix": dict(peft_type="prefix", num_virtual_tokens=3),
    "prompt": dict(peft_type="prompt", num_virtual_tokens=3),
}
T = torch.from_numpy


def map_adapters(tree, fn):
    """``tree`` with every adapter leaf replaced by ``fn(leaf)``."""
    return {k: (map_adapters(v, fn) if isinstance(v, dict) else (fn(v) if k in ADAPTERS else v))
            for k, v in tree.items()}


def seeded_adapters(tree, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return map_adapters(tree, lambda x: (scale * rng.standard_normal(np.shape(x))).astype(np.float32))


def _pair(kind, impl="xla", bump=True):
    """(JAX module, its config, numpy params, port module) on one seed."""
    over = dict(TINY, **PEFT[kind], attention_impl=impl)
    jcfg = JAX_PRESETS["gpt2"].replace(**over, compute_dtype=jnp.float32)
    tcfg = PRESETS["gpt2"].replace(**over, compute_dtype=torch.float32)
    jm = JaxLM(jcfg)
    ones = jnp.ones((1, 4), jnp.int32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), ones, ones)["params"])
    if bump:
        params = seeded_adapters(params, 3)
    tm = TransformerLM(tcfg)
    tm.load_state_dict(params_from_jax(params, tcfg))
    return jm, jcfg, params, tm


def _inputs(B=3, T_=7, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY["vocab_size"], (B, T_)).astype(np.int32)
    mask = np.ones((B, T_), np.int32)
    mask[1, :2] = 0  # left padding
    mask[2, :T_ - 1] = 0  # one real token
    return ids, mask


def _base(jcfg):
    return JaxLM(jcfg.replace(lora_r=0, peft_type="none", num_virtual_tokens=0))


def test_lora_starts_as_noop():
    jm, jcfg, params, tm = _pair("lora", bump=False)
    ids, mask = _inputs()
    with torch.no_grad():
        on = tm(T(ids), T(mask))[0]
        with disable_adapters():
            off = tm(T(ids), T(mask))[0]
    assert torch.equal(on, off)  # lora_b == 0 at init
    jl = _base(jcfg).apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))[0]
    np.testing.assert_allclose(on.numpy(), np.asarray(jl), **TOL)
    # the port's own init: normal(1/r) A, zero B
    fresh = TransformerLM(tm.config).init_params(5)
    a = fresh.layers_0.attn.q_proj.lora_a
    assert float(fresh.layers_0.attn.q_proj.lora_b.detach().abs().max()) == 0.0
    assert abs(float(a.detach().std()) - 1.0 / tm.config.lora_r) < 0.1
    assert not hasattr(fresh.layers_0.attn.k_proj, "lora_a") and hasattr(fresh.layers_0.mlp.up_proj, "lora_a")


def test_lora_grads_only_touch_adapters_as_jax():
    from trlx_tpu_torch.data.configs import ModelConfig
    from trlx_tpu_torch.trainer.mesh_trainer import MeshRLTrainer

    jm, jcfg, params, tm = _pair("lora")
    ids, mask = _inputs()

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask))[0]
        return jnp.sum(logits ** 2)

    jgrads = jax.tree.map(np.asarray, jax.grad(jloss)(jax.tree.map(jnp.asarray, params)))

    class FakeTrainer:
        config = type("C", (), {"model": ModelConfig(peft_config={"r": 4})})()
        trainable_path_predicate = MeshRLTrainer.trainable_path_predicate

    pred = FakeTrainer().trainable_path_predicate
    for name, p in tm.named_parameters():
        p.requires_grad_(pred("transformer." + name))
    assert pred("transformer.layers_0.attn.q_proj.lora_a") and pred("v_head.value_head.fc_in.kernel")
    assert not pred("transformer.layers_0.attn.q_proj.kernel")
    loss = (tm(T(ids), T(mask))[0] ** 2).sum()
    loss.backward()
    flat = {".".join(str(k.key) for k in path): v for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    n_adapter = 0
    for name, p in tm.named_parameters():
        if name.rsplit(".", 1)[-1] in ADAPTERS:
            n_adapter += 1
            np.testing.assert_allclose(p.grad.numpy(), flat[name], rtol=1e-4, atol=1e-4, err_msg=name)
        else:
            assert p.grad is None, name
    assert n_adapter == 2 * 3 * TINY["num_layers"]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("kind", list(PEFT))
def test_peft_forward_and_disabled_forward_match_jax(kind, impl):
    jm, jcfg, params, tm = _pair(kind, impl)
    ids, mask = _inputs()
    tol = TOL if impl == "xla" else FLASH_TOL
    jl = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))[0]
    jbase = _base(jcfg).apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))[0]
    with torch.no_grad():
        tl = tm(T(ids), T(mask))[0]
        with disable_adapters():
            tbase = tm(T(ids), T(mask))[0]
    valid = mask.astype(bool)  # padded rows' logits are arbitrary in both
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **tol)
    np.testing.assert_allclose(tbase.numpy()[valid], np.asarray(jbase)[valid], **tol)
    # the adapters really change the forward
    assert np.abs(tl.numpy()[valid] - tbase.numpy()[valid]).max() > 1e-3


@pytest.mark.parametrize("kind", list(PEFT))
def test_peft_cached_generation_matches_naive_and_jax(kind):
    """Greedy decode through the contiguous cache equals re-running the full
    adapter forward each step, and the JAX ``generate`` (virtual rows and
    prefixes live correctly in the cached path)."""
    from trlx_tpu.ops.generation import generate as jax_generate
    from trlx_tpu.ops.generation import left_pad_batch
    from trlx_tpu_torch.ops.generation import generate

    jm, jcfg, params, tm = _pair(kind, "flash")
    prompt = np.array([5, 9, 11, 2], np.int32)
    n_new = 5
    seq = prompt.copy()
    with torch.no_grad():
        for _ in range(n_new):
            logits = tm(T(seq[None]), torch.ones((1, len(seq)), dtype=torch.int32))[0]
            seq = np.append(seq, int(logits[0, -1].argmax()))
    pids, pmask = left_pad_batch([prompt], pad_token_id=0, target_len=8)

    def tstep(i, m, pos, cache):
        logits, hidden, _, cache = tm(i, m, pos, cache)
        return logits, hidden, cache

    out = generate(tstep, lambda b, s: tm.init_cache(b, s, torch.float32), T(pids), T(pmask), None, n_new,
                   do_sample=False, pad_token_id=0)
    np.testing.assert_array_equal(out["sequences"].numpy()[0, 8:], seq[len(prompt):])

    def jstep(p, i, m, pos, cache):
        logits, hidden, _, cache = jm.apply({"params": p}, i, m, pos, cache)
        return logits, hidden, cache

    jout = jax_generate(jstep, params, lambda b, s: jm.init_cache(b, s, jnp.float32), jnp.asarray(pids),
                        jnp.asarray(pmask), jax.random.PRNGKey(0), max_new_tokens=n_new, do_sample=False,
                        pad_token_id=0)
    np.testing.assert_array_equal(out["sequences"].numpy(), np.asarray(jout["sequences"]))


def test_prompt_tuning_cache_rules():
    _, _, _, tm = _pair("prompt")
    cache = tm.init_cache(2, 6)
    assert cache["k"][0].shape[2] == 6 + 3  # the virtual rows take slots
    ids = torch.ones((2, 2), dtype=torch.int32)
    with torch.no_grad():
        tm(ids, torch.ones((2, 6), dtype=torch.int32), None, cache)
        assert cache["index"] == 2 + 3
        with pytest.raises(ValueError, match="prefill-from-zero or single-token"):
            tm(ids, torch.ones((2, 6), dtype=torch.int32), None, cache)


@pytest.mark.parametrize("kind", list(PEFT))
def test_peft_trainable_mask_and_adapter_io(kind, tmp_path):
    from trlx_tpu.models.hf_loading import extract_adapter_params as jax_extract
    from trlx_tpu_torch.data.configs import ModelConfig
    from trlx_tpu_torch.models.hf_loading import extract_adapter_params, load_adapters, save_adapters
    from trlx_tpu_torch.trainer.mesh_trainer import MeshRLTrainer

    _, _, params, tm = _pair(kind)
    peft = {"lora": {"r": 4}, "prefix": {"peft_type": "PREFIX_TUNING"}, "prompt": {"peft_type": "PROMPT_TUNING"}}

    class FakeTrainer:
        config = type("C", (), {"model": ModelConfig(peft_config=peft[kind])})()
        trainable_path_predicate = MeshRLTrainer.trainable_path_predicate

    pred = FakeTrainer().trainable_path_predicate
    marker = {"lora": "layers_0.attn.q_proj.lora_a", "prefix": "layers_0.attn.prefix_k",
              "prompt": "prompt_embeddings"}[kind]
    assert pred(f"transformer.{marker}") and pred("v_head.value_head.fc_out.bias")
    assert not pred("transformer.layers_0.attn.q_proj.kernel") and not pred("transformer.embed_tokens.embedding")

    state = {f"transformer.{k}": v for k, v in tm.state_dict().items()}
    adapters = extract_adapter_params(state)
    jflat = {".".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jax_extract({"transformer": params}))[0]}
    assert set(adapters) == jflat  # the same leaves as the JAX package's
    assert save_adapters(str(tmp_path), state)
    assert (tmp_path / "adapters.safetensors").exists()
    fresh = TransformerLM(tm.config).init_params(9)
    fresh_state = {f"transformer.{k}": v for k, v in fresh.state_dict().items()}
    assert not all(torch.equal(fresh_state[k], v) for k, v in adapters.items())
    restored = load_adapters(str(tmp_path), fresh_state)
    for k, v in restored.items():
        assert torch.equal(v, state[k] if k in adapters else fresh_state[k]), k
    assert not save_adapters(str(tmp_path / "none"), {"transformer.ln_f.scale": torch.ones(2)})


def test_lora_merge_matches_jax_and_the_adapter_forward():
    from trlx_tpu.models.transformer import merge_lora_params

    jm, jcfg, params, tm = _pair("lora", bump=False)
    params = seeded_adapters(params, 7, scale=0.1)
    tm.load_state_dict(params_from_jax(params, tm.config))
    merged = merge_lora_state(tm.state_dict(), tm.config.lora_alpha, tm.config.lora_r)
    assert not any("lora_" in k for k in merged)
    jmerged = merge_lora_params(params, jcfg)
    base_cfg = tm.config.replace(lora_r=0)
    jstate = params_from_jax(jmerged, base_cfg)
    assert set(jstate) == set(merged)
    for k, v in merged.items():
        np.testing.assert_allclose(v.numpy(), jstate[k].numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
    base = TransformerLM(base_cfg)
    base.load_state_dict(merged)
    ids, mask = _inputs()
    with torch.no_grad():
        np.testing.assert_allclose(base(T(ids), T(mask))[0].numpy(), tm(T(ids), T(mask))[0].numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_t5_lora_matches_jax_and_disables():
    from trlx_tpu.models import t5 as jt5
    from trlx_tpu_torch.models import t5 as tt5

    small = dict(vocab_size=48, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2, num_heads=4,
                 relative_attention_num_buckets=8, lora_r=4, lora_alpha=16.0)
    jcfg = jt5.T5Config(**small, compute_dtype=jnp.float32)
    jm = jt5.T5LM(jcfg)
    ones = jnp.ones((1, 4), jnp.int32)
    params = jm.init(jax.random.PRNGKey(0), ones, ones, jnp.zeros((1, 2), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    params = seeded_adapters(params, 11, scale=0.2)
    tcfg = tt5.T5Config(**small, compute_dtype=torch.float32)
    tm = tt5.T5LM(tcfg)
    tm.load_state_dict(t5_params_from_jax(params, tcfg))
    names = [k for k in tm.state_dict() if "lora_" in k]
    assert names and all(k.split(".")[-2] in ("q", "v") for k in names)  # T5_LORA_TARGETS' default
    rng = np.random.default_rng(0)
    enc = rng.integers(2, 48, (2, 6)).astype(np.int32)
    dec = rng.integers(2, 48, (2, 4)).astype(np.int32)
    em, dm = np.ones_like(enc), np.ones_like(dec)
    jl = jm.apply({"params": params}, *map(jnp.asarray, (enc, em, dec, dm)))[0]
    jbase = jt5.T5LM(jcfg.replace(lora_r=0)).apply({"params": params}, *map(jnp.asarray, (enc, em, dec, dm)))[0]
    with torch.no_grad():
        tl = tm(T(enc), T(em), T(dec), T(dm))[0]
        with disable_adapters():
            tbase = tm(T(enc), T(em), T(dec), T(dm))[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tbase.numpy(), np.asarray(jbase), **TOL)
    assert np.abs(tl.numpy() - tbase.numpy()).max() > 1e-3


def test_peft_overrides_as_jax():
    from trlx_tpu.models import hf_loading as jh
    from trlx_tpu_torch.models import hf_loading as th

    for cfg in ({"r": 4}, {"peft_type": "LORA", "r": 8, "lora_alpha": 32, "target_modules": ["q_proj"]},
                {"peft_type": "PREFIX_TUNING", "num_virtual_tokens": 5}, {"peft_type": "PROMPT_TUNING"}, None):
        assert th.peft_overrides(cfg) == jh.peft_overrides(cfg)
    assert th.t5_peft_overrides({"r": 4}) == jh.t5_peft_overrides({"r": 4})
    assert th.T5_LORA_TARGETS == jh.T5_LORA_TARGETS and th.ADAPTER_PARAM_NAMES == jh.ADAPTER_PARAM_NAMES
    with pytest.raises(ValueError, match="match no T5 module"):
        th.t5_peft_overrides({"r": 4, "target_modules": ["q_proj"]})
    with pytest.raises(NotImplementedError, match="LORA"):
        th.t5_peft_overrides({"peft_type": "PROMPT_TUNING"})
    with pytest.raises(ValueError, match="Unsupported peft_type"):
        th.peft_overrides({"peft_type": "IA3"})


@pytest.mark.parametrize("kind", ["prefix", "prompt"])
def test_serving_engine_refuses_prompt_and_prefix(kind):
    from trlx_tpu_torch.serving import ServingEngine

    _, _, _, tm = _pair(kind)
    with pytest.raises(NotImplementedError, match="prompt/prefix"):
        ServingEngine(tm, None, num_slots=2, max_seq_len=16, device="cpu")


@pytest.mark.parametrize("kind", list(PEFT))
def test_params_from_jax_checks_adapter_leaves(kind):
    _, _, params, tm = _pair(kind)
    base_cfg = tm.config.replace(lora_r=0, peft_type="none", num_virtual_tokens=0)
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(params, base_cfg)  # adapters the config has no parameter for

    def drop_adapters(tree):
        return {k: drop_adapters(v) if isinstance(v, dict) else v for k, v in tree.items() if k not in ADAPTERS}

    with pytest.raises(ValueError, match="missing"):
        params_from_jax(drop_adapters(params), tm.config)  # a config with adapters the tree lacks
    wrong = map_adapters(params, lambda x: np.zeros(np.shape(x)[:-1] + (np.shape(x)[-1] + 1,), np.float32))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(wrong, tm.config)
