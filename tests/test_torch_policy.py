"""Port parity for the PPO policy: trlx_tpu_torch's ``CausalLMWithValueHead``
against trlx_tpu's on the same weights (carried across by
``policy_params_from_jax``) and the same left-padded numpy inputs, in f32 on
the CPU, with attention_impl "xla" and "flash" (the JAX flash kernels in
interpret mode, the port's plain versions), for a gpt2-style and a
llama-style (GQA 4/2) trunk. Checked: logits and values (tolerance 1e-4),
and the gradient of a scalar loss with respect to every parameter against
``jax.grad`` (tolerance atol 2e-4 / rtol 1e-3: sums of many products
in a different order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu.models.policy import CausalLMWithValueHead as JaxPolicy
from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
from trlx_tpu_torch.models.convert import _flatten, policy_params_from_jax
from trlx_tpu_torch.models.policy import CausalLMWithValueHead
from trlx_tpu_torch.models.presets import PRESETS

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=2e-4)

FAMILIES = {
    "gpt2": ("gpt2", dict(vocab_size=37, hidden_size=32, num_layers=2, num_heads=4,
                          max_position_embeddings=64)),
    "llama": ("llama", dict(vocab_size=41, hidden_size=32, num_layers=2, num_heads=4,
                            num_kv_heads=2, intermediate_size=48, max_position_embeddings=64)),
}


def _models(family, impl):
    preset, dims = FAMILIES[family]
    jcfg = JAX_PRESETS[preset].replace(**dims, compute_dtype=jnp.float32, attention_impl=impl)
    tcfg = PRESETS[preset].replace(**dims, compute_dtype=torch.float32, attention_impl=impl)
    jm = JaxPolicy(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))["params"]
    # perturb every leaf (biases and norms off their init) so the mapping is exercised
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32) for x in leaves]
    params = jax.tree.unflatten(treedef, leaves)
    tm = CausalLMWithValueHead(tcfg)
    tm.load_state_dict(policy_params_from_jax(params, tcfg))
    return jm, params, tm


def _inputs(vocab, B=3, T=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, :4] = 0  # left padding
    mask[2, :T - 2] = 0  # two real tokens
    return ids, mask


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_and_values_match_jax(family, impl):
    jm, params, tm = _models(family, impl)
    ids, mask = _inputs(FAMILIES[family][1]["vocab_size"])
    jl, jv, _, _ = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        tl, tv, branch, cache = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    assert branch is None and cache is None and tv.dtype == torch.float32
    assert tv.shape == ids.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    jlm, _ = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), method=jm.lm_only)
    with torch.no_grad():
        tlm, _ = tm.lm_only(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(tlm.numpy(), np.asarray(jlm), **TOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_parameter_gradients_match_jax(family, impl):
    """Gradient of a PPO-like scalar (masked label logprobs + value
    regression) with respect to every parameter, trunk and head."""
    jm, params, tm = _models(family, impl)
    vocab = FAMILIES[family][1]["vocab_size"]
    ids, mask = _inputs(vocab, seed=3)
    rng = np.random.default_rng(4)
    target = rng.normal(size=ids.shape).astype(np.float32)
    m = mask.astype(np.float32)

    def jloss(p):
        logits, values, _, _ = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask))
        lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
        lp = jnp.take_along_axis(lp, jnp.asarray(ids)[:, 1:, None], axis=-1)[..., 0]
        return jnp.sum(lp * m[:, 1:]) + jnp.sum((values - target) ** 2 * m)

    jgrads = _flatten(jax.tree.map(np.asarray, jax.grad(jloss)(params)))

    logits, values, _, _ = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    lp = torch.gather(lp, -1, torch.from_numpy(ids)[:, 1:, None].long())[..., 0]
    mt = torch.from_numpy(m)
    loss = (lp * mt[:, 1:]).sum() + ((values - torch.from_numpy(target)) ** 2 * mt).sum()
    loss.backward()
    tgrads = {name: p.grad for name, p in tm.named_parameters()}
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in tgrads.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), jgrads[name], err_msg=name, **GRAD_TOL)


def test_policy_params_from_jax_rejects_mismatched_trees():
    jm, params, tm = _models("gpt2", "xla")
    tree = jax.tree.map(np.asarray, params)
    tree = {**tree, "v_head": {"value_head": {**tree["v_head"]["value_head"], "extra": np.zeros(3)}}}
    with pytest.raises(ValueError, match="unexpected"):
        policy_params_from_jax(tree, tm.config)
    tree = jax.tree.map(np.asarray, params)
    tree["v_head"]["value_head"]["fc_in"]["kernel"] = np.zeros((5, 5), np.float32)
    with pytest.raises(ValueError, match="shape"):
        policy_params_from_jax(tree, tm.config)


def test_unported_branches_raise_naming_their_slice():
    """Remat and LoRA build since the peft / training-memory slice (a value
    branch gets adapters as the trunk does, as the JAX policy's value blocks
    do); stacked layouts since the stacked-layout slice
    (tests/test_torch_stacked.py)."""
    cfg = PRESETS["gpt2"].replace(vocab_size=11, hidden_size=8, num_layers=2, num_heads=2)
    with pytest.raises(ValueError, match="exceeds num_layers"):
        CausalLMWithValueHead(cfg, num_value_layers=3)
    model = CausalLMWithValueHead(cfg.replace(remat="full", lora_r=4), num_value_layers=1).init_params(0)
    names = [n for n, _ in model.named_parameters()]
    assert "transformer.layers_0.attn.q_proj.lora_a" in names and "value_blocks_0.attn.v_proj.lora_b" in names
    ids = torch.tensor([[1, 2, 3, 4]])
    logits, values, _, _ = model(ids, torch.ones_like(ids))
    (logits.float().square().mean() + values.square().mean()).backward()
    assert model.transformer.layers_0.attn.q_proj.lora_b.grad is not None
