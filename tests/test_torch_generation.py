"""Port parity for the padded one-shot ``generate``: the port's loop over its
TransformerLM against ``trlx_tpu.ops.generation.generate`` over the JAX
TransformerLM on the same weights and left-padded prompts, greedy, f32 on
the CPU, with attention_impl "xla" and "flash" (JAX flash prefill in
interpret mode). Sequences and response masks must be identical, with an
eos that finishes one row mid-batch, with ``min_new_tokens``, and with no
eos at all."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
from trlx_tpu.models.transformer import TransformerLM as JaxLM
from trlx_tpu.ops.generation import generate as jax_generate
from trlx_tpu_torch.models.convert import load_jax_params
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.ops import _kernels
from trlx_tpu_torch.ops.generation import generate, left_pad_batch

pytestmark = pytest.mark.torch_port

DIMS = dict(vocab_size=29, hidden_size=32, num_layers=2, num_heads=4, max_position_embeddings=64)
N_NEW = 10
PAD = 0


def _models(impl):
    jcfg = JAX_PRESETS["gpt2"].replace(**DIMS, compute_dtype=jnp.float32, attention_impl=impl)
    tcfg = PRESETS["gpt2"].replace(**DIMS, compute_dtype=torch.float32, attention_impl=impl)
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.PRNGKey(3), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))["params"]
    # larger weights than the init: sharper logits, so greedy ties are far away
    params = jax.tree.map(lambda x: np.asarray(x) * 4.0, params)
    return jm, params, load_jax_params(TransformerLM(tcfg), params)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, DIMS["vocab_size"], n).astype(np.int32) for n in (5, 8, 2, 7)]


def _run_jax(jm, params, ids, mask, **kw):
    def step(p, i, m, pos, cache):
        logits, hidden, _, cache = jm.apply({"params": p}, i, m, pos, cache)
        return logits, hidden, cache

    out = jax_generate(
        step, params, lambda b, s: jm.init_cache(b, s), jnp.asarray(ids), jnp.asarray(mask),
        jax.random.PRNGKey(0), N_NEW, pad_token_id=PAD, do_sample=False, **kw,
    )
    return np.asarray(out["sequences"]), np.asarray(out["response_mask"])


def _run_torch(tm, ids, mask, **kw):
    def step(i, m, pos, cache):
        logits, hidden, _, cache = tm(i, m, pos, cache, last_only=True)
        return logits, hidden, cache

    out = generate(
        step, tm.init_cache, torch.from_numpy(ids), torch.from_numpy(mask), None, N_NEW,
        pad_token_id=PAD, do_sample=False, **kw,
    )
    return out["sequences"].numpy(), out["response_mask"].numpy()


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_greedy_generate_matches_jax(impl):
    jm, params, tm = _models(impl)
    ids, mask = left_pad_batch(_prompts(), PAD, 8)
    P = ids.shape[1]
    # no eos: every row runs the whole budget
    jseq, jmask = _run_jax(jm, params, ids, mask)
    tseq, tmask = _run_torch(tm, ids, mask)
    np.testing.assert_array_equal(tseq, jseq)
    np.testing.assert_array_equal(tmask, jmask)
    assert (tmask == 1).all()
    # an eos that row 0 emits before its last step: row 0 finishes mid-batch
    eos = int(jseq[0, P + 2])
    first = int(np.argmax(jseq[0, P:] == eos))
    for kw in (dict(eos_token_id=eos), dict(eos_token_id=eos, min_new_tokens=4)):
        jseq, jmask = _run_jax(jm, params, ids, mask, **kw)
        tseq, tmask = _run_torch(tm, ids, mask, **kw)
        np.testing.assert_array_equal(tseq, jseq, err_msg=str(kw))
        np.testing.assert_array_equal(tmask, jmask, err_msg=str(kw))
        if "min_new_tokens" not in kw:
            assert tmask[0].sum() == first + 1 < N_NEW and (tseq[0, P + first + 1:] == PAD).all()
        else:
            assert (tseq[:, P:P + 4] != eos).all()


def test_generate_exits_early_when_every_row_finished():
    """Every row emitting eos at step 0 ends the loop after the prefill: one
    forward in all (the JAX while_loop's cond). Four copies of one prompt
    give four identical greedy first tokens."""
    _, _, tm = _models("xla")
    ids, mask = left_pad_batch([_prompts()[0]] * 4, PAD, 8)
    calls = []

    def step(i, m, pos, cache):
        calls.append(i.shape)
        logits, hidden, _, cache = tm(i, m, pos, cache, last_only=True)
        return logits, hidden, cache

    with torch.no_grad():
        first = int(tm(torch.from_numpy(ids), torch.from_numpy(mask))[0][0, -1].argmax())
    out = generate(step, tm.init_cache, torch.from_numpy(ids), torch.from_numpy(mask), None, N_NEW,
                   pad_token_id=PAD, do_sample=False, eos_token_id=first)
    assert len(calls) == 1
    assert out["response_mask"].tolist() == [[1] + [0] * (N_NEW - 1)] * 4


def test_sampled_generate_is_seeded_and_launches_nothing_on_cpu():
    _, _, tm = _models("flash")
    ids, mask = left_pad_batch(_prompts(), PAD, 8)

    def step(i, m, pos, cache):
        logits, hidden, _, cache = tm(i, m, pos, cache, last_only=True)
        return logits, hidden, cache

    _kernels.reset_launches()
    outs = [
        generate(step, tm.init_cache, torch.from_numpy(ids), torch.from_numpy(mask),
                 torch.Generator().manual_seed(5), N_NEW, pad_token_id=PAD, top_k=5)["sequences"]
        for _ in range(2)
    ]
    assert torch.equal(outs[0], outs[1])
    assert sum(_kernels.launches().values()) == 0
