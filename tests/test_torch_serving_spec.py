"""Port parity for speculative decoding and chunked prefill in the serving
engine: the port's ``_ngram_propose`` against JAX's on seeded contexts; the
port's ``ServingEngine`` greedy and byte-identical to trlx_tpu's with the
same knobs — (spec_k, prefill_chunk) in {(4, 0), (0, 4), (3, 5)}, f32 and
int8 KV, on tests/test_serving_spec.py's tiny config and prompts, 5 prompts
through 3 slots — with equal spec / chunk / delivery stats and no leaked
blocks; an eos validated inside an accept run; the summary and gauges; and
an accept-all ``count_accepted_drafts`` that must break parity, which shows
the comparison can fail."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
from trlx_tpu.models.transformer import TransformerLM as JaxLM
from trlx_tpu.serving import GenerationClient as JaxClient, ServingEngine as JaxEngine
from trlx_tpu.serving.engine import _ngram_propose as jax_ngram_propose
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.serving import GenerationClient, ServingEngine
from trlx_tpu_torch.serving import engine as engine_mod
from trlx_tpu_torch.serving.engine import _ngram_propose
from trlx_tpu_torch.utils.metrics import gauges

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=64)
PROMPTS = [
    [5, 9, 11], [2, 30, 7, 1, 3, 22, 4, 8, 15, 16, 23, 31],
    [1, 2, 3, 4, 5, 6, 7], [33, 12], [9, 9, 9, 9, 9],
]
STATS = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens", "chunk_appends",
         "delivered_tokens", "decode_steps", "prefill_waves", "prefill_tokens", "decode_slot_rounds")


@pytest.fixture(scope="module")
def shared_weights():
    jcfg = JAX_PRESETS["gpt2"].replace(**TINY, compute_dtype=jnp.float32)
    params = JaxLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32)
    )["params"]
    return jcfg, jax.tree.map(np.asarray, params)


_OPEN_ENGINES = []


@pytest.fixture(autouse=True)
def _close_engines():
    """Close every engine a test made, so no gauge it exported outlives the test
    (trlx_tpu's gauges are process-global and later tests assert they are clear)."""
    yield
    while _OPEN_ENGINES:
        _OPEN_ENGINES.pop().close()


def _engines(shared_weights, *, quant=False, eos=None, num_slots=3, **knobs):
    jcfg, params = shared_weights
    tcfg = PRESETS["gpt2"].replace(**TINY, compute_dtype=torch.float32, kv_cache_quant=quant)
    kw = dict(num_slots=num_slots, max_seq_len=32, block_size=4, eos_token_id=eos, pad_token_id=0,
              gen_kwargs=dict(do_sample=False), seed=0, **knobs)
    jeng = JaxEngine(JaxLM(jcfg.replace(kv_cache_quant=quant)), params, **kw)
    teng = ServingEngine(TransformerLM(tcfg), params_from_jax(params, tcfg), device="cpu", **kw)
    _OPEN_ENGINES.extend((jeng, teng))
    return jeng, teng


def test_ngram_propose_matches_jax_on_seeded_contexts():
    rng = np.random.default_rng(0)
    for _ in range(200):
        ctx = rng.integers(0, int(rng.integers(2, 8)), int(rng.integers(0, 40))).astype(np.int32)
        k, order = int(rng.integers(1, 6)), int(rng.integers(1, 5))
        np.testing.assert_array_equal(
            _ngram_propose(ctx, k, order, 0), jax_ngram_propose(ctx, k, order, 0)
        )
    # the latest match of the longest suffix wins: [7,8,9] at 0 -> 5, 6, ...
    ctx = np.array([7, 8, 9, 5, 6, 7, 8, 9], np.int32)
    np.testing.assert_array_equal(_ngram_propose(ctx, 4, 3, 0), [5, 6, 7, 8])


@pytest.mark.parametrize(
    "spec_k,prefill_chunk", [(4, 0), (0, 4), (3, 5)], ids=["spec_k4", "chunk4", "spec_k3+chunk5"]
)
@pytest.mark.parametrize("quant", [False, True], ids=["f32kv", "int8kv"])
def test_spec_engine_greedy_byte_parity_with_jax_engine(shared_weights, quant, spec_k, prefill_chunk):
    jeng, teng = _engines(shared_weights, quant=quant, spec_k=spec_k, prefill_chunk=prefill_chunk)
    prompts = [np.asarray(p, np.int32) for p in PROMPTS]
    jout = JaxClient(jeng).generate_batch(prompts, 6)
    tout = GenerationClient(teng).generate_batch(prompts, 6)
    np.testing.assert_array_equal(tout[0], jout[0])
    np.testing.assert_array_equal(tout[1], jout[1])
    assert tout[2] == jout[2]
    for key in STATS:
        assert getattr(teng.stats, key) == getattr(jeng.stats, key), key
    if spec_k:
        assert teng.stats.spec_rounds > 0
    if prefill_chunk:
        assert teng.stats.chunk_appends > 0  # the 12-token prompt chunks
    assert teng.allocator.blocks_in_use == 0
    teng.allocator.check_invariants()


def test_spec_eos_stops_inside_an_accept_run(shared_weights):
    """An eos validated mid-accept-run finishes the request there: tokens
    past it in the same verify round are never emitted."""
    prompts = [np.asarray(p, np.int32) for p in ([5, 9, 11, 2], [7, 1, 3])]
    free_run = JaxClient(_engines(shared_weights, num_slots=2)[0]).generate_batch(prompts, 8)[0]
    eos = int(free_run[0, -8:][1])  # the second generated token becomes eos
    jeng, teng = _engines(shared_weights, eos=eos, num_slots=2, spec_k=4)
    jseqs, jmask, _ = JaxClient(jeng).generate_batch(prompts, 8)
    tseqs, tmask, _ = GenerationClient(teng).generate_batch(prompts, 8)
    np.testing.assert_array_equal(tseqs, jseqs)
    np.testing.assert_array_equal(tmask, jmask)
    assert 0 < tmask[0].sum() <= 2
    assert teng.stats.spec_accepted_tokens == jeng.stats.spec_accepted_tokens
    teng.allocator.check_invariants()


def test_spec_summary_and_gauges(shared_weights):
    _, teng = _engines(shared_weights, spec_k=3, prefill_chunk=5)
    GenerationClient(teng).generate_batch([np.asarray(p, np.int32) for p in PROMPTS], 6)
    s = teng.summary()
    assert s["spec_rounds"] == teng.stats.spec_rounds > 0
    assert s["chunk_appends"] == teng.stats.chunk_appends > 0
    assert 0.0 <= s["spec_accept_rate"] <= 1.0
    assert 1.0 <= s["accepted_tok_per_round"] <= 4.0
    teng.export_gauges()
    snap = gauges.snapshot("serving/")
    assert snap["serving/accepted_tok_per_round"] == pytest.approx(s["accepted_tok_per_round"])
    assert snap["serving/spec_accept_rate"] == pytest.approx(s["spec_accept_rate"])
    teng.close()
    assert not gauges.snapshot("serving/")
    # spec off keeps the one-token accounting
    _, plain = _engines(shared_weights)
    GenerationClient(plain).generate_batch([np.asarray(p, np.int32) for p in PROMPTS[:2]], 4)
    s = plain.summary()
    assert (s["accepted_tok_per_round"], s["spec_accept_rate"], s["spec_rounds"], s["chunk_appends"]) == (
        1.0, 0.0, 0.0, 0.0)


def test_engine_rejects_bad_spec_knobs(shared_weights):
    for kw, name in ((dict(spec_k=-1), "spec_k"), (dict(spec_k=2, spec_ngram=0), "spec_ngram"),
                     (dict(prefill_chunk=-2), "prefill_chunk")):
        with pytest.raises(ValueError, match=name):
            _engines(shared_weights, **kw)


def test_accept_all_breaks_parity(shared_weights, monkeypatch):
    """Claiming every draft accepted must break parity with the JAX engine:
    the comparison above can fail."""
    jeng, teng = _engines(shared_weights, spec_k=4)
    prompts = [np.asarray(p, np.int32) for p in PROMPTS]
    jout = JaxClient(jeng).generate_batch(prompts, 6)
    monkeypatch.setattr(
        engine_mod, "count_accepted_drafts",
        lambda sampled, proposed: torch.full((proposed.shape[0],), proposed.shape[1] - 1, dtype=torch.int32),
    )
    tout = GenerationClient(teng).generate_batch(prompts, 6)
    assert not np.array_equal(tout[0], jout[0])
