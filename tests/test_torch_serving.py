"""Port parity for the serving path: the port's allocator and scheduler units
(mirrored from tests/test_serving.py), greedy byte-parity of the port's
ServingEngine with trlx_tpu's ServingEngine on the same weights (5 prompts
through 3 slots, block_size 4, mixed lengths, f32, attention_impl "flash"
and "xla", plain and int8 KV), an eos case, prefix sharing, no leaked blocks, and the
top-k / top-p masks against JAX's on the same logits."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
from trlx_tpu.models.transformer import TransformerLM as JaxLM
from trlx_tpu.ops.sampling import apply_top_k as jax_top_k, apply_top_p as jax_top_p
from trlx_tpu.serving import GenerationClient as JaxClient, ServingEngine as JaxEngine
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.ops.sampling import apply_top_k, apply_top_p, sample_token
from trlx_tpu_torch.serving import (
    GenerationClient,
    InflightScheduler,
    PagedBlockAllocator,
    ServingEngine,
)
from trlx_tpu_torch.serving.scheduler import (
    FINISH_CANCELLED,
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_STOP,
)

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=64)
PROMPTS = [
    [5, 9, 11], [2, 30, 7, 1, 3, 22, 4, 8, 15, 16, 23, 31],
    [1, 2, 3, 4, 5, 6, 7], [33, 12], [9, 9, 9, 9, 9],
]


# ---------------------------------------------------------------- allocator


def test_allocator_reserves_and_frees_without_leak():
    a = PagedBlockAllocator(num_blocks=9, block_size=4, prefix_caching=False)
    seqs = [a.allocate(list(range(5)), 5 + 6) for _ in range(2)]
    assert all(s is not None for s in seqs)
    assert a.blocks_in_use == 6
    a.check_invariants()
    assert a.allocate(list(range(9)), 18) is None
    for s in seqs:
        a.free(s)
    assert a.blocks_in_use == 0
    a.check_invariants()
    with pytest.raises(ValueError, match="double free"):
        a.free(type(seqs[0])(blocks=[1], num_shared=0))


def test_allocator_refcount_under_prefix_sharing():
    a = PagedBlockAllocator(num_blocks=16, block_size=4)
    shared_prompt = list(range(8))
    s1 = a.allocate(shared_prompt + [100], 12)
    s2 = a.allocate(shared_prompt + [101], 12)
    assert s1.num_shared == 0
    assert s2.num_shared == 2 and s2.blocks[:2] == s1.blocks[:2]
    a.check_invariants()
    in_use_both = a.blocks_in_use
    a.free(s1)
    a.check_invariants()
    assert a.blocks_in_use == in_use_both - 1
    a.free(s2)
    a.check_invariants()
    assert a.blocks_in_use == 0
    s3 = a.allocate(shared_prompt + [102], 12)
    assert s3.num_shared == 2
    assert a.stats.prefix_hits == 4
    a.free(s3)
    a.check_invariants()


def test_allocator_flush_and_write_frontier():
    a = PagedBlockAllocator(num_blocks=16, block_size=4)
    s = a.allocate(list(range(8)), 8)
    a.free(s)
    a.flush_prefix_cache()
    a.check_invariants()
    assert a.allocate(list(range(8)), 8).num_shared == 0
    p = list(range(10))  # 2 full blocks + a partial tail
    s1, s2 = a.allocate(p, 14), a.allocate(p, 14)
    assert s2.num_shared == 2 and s2.blocks[2] != s1.blocks[2]


# ---------------------------------------------------------------- scheduler


def test_scheduler_slot_turnover_and_finish_reasons():
    a = PagedBlockAllocator(num_blocks=32, block_size=4, prefix_caching=False)
    s = InflightScheduler(num_slots=2, allocator=a)
    u_eos = s.submit([1], 8, eos_token_id=9)
    u_stop = s.submit([4, 5], 8, stop_sequences=[[7, 8]])
    u_len = s.submit([6, 7, 8], 2)
    placed = s.admissions()
    assert [r.uid for _, r in placed] == [u_eos, u_stop]
    s.on_token(0, 5)
    assert s.on_token(0, 9).finish_reason == FINISH_EOS
    s.on_token(1, 7)
    assert s.on_token(1, 8).finish_reason == FINISH_STOP
    placed = s.admissions()
    assert [r.uid for _, r in placed] == [u_len]
    slot = placed[0][0]
    s.on_token(slot, 1)
    done = s.on_token(slot, 2)
    assert done.finish_reason == FINISH_LENGTH and len(done.generated) == 2
    assert a.blocks_in_use == 0
    a.check_invariants()
    assert set(s.pop_finished()) == {u_eos, u_stop, u_len}


def test_scheduler_cancel_frees_blocks():
    a = PagedBlockAllocator(num_blocks=32, block_size=4, prefix_caching=False)
    s = InflightScheduler(num_slots=2, allocator=a)
    u1 = s.submit([1, 2, 3], 8)
    u2 = s.submit([4, 5, 6], 8)
    s.admissions()
    assert s.cancel(u1)
    assert s.reap_cancelled() == [0]
    assert s.requests[u1].finish_reason == FINISH_CANCELLED
    u3 = s.submit([7], 4)
    assert s.cancel(u3)
    assert s.requests[u3].finish_reason == FINISH_CANCELLED
    s.cancel(u2)
    s.reap_cancelled()
    assert a.blocks_in_use == 0
    a.check_invariants()


# ------------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def shared_weights():
    jcfg = JAX_PRESETS["gpt2"].replace(**TINY, compute_dtype=jnp.float32)
    params = JaxLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    return jcfg, params


_OPEN_ENGINES = []


@pytest.fixture(autouse=True)
def _close_engines():
    """Close every engine a test made, so no gauge it exported outlives the test
    (trlx_tpu's gauges are process-global and later tests assert they are clear)."""
    yield
    while _OPEN_ENGINES:
        _OPEN_ENGINES.pop().close()


def _engines(shared_weights, num_slots=3, eos=None, max_seq_len=32, **over):
    jcfg, params = shared_weights
    tcfg = PRESETS["gpt2"].replace(**TINY, compute_dtype=torch.float32, **over)
    kw = dict(num_slots=num_slots, max_seq_len=max_seq_len, block_size=4, eos_token_id=eos,
              pad_token_id=0, gen_kwargs=dict(do_sample=False), seed=0)
    jeng = JaxEngine(JaxLM(jcfg.replace(**over)), params, **kw)
    teng = ServingEngine(TransformerLM(tcfg), params_from_jax(params, tcfg), device="cpu", **kw)
    _OPEN_ENGINES.extend((jeng, teng))
    return jeng, teng


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32kv", "int8kv"])
def test_engine_greedy_byte_parity_with_jax_engine(shared_weights, quant, impl):
    jeng, teng = _engines(shared_weights, attention_impl=impl, kv_cache_quant=quant)
    prompts = [np.asarray(p, np.int32) for p in PROMPTS]
    jout = JaxClient(jeng).generate_batch(prompts, 6)
    tout = GenerationClient(teng).generate_batch(prompts, 6)
    np.testing.assert_array_equal(tout[0], jout[0])
    np.testing.assert_array_equal(tout[1], jout[1])
    assert tout[2] == jout[2]
    assert teng.stats.prefill_waves >= 2  # slots refilled mid-run
    assert teng.stats.prefill_waves == jeng.stats.prefill_waves
    assert teng.stats.decode_steps == jeng.stats.decode_steps
    assert teng.allocator.blocks_in_use == 0
    teng.allocator.check_invariants()


def test_engine_eos_parity(shared_weights):
    jeng0, _ = _engines(shared_weights, num_slots=2)
    prompts = [np.asarray(p, np.int32) for p in ([5, 9, 11, 2], [7, 1, 3])]
    free_run = JaxClient(jeng0).generate_batch(prompts, 8)[0]
    eos = int(free_run[0, -8:][1])  # the second generated token becomes eos
    jeng, teng = _engines(shared_weights, num_slots=2, eos=eos, attention_impl="flash")
    jseqs, jmask, _ = JaxClient(jeng).generate_batch(prompts, 8)
    tseqs, tmask, _ = GenerationClient(teng).generate_batch(prompts, 8)
    np.testing.assert_array_equal(tseqs, jseqs)
    np.testing.assert_array_equal(tmask, jmask)
    assert 0 < tmask[0].sum() <= 2  # finished at eos, mask up to and including it
    teng.allocator.check_invariants()


def test_engine_prefix_sharing_stream_and_cancel(shared_weights):
    jeng, teng = _engines(shared_weights, num_slots=2, max_seq_len=40, attention_impl="flash")
    system = [5, 9, 11, 2, 30, 7, 1, 3]  # two full shareable blocks
    prompts = [np.asarray(system + [t], np.int32) for t in (4, 8, 15, 16)]
    client = GenerationClient(teng)
    first = client.generate_batch(prompts, 4)[0]
    np.testing.assert_array_equal(first, JaxClient(jeng).generate_batch(prompts, 4)[0])
    assert teng.allocator.stats.prefix_hits > 0
    assert teng.allocator.blocks_in_use == 0
    teng.set_params(teng.trunk.state_dict())  # flushes the prefix cache
    np.testing.assert_array_equal(client.generate_batch(prompts, 4)[0], first)
    uid = client.submit([5, 9, 11], 16)
    stream = client.stream(uid)
    got = [next(stream) for _ in range(3)]
    assert client.cancel(uid)
    list(stream)
    teng.step()  # reap round
    req = teng.scheduler.requests[uid]
    assert req.finish_reason == FINISH_CANCELLED and req.generated[:3] == got
    assert teng.allocator.blocks_in_use == 0
    teng.allocator.check_invariants()
    with pytest.raises(ValueError, match="max_seq_len"):
        teng.submit(list(range(30)), 16)
    assert teng.summary()["finished_requests"] == 8  # cancels are reaped, not finished rounds
    teng.close()


def test_engine_later_slices_raise(shared_weights):
    """No engine knob of a later slice is left: the policy and the tenancy
    registry build since the production-serving slice, and an island
    attaches since the serving-fleet slice (tests/test_torch_islands.py
    drives it); the engine then serves version -1 until its first swap."""
    from trlx_tpu_torch.serving import GenerationIsland, ServingResiliencePolicy, TenantRegistry

    _, params = shared_weights
    tcfg = PRESETS["gpt2"].replace(**TINY, compute_dtype=torch.float32)
    for kw in (dict(policy=ServingResiliencePolicy()), dict(tenants=TenantRegistry())):
        eng = ServingEngine(TransformerLM(tcfg), num_slots=1, max_seq_len=8, device="cpu", **kw)
        assert eng.policy is kw.get("policy") and eng.tenants is kw.get("tenants")
        eng.close()
    eng = ServingEngine(TransformerLM(tcfg), num_slots=1, max_seq_len=8, device="cpu")
    island = GenerationIsland(eng)
    assert eng._island is island and eng.serving_version == -1
    island.close()
    eng.close()


def test_prefill_pack_writes_each_pool_slot_once():
    """Rows sharing prefix blocks name the same pool slots; the pack writes
    each slot once, from the last row naming it (a sequential scatter's
    result), so the card cannot keep an arbitrary duplicate."""
    from trlx_tpu_torch.serving.engine import pack_targets

    BS, P = 4, 8
    rows = np.array([[1, 2, 0], [1, 2, 0], [1, 3, 0]], np.int32)  # rows 0-1 share blocks 1-2, row 2 block 1
    lens = np.array([8, 6, 5])
    dest, src = pack_targets(rows, lens, P, BS, 3)
    assert len(np.unique(dest)) == len(dest)
    writers = {}
    for r in range(3):  # the sequential reference: later rows overwrite earlier ones
        for p in range(P):
            logical = p - (P - lens[r])
            if logical >= 0:
                writers[rows[r, logical // BS] * BS + logical % BS] = r * P + p
    assert dict(zip(dest.tolist(), src.tolist())) == writers
    assert sorted(src.tolist()) == src.tolist()  # the wave's order is kept


def test_prefill_pack_without_prefix_caching_keeps_every_position():
    """Without prefix caching no two rows share a block: the pack skips the
    dedupe and returns every non-padding position in the wave's order, the
    same targets the deduped pack gives for disjoint rows."""
    from trlx_tpu_torch.serving.engine import pack_targets

    BS, P = 4, 8
    rows = np.array([[1, 2, 0], [3, 4, 0], [5, 6, 0]], np.int32)
    lens = np.array([8, 6, 5])
    dest, src = pack_targets(rows, lens, P, BS, 3, shared=False)
    assert len(dest) == len(src) == int(lens.sum()) and len(np.unique(dest)) == len(dest)
    want = pack_targets(rows, lens, P, BS, 3)
    assert dest.tolist() == want[0].tolist() and src.tolist() == want[1].tolist()


# ----------------------------------------------------------------- sampling


def test_top_k_top_p_masks_match_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((4, 97)) * 2).astype(np.float32)
    for k in (0, 1, 5, 50, 97):
        np.testing.assert_array_equal(
            apply_top_k(torch.from_numpy(logits), k).numpy(), np.asarray(jax_top_k(jnp.asarray(logits), k))
        )
    for p in (0.1, 0.5, 0.9, 1.0):
        np.testing.assert_array_equal(
            apply_top_p(torch.from_numpy(logits), p).numpy(), np.asarray(jax_top_p(jnp.asarray(logits), p))
        )


def test_sample_token_greedy_and_seeded():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 0.0, 0.0, 5.0]])
    gen = torch.Generator().manual_seed(0)
    assert sample_token(gen, logits, do_sample=False).tolist() == [1, 0]  # first-index ties
    a = sample_token(torch.Generator().manual_seed(3), logits.repeat(8, 1), top_k=2, top_p=0.9)
    b = sample_token(torch.Generator().manual_seed(3), logits.repeat(8, 1), top_k=2, top_p=0.9)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert set(a[0::2].tolist()) <= {1, 2} and set(a[1::2].tolist()) <= {0, 3}
