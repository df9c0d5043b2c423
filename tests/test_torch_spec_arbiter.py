"""chip_smoke.py's teacher-forced arbiter for the speculative engine
(``engine_forced_gaps``), on the CPU at a tiny size: forced onto the rows a
one-token engine generated itself, every gap is exactly 0 (f32 and int8 KV);
forced onto other rows, each request takes its row and, in f32, the gaps
equal the dense model's teacher-forced gaps at every position (so they are
aligned with the positions they name); it refuses an engine it cannot
force; and engine_spec's whole check (``hold_against_one_token``) passes
the speculative engine's rows and fails them with one token changed."""

import numpy as np
import pytest
import torch

import chip_smoke
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.serving import ServingEngine

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=64)
NEW = 12  # generated tokens per row


def _engine(quant, prefill_chunk=4, spec_k=0, num_slots=3):
    cfg = PRESETS["gpt2"].replace(**TINY, compute_dtype=torch.float32, kv_cache_quant=quant)
    model = TransformerLM(cfg)
    state = model.init_params(0).state_dict()
    return ServingEngine(model, state, num_slots=num_slots, max_seq_len=40, block_size=4, pad_token_id=0,
                         gen_kwargs=dict(do_sample=False), seed=0, prefill_chunk=prefill_chunk,
                         spec_k=spec_k, device="cpu")


def _prompts(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TINY["vocab_size"], int(rng.integers(5, 14))).tolist() for _ in range(n)]


def _generate(eng, prompts):
    uids = [eng.submit(p, NEW) for p in prompts]
    done = eng.run(uids)
    rows = [list(done[u].generated) for u in uids]
    for u in uids:
        eng.scheduler.pop_request(u)
    return rows


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_forced_onto_its_own_rows_every_gap_is_zero(quant):
    eng = _engine(quant)
    try:
        prompts = _prompts()
        own = _generate(eng, prompts)
        gaps = chip_smoke.engine_forced_gaps(eng, prompts, own)
        assert [len(g) for g in gaps] == [NEW] * len(prompts)
        assert all(g == 0.0 for row in gaps for g in row)
        assert eng.allocator.blocks_in_use == 0
        assert _generate(eng, prompts) == own  # the engine samples greedily again afterwards
    finally:
        eng.close()


def test_forced_onto_other_rows_the_gaps_are_the_dense_models_in_f32():
    eng = _engine(False)
    try:
        prompts = _prompts(seed=1)
        rng = np.random.default_rng(2)
        rows = [rng.integers(1, TINY["vocab_size"], NEW).tolist() for _ in prompts]
        gaps = chip_smoke.engine_forced_gaps(eng, prompts, rows)
        dense = chip_smoke.teacher_forced_gaps(eng.trunk, prompts, rows)
        np.testing.assert_allclose([g for row in gaps for g in row], dense, rtol=0, atol=1e-4)
        assert sum(g > 0 for g in dense) > NEW  # random rows are mostly not greedy
    finally:
        eng.close()


@pytest.mark.parametrize("knobs", [dict(spec_k=2), dict(prefill_chunk=0), dict(prefill_chunk=16)], ids=str)
def test_refuses_an_engine_it_cannot_force(knobs):
    eng = _engine(False, **{"prefill_chunk": 4, **knobs})
    try:
        with pytest.raises(ValueError, match="one-token engine"):
            chip_smoke.engine_forced_gaps(eng, _prompts(), [[1] * NEW] * 5)
    finally:
        eng.close()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_the_speculative_engines_rows_pass_and_a_changed_token_fails(quant):
    """engine_spec's check (``hold_against_one_token``) at a tiny size:
    the speculative engine's first 3 greedy rows of 5 pass against the
    one-token engine with its slots running all 5 prompts; the same rows
    with one token swapped for the least likely one fail, both as an
    off-tie split and as a teacher-forced gap."""
    prompts = _prompts(seed=3)
    spec = _engine(quant, spec_k=3, num_slots=5)
    try:
        got = _generate(spec, prompts)[:3]
    finally:
        spec.close()
    ref = _engine(quant, num_slots=5)
    try:
        report, failures = chip_smoke.hold_against_one_token(ref, prompts, got, NEW, "float32")
        assert failures == [] and report["teacher_forced"]["own_rows_max_abs_gap"] == 0.0
        assert report["tokens"] == report["teacher_forced"]["positions"] == NEW * 3
        logits = chip_smoke._last_logits(ref.trunk, prompts[1], got[1], 4)
        bad = [row[:] for row in got]
        bad[1][4] = int(logits.argmin())
        report, failures = chip_smoke.hold_against_one_token(ref, prompts, bad, NEW, "float32")
        assert len(failures) == 2 and report["splits"][0]["row"] == 1 and report["splits"][0]["position"] == 4
        assert report["teacher_forced"]["max_gap"] > 1.0e-3
        assert ref.allocator.blocks_in_use == 0
    finally:
        ref.close()
