"""The port's C++ host data plane (``trlx_tpu_torch/native``): the library
built from ``csrc/data_plane.cpp`` equals its numpy versions and the JAX
package's ``trlx_tpu.native`` (its library and its numpy fallback) on
hypothesis inputs — empty rows, rows longer than the target, left and right
padding, stop patterns longer than the row; a failed build raises with the
compiler's output; and the trainer's collate, prompt padding and stop scan
go through the library in a CPU PPO run (the call counts)."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import trlx_tpu.native as jax_native
from trlx_tpu_torch import native

pytestmark = pytest.mark.torch_port

rows_i32 = st.lists(st.lists(st.integers(-2 ** 31, 2 ** 31 - 1), max_size=12), max_size=7)
rows_f32 = st.lists(st.lists(st.floats(-1e6, 1e6, width=32), max_size=12), max_size=7)


def _jax_fallback(fn, *args, **kwargs):
    """``trlx_tpu.native``'s numpy fallback (its library hidden)."""
    saved = jax_native._lib, jax_native._tried
    jax_native._lib, jax_native._tried = None, True
    try:
        return fn(*args, **kwargs)
    finally:
        jax_native._lib, jax_native._tried = saved


def _all_equal(*outs):
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@settings(max_examples=60, deadline=None)
@given(rows=rows_i32, target=st.integers(1, 10), pad=st.integers(-5, 5), left=st.booleans())
def test_pad_collate_i32_equals_numpy_and_the_jax_package(rows, target, pad, left):
    rows = [np.asarray(r, np.int32) for r in rows]
    _all_equal(
        native.pad_collate_i32(rows, target, pad, left),
        native.plain_pad_collate_i32(rows, target, pad, left),
        jax_native.pad_collate_i32(rows, target, pad, left),
        _jax_fallback(jax_native.pad_collate_i32, rows, target, pad, left),
    )


@settings(max_examples=60, deadline=None)
@given(rows=rows_f32, target=st.integers(1, 10), pad=st.floats(-2, 2, width=32), left=st.booleans())
def test_pad_collate_f32_equals_numpy_and_the_jax_package(rows, target, pad, left):
    rows = [np.asarray(r, np.float32) for r in rows]
    _all_equal(
        native.pad_collate_f32(rows, target, pad, left),
        native.plain_pad_collate_f32(rows, target, pad, left),
        jax_native.pad_collate_f32(rows, target, pad, left),
        _jax_fallback(jax_native.pad_collate_f32, rows, target, pad, left),
    )


@settings(max_examples=60, deadline=None)
@given(
    seqs=st.integers(0, 6).flatmap(lambda B: st.integers(0, 12).flatmap(
        lambda T: st.lists(st.lists(st.integers(0, 3), min_size=T, max_size=T), min_size=B, max_size=B))),
    stops=st.lists(st.lists(st.integers(0, 3), max_size=15), max_size=4),
)
def test_find_stop_positions_equals_numpy_and_the_jax_package(seqs, stops):
    T = len(seqs[0]) if seqs else 0
    seqs = np.asarray(seqs, np.int32).reshape(len(seqs), T)
    _all_equal(
        native.find_stop_positions(seqs, stops),
        native.plain_find_stop_positions(seqs, stops),
        jax_native.find_stop_positions(seqs, stops),
        _jax_fallback(jax_native.find_stop_positions, seqs, stops),
    )


def test_edge_cases_by_hand():
    rows = [np.array([], np.int32), np.arange(1, 8, dtype=np.int32), np.array([9], np.int32)]
    out, mask = native.pad_collate_i32(rows, 4, 0, pad_left=True)
    np.testing.assert_array_equal(out, [[0, 0, 0, 0], [4, 5, 6, 7], [0, 0, 0, 9]])
    np.testing.assert_array_equal(mask, [[0, 0, 0, 0], [1, 1, 1, 1], [0, 0, 0, 1]])
    out, mask = native.pad_collate_i32(rows, 4, 0, pad_left=False)
    np.testing.assert_array_equal(out, [[0, 0, 0, 0], [1, 2, 3, 4], [9, 0, 0, 0]])
    seqs = np.array([[1, 2, 3], [3, 1, 2]], np.int32)
    # a pattern longer than the row never matches; an empty one is ignored
    np.testing.assert_array_equal(native.find_stop_positions(seqs, [[1, 2, 3, 4], []]), [3, 3])
    np.testing.assert_array_equal(native.find_stop_positions(seqs, [[2], [1, 2]]), [0, 1])
    empty_out, empty_mask = native.pad_collate_i32([], 5, 0, True)
    assert empty_out.shape == empty_mask.shape == (0, 5)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken_plane.cpp"
    bad.write_text('extern "C" void f() { this is not C++ }\n')
    with pytest.raises(RuntimeError, match="host data plane build failed") as err:
        native.build(bad)
    assert "broken_plane.cpp" in str(err.value)
    assert not native.lib_path(bad).exists()
    with pytest.raises(RuntimeError, match="could not run"):
        native.build(bad, cxx=str(tmp_path / "no-such-g++"))


def test_the_library_is_named_after_its_source(tmp_path):
    a, b = tmp_path / "a.cpp", tmp_path / "b.cpp"
    a.write_text(native.SOURCE.read_text())
    b.write_text(native.SOURCE.read_text() + "\n// edited\n")
    assert native.lib_path(a).name.startswith("liba-")
    assert native.lib_path(a).name[5:] != native.lib_path(b).name[5:]


def test_calls_count_once_per_call():
    native.reset_calls()
    native.pad_collate_i32([np.arange(3)], 4, 0, True)
    native.pad_collate_f32([np.ones(2)], 4)
    native.find_stop_positions(np.zeros((1, 3), np.int32), [[1]])
    native.find_stop_positions(np.zeros((1, 3), np.int32), [[1]])
    assert native.calls() == {"pad_collate_i32": 1, "pad_collate_f32": 1, "find_stop_positions": 2}


def test_a_cpu_ppo_run_collates_pads_and_scans_through_the_library(tmp_path):
    """``trlx_tpu_torch.train`` on the CPU with stop sequences: the rollout
    collate (ppo_pipeline), the prompt padding (``left_pad_batch``) and the
    stop scan (``MeshRLTrainer.decode``) each reach the library."""
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_ppo_config
    from trlx_tpu_torch.ops.generation import left_pad_batch

    native.reset_calls()
    left_pad_batch([np.arange(1, 4, dtype=np.int32)], 0, 4)
    assert native.calls()["pad_collate_i32"] == 1

    base = default_ppo_config()
    base.model.num_layers_unfrozen = -1
    cfg = TRLConfig.update(base, {
        "model.model_path": "gpt2",
        "model.model_overrides": dict(vocab_size=259, hidden_size=16, num_layers=1, num_heads=2,
                                      max_position_embeddings=64),
        "mesh.compute_dtype": "float32", "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": 32, "train.batch_size": 4, "train.minibatch_size": 4, "train.total_steps": 1,
        "train.eval_interval": 100, "train.checkpoint_interval": 100, "train.save_best": False,
        "train.tracker": None, "train.checkpoint_dir": str(tmp_path / "ckpt"), "train.seed": 0,
        "method.num_rollouts": 4, "method.chunk_size": 4, "method.ppo_epochs": 1,
        "method.gen_kwargs": dict(max_new_tokens=6, do_sample=True, top_k=0, top_p=1.0),
    })
    native.reset_calls()
    trlx_tpu_torch.train(reward_fn=lambda samples, **_: [float(len(s)) for s in samples],
                         prompts=["ab", "cde", "f", "ghij"], eval_prompts=["ab"], config=cfg,
                         stop_sequences=["e"], device="cpu")
    calls = native.calls()
    assert calls["pad_collate_i32"] > 0 and calls["pad_collate_f32"] > 0 and calls["find_stop_positions"] > 0


def test_call_counts_lose_no_update_across_threads():
    """The learner and the rollout producer both collate: counts from many
    threads at a short switch interval add up exactly."""
    import sys
    import threading

    native.reset_calls()
    rows = [np.arange(3, dtype=np.int32)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [native.pad_collate_i32(rows, 4, 0, True) for _ in range(200)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert native.calls()["pad_collate_i32"] == 16 * 200
