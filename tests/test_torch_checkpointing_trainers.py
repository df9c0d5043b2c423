"""Trainers from a native store on two gloo ranks against the JAX trainers
on the same mesh (the trainer cases of ``tests/test_checkpointing.py``;
the store itself is :mod:`tests.test_torch_checkpointing`)."""

import pytest

from trlx_tpu import checkpointing as jax_ckpt

pytestmark = pytest.mark.torch_port


def _store_for(kind, tmp):
    """A store of the scale-out tests' tiny gpt2 (random, written by the JAX package)."""
    from tests.test_torch_scale_out import config_dict

    overrides = config_dict(kind, {}, tmp)["model"]["model_overrides"]
    return jax_ckpt.convert_hf_to_native("gpt2", str(tmp / "store"), allow_random=True, overrides=overrides)


def test_trainers_from_a_store_match_jax_on_two_ranks(tmp_path):
    """PPO on fsdp=2 with its trunk (policy and reference) restored from a
    store onto the mesh (each rank reading its blocks' chunks), and SFT
    with ``scan_layers`` (the stacked layout restacks the restored layers)
    on fsdp=2, against the JAX trainers started from the same store."""
    from tests.test_torch_mesh import run_ranks
    from tests.test_torch_scale_out import _drive, compare, jax_trainer
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline

    store = _store_for("ppo", tmp_path)
    runs = {"ppo": {"model.model_path": store},
            "sft": {"model.model_path": store, "model.model_overrides": dict(
                vocab_size=12, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                max_position_embeddings=64, attention_impl="flash", scan_layers=True)}}
    jts, jobs = {}, []
    for kind, patch in runs.items():
        jts[kind], init = jax_trainer(kind, dict(fsdp=2), 2, tmp_path / f"jax_{kind}", patch)
        # the heads from the JAX trainer; the trunk comes from the store
        heads = {k: v for k, v in init.items() if k.split(".", 1)[0] not in ("transformer", "ref_model")}
        jobs.append(("tests.test_torch_scale_out:port_train",
                     dict(kind=kind, mesh=dict(fsdp=2), init=heads, ckpt_dir=str(tmp_path / f"port_{kind}"),
                          patch=patch)))
    handle = run_ranks(2, jobs, tmp_path / "ranks", wait=False)
    try:
        jrecs = {kind: _drive(jts[kind], kind, JaxPipeline) for kind in runs}
    finally:
        results = handle.results()
    for i, kind in enumerate(runs):
        compare(kind, jrecs[kind], jts[kind], [r[i] for r in results])
