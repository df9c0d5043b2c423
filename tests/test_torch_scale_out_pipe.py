"""Scale-out parity on the ``pipe`` axis: the port's PPO and SFT trainers on
N gloo ranks against the JAX package's on a mesh of the same shape (the
checks of :mod:`tests.test_torch_scale_out`: experience within 1e-4, stats
within 1e-3 relative, gathered parameters after 2 steps within 1e-5, every
rank's stats ``==``), on ``pipe=2`` (PPO's reference a full pipelined
copy), and SFT on ``pipe=2 x model=2``. Also: sampled rollouts on
``pipe=2`` token-identical to the 1-rank run of the same stacked trunk;
the HF export of a ``pipe=2`` run (every stage's layers gathered, written
by rank 0) equal to its gathered parameters; ``mesh.sequence_shard`` under
``pipe=2`` warning and disabled. ``data=2 x pipe=2`` and the stacked
layout on ``fsdp=2 x model=2`` are in :mod:`tests.test_torch_scale_out_pipe_data`.
"""

import logging

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import run_ranks
from tests.test_torch_scale_out import ELEMENT_TOL, STAT_TOL, compare, jax_trainer, port_train

pytestmark = pytest.mark.torch_port

PIPE_MB = {"mesh.pipeline_microbatches": 2}


def pipe_fixture(mesh, n, kinds):
    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("scale_out_pipe")
        jts, jobs = {}, []
        for kind in kinds:
            jts[kind], init = jax_trainer(kind, dict(mesh, pipeline_microbatches=2), n, tmp / f"jax_{kind}")
            jobs.append(("tests.test_torch_scale_out:port_train",
                         dict(kind=kind, mesh=mesh, init=init, ckpt_dir=str(tmp / f"port_{kind}"),
                              overrides=PIPE_MB)))
        handle = run_ranks(n, jobs, tmp / "ranks", wait=False)
        yield jts, handle, kinds
        handle.kill()

    return runs


def check(runs, kind):
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from tests.test_torch_scale_out import _drive

    jts, handle, kinds = runs
    jrec = _drive(jts[kind], kind, JaxPipeline)
    ranks = [r[kinds.index(kind)] for r in handle.results()]
    compare(kind, jrec, jts[kind], ranks)
    assert any(k.startswith("transformer.layers_scan.") for k in ranks[0]["params"])


pipe2 = pipe_fixture(dict(pipe=2), 2, ("ppo", "sft"))
pipe2_model2 = pipe_fixture(dict(pipe=2, model=2), 4, ("sft",))


@pytest.mark.parametrize("kind", ["ppo", "sft"])
def test_trainers_match_jax_on_pipe2(pipe2, kind):
    check(pipe2, kind)


def test_sft_matches_jax_on_pipe2_model2(pipe2_model2):
    check(pipe2_model2, "sft")


def pipe_extras(tmp):
    """A 2-stage rank's sampled PPO run (its tokens), the HF export of an
    SFT run against its gathered parameters, and a trainer built with
    ``mesh.sequence_shard`` under ``pipe=2`` (a job)."""
    import os

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.models.hf_loading import load_pretrained
    from trlx_tpu_torch.parallel.pipeline import stack_layer_params
    from trlx_tpu_torch.utils.loading import get_trainer
    from tests.test_torch_scale_out import config_dict, reward_fn

    out = {"sampled": port_train("ppo", dict(pipe=2), None, os.path.join(tmp, "sampled"), PIPE_MB, do_sample=True)}
    cfg = TRLConfig.update(TRLConfig.from_dict(config_dict("sft", dict(pipe=2), os.path.join(tmp, "sft"))), PIPE_MB)
    trainer = get_trainer("SFTTrainer")(config=cfg, device="cpu")
    trainer.make_experience(["ab cd", "efgh", "a b", "dd ee"] * 2, 12)
    trainer.learn()
    export = os.path.join(tmp, "export")
    trainer.save_pretrained(export)
    gathered = trainer.model_state_dict()
    from trlx_tpu_torch.parallel import collectives as coll

    coll.barrier(trainer.mesh.world_group)
    if trainer.is_main_process:
        config, state, _ = load_pretrained(export)
        state = stack_layer_params(state, config.num_layers)
        out["export_equal"] = sorted(state) == sorted(k[len("transformer."):] for k in gathered) and all(
            torch.equal(state[k[len("transformer."):]], v) for k, v in gathered.items())
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep()
    logging.getLogger("trlx_tpu_torch").addHandler(handler)
    try:
        over = dict(PIPE_MB, **{"mesh.sequence_shard": True})
        cfg = TRLConfig.update(TRLConfig.from_dict(config_dict("ppo", dict(pipe=2), os.path.join(tmp, "sp"))), over)
        t = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu")
        out["sp_disabled"] = t.model_config.sequence_sharding is False and t.ref_model is not None
    finally:
        logging.getLogger("trlx_tpu_torch").removeHandler(handler)
    out["log"] = records
    return out


def test_pipe2_sampling_export_and_sequence_shard(tmp_path):
    handle = run_ranks(2, [("tests.test_torch_scale_out_pipe:pipe_extras", dict(tmp=str(tmp_path / "runs")))],
                       tmp_path / "ranks", wait=False)
    try:
        # the same stacked trunk on one rank (no pipe axis), from the same seed
        from tests.test_torch_scale_out import config_dict

        stacked = dict(config_dict("ppo", {}, "")["model"]["model_overrides"], pipeline_stages=2)
        one = port_train("ppo", dict(data=1), None, str(tmp_path / "one"), {"model.model_overrides": stacked},
                         do_sample=True)
    finally:
        ranks = [r[0] for r in handle.results()]
    for r in ranks:
        two = r["sampled"]
        assert len(two["phases"]) == len(one["phases"]) >= 1
        for p2, p1 in zip(two["phases"], one["phases"]):
            for e2, e1 in zip(p2, p1):
                np.testing.assert_array_equal(e2[1], e1[1])
                np.testing.assert_allclose(e2[2], e1[2], **ELEMENT_TOL)
        for s2, s1 in zip(two["steps"], one["steps"]):
            for key in s1:
                np.testing.assert_allclose(s2[key], s1[key], err_msg=key, **STAT_TOL)
        assert r["sp_disabled"]
    assert ranks[1]["sampled"]["steps"] == ranks[0]["sampled"]["steps"]
    assert ranks[0]["export_equal"] is True
    assert any("mesh.sequence_shard is disabled under pipeline parallelism" in m for m in ranks[0]["log"])
