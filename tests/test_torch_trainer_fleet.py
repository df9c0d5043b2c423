"""Port parity for PPO rollouts through a serving fleet
(``train.serving_fleet``): the port's ``PPOTrainer`` with 2 replicas
against the JAX one on the tiny config of tests/test_torch_trainer.py
(2 layers, hidden 32, char tokenizer, greedy, f32), from the same weights:
every rollout's uid on the same seat in both, the rollout store within
1e-4, the step stats within 1e-3 relative (the trainer-parity limits), the
``fleet/*`` gauges in the step stats, and ``learn()`` retiring every
replica of the port's router."""

import numpy as np
import pytest

import jax

from trlx_tpu_torch.utils.metrics import gauges

pytestmark = pytest.mark.torch_port


def test_ppo_trainer_with_a_fleet_matches_jax(tmp_path, monkeypatch):
    """``train.serving_fleet`` (2 replicas, greedy) in both trainers from the
    same weights: every rollout's uid on the same seat, the rollout store
    within 1e-4, the step stats within 1e-3 relative; both seats serve."""
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)
    from tests.test_torch_trainer import (
        ELEMENT_TOL,
        STAT_TOL,
        _attach_pipelines,
        _config_dict,
        _port_trainer,
        _record,
        reward_fn,
    )
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.parallel import mesh as mesh_lib
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer
    from trlx_tpu_torch.models.convert import policy_params_from_jax

    real = mesh_lib.make_mesh
    monkeypatch.setattr(mesh_lib, "mesh_from_config",
                        lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]))
    fleet = {"train.serving": dict(enabled=True, num_slots=2, block_size=4),
             "train.serving_fleet": dict(enabled=True, num_replicas=2), "train.total_steps": 2}

    jcfg = JaxConfig.update(JaxConfig.from_dict(_config_dict(tmp_path / "jax")), fleet)
    jt = jax_get_trainer("PPOTrainer")(config=jcfg, reward_fn=reward_fn)
    _attach_pipelines(jt, JaxPipeline, jcfg)
    pt = _port_trainer(tmp_path / "port", **fleet)
    state = policy_params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params)), pt.model_config)
    pt.model.load_state_dict(state)
    pt.ref_model.load_state_dict(pt.model.transformer.state_dict())

    seats = {"jax": [], "port": []}

    def record_seats(trainer, key):
        resolve = trainer._resolve_serving

        def wrapped():
            resolve()
            router = trainer._serving_engine
            submit = router.submit

            def routed(*a, **kw):
                uid = submit(*a, **kw)
                seats[key].append((uid, router.replica_of(uid)))
                return uid

            router.submit = routed

        trainer._resolve_serving = wrapped

    record_seats(jt, "jax")
    record_seats(pt, "port")
    jrec, prec = _record(jt), _record(pt)
    routers = []
    close = type(pt).on_learn_end

    def keep_router(self):
        routers.append(self._serving_engine)
        close(self)

    monkeypatch.setattr(type(pt), "on_learn_end", keep_router)
    try:
        jt.learn()
        pt.learn()
    finally:
        if jt._serving_engine is not None:
            jt._serving_engine.close()
    assert seats["port"] == seats["jax"] and {s for _, s in seats["port"]} == {0, 1}
    assert len(prec["phases"]) == len(jrec["phases"]) >= 1
    for jphase, pphase in zip(jrec["phases"], prec["phases"]):
        assert len(pphase) == len(jphase) == 8
        for je, pe in zip(jphase, pphase):
            np.testing.assert_array_equal(np.asarray(pe.query_tensor), np.asarray(je.query_tensor))
            np.testing.assert_array_equal(np.asarray(pe.response_tensor), np.asarray(je.response_tensor))
            for field in ("logprobs", "values", "rewards"):
                np.testing.assert_allclose(getattr(pe, field), np.asarray(getattr(je, field)), err_msg=field,
                                           **ELEMENT_TOL)
    assert len(prec["steps"]) == len(jrec["steps"]) == 2
    for i, (js, ps) in enumerate(zip(jrec["steps"], prec["steps"])):
        compared = [k for k in js if k.split("/")[0] in (
            "losses", "values", "old_values", "returns", "policy", "ratio", "padding_percentage",
            "learning_rate_group_0", "rollout_scores", "kl_ctl_value")]
        assert len(compared) >= 20
        for key in compared:
            np.testing.assert_allclose(ps[key], js[key], err_msg=f"step {i + 1} {key}", **STAT_TOL)
        assert ps["fleet/replicas"] == js["fleet/replicas"] == 2.0
        assert ps["fleet/routed"] == js["fleet/routed"]
    # learn()'s teardown closed the port's router: every replica retired
    assert routers and routers[0].num_replicas == 0 and gauges.snapshot(prefix="fleet/") == {}
