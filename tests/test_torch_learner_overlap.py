"""The port's overlapped FSDP step (``train.learner_overlap``) against the
JAX package's ``make_overlapped_grad_accum_step`` on ``data=2 x fsdp=2``
(the port of ``tests/test_learner_overlap.py``'s
``test_overlap_matches_whole_batch_reference``): the same toy MLP, rules and
batch, four microbatches, the shard-aware clip, with AdamW and with 8-bit
AdamW (blocks over the local shard). Parameters within 1e-5 after two
steps, stats within 1e-4, each rank's optimizer state 1/fsdp of each
sharded leaf. Also: the trainer's gate warns and keeps the default step
for ``model=2`` and for the self-healing guard, as the JAX trainer's does.
"""

import types

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import run_ranks

pytestmark = pytest.mark.torch_port

LR = 1e-2


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "dense.kernel": (rng.randn(16, 8) * 0.1).astype(np.float32),
        "dense.bias": np.zeros((8,), np.float32),
        "out.kernel": (rng.randn(8, 4) * 0.1).astype(np.float32),
    }


def _batch(B=16, seed=1):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(B, 16).astype(np.float32), "y": rng.randn(B, 4).astype(np.float32)}


def _rules():
    from trlx_tpu_torch.parallel.sharding import PartitionSpec as P

    return [(r".*dense/kernel$", P("fsdp", None)), (r".*out/kernel$", P(None, "fsdp")), (r".*", P())]


class _Leaf(torch.nn.Module):
    def __init__(self, shape, bias=None):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.zeros(shape))
        self.bias = torch.nn.Parameter(torch.zeros(bias)) if bias else None

    def forward(self, x):
        y = x @ self.kernel
        return y + self.bias if self.bias is not None else y


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = _Leaf((16, 8), 8)
        self.out = _Leaf((8, 4))

    def forward(self, x):
        return self.out(torch.tanh(self.dense(x)))


class _Batch(dict):
    def split(self, n):
        m = len(self["x"]) // n
        return [_Batch({k: v[i * m:(i + 1) * m] for k, v in self.items()}) for i in range(n)]


class _Constant:
    """The schedule of the JAX test: a constant rate."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        for g in optimizer.param_groups:
            g["lr"] = LR

    def get_last_lr(self):
        return [LR]

    def step(self):
        pass


def overlap_steps(opt_name, steps, num_mb=4, max_grad_norm=1.0):
    """A rank's run of the overlapped step on the toy MLP (a job): stats per
    step, the gathered parameters, the optimizer state's shapes."""
    from trlx_tpu_torch.parallel.fsdp import ShardedParams, make_overlapped_grad_accum_step
    from trlx_tpu_torch.parallel.mesh import make_mesh
    from trlx_tpu_torch.parallel.sharding import make_param_specs
    from trlx_tpu_torch.utils import get_optimizer_class

    mesh = make_mesh(data=2, fsdp=2, device=torch.device("cpu"))
    model = _MLP()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(_params()[name]))
    specs = make_param_specs(dict(model.named_parameters()), mesh, _rules())
    shards = ShardedParams({"": model}, specs, mesh)
    leaf_params = list(model.parameters())
    masters = [shards.by_param[id(p)].master for p in leaf_params]
    optimizer = get_optimizer_class(opt_name)(masters, learning_rate=LR)
    trainer = types.SimpleNamespace(
        mesh=mesh, shards=shards, model=model, optimizer=optimizer, scheduler=_Constant(optimizer),
        trainable_params=masters, _leaf_params=leaf_params, max_grad_norm=max_grad_norm,
        device=torch.device("cpu"), _rollout_model=None)

    def loss_fn(mb):
        loss = torch.mean(torch.square(model(mb["x"]) - mb["y"]))
        return loss, {"loss": loss}

    step = make_overlapped_grad_accum_step(trainer, loss_fn, num_mb)
    batch = _Batch({k: torch.from_numpy(v) for k, v in _batch().items()})
    stats = [step(batch) for _ in range(steps)]
    state = {name: {k: tuple(v.shape) for k, v in optimizer.state[shards.by_param[id(p)].master].items()
                    if torch.is_tensor(v)} for name, p in model.named_parameters()}
    return {"stats": stats, "params": {k: v.numpy() for k, v in shards.full_state().items()}, "state": state}


def overlap_gate(tmp):
    """The trainer's gate on a 4-rank group (a job): ``model=2`` and the
    self-healing guard keep the default step, ``data=2 x fsdp=2`` takes
    the overlapped one."""
    import logging

    from tests.test_torch_scale_out import config_dict, reward_fn
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logging.getLogger("trlx_tpu_torch").addHandler(keep := Keep())
    out = {}
    try:
        for name, mesh, over in (("model2", dict(data=2, model=2), {}),
                                 ("healing", dict(data=2, fsdp=2), {"train.self_healing.enabled": True}),
                                 ("on", dict(data=2, fsdp=2), {})):
            cfg = TRLConfig.update(TRLConfig.from_dict(config_dict("ppo", mesh, f"{tmp}/{name}")),
                                   {"train.learner_overlap.enabled": True, **over})
            out[name] = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu").overlap
    finally:
        logging.getLogger("trlx_tpu_torch").removeHandler(keep)
    out["log"] = records
    return out


def _jax_overlap(tx, steps):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from trlx_tpu.parallel import fsdp as fsdp_lib
    from trlx_tpu.parallel.mesh import FSDP_AXIS, make_mesh, put_batch
    from trlx_tpu.parallel.sharding import shard_params

    rules = [(r".*dense/kernel$", P(FSDP_AXIS, None)), (r".*out/kernel$", P(None, FSDP_AXIS)), (r".*", P())]
    mesh = make_mesh(data=2, fsdp=2, model=1, pipe=1, devices=jax.devices()[:4])
    flat = _params()
    params = {"dense": {"kernel": jnp.asarray(flat["dense.kernel"]), "bias": jnp.asarray(flat["dense.bias"])},
              "out": {"kernel": jnp.asarray(flat["out.kernel"])}}

    def loss_fn(p, mb):
        h = jnp.tanh(mb["x"] @ p["dense"]["kernel"] + p["dense"]["bias"])
        loss = jnp.mean(jnp.square(h @ p["out"]["kernel"] - mb["y"]))
        return loss, {"loss": loss}

    specs = fsdp_lib.make_overlap_specs(params, tx, mesh, rules)
    sp = shard_params(params, mesh, rules)
    state = fsdp_lib.make_sharded_opt_init(tx, specs, mesh)(sp)
    step = fsdp_lib.make_overlapped_grad_accum_step(
        loss_fn, tx, specs, mesh, num_mb=4, max_grad_norm=1.0, lr_schedule=lambda c: jnp.float32(LR), donate=False)
    stats = []
    for _ in range(steps):
        sp, state, s = step(sp, state, put_batch(mesh, _batch()))
        stats.append({k: float(v) for k, v in s.items()})
    p = jax.device_get(sp)
    return stats, {"dense.kernel": np.asarray(p["dense"]["kernel"]), "dense.bias": np.asarray(p["dense"]["bias"]),
                   "out.kernel": np.asarray(p["out"]["kernel"])}


def test_overlap_step_matches_jax_and_the_gate_falls_back(tmp_path):
    import optax

    from trlx_tpu.ops.quantized_adam import adamw_8bit

    jobs = [("tests.test_torch_learner_overlap:overlap_steps", dict(opt_name="adamw", steps=2)),
            ("tests.test_torch_learner_overlap:overlap_steps", dict(opt_name="adamw_8bit_bnb", steps=2)),
            ("tests.test_torch_learner_overlap:overlap_gate", dict(tmp=str(tmp_path / "gate")))]
    handle = run_ranks(4, jobs, tmp_path / "ranks", wait=False)
    try:
        want = {"adamw": _jax_overlap(optax.adamw(LR, weight_decay=0.0), 2),
                "adamw_8bit_bnb": _jax_overlap(adamw_8bit(LR, weight_decay=0.0), 2)}
    finally:
        ranks = handle.results()
    for j, name in enumerate(("adamw", "adamw_8bit_bnb")):
        jstats, jparams = want[name]
        got = ranks[0][j]
        for r in ranks[1:]:
            assert r[j]["stats"] == got["stats"]
        for js, ps in zip(jstats, got["stats"]):
            assert set(js) == set(ps) == {"loss", "learning_rate_group_0"}
            for key in js:
                np.testing.assert_allclose(ps[key], js[key], rtol=1e-4, atol=1e-6, err_msg=f"{name} {key}")
        for key, value in jparams.items():
            np.testing.assert_allclose(got["params"][key], value, rtol=1e-5, atol=1e-5, err_msg=f"{name} {key}")
        # ZeRO: each rank holds half of each fsdp-sharded leaf's optimizer state
        state = got["state"]
        if name == "adamw":
            assert state["dense.kernel"]["exp_avg"] == (8, 8) and state["out.kernel"]["exp_avg_sq"] == (8, 2)
            assert state["dense.bias"]["exp_avg"] == (8,)
        else:  # 64 elements of the local shard: one 256-wide block
            assert state["dense.kernel"]["m_q"] == (1, 256) and state["out.kernel"]["v_q"] == (1, 256)
    gate = ranks[0][2]
    assert gate["model2"] is False and gate["healing"] is False and gate["on"] is True
    log = "\n".join(gate["log"])
    assert "train.learner_overlap requires a pure data/fsdp mesh (model=1, pipe=1)" in log
    assert "incompatible with the self-healing health guard" in log
    assert "learner_overlap: overlapped FSDP step active" not in log  # the step is built at the first train step
