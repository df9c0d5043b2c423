"""Scale-out parity for T5: the port's seq2seq PPO (with the decoder-top
hydra branch, ``num_layers_unfrozen=1``), ILQL and SFT trainers on
``model=2`` (heads, the relative bias's head columns, the vocab-parallel
tied head; 2 gloo ranks; ``fsdp=2`` is
:mod:`tests.test_torch_scale_out_t5_fsdp`), against the JAX package's
trainers on a mesh of the same shape, with the checks of
:mod:`tests.test_torch_scale_out` at T5's tiny width (``d_model`` 32,
2 + 2 layers). T5 attention runs on no kernel in either package.

T5's parameters after two steps are more sensitive to summation order than
the causal model's: the JAX package's run on ``model=2`` differs from the
port's one-rank run of the same weights by more than 1e-5 in some elements
(ILQL's encoder value kernel, for one; so does its own one-device run). So
each parameter is held to 1e-5 plus twice that difference, elementwise: a
fault of the sharded path would move the port's two ranks far past its
own one rank.
"""

import numpy as np
import pytest

from tests.test_torch_mesh import run_ranks
from tests.test_torch_scale_out import _drive, compare, jax_params_in_port_names, jax_trainer, port_train
from tests.test_torch_scale_out_peft import T5_MODEL, t5_noise_leaves

pytestmark = pytest.mark.torch_port

KINDS = ("ppo", "ilql", "sft")
PATCH = {"ppo": {**T5_MODEL, "model.num_layers_unfrozen": 1}, "ilql": T5_MODEL, "sft": T5_MODEL}
MESHES = {"model2": dict(model=2), "fsdp2": dict(fsdp=2)}


def shape_fixture(shape):
    """A module fixture for one shape: its JAX trainers here, the port's
    rank group meanwhile, and the port's one-rank runs from the same
    weights (the slack's other side)."""

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline

        tmp = tmp_path_factory.mktemp(f"t5_{shape}")
        jts, inits, jobs = {}, {}, []
        for kind in KINDS:
            jts[kind], inits[kind] = jax_trainer(kind, MESHES[shape], 2, tmp / f"jax_{kind}", PATCH[kind])
            jobs.append(("tests.test_torch_scale_out:port_train",
                         dict(kind=kind, mesh=MESHES[shape], init=inits[kind], ckpt_dir=str(tmp / f"port_{kind}"),
                              patch=PATCH[kind])))
        handle = run_ranks(2, jobs, tmp / "ranks", wait=False)
        try:
            ones = {kind: port_train(kind, dict(data=1), inits[kind], str(tmp / f"one_{kind}"), patch=PATCH[kind])
                    for kind in KINDS}
            jrecs = {kind: _drive(jt, kind, JaxPipeline) for kind, jt in jts.items()}
            results = handle.results()
        finally:
            handle.kill()
        yield jts, jrecs, results, ones

    return runs


def check_kind(runs, kind):
    jts, jrecs, results, ones = runs
    ranks = [r[KINDS.index(kind)] for r in results]
    jt, jrec = jts[kind], jrecs[kind]
    mesh_p = jax_params_in_port_names(jt)
    slack = {n: 2 * np.abs(mesh_p[n] - v) for n, v in ones[kind]["params"].items()}
    # greedy PPO rollouts of a random T5 repeat one token (the noise leaves' docstring); SFT's and
    # ILQL's decoder tokens vary, so their decoder leaves are held as every other leaf
    noise = t5_noise_leaves(ranks[0]["params"]) if kind == "ppo" else set()
    compare(kind, jrec, jt, ranks, noise=noise, slack=slack)
    if kind == "ppo":
        assert jt.branch_start == 1
    if kind != "sft":
        assert ranks[0]["results"] == jrec["results"]


model2 = shape_fixture("model2")


@pytest.mark.parametrize("kind", KINDS)
def test_t5_trainers_match_jax_on_model2(model2, kind):
    check_kind(model2, kind)
