"""Scale-out parity under peft on ``fsdp=2`` (2 gloo ranks): the port's PPO
with LoRA, prefix and prompt tuning against the JAX package's trainers on a
mesh of the same shape, with the checks of
:mod:`tests.test_torch_scale_out_peft`; the exported adapter file is the
one a one-rank trainer exports for the same weights.
"""

import pytest

from tests.test_torch_mesh import run_ranks
from tests.test_torch_scale_out import jax_trainer
from tests.test_torch_scale_out_peft import PEFT, _check_peft, _drive_jax, _job, one_rank_adapters, peft_patch

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def fsdp2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("peft_fsdp2")
    jts, inits, jobs = {}, {}, []
    for kind in PEFT:
        jts[kind], inits[kind] = jax_trainer("ppo", dict(fsdp=2), 2, tmp / f"jax_{kind}", peft_patch(kind))
        jobs.append(_job("ppo", dict(fsdp=2), inits[kind], tmp / f"port_{kind}", peft_patch(kind)))
    handle = run_ranks(2, jobs, tmp / "ranks", wait=False)
    try:
        jrecs = _drive_jax(jts)
        results = handle.results()
    finally:
        handle.kill()
    yield tmp, jts, jrecs, inits, results


@pytest.mark.parametrize("kind", list(PEFT))
def test_ppo_peft_matches_jax_on_fsdp2(fsdp2, kind):
    tmp, jts, jrecs, inits, results = fsdp2
    ranks = [r[list(PEFT).index(kind)] for r in results]
    adapters = one_rank_adapters(ranks[0]["params"], peft_patch(kind), tmp / f"export_{kind}")
    _check_peft(kind, jts[kind], jrecs[kind], ranks, inits[kind], adapters)
