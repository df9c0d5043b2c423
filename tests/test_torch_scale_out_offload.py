"""Scale-out parity for T5 LoRA PPO on ``model=2`` and for
``model.offload_ref`` PPO on ``fsdp=2`` (2 gloo ranks), against the JAX
package's trainers on meshes of the same shape (the checks of
:mod:`tests.test_torch_scale_out_peft`). The offloaded reference scores
``==`` a resident sharded one from the same weights, and each rank's host
copy is its fsdp blocks of the reference, no more.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import run_ranks
from tests.test_torch_scale_out import compare, jax_trainer
from tests.test_torch_scale_out_peft import _check_peft, _drive_jax, _job, peft_patch

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("offload")
    jts, inits = {}, {}
    jts["t5_lora"], inits["t5_lora"] = jax_trainer("ppo", dict(model=2), 2, tmp / "jax_t5", peft_patch("lora", True))
    jts["offload"], inits["offload"] = jax_trainer("ppo", dict(fsdp=2), 2, tmp / "jax_offload",
                                                   {"model.offload_ref": True})
    jobs = [_job("ppo", dict(model=2), inits["t5_lora"], tmp / "port_t5", peft_patch("lora", True))]
    jobs += [_job("ppo", dict(fsdp=2), inits["offload"], tmp / f"offload_{offload}", {"model.offload_ref": offload})
             for offload in (True, False)]
    handle = run_ranks(2, jobs, tmp / "ranks", wait=False)
    try:
        jrecs = _drive_jax(jts)
        results = handle.results()
    finally:
        handle.kill()
    yield jts, jrecs, inits, results


def test_t5_lora_ppo_matches_jax_on_model2(runs):
    jts, jrecs, inits, results = runs
    _check_peft("t5_lora", jts["t5_lora"], jrecs["t5_lora"], [r[0] for r in results], inits["t5_lora"])


def test_offload_ref_on_fsdp2_matches_jax_and_the_resident_reference(runs):
    from trlx_tpu_torch.parallel.mesh import make_mesh
    from trlx_tpu_torch.parallel.sharding import make_param_specs, shard_tensor

    jts, jrecs, inits, results = runs
    off, res = [r[1] for r in results], [r[2] for r in results]
    compare("ppo", jrecs["offload"], jts["offload"], off)
    for o, r in zip(off, res):
        assert o["phases"] and len(o["phases"]) == len(r["phases"])
        for po, pr in zip(o["phases"], r["phases"]):  # scoring == the resident sharded reference
            for eo, er in zip(po, pr):
                for a, b in zip(eo, er):
                    np.testing.assert_array_equal(a, b)
        assert o["steps"] == r["steps"]
        assert o["probe"]["ref_uploads"] >= 1 and r["probe"]["ref_host_bytes"] is None
    # each rank's host copy is its fsdp blocks of the reference, and no more
    shapes = {k: v.shape for k, v in off[0]["params"].items()}
    specs = make_param_specs(shapes, make_mesh(fsdp=2, world_size=2, rank=0, build_groups=False))
    for rank, o in enumerate(off):
        host = o["probe"]["ref_host_shapes"]
        m = make_mesh(fsdp=2, world_size=2, rank=rank, build_groups=False)
        assert host and all(name.startswith("ref_model.") for name in host)
        for name, shape in host.items():
            trunk = "transformer." + name[len("ref_model."):]
            assert shape == tuple(shard_tensor(torch.zeros(shapes[trunk]), specs[trunk], m).shape), name
        assert o["probe"]["ref_host_bytes"] == sum(4 * int(np.prod(s)) for s in host.values())
        whole = sum(4 * int(np.prod(shapes["transformer." + n[len("ref_model."):]])) for n in host)
        assert o["probe"]["ref_host_bytes"] < whole
