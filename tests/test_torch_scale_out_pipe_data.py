"""Scale-out parity of the stacked layouts on larger meshes: PPO and SFT on
``data=2 x pipe=2`` (the checks of :mod:`tests.test_torch_scale_out_pipe`)
and a ``scan_layers`` SFT on ``fsdp=2 x model=2`` (the stacked layout on a
mesh without a pipe axis: ZeRO storage of ``[L, ...]`` leaves, tensor
parallelism over each layer's views) against the JAX trainers on meshes of
the same shapes.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import run_ranks
from tests.test_torch_scale_out import compare
from tests.test_torch_scale_out_pipe import check, pipe_fixture

pytestmark = pytest.mark.torch_port

data2_pipe2 = pipe_fixture(dict(data=2, pipe=2), 4, ("ppo", "sft"))


@pytest.mark.parametrize("kind", ["ppo", "sft"])
def test_trainers_match_jax_on_data2_pipe2(data2_pipe2, kind):
    check(data2_pipe2, kind)


@pytest.fixture(scope="module")
def scan_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scan_fsdp_model")
    mesh = dict(fsdp=2, model=2)
    over = {"model.model_overrides": _scan_overrides()}
    jt, init = jax_trainer_scan(mesh, tmp / "jax")
    handle = run_ranks(4, [("tests.test_torch_scale_out:port_train",
                            dict(kind="sft", mesh=mesh, init=init, ckpt_dir=str(tmp / "port"), overrides=over))],
                       tmp / "ranks", wait=False)
    yield jt, handle
    handle.kill()


def _scan_overrides():
    from tests.test_torch_scale_out import config_dict

    return dict(config_dict("sft", {}, "")["model"]["model_overrides"], scan_layers=True)


def jax_trainer_scan(mesh, ckpt_dir):
    """The JAX SFT trainer with ``scan_layers`` on ``mesh`` (4 devices) and
    its initial parameters in the port's names."""
    import jax

    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer
    from tests.test_torch_scale_out import config_dict, jax_mesh_of
    from trlx_tpu_torch.models.convert import params_from_jax
    from trlx_tpu_torch.models.presets import PRESETS

    d = config_dict("sft", mesh, ckpt_dir)
    d["model"]["model_overrides"] = _scan_overrides()
    with jax_mesh_of(4):
        jt = jax_get_trainer("SFTTrainer")(config=JaxConfig.from_dict(d))
    params = jax.tree.map(np.asarray, jax.device_get(jt.params))
    cfg = PRESETS["gpt2"].replace(**d["model"]["model_overrides"], compute_dtype=torch.float32)
    init = {f"transformer.{k}": v.numpy() for k, v in params_from_jax(params["transformer"], cfg).items()}
    return jt, init


def test_scan_layers_sft_matches_jax_on_fsdp2_model2(scan_runs):
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from tests.test_torch_scale_out import _drive

    jt, handle = scan_runs
    jrec = _drive(jt, "sft", JaxPipeline)
    ranks = [r[0] for r in handle.results()]
    compare("sft", jrec, jt, ranks)
    assert any(k.startswith("transformer.layers_scan.") for k in ranks[0]["params"])
