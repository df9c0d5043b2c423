"""Scale-out parity under peft: the port's PPO with LoRA, prefix and prompt
tuning on ``data=2 x model=2`` (4 gloo ranks) against the JAX package's
trainers on a mesh of the same shape, from the same initial parameters (the
adapters drawn non-zero from a seed), with the checks of
:mod:`tests.test_torch_scale_out`: experience within 1e-4, step stats within
rtol 1e-3, gathered parameters within 1e-5, every rank's stats ``==``.
Under peft the trunk holds no optimizer state and stays equal to its
initial weights. ``fsdp=2`` is :mod:`tests.test_torch_scale_out_peft_fsdp`;
T5 LoRA and the offloaded reference are
:mod:`tests.test_torch_scale_out_offload`.

The trainers of a shape run as jobs of one spawned rank group, while the
JAX trainers run here.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import run_ranks
from tests.test_torch_scale_out import _drive, compare, jax_trainer

pytestmark = pytest.mark.torch_port

PEFT = {
    "lora": {"peft_type": "LORA", "r": 4, "lora_alpha": 8},
    "prefix": {"peft_type": "PREFIX_TUNING", "num_virtual_tokens": 3},
    "prompt": {"peft_type": "PROMPT_TUNING", "num_virtual_tokens": 3},
}
T5_DIMS = dict(vocab_size=12, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2, num_heads=4,
               relative_attention_num_buckets=8, decoder_start_token_id=1)
T5_MODEL = {"model.model_path": "t5", "model.model_arch_type": "seq2seq", "model.model_overrides": T5_DIMS}
ADAPTER_NAMES = ("lora_a", "lora_b", "prefix_k", "prefix_v", "prompt_embeddings")


def peft_patch(kind, t5=False):
    patch = {"model.peft_config": PEFT[kind]}
    return {**patch, **T5_MODEL} if t5 else patch


def probe(trainer):
    """What a run's ranks report besides the stats: the trunk's tensors
    (peft), the adapter export's bytes, the reference's host bytes."""
    from trlx_tpu_torch.models.hf_loading import ADAPTERS_FILE

    out = {"ref_host_bytes": getattr(trainer, "ref_host_bytes", None),
           "ref_uploads": getattr(trainer, "ref_uploads", None)}
    if trainer.config.model.peft_config:
        out_dir = os.path.join(trainer.config.train.checkpoint_dir, "export")
        trainer.save_pretrained(out_dir)
        if trainer.is_main_process:
            with open(os.path.join(out_dir, ADAPTERS_FILE), "rb") as f:
                out["adapters"] = f.read()
        named = dict(trainer.model.named_parameters())
        trained = {id(p) for p in trainer.trainable_params}
        out["trunk_frozen"] = all(
            id(trainer.shards.by_param[id(p)].master if trainer.shards else p) not in trained
            for n, p in named.items() if n.split(".", 1)[0] in ("transformer", "t5")
            and n.rsplit(".", 1)[-1] not in ADAPTER_NAMES)
    if trainer.ref_host_bytes is not None:
        out["ref_host_shapes"] = {leaf.name: tuple(leaf.host.shape) for leaf in trainer.shards.leaves
                                  if leaf.host is not None}
    return out


def one_rank_adapters(params, patch, tmp):
    """The adapter file a one-rank trainer exports for ``params``."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.models.hf_loading import ADAPTERS_FILE
    from trlx_tpu_torch.utils.loading import get_trainer

    from tests.test_torch_scale_out import config_dict, reward_fn

    cfg = TRLConfig.from_dict(config_dict("ppo", dict(data=1), tmp, patch=patch))
    trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu")
    trainer.load_full_params({k: torch.from_numpy(v) for k, v in params.items()})
    trainer.save_pretrained(str(tmp / "export"))
    with open(tmp / "export" / ADAPTERS_FILE, "rb") as f:
        return f.read()


def _job(kind, mesh, init, ckpt, patch, overrides=None):
    return ("tests.test_torch_scale_out:port_train",
            dict(kind=kind, mesh=mesh, init=init, ckpt_dir=str(ckpt), patch=patch, overrides=overrides,
                 probe="tests.test_torch_scale_out_peft:probe"))


def t5_noise_leaves(params):
    """The leaves of the T5 decoder's self-attention weights (query and key
    kernels and adapters, the relative bias): with greedy responses of one
    repeated token every value row of a decoder self-attention is the same,
    so the attention weights do not reach its output and their gradient is
    zero up to rounding (about 1e-9 here, on one rank and one device as
    well)."""
    return {n for n in params if n.startswith("t5.decoder_blocks_")
            and any(f".self_attn.{leaf}" in n for leaf in ("q.", "k.", "relative_attention_bias."))}


def _drive_jax(jts):
    """Drive the JAX trainers (while the ranks work): their records by key."""
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline

    return {key: _drive(jt, "ppo", JaxPipeline) for key, jt in jts.items()}


def _check_peft(name, jt, jrec, ranks, init, one=None):
    compare("ppo", jrec, jt, ranks, noise=t5_noise_leaves(ranks[0]["params"]))
    params = ranks[0]["params"]
    assert all(r["probe"]["trunk_frozen"] for r in ranks), name
    trunk = [n for n in params if n.split(".", 1)[0] in ("transformer", "t5")
             and n.rsplit(".", 1)[-1] not in ADAPTER_NAMES]
    assert trunk
    for n in trunk:  # the trunk stays at its initial weights
        np.testing.assert_array_equal(params[n], init[n], err_msg=n)
    if one is not None:  # the export's adapter file is the one a one-rank trainer writes for these weights
        assert ranks[0]["probe"]["adapters"] == one


@pytest.fixture(scope="module")
def d2m2(tmp_path_factory):
    """LoRA, prefix and prompt PPO on data=2 x model=2: the JAX trainers
    here, the port's 4 ranks meanwhile."""
    tmp = tmp_path_factory.mktemp("peft_d2m2")
    mesh = dict(data=2, model=2)
    jts, inits, jobs = {}, {}, []
    for kind in PEFT:
        jts[kind], inits[kind] = jax_trainer("ppo", mesh, 4, tmp / f"jax_{kind}", peft_patch(kind))
        jobs.append(_job("ppo", mesh, inits[kind], tmp / f"port_{kind}", peft_patch(kind)))
    handle = run_ranks(4, jobs, tmp / "ranks", wait=False)
    try:
        jrecs = _drive_jax(jts)
        results = handle.results()
    finally:
        handle.kill()
    yield jts, jrecs, inits, results


@pytest.mark.parametrize("kind", list(PEFT))
def test_ppo_peft_matches_jax_on_data2_model2(d2m2, kind):
    jts, jrecs, inits, results = d2m2
    ranks = [r[list(PEFT).index(kind)] for r in results]
    _check_peft(kind, jts[kind], jrecs[kind], ranks, inits[kind])


