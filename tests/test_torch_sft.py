"""Port parity for supervised fine-tuning: trlx_tpu_torch's ``SFTTrainer``
against trlx_tpu's on the tiny config of ``test_torch_trainer.py`` (2
layers, hidden 32, char tokenizer, f32, flash attention — the JAX kernels in
interpret mode, the port's plain versions), from the same initial weights
carried across with ``params_from_jax``. Three optimizer steps in two
microbatches, one of them on a 3-row batch padded to 4 with a fully masked
row; every step's stats within rtol 1e-3, atol 1e-5. Also the pieces the
trainer rests on: ``tokenize_dialogue`` (identical messages for strings and
dialogues, left and right truncation, the bos re-insert), ``DialogStore``
(identical collated arrays) and the shuffled loader (identical order).
"""

import numpy as np
import pytest
import torch

import jax

from trlx_tpu_torch.models.convert import params_from_jax

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
SAMPLES = [
    ["ab", "cd ef"], "hhh a", ["gh", "a b c"], "bad cafe", ["e", "fg ab"], "dead beef", ["a", "bb"],
]
STAT_TOL = dict(rtol=1e-3, atol=1e-5)


def _config_dict(tmp_path, **train):
    return dict(
        method=dict(name="SFTConfig", gen_kwargs=dict(max_new_tokens=4, do_sample=False)),
        train=dict(
            seq_length=12, epochs=4, total_steps=3, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="SFTTrainer", tracker=None, seed=3, save_best=False,
            **train,
        ),
        model=dict(
            model_path="gpt2", num_layers_unfrozen=-1,
            model_overrides=dict(
                vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=64, attention_impl="flash",
            ),
        ),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4,
                                                  max_grad_norm=1.0)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    )


@pytest.fixture
def single_device_mesh(monkeypatch):
    """Pin JAX trainer meshes to the first of conftest's 8 virtual CPU devices."""
    from trlx_tpu.parallel import mesh as mesh_lib

    real = mesh_lib.make_mesh
    monkeypatch.setattr(
        mesh_lib, "mesh_from_config",
        lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]),
    )


def _drive(trainer, steps=3):
    """make_experience, prepare_learning, then ``steps`` optimizer steps
    over the shuffled epochs (the learn loop's order); returns the stats and
    each step's collated batch."""
    trainer.make_experience(SAMPLES, trainer.config.train.seq_length)
    trainer.prepare_learning()
    stats, batches = [], []
    while len(stats) < steps:
        for batch in trainer.create_train_dataloader():
            batches.append({k: np.asarray(v) for k, v in batch.items()})
            stats.append(trainer.train_step(batch))
            if len(stats) == steps:
                break
    return stats, batches


def test_sft_trainer_matches_jax(tmp_path, single_device_mesh):
    import trlx_tpu.methods  # noqa: F401  (registers SFTConfig)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    jt = jax_get_trainer("SFTTrainer")(config=JaxConfig.from_dict(_config_dict(tmp_path / "jax")))
    pt = get_trainer("SFTTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path / "port")), device="cpu")
    jparams = jax.tree.map(np.asarray, jax.device_get(jt.params))
    pt.model.transformer.load_state_dict(params_from_jax(jparams["transformer"], pt.model_config))

    jstats, jbatches = _drive(jt)
    pstats, pbatches = _drive(pt)
    # the second step's batch has 3 rows: padded to 4, one fully masked row
    assert [len(b["input_ids"]) for b in pbatches] == [4, 3, 4]
    for jb, pb in zip(jbatches, pbatches):
        for key in ("input_ids", "attention_mask", "labels"):
            np.testing.assert_array_equal(pb[key], jb[key])
    for i, (js, ps) in enumerate(zip(jstats, pstats)):
        assert set(js) == set(ps) == {"losses/loss", "learning_rate_group_0"}
        for key in js:
            np.testing.assert_allclose(ps[key], js[key], err_msg=f"step {i + 1} {key}", **STAT_TOL)
        assert np.isfinite(ps["losses/loss"])
    final = jax.tree.map(np.asarray, jax.device_get(jt.params))["transformer"]
    for name, value in params_from_jax(final, pt.model_config).items():
        np.testing.assert_allclose(pt.model.transformer.state_dict()[name].numpy(), value.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_train_with_samples_runs_sft(tmp_path):
    """``train(samples=...)`` dispatches to the SFT trainer: it learns,
    evaluates on bos prompts, writes its final checkpoint, and the loss
    falls on a repeated sample."""
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    cfg = TRLConfig.from_dict(_config_dict(tmp_path, **{}))
    cfg = TRLConfig.update(cfg, {"train.total_steps": 12, "train.epochs": 20})
    losses = []
    step = SFTTrainer.train_step

    def record(self, batch):
        out = step(self, batch)
        losses.append(out["losses/loss"])
        return out

    SFTTrainer.train_step = record
    try:
        trainer = trlx_tpu_torch.train(samples=["abc abc"] * 8, config=cfg, device="cpu")
    finally:
        SFTTrainer.train_step = step
    assert isinstance(trainer, SFTTrainer) and trainer.iter_count == 12
    assert len(trainer.eval_pipeline) == cfg.train.batch_size  # bos x batch
    assert losses[-1] < 0.8 * losses[0], losses
    assert (tmp_path / "ckpts" / "checkpoint_12" / "trainer.pt").exists()


def test_default_config_for_samples_is_sft(monkeypatch):
    """``config=None`` with ``samples`` picks the default SFT config."""
    import trlx_tpu_torch
    from trlx_tpu_torch import trlx as entry

    seen = {}

    def fake_get_trainer(name):
        seen["trainer"] = name
        raise RuntimeError("stop")

    monkeypatch.setattr(entry, "get_trainer", fake_get_trainer)
    with pytest.raises(RuntimeError, match="stop"):
        trlx_tpu_torch.train(samples=["ab"], device="cpu")
    assert seen["trainer"] == "SFTTrainer"


DIALOGUES = [
    "abc",
    "a b c d e f g h",
    ["ab", "cd"],
    ["abcdefgh", "hh"],  # the prompt is truncated away on the left
    ["a", "bcdefgh abcd"],
    ["ab", "c", "de", "fgh"],
    ["", "abcdefghabcdefgh"],
]


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("max_length", [3, 6, 11, 64])
def test_tokenize_dialogue_matches_jax(side, max_length):
    from trlx_tpu.pipeline.offline_pipeline import tokenize_dialogue as jax_tokenize
    from trlx_tpu.pipeline.tokenization import CharTokenizer as JaxChar

    from trlx_tpu_torch.pipeline.offline_pipeline import tokenize_dialogue
    from trlx_tpu_torch.pipeline.tokenization import CharTokenizer

    jtok, ptok = JaxChar(ALPHABET, truncation_side=side), CharTokenizer(ALPHABET, truncation_side=side)
    reinserted = 0
    for d in DIALOGUES:
        want = jax_tokenize(d, jtok, max_length)
        got = tokenize_dialogue(d, ptok, max_length)
        assert [(m.is_output, tuple(m.tokens)) for m in got] == [(m.is_output, tuple(m.tokens)) for m in want], d
        assert sum(len(m.tokens) for m in got) <= max(max_length, 1)
        reinserted += bool(got) and got[0].tokens == (ptok.bos_token_id,) and not isinstance(d, str)
    if side == "left" and max_length <= 6:
        assert reinserted  # the bos re-insert path ran


def test_dialog_store_and_loader_match_jax():
    """DialogStore collates identical arrays, and the shuffled loader visits
    them in the same order for the same seed, epoch after epoch."""
    from trlx_tpu.pipeline.offline_pipeline import DialogStore as JaxStore
    from trlx_tpu.pipeline.offline_pipeline import tokenize_dialogue as jax_tokenize
    from trlx_tpu.pipeline.tokenization import CharTokenizer as JaxChar

    from trlx_tpu_torch.pipeline.offline_pipeline import DialogStore, tokenize_dialogue
    from trlx_tpu_torch.pipeline.tokenization import CharTokenizer

    rng = np.random.default_rng(0)
    texts = ["".join(rng.choice(list(ALPHABET), int(rng.integers(1, 15)))) for _ in range(23)]
    samples = [[t[: len(t) // 2], t[len(t) // 2:]] if i % 2 else t for i, t in enumerate(texts)]
    jtok, ptok = JaxChar(ALPHABET), CharTokenizer(ALPHABET)
    js = JaxStore([jax_tokenize(s, jtok, 10) for s in samples], jtok)
    ps = DialogStore([tokenize_dialogue(s, ptok, 10) for s in samples], ptok)
    jl = js.create_loader(5, shuffle=True, seed=7)
    pl = ps.create_loader(5, shuffle=True, seed=7)
    for _epoch in range(3):
        jbatches, pbatches = list(jl), list(pl)
        assert len(jbatches) == len(pbatches) == 5
        for jb, pb in zip(jbatches, pbatches):
            assert set(jb) == set(pb) == {"input_ids", "attention_mask", "labels"}
            for key in jb:
                assert pb[key].dtype == jb[key].dtype
                np.testing.assert_array_equal(pb[key], jb[key])
        assert any((b["labels"] == -100).any() for b in pbatches)


def test_sft_loss_runs_in_the_logits_dtype():
    """SFTConfig.loss takes log_softmax and the mask sum in the logits'
    dtype (bf16 in a bf16 run), as the JAX loss does; in f32 it equals the
    JAX loss."""
    import jax.numpy as jnp

    from trlx_tpu.methods.sft import SFTConfig as JaxSFT

    from trlx_tpu_torch.methods.sft import SFTConfig

    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 7))
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    want, _ = JaxSFT().loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    got, stats = SFTConfig().loss(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert stats["losses"]["loss"] is got
    bf16, _ = SFTConfig().loss(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels), torch.from_numpy(mask))
    assert bf16.dtype == torch.bfloat16
