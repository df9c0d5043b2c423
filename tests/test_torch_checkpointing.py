"""The port's native pre-converted store (:mod:`trlx_tpu_torch.checkpointing`
and its codecs, :mod:`trlx_tpu_torch.store`) against the JAX package's
(``trlx_tpu/checkpointing.py``, orbax and tensorstore), mirroring
``tests/test_checkpointing.py`` case by case:

- a store the JAX package wrote reads in the port bit for bit (f32 and
  bf16), and one the port wrote reads in ``trlx_tpu.checkpointing.
  restore_native`` bit for bit, compressed or not (the writer without
  libzstd); ``native_config.json`` and ``inspect``'s output are the same
  bytes in both packages;
- every rank's blocks on ``data=2, fsdp=2, model=2`` equal the JAX arrays'
  ``addressable_shards`` on the device with the same coordinates, reading
  only the chunks they overlap;
- the refusals (a newer format, a seq2seq mismatch, an unknown override,
  missing weights without ``--allow-random``), tuple fields, a T5 store;
- (in :mod:`tests.test_torch_checkpointing_trainers`) a 2-rank PPO from a
  store, and SFT with ``scan_layers`` from a store, against the JAX
  trainers on the same mesh;
- CRC-32C against RFC 3720's test vectors and every OCDBT footer.
"""

import json
import struct

import numpy as np
import pytest
import torch

import jax

from trlx_tpu import checkpointing as jax_ckpt
from trlx_tpu_torch import checkpointing as port_ckpt
from trlx_tpu_torch.models.convert import _flatten

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=32, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=32)


def _np(tree):
    return {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, tree)).items()}


def _bits(x):
    """An array's raw bits (bf16 included) for bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes() if x.dim() else x.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _same(port_state, jax_tree):
    want = _np(jax_tree)
    assert set(port_state) == set(want)
    for name, t in port_state.items():
        assert tuple(t.shape) == want[name].shape, name
        assert _bits(t) == _bits(want[name]), name


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from tests.test_hf_parity import make_hf_model

    path = tmp_path_factory.mktemp("hf_gpt2")
    make_hf_model("gpt2").save_pretrained(path)
    return str(path)


@pytest.fixture(scope="module")
def stores(hf_dir, tmp_path_factory):
    """The same HF checkpoint converted by both packages, through their CLIs."""
    root = tmp_path_factory.mktemp("stores")
    jax_ckpt.main(["convert", hf_dir, str(root / "jax")])
    port_ckpt.main(["convert", hf_dir, str(root / "port")])
    return {"jax": str(root / "jax"), "port": str(root / "port")}


def test_convert_writes_metadata_byte_identical(stores):
    meta = port_ckpt.load_native_config(stores["port"])
    assert meta["model_type"] == "gpt2" and meta["format_version"] == 1 and meta["config"]["hidden_size"] == 32
    with open(f"{stores['port']}/{port_ckpt.NATIVE_CONFIG}", "rb") as a, \
            open(f"{stores['jax']}/{jax_ckpt.NATIVE_CONFIG}", "rb") as b:
        assert a.read() == b.read()


def test_stores_cross_read_bit_for_bit(stores):
    for path in stores.values():  # each package reads both stores, to the same bits
        _, want, jtype = jax_ckpt.restore_native(path)
        config, state, ptype = port_ckpt.restore_native(path)
        assert ptype == jtype == "gpt2" and config.hidden_size == 32
        _same(state, want)
    _, a, _ = port_ckpt.restore_native(stores["port"])
    _, b, _ = port_ckpt.restore_native(stores["jax"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_load_pretrained_roundtrips_through_native(hf_dir, stores):
    from trlx_tpu_torch.models.hf_loading import load_pretrained
    from trlx_tpu_torch.models.transformer import TransformerLM

    config_hf, state_hf, type_hf = load_pretrained(hf_dir, {"compute_dtype": "float32"})
    config_nat, state_nat, type_nat = load_pretrained(stores["port"], {"compute_dtype": "float32"})
    assert type_hf == type_nat == "gpt2" and config_nat.hidden_size == config_hf.hidden_size
    for name, value in state_hf.items():
        assert torch.equal(state_nat[name], value), name
    model = TransformerLM(config_nat)
    model.load_state_dict(state_nat)
    ids = torch.from_numpy(np.random.default_rng(0).integers(1, 61, (2, 8)))
    logits = model(ids, torch.ones_like(ids))[0]
    assert torch.isfinite(logits).all()


def test_restore_to_mesh_matches_addressable_shards(stores):
    """Each rank's blocks on data=2 x fsdp=2 x model=2 against the JAX
    restore's shard on the device at the same coordinates, both stores;
    a sharded rank reads fewer chunk bytes than a whole restore."""
    from trlx_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from trlx_tpu_torch.parallel.mesh import make_mesh

    jm = jax_make_mesh(data=2, fsdp=2, model=2)
    for path in stores.values():
        _, jparams, _ = jax_ckpt.restore_native(path, mesh=jm)
        flat = _flatten(jparams)
        assert any(not leaf.is_fully_replicated for leaf in flat.values())
        whole = {}
        port_ckpt.restore_native(path, stats=whole)
        for rank in range(8):
            m = make_mesh(data=2, fsdp=2, model=2, world_size=8, rank=rank, build_groups=False)
            dev = jm.devices[tuple(m.coords[a] for a in ("data", "fsdp", "pipe", "model"))]
            stats = {}
            _, state, _ = port_ckpt.restore_native(path, mesh=m, stats=stats)
            for name, arr in flat.items():
                shard = {s.device.id: s.data for s in arr.addressable_shards}[dev.id]
                assert tuple(state[name].shape) == shard.shape, name
                assert _bits(state[name]) == _bits(np.asarray(shard)), name
            assert 0 < stats["bytes_read"] <= whole["bytes_read"]
            if path == stores["port"]:  # the port's chunk grid: a rank reads a share of the store
                assert stats["bytes_read"] < whole["bytes_read"]


def test_jax_restores_port_store_onto_mesh(stores):
    from trlx_tpu.parallel.mesh import make_mesh as jax_make_mesh

    _, params, _ = jax_ckpt.restore_native(stores["port"], mesh=jax_make_mesh(data=2, fsdp=2, model=2))
    _, host, _ = port_ckpt.restore_native(stores["port"])
    _same(host, params)


def test_arch_mismatch_and_unknown_override_raise(stores):
    with pytest.raises(ValueError, match="causal"):
        port_ckpt.restore_native(stores["port"], expect_seq2seq=True)
    with pytest.raises(TypeError, match="Unknown config override"):
        port_ckpt.restore_native(stores["port"], {"hidden_sizee": 64})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_convert_dtype_cast(hf_dir, tmp_path, writer):
    """A bf16 store from either package reads in both, bit for bit."""
    out = str(tmp_path / "bf16")
    (port_ckpt if writer == "port" else jax_ckpt).convert_hf_to_native(hf_dir, out, dtype="bfloat16")
    _, state, _ = port_ckpt.restore_native(out)
    assert {t.dtype for t in state.values()} == {torch.bfloat16}
    _, params, _ = jax_ckpt.restore_native(out)
    _same(state, params)


def test_uncompressed_store_reads_in_both(hf_dir, tmp_path):
    """The writer without libzstd: ``compression: none`` in OCDBT and
    ``compressor: null`` in zarr, which orbax and tensorstore read."""
    from trlx_tpu_torch.models.hf_loading import load_pretrained
    from trlx_tpu_torch.store import ocdbt

    config, state, model_type = load_pretrained(hf_dir)
    port_ckpt.save_native(str(tmp_path), state, config, model_type, hf_dir, compress=False)
    assert ocdbt.read_manifest(str(tmp_path / "params"))["config"]["compression"] == ocdbt.NO_COMPRESSION
    meta = json.loads(ocdbt.read_database(str(tmp_path / "params"))["embed_tokens.embedding/.zarray"])
    assert meta["compressor"] is None
    _, params, _ = jax_ckpt.restore_native(str(tmp_path))
    _same(state, params)


def test_missing_libzstd_raises_naming_it(stores, monkeypatch):
    from trlx_tpu_torch.store import zstd

    monkeypatch.setattr(zstd, "_LIB", None)
    monkeypatch.setattr(zstd, "_LOAD_ERROR", "not found")
    assert not zstd.available()
    with pytest.raises(zstd.ZstdUnavailable, match="libzstd.so.1"):
        port_ckpt.restore_native(stores["jax"])


def test_inspect_cli_output_identical(stores, capsys):
    port_ckpt.main(["inspect", stores["port"]])
    ours = capsys.readouterr().out
    jax_ckpt.main(["inspect", stores["jax"]])
    assert ours == capsys.readouterr().out
    assert "gpt2" in ours and "hidden_size" in ours


def test_convert_missing_weights_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="allow-random"):
        port_ckpt.convert_hf_to_native("gpt2", str(tmp_path / "out"))
    with pytest.raises(FileNotFoundError, match="seq2seq"):
        port_ckpt.convert_hf_to_native("t5", str(tmp_path / "t5"), seq2seq=True)
    out = port_ckpt.convert_hf_to_native("gpt2", str(tmp_path / "out2"), allow_random=True, overrides=TINY)
    cfg, state, model_type = port_ckpt.restore_native(out)
    assert model_type == "gpt2" and state and cfg.num_layers == 2
    _, params, _ = jax_ckpt.restore_native(out)
    _same(state, params)


def test_restore_rejects_newer_format_version(tmp_path):
    out = port_ckpt.convert_hf_to_native("gpt2", str(tmp_path / "out"), allow_random=True, overrides=TINY)
    meta = port_ckpt.load_native_config(out)
    meta["format_version"] = port_ckpt.FORMAT_VERSION + 1
    with open(out + "/" + port_ckpt.NATIVE_CONFIG, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="format_version"):
        port_ckpt.restore_native(out)


def test_native_config_tuple_fields_roundtrip(tmp_path):
    out = port_ckpt.convert_hf_to_native("gpt2", str(tmp_path / "out"), allow_random=True,
                                         overrides=dict(TINY, lora_r=2, lora_targets=("q_proj", "v_proj")))
    cfg, _, _ = port_ckpt.restore_native(out)
    assert cfg.lora_targets == ("q_proj", "v_proj") and isinstance(cfg.lora_targets, tuple)
    jcfg, _, _ = jax_ckpt.restore_native(out)
    assert jcfg.lora_targets == cfg.lora_targets


def test_t5_store(tmp_path):
    """A T5 store from an HF T5 directory: written by the port, read by both
    packages bit for bit, and the other way round; the T5 loader restores it."""
    import transformers

    from trlx_tpu_torch.models.hf_loading import load_pretrained_seq2seq

    torch.manual_seed(0)
    hf = transformers.T5ForConditionalGeneration(transformers.T5Config(
        vocab_size=48, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2, num_heads=4,
        relative_attention_num_buckets=8, dropout_rate=0.0, tie_word_embeddings=True))
    hf.save_pretrained(tmp_path / "hf")
    for writer in (port_ckpt, jax_ckpt):
        out = writer.convert_hf_to_native(str(tmp_path / "hf"), str(tmp_path / writer.__name__), seq2seq=True)
        _, state, model_type = port_ckpt.restore_native(out, expect_seq2seq=True)
        _, params, _ = jax_ckpt.restore_native(out, expect_seq2seq=True)
        assert model_type == "t5"
        _same(state, params)
        config, loaded = load_pretrained_seq2seq(out)
        assert config.d_model == 32 and all(torch.equal(loaded[k], state[k]) for k in state)
    with open(f"{tmp_path}/trlx_tpu_torch.checkpointing/{port_ckpt.NATIVE_CONFIG}", "rb") as a, \
            open(f"{tmp_path}/trlx_tpu.checkpointing/{jax_ckpt.NATIVE_CONFIG}", "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="seq2seq"):
        port_ckpt.restore_native(str(tmp_path / "trlx_tpu_torch.checkpointing"), expect_seq2seq=False)


def test_crc32c_vectors_and_ocdbt_footers(stores):
    """RFC 3720 appendix B.4's CRC-32C vectors, and every manifest and
    node footer of both stores."""
    import glob
    import os

    from trlx_tpu_torch.store.crc32c import crc32c

    assert crc32c(bytes(32)) == 0x8A9136AA
    assert crc32c(b"\xff" * 32) == 0x62A8AB43
    assert crc32c(bytes(range(32))) == 0x46DD794E
    assert crc32c(bytes(range(31, -1, -1))) == 0x113FDB5C
    assert crc32c(b"123456789") == 0xE3069283
    checked = 0
    for path in stores.values():
        for f in glob.glob(os.path.join(path, "params", "**", "*"), recursive=True):
            if not os.path.isfile(f):
                continue
            with open(f, "rb") as fh:
                data = fh.read()
            if len(data) >= 18 and struct.unpack(">I", data[:4])[0] in (0x0CDB3A2A, 0x0CDB20DE) \
                    and struct.unpack("<Q", data[4:12])[0] == len(data):
                assert crc32c(data[:-4]) == struct.unpack("<I", data[-4:])[0], f
                checked += 1
    assert checked >= 4
