"""Port parity for HF-format checkpoints: ``trlx_tpu_torch.models.hf_loading``
against ``trlx_tpu.models.hf_loading`` and against ``transformers`` /
``safetensors`` themselves, for the seven families the port runs (gpt2,
llama, gpt_neox, gptj, opt, gpt_bigcode, bloom) at the tiny sizes of
``test_hf_parity.py``, all in f32:

- a directory the JAX ``save_pretrained_hf`` wrote loads into the port with
  logits within 1e-5 of the JAX model's;
- a directory the port wrote loads back into the JAX ``load_pretrained``
  with logits within 1e-5, its ``config.json`` reads through
  ``transformers.AutoConfig`` and its weights through
  ``AutoModelForCausalLM`` (logits within 2e-3, the tolerance of
  ``test_hf_parity.py``);
- a ``config.json`` written by ``transformers`` (defaults left out), and a
  minimal one, give a port config equal to the JAX ``from_hf_config``'s,
  field by field;
- the port's safetensors writer gives the library's bytes and reads back
  through ``safetensors.safe_open``; its reader reads library-written
  single, sharded and ``pytorch_model.bin`` checkpoints;
- a bloom directory written by ``transformers`` loads to its logits, a
  native-store directory restores to the JAX restore's tensors, and the checkpoint path
  runs with ``transformers`` and ``safetensors`` blocked.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = ["gpt2", "llama", "gpt_neox", "gptj", "opt", "gpt_bigcode", "bloom"]
TINY = dict(vocab=61, hidden=32, layers=2, heads=4, positions=64)
LOGIT_TOL = dict(rtol=0, atol=1e-5)


def hf_config(family):
    """A tiny ``transformers`` config of ``family`` (test_hf_parity.py's)."""
    import transformers

    v, h, n, a, p = (TINY[k] for k in ("vocab", "hidden", "layers", "heads", "positions"))
    return {
        "gpt2": lambda: transformers.GPT2Config(vocab_size=v, n_embd=h, n_layer=n, n_head=a, n_positions=p),
        "llama": lambda: transformers.LlamaConfig(
            vocab_size=v, hidden_size=h, num_hidden_layers=n, num_attention_heads=a, num_key_value_heads=2,
            intermediate_size=3 * h, max_position_embeddings=p),
        "gpt_neox": lambda: transformers.GPTNeoXConfig(
            vocab_size=v, hidden_size=h, num_hidden_layers=n, num_attention_heads=a, intermediate_size=4 * h,
            max_position_embeddings=p, rotary_pct=0.25, use_parallel_residual=True),
        "gptj": lambda: transformers.GPTJConfig(
            vocab_size=v, n_embd=h, n_layer=n, n_head=a, n_positions=p, rotary_dim=4),
        "opt": lambda: transformers.OPTConfig(
            vocab_size=v, hidden_size=h, num_hidden_layers=n, num_attention_heads=a, ffn_dim=4 * h,
            max_position_embeddings=p, do_layer_norm_before=True, word_embed_proj_dim=h),
        "bloom": lambda: transformers.BloomConfig(vocab_size=v, hidden_size=h, n_layer=n, n_head=a),
        "gpt_bigcode": lambda: transformers.GPTBigCodeConfig(
            vocab_size=v, n_embd=h, n_layer=n, n_head=a, n_positions=p, multi_query=True,
            activation_function="gelu_pytorch_tanh"),
    }[family]()


def hf_model(family):
    import transformers

    torch.manual_seed(0)
    return transformers.AutoModelForCausalLM.from_config(hf_config(family)).eval()


def _ids():
    return np.random.default_rng(0).integers(1, TINY["vocab"], size=(2, 10))


def jax_logits(path):
    from trlx_tpu.models.hf_loading import load_pretrained
    from trlx_tpu.models.transformer import TransformerLM

    config, params, _ = load_pretrained(path, dict(compute_dtype=jnp.float32))
    ids = jnp.asarray(_ids())
    logits, *_ = TransformerLM(config).apply({"params": params}, ids, jnp.ones_like(ids))
    return np.asarray(logits)


def port_model(path):
    from trlx_tpu_torch.models.hf_loading import load_pretrained
    from trlx_tpu_torch.models.transformer import TransformerLM

    config, state, model_type = load_pretrained(path, dict(compute_dtype="float32"))
    model = TransformerLM(config)
    model.load_state_dict(state)
    return model, model_type


def port_logits(model):
    ids = torch.from_numpy(_ids())
    with torch.no_grad():
        return model(ids, torch.ones_like(ids))[0].numpy()


def jax_export(family, out):
    """The JAX package's ``save_pretrained_hf`` of a tiny HF model's weights."""
    from trlx_tpu.models.hf_loading import hf_state_dict_to_params, save_pretrained_hf
    from trlx_tpu.models.presets import from_hf_config

    model = hf_model(family)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    config = from_hf_config(model.config)
    save_pretrained_hf(out, family, hf_state_dict_to_params(family, sd, config), config)
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_export_loads_into_port(tmp_path, family):
    path = jax_export(family, str(tmp_path / "jax_export"))
    model, model_type = port_model(path)
    assert model_type == family
    np.testing.assert_allclose(port_logits(model), jax_logits(path), **LOGIT_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_port_export_loads_into_jax_and_transformers(tmp_path, family):
    import transformers

    from trlx_tpu_torch.models.hf_loading import save_pretrained_hf

    model, _ = port_model(jax_export(family, str(tmp_path / "jax_export")))
    out = str(tmp_path / "port_export")
    save_pretrained_hf(out, family, model.state_dict(), model.config)
    assert sorted(os.listdir(out)) == ["config.json", "model.safetensors"]
    ours = port_logits(model)
    np.testing.assert_allclose(jax_logits(out), ours, **LOGIT_TOL)

    hf_cfg = transformers.AutoConfig.from_pretrained(out)
    assert hf_cfg.model_type == family
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["model_type"] == family
    hf = transformers.AutoModelForCausalLM.from_pretrained(out).eval()
    with torch.no_grad():
        hf_out = hf(torch.from_numpy(_ids())).logits.numpy()
    np.testing.assert_allclose(hf_out, ours, atol=2e-3, rtol=1e-3)


def _same_config(port_cfg, jax_cfg):
    for field in dataclasses.fields(jax_cfg):
        a, b = getattr(port_cfg, field.name), getattr(jax_cfg, field.name)
        if field.name in ("param_dtype", "compute_dtype"):
            a, b = str(a).rsplit(".", 1)[-1], np.dtype(b).name
        assert a == b, (field.name, a, b)


@pytest.mark.parametrize("family", FAMILIES)
def test_config_json_defaults_match_jax(tmp_path, family):
    """A transformers-written config.json (a diff against the class
    defaults) and a minimal one give the JAX config, field by field."""
    import transformers

    from trlx_tpu.models.presets import from_hf_config as jax_from_hf_config

    from trlx_tpu_torch.models.presets import from_hf_config

    written = tmp_path / "written"
    hf_config(family).save_pretrained(written)
    minimal = tmp_path / "minimal"
    minimal.mkdir()
    wide = {"gpt2": "n_embd", "gptj": "n_embd", "gpt_bigcode": "n_embd"}.get(family, "hidden_size")
    (minimal / "config.json").write_text(json.dumps({"model_type": family, wide: 64, "vocab_size": 99}))
    left_out = 0
    for d in (written, minimal):
        with open(d / "config.json") as f:
            raw = json.load(f)
        left_out += "tie_word_embeddings" not in raw
        _same_config(from_hf_config(raw), jax_from_hf_config(transformers.AutoConfig.from_pretrained(d)))
    assert left_out >= 1


def test_safetensors_writer_matches_the_library(tmp_path):
    from safetensors import safe_open
    from safetensors.numpy import save_file as np_save
    from safetensors.torch import save_file as torch_save

    from trlx_tpu_torch.models import safetensors_io

    rng = np.random.default_rng(0)
    arrays = {
        "w.f32": rng.normal(size=(3, 5)).astype(np.float32), "b.f16": rng.normal(size=7).astype(np.float16),
        "idx": np.arange(4, dtype=np.int64), "n": np.ones((2, 2), np.int32), "scalar": np.zeros((), np.float32),
    }
    tensors = {**{k: torch.from_numpy(v) for k, v in arrays.items()},
               "z.bf16": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)).bfloat16()}
    ours, lib = str(tmp_path / "ours.safetensors"), str(tmp_path / "lib.safetensors")
    safetensors_io.save_file(tensors, ours, metadata={"format": "pt"})
    torch_save(tensors, lib, metadata={"format": "pt"})
    assert Path(ours).read_bytes() == Path(lib).read_bytes()
    safetensors_io.save_file(arrays, ours)
    np_save(arrays, lib)
    assert Path(ours).read_bytes() == Path(lib).read_bytes()

    safetensors_io.save_file(tensors, ours)
    with safe_open(ours, framework="pt") as f:
        assert sorted(f.keys()) == sorted(tensors)
        for k in f.keys():
            got = f.get_tensor(k)
            assert got.dtype == tensors[k].dtype and torch.equal(got, tensors[k]), k
    back = safetensors_io.load_file(ours)
    assert all(back[k].dtype == v.dtype and torch.equal(back[k], v) for k, v in tensors.items())


@pytest.mark.parametrize("layout", ["safetensors", "safetensors_sharded", "bin", "bin_sharded"])
def test_reader_reads_library_checkpoints(tmp_path, layout):
    from trlx_tpu.models.hf_loading import load_torch_state_dict as jax_load

    from trlx_tpu_torch.models.hf_loading import load_torch_state_dict

    model = hf_model("gpt2")
    out = tmp_path / layout
    model.save_pretrained(out, safe_serialization=layout.startswith("safetensors"),
                          max_shard_size="40KB" if layout.endswith("sharded") else "5GB")
    names = sorted(os.listdir(out))
    assert any(n.endswith(".index.json") for n in names) == layout.endswith("sharded"), names
    got = load_torch_state_dict(str(out))
    want = jax_load(str(out))
    assert sorted(got) == sorted(want) and len(got) > 10
    sd = model.state_dict()
    for k, v in got.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, want[k], err_msg=k)
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)


def test_reader_upcasts_bf16_and_f16(tmp_path):
    from safetensors.torch import save_file

    from trlx_tpu_torch.models.hf_loading import load_torch_state_dict

    x = torch.randn(3, 4)
    save_file({"a": x.bfloat16(), "b": x.half()}, str(tmp_path / "model.safetensors"))
    got = load_torch_state_dict(str(tmp_path))
    assert got["a"].dtype == got["b"].dtype == np.float32
    np.testing.assert_array_equal(got["a"], x.bfloat16().float().numpy())
    np.testing.assert_array_equal(got["b"], x.half().float().numpy())


def test_bloom_and_native_store_raise_naming_their_slice(tmp_path):
    from trlx_tpu.checkpointing import convert_hf_to_native

    from trlx_tpu_torch.models.hf_loading import load_pretrained

    # bloom no longer raises: it loads as the other families (ALiBi ported)
    bloom = tmp_path / "bloom"
    hf = hf_model("bloom")
    hf.save_pretrained(bloom)
    model, model_type = port_model(str(bloom))
    assert model_type == "bloom" and model.config.pos_embedding == "alibi"
    with torch.no_grad():
        ref = hf(torch.from_numpy(_ids())).logits.numpy()
    np.testing.assert_allclose(port_logits(model), ref, atol=2e-3, rtol=1e-3)
    # the native store restores (it raised until the port read it): the JAX restore's tensors, bit for bit
    from trlx_tpu.checkpointing import restore_native
    from trlx_tpu_torch.models.hf_loading import state_from_params

    native = convert_hf_to_native(jax_export("gpt2", str(tmp_path / "gpt2")), str(tmp_path / "native"))
    config, state, model_type = load_pretrained(native)
    _, want, _ = restore_native(native)
    want = state_from_params(want)
    assert model_type == "gpt2" and set(state) == set(want)
    for name, value in state.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[name]), err_msg=name)
    # a hub name keeps the preset fallback
    config, state, model_type = load_pretrained("lvwerra/gpt2-imdb")
    assert state is None and model_type == "gpt2" and config.hidden_size == 768


@pytest.mark.parametrize("contents", [(), ("model.safetensors",), ("trainer.pt", "hf_model/")])
def test_directory_without_config_json_raises(tmp_path, contents):
    """A local directory is a checkpoint or an error, never the random-init
    preset: a bare one, one whose config.json is missing, and an interval
    checkpoint (``trainer.pt``) all raise naming the files expected."""
    from trlx_tpu_torch.models.hf_loading import load_pretrained

    for name in contents:
        if name.endswith("/"):
            (tmp_path / name).mkdir()
        else:
            (tmp_path / name).write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="config.json"):
        load_pretrained(str(tmp_path))


def test_checkpoint_path_needs_neither_transformers_nor_safetensors(tmp_path):
    """Export, reload and the bpe tokenizer in a process where importing
    ``transformers`` or ``safetensors`` fails (as on a host without them)."""
    code = f"""
import sys
sys.modules["transformers"] = None
sys.modules["safetensors"] = None
import torch
from trlx_tpu_torch.models.hf_loading import load_pretrained, save_pretrained_hf
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.pipeline.bpe import train_and_save
from trlx_tpu_torch.pipeline.tokenization import load_tokenizer
from trlx_tpu_torch.data.configs import TokenizerConfig
cfg = PRESETS["llama"].replace(vocab_size=50, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                               intermediate_size=48, max_position_embeddings=32, compute_dtype=torch.float32)
m = TransformerLM(cfg).init_params(0)
save_pretrained_hf({str(tmp_path / 'out')!r}, "llama", m.state_dict(), cfg)
cfg2, state, mt = load_pretrained({str(tmp_path / 'out')!r}, dict(compute_dtype="float32"))
m2 = TransformerLM(cfg2)
m2.load_state_dict(state)
ids = torch.randint(1, 50, (2, 7))
assert torch.equal(m(ids, torch.ones_like(ids))[0], m2(ids, torch.ones_like(ids))[0])
train_and_save(["ab ab abc", "abc d"], 270, {str(tmp_path / 'bpe.json')!r})
tok = load_tokenizer(TokenizerConfig(tokenizer_path="bpe://" + {str(tmp_path / 'bpe.json')!r}))
assert tok.decode(tok.encode("ab abc")) == "ab abc"
try:
    load_tokenizer(TokenizerConfig(tokenizer_path={str(tmp_path)!r}))
except ImportError as e:
    assert "transformers" in str(e)
else:
    raise AssertionError("an HF tokenizer directory needs transformers")
print("OK", mt)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK llama")
