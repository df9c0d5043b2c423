"""HF checkpoint interop (counterpart of ``trlx_tpu/models/hf_loading.py``):
load a local HF-format directory into a :class:`TransformerLM` state dict,
export one back, and resolve a preset name to random-init weights.

A model path is one of:

- a local directory with ``config.json`` and weights (``model.safetensors``,
  a sharded ``model.safetensors.index.json``, or ``pytorch_model.bin[.index.json]``):
  the config converts through :func:`~trlx_tpu_torch.models.presets.from_hf_config`
  and the weights through the per-family converters (gpt2, llama, gpt_neox,
  gptj, opt, gpt_bigcode, bloom), copied from the JAX package;
- a local directory without ``config.json``: ``FileNotFoundError``;
- anything else, such as a hub name: the family preset at its published
  widths with random weights, which the caller initialises from a seed.

The port reads and writes safetensors and ``config.json`` itself
(:mod:`~trlx_tpu_torch.models.safetensors_io`, :func:`make_hf_config`): it
needs neither ``transformers`` nor ``safetensors``. Bloom (ALiBi) loads as
the other families do. T5 checkpoints load through
:func:`load_pretrained_seq2seq` and export through ``save_pretrained_hf(...,
"t5", ...)``. A native pre-converted store (``native_config.json``)
restores through :mod:`trlx_tpu_torch.checkpointing`.

Parameter trees here are nested dicts of numpy arrays in the flax layout
(``layers_{i}.attn.q_proj.kernel``, kernels ``[in, out]``), which are the
port's ``state_dict`` names once flattened with ``.``
(:func:`state_from_params` / :func:`params_from_state`).

peft: :func:`peft_overrides` / :func:`t5_peft_overrides` map a reference
peft config to model overrides, and :func:`save_adapters` /
:func:`load_adapters` write and read the adapters alone. The JAX package
writes them as ``adapters.msgpack`` (flax serialization); the port writes
``adapters.safetensors`` through its own reader and writer, as it writes
``heads.safetensors`` for the JAX package's ``heads.msgpack``, since the
card's machine has no msgpack. A checkpoint without adapters loads over a
peft model and keeps the adapters' seed init (:func:`merge_loaded_state`).
"""

import json
import logging
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.models import safetensors_io
from trlx_tpu_torch.models.presets import from_hf_config, get_preset
from trlx_tpu_torch.models.transformer import TransformerConfig
from trlx_tpu_torch.parallel.pipeline import is_stacked, unstack_layer_params

logger = logging.getLogger(__name__)

_DTYPE_FIELDS = ("param_dtype", "compute_dtype")

def torch_dtype(x) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``"bfloat16"``)."""
    if isinstance(x, torch.dtype):
        return x
    name = str(x).rsplit(".", 1)[-1]
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {x!r}")
    return dtype


# --------------------------------------------------------------------------- io


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 and f16 upcast to f32, as the JAX package's reader does."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def load_torch_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    """Load (possibly sharded) weights from a local HF model dir into numpy."""
    out: Dict[str, np.ndarray] = {}

    def _load_safetensors(path):
        for k, v in safetensors_io.load_file(path).items():
            out[k] = _to_numpy(v)

    def _load_bin(path):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for k, v in sd.items():
            out[k] = _to_numpy(v)

    for index_name, loader in (
        ("model.safetensors.index.json", _load_safetensors),
        ("pytorch_model.bin.index.json", _load_bin),
    ):
        index_path = os.path.join(model_dir, index_name)
        if os.path.exists(index_path):
            with open(index_path) as f:
                index = json.load(f)
            for shard in sorted(set(index["weight_map"].values())):
                loader(os.path.join(model_dir, shard))
            return out
    for name, loader in (("model.safetensors", _load_safetensors), ("pytorch_model.bin", _load_bin)):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            loader(path)
            return out
    raise FileNotFoundError(f"No weights found in {model_dir}")


# ------------------------------------------------------------------ conversions

# Each family: (hf_to_params, params_to_hf). Params trees are plain nested dicts of
# numpy arrays with TransformerLM naming.


def _ln(sd, prefix):
    d = {"scale": sd[f"{prefix}.weight"]}
    if f"{prefix}.bias" in sd:
        d["bias"] = sd[f"{prefix}.bias"]
    return d


def _linear(sd, prefix, transpose=True):
    d = {"kernel": sd[f"{prefix}.weight"].T if transpose else sd[f"{prefix}.weight"]}
    if f"{prefix}.bias" in sd:
        d["bias"] = sd[f"{prefix}.bias"]
    return d


def _gpt2_to_params(sd: Dict[str, np.ndarray], c: TransformerConfig) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "embed_tokens": {"embedding": sd["transformer.wte.weight"]},
        "embed_positions": {"embedding": sd["transformer.wpe.weight"]},
        "ln_f": _ln(sd, "transformer.ln_f"),
    }
    H = c.hidden_size
    for i in range(c.num_layers):
        pre = f"transformer.h.{i}"
        # HF Conv1D stores [in, out] — no transpose
        ck = sd[f"{pre}.attn.c_attn.weight"]
        cb = sd[f"{pre}.attn.c_attn.bias"]
        p[f"layers_{i}"] = {
            "ln_1": _ln(sd, f"{pre}.ln_1"),
            "ln_2": _ln(sd, f"{pre}.ln_2"),
            "attn": {
                "q_proj": {"kernel": ck[:, :H], "bias": cb[:H]},
                "k_proj": {"kernel": ck[:, H : 2 * H], "bias": cb[H : 2 * H]},
                "v_proj": {"kernel": ck[:, 2 * H :], "bias": cb[2 * H :]},
                "o_proj": _linear(sd, f"{pre}.attn.c_proj", transpose=False),
            },
            "mlp": {
                "up_proj": _linear(sd, f"{pre}.mlp.c_fc", transpose=False),
                "down_proj": _linear(sd, f"{pre}.mlp.c_proj", transpose=False),
            },
        }
    return p


def _gpt2_from_params(p: Dict[str, Any], c: TransformerConfig) -> Dict[str, np.ndarray]:
    sd = {
        "transformer.wte.weight": p["embed_tokens"]["embedding"],
        "transformer.wpe.weight": p["embed_positions"]["embedding"],
        "transformer.ln_f.weight": p["ln_f"]["scale"],
        "transformer.ln_f.bias": p["ln_f"]["bias"],
    }
    for i in range(c.num_layers):
        L = p[f"layers_{i}"]
        pre = f"transformer.h.{i}"
        sd[f"{pre}.ln_1.weight"] = L["ln_1"]["scale"]
        sd[f"{pre}.ln_1.bias"] = L["ln_1"]["bias"]
        sd[f"{pre}.ln_2.weight"] = L["ln_2"]["scale"]
        sd[f"{pre}.ln_2.bias"] = L["ln_2"]["bias"]
        sd[f"{pre}.attn.c_attn.weight"] = np.concatenate(
            [L["attn"][k]["kernel"] for k in ("q_proj", "k_proj", "v_proj")], axis=1
        )
        sd[f"{pre}.attn.c_attn.bias"] = np.concatenate(
            [L["attn"][k]["bias"] for k in ("q_proj", "k_proj", "v_proj")]
        )
        sd[f"{pre}.attn.c_proj.weight"] = L["attn"]["o_proj"]["kernel"]
        sd[f"{pre}.attn.c_proj.bias"] = L["attn"]["o_proj"]["bias"]
        sd[f"{pre}.mlp.c_fc.weight"] = L["mlp"]["up_proj"]["kernel"]
        sd[f"{pre}.mlp.c_fc.bias"] = L["mlp"]["up_proj"]["bias"]
        sd[f"{pre}.mlp.c_proj.weight"] = L["mlp"]["down_proj"]["kernel"]
        sd[f"{pre}.mlp.c_proj.bias"] = L["mlp"]["down_proj"]["bias"]
    return sd


def _llama_to_params(sd, c):
    p = {
        "embed_tokens": {"embedding": sd["model.embed_tokens.weight"]},
        "ln_f": {"scale": sd["model.norm.weight"]},
    }
    if not c.tie_word_embeddings:
        p["lm_head"] = _linear(sd, "lm_head")
    for i in range(c.num_layers):
        pre = f"model.layers.{i}"
        p[f"layers_{i}"] = {
            "ln_1": {"scale": sd[f"{pre}.input_layernorm.weight"]},
            "ln_2": {"scale": sd[f"{pre}.post_attention_layernorm.weight"]},
            "attn": {
                "q_proj": _linear(sd, f"{pre}.self_attn.q_proj"),
                "k_proj": _linear(sd, f"{pre}.self_attn.k_proj"),
                "v_proj": _linear(sd, f"{pre}.self_attn.v_proj"),
                "o_proj": _linear(sd, f"{pre}.self_attn.o_proj"),
            },
            "mlp": {
                "gate_proj": _linear(sd, f"{pre}.mlp.gate_proj"),
                "up_proj": _linear(sd, f"{pre}.mlp.up_proj"),
                "down_proj": _linear(sd, f"{pre}.mlp.down_proj"),
            },
        }
    return p


def _llama_from_params(p, c):
    sd = {
        "model.embed_tokens.weight": p["embed_tokens"]["embedding"],
        "model.norm.weight": p["ln_f"]["scale"],
    }
    if "lm_head" in p:
        sd["lm_head.weight"] = p["lm_head"]["kernel"].T
    for i in range(c.num_layers):
        L = p[f"layers_{i}"]
        pre = f"model.layers.{i}"
        sd[f"{pre}.input_layernorm.weight"] = L["ln_1"]["scale"]
        sd[f"{pre}.post_attention_layernorm.weight"] = L["ln_2"]["scale"]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[f"{pre}.self_attn.{name}.weight"] = L["attn"][name]["kernel"].T
        for name in ("gate_proj", "up_proj", "down_proj"):
            sd[f"{pre}.mlp.{name}.weight"] = L["mlp"][name]["kernel"].T
    return sd


def _neox_to_params(sd, c):
    p = {
        "embed_tokens": {"embedding": sd["gpt_neox.embed_in.weight"]},
        "ln_f": _ln(sd, "gpt_neox.final_layer_norm"),
        "lm_head": _linear(sd, "embed_out"),
    }
    heads, hd, H = c.num_heads, c.dim_per_head, c.hidden_size
    for i in range(c.num_layers):
        pre = f"gpt_neox.layers.{i}"
        qkv_w = sd[f"{pre}.attention.query_key_value.weight"]  # [3H, H], per-head interleave
        qkv_b = sd[f"{pre}.attention.query_key_value.bias"]
        w = qkv_w.reshape(heads, 3, hd, H)
        b = qkv_b.reshape(heads, 3, hd)
        mk_w = lambda j: w[:, j].reshape(heads * hd, H).T  # -> [H, H] kernel
        mk_b = lambda j: b[:, j].reshape(heads * hd)
        p[f"layers_{i}"] = {
            "ln_1": _ln(sd, f"{pre}.input_layernorm"),
            "ln_2": _ln(sd, f"{pre}.post_attention_layernorm"),
            "attn": {
                "q_proj": {"kernel": mk_w(0), "bias": mk_b(0)},
                "k_proj": {"kernel": mk_w(1), "bias": mk_b(1)},
                "v_proj": {"kernel": mk_w(2), "bias": mk_b(2)},
                "o_proj": _linear(sd, f"{pre}.attention.dense"),
            },
            "mlp": {
                "up_proj": _linear(sd, f"{pre}.mlp.dense_h_to_4h"),
                "down_proj": _linear(sd, f"{pre}.mlp.dense_4h_to_h"),
            },
        }
    return p


def _neox_from_params(p, c):
    sd = {
        "gpt_neox.embed_in.weight": p["embed_tokens"]["embedding"],
        "gpt_neox.final_layer_norm.weight": p["ln_f"]["scale"],
        "gpt_neox.final_layer_norm.bias": p["ln_f"]["bias"],
        "embed_out.weight": p["lm_head"]["kernel"].T,
    }
    heads, hd, H = c.num_heads, c.dim_per_head, c.hidden_size
    for i in range(c.num_layers):
        L = p[f"layers_{i}"]
        pre = f"gpt_neox.layers.{i}"
        sd[f"{pre}.input_layernorm.weight"] = L["ln_1"]["scale"]
        sd[f"{pre}.input_layernorm.bias"] = L["ln_1"]["bias"]
        sd[f"{pre}.post_attention_layernorm.weight"] = L["ln_2"]["scale"]
        sd[f"{pre}.post_attention_layernorm.bias"] = L["ln_2"]["bias"]
        ws = [L["attn"][k]["kernel"].T.reshape(heads, hd, H) for k in ("q_proj", "k_proj", "v_proj")]
        bs = [L["attn"][k]["bias"].reshape(heads, hd) for k in ("q_proj", "k_proj", "v_proj")]
        sd[f"{pre}.attention.query_key_value.weight"] = np.stack(ws, axis=1).reshape(3 * H, H)
        sd[f"{pre}.attention.query_key_value.bias"] = np.stack(bs, axis=1).reshape(3 * H)
        sd[f"{pre}.attention.dense.weight"] = L["attn"]["o_proj"]["kernel"].T
        sd[f"{pre}.attention.dense.bias"] = L["attn"]["o_proj"]["bias"]
        sd[f"{pre}.mlp.dense_h_to_4h.weight"] = L["mlp"]["up_proj"]["kernel"].T
        sd[f"{pre}.mlp.dense_h_to_4h.bias"] = L["mlp"]["up_proj"]["bias"]
        sd[f"{pre}.mlp.dense_4h_to_h.weight"] = L["mlp"]["down_proj"]["kernel"].T
        sd[f"{pre}.mlp.dense_4h_to_h.bias"] = L["mlp"]["down_proj"]["bias"]
    return sd


def _gptj_to_params(sd, c):
    p = {
        "embed_tokens": {"embedding": sd["transformer.wte.weight"]},
        "ln_f": _ln(sd, "transformer.ln_f"),
        "lm_head": _linear(sd, "lm_head"),
    }
    for i in range(c.num_layers):
        pre = f"transformer.h.{i}"
        p[f"layers_{i}"] = {
            "ln_1": _ln(sd, f"{pre}.ln_1"),
            "attn": {
                "q_proj": _linear(sd, f"{pre}.attn.q_proj"),
                "k_proj": _linear(sd, f"{pre}.attn.k_proj"),
                "v_proj": _linear(sd, f"{pre}.attn.v_proj"),
                "o_proj": _linear(sd, f"{pre}.attn.out_proj"),
            },
            "mlp": {
                "up_proj": _linear(sd, f"{pre}.mlp.fc_in"),
                "down_proj": _linear(sd, f"{pre}.mlp.fc_out"),
            },
        }
    return p


def _gptj_from_params(p, c):
    sd = {
        "transformer.wte.weight": p["embed_tokens"]["embedding"],
        "transformer.ln_f.weight": p["ln_f"]["scale"],
        "transformer.ln_f.bias": p["ln_f"]["bias"],
        "lm_head.weight": p["lm_head"]["kernel"].T,
    }
    if "bias" in p["lm_head"]:
        sd["lm_head.bias"] = p["lm_head"]["bias"]
    for i in range(c.num_layers):
        L = p[f"layers_{i}"]
        pre = f"transformer.h.{i}"
        sd[f"{pre}.ln_1.weight"] = L["ln_1"]["scale"]
        sd[f"{pre}.ln_1.bias"] = L["ln_1"]["bias"]
        for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"), ("o_proj", "out_proj")):
            sd[f"{pre}.attn.{theirs}.weight"] = L["attn"][ours]["kernel"].T
        sd[f"{pre}.mlp.fc_in.weight"] = L["mlp"]["up_proj"]["kernel"].T
        sd[f"{pre}.mlp.fc_in.bias"] = L["mlp"]["up_proj"]["bias"]
        sd[f"{pre}.mlp.fc_out.weight"] = L["mlp"]["down_proj"]["kernel"].T
        sd[f"{pre}.mlp.fc_out.bias"] = L["mlp"]["down_proj"]["bias"]
    return sd


def _opt_to_params(sd, c):
    prefix = "model.decoder" if "model.decoder.embed_tokens.weight" in sd else "decoder"
    p = {
        "embed_tokens": {"embedding": sd[f"{prefix}.embed_tokens.weight"]},
        "embed_positions": {"embedding": sd[f"{prefix}.embed_positions.weight"]},
    }
    if f"{prefix}.final_layer_norm.weight" in sd:
        p["ln_f"] = _ln(sd, f"{prefix}.final_layer_norm")
    for i in range(c.num_layers):
        pre = f"{prefix}.layers.{i}"
        p[f"layers_{i}"] = {
            "ln_1": _ln(sd, f"{pre}.self_attn_layer_norm"),
            "ln_2": _ln(sd, f"{pre}.final_layer_norm"),
            "attn": {
                "q_proj": _linear(sd, f"{pre}.self_attn.q_proj"),
                "k_proj": _linear(sd, f"{pre}.self_attn.k_proj"),
                "v_proj": _linear(sd, f"{pre}.self_attn.v_proj"),
                "o_proj": _linear(sd, f"{pre}.self_attn.out_proj"),
            },
            "mlp": {
                "up_proj": _linear(sd, f"{pre}.fc1"),
                "down_proj": _linear(sd, f"{pre}.fc2"),
            },
        }
    return p


def _opt_from_params(p, c):
    prefix = "model.decoder"
    sd = {
        f"{prefix}.embed_tokens.weight": p["embed_tokens"]["embedding"],
        f"{prefix}.embed_positions.weight": p["embed_positions"]["embedding"],
    }
    if "ln_f" in p:
        sd[f"{prefix}.final_layer_norm.weight"] = p["ln_f"]["scale"]
        sd[f"{prefix}.final_layer_norm.bias"] = p["ln_f"]["bias"]
    for i in range(c.num_layers):
        L = p[f"layers_{i}"]
        pre = f"{prefix}.layers.{i}"
        sd[f"{pre}.self_attn_layer_norm.weight"] = L["ln_1"]["scale"]
        sd[f"{pre}.self_attn_layer_norm.bias"] = L["ln_1"]["bias"]
        sd[f"{pre}.final_layer_norm.weight"] = L["ln_2"]["scale"]
        sd[f"{pre}.final_layer_norm.bias"] = L["ln_2"]["bias"]
        for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"), ("o_proj", "out_proj")):
            sd[f"{pre}.self_attn.{theirs}.weight"] = L["attn"][ours]["kernel"].T
            sd[f"{pre}.self_attn.{theirs}.bias"] = L["attn"][ours]["bias"]
        sd[f"{pre}.fc1.weight"] = L["mlp"]["up_proj"]["kernel"].T
        sd[f"{pre}.fc1.bias"] = L["mlp"]["up_proj"]["bias"]
        sd[f"{pre}.fc2.weight"] = L["mlp"]["down_proj"]["kernel"].T
        sd[f"{pre}.fc2.bias"] = L["mlp"]["down_proj"]["bias"]
    return sd


def _bloom_to_params(sd, c):
    """Bloom: ALiBi, the embedding LayerNorm, and a fused qkv interleaved per
    head (``[heads, 3, head_dim, hidden]`` rows)."""
    pre0 = "transformer." if "transformer.word_embeddings.weight" in sd else ""
    p = {
        "embed_tokens": {"embedding": sd[f"{pre0}word_embeddings.weight"]},
        "embed_layernorm": _ln(sd, f"{pre0}word_embeddings_layernorm"),
        "ln_f": _ln(sd, f"{pre0}ln_f"),
    }
    heads, hd, H = c.num_heads, c.dim_per_head, c.hidden_size
    for i in range(c.num_layers):
        pre = f"{pre0}h.{i}"
        w = sd[f"{pre}.self_attention.query_key_value.weight"].reshape(heads, 3, hd, H)
        b = sd[f"{pre}.self_attention.query_key_value.bias"].reshape(heads, 3, hd)
        mk_w = lambda j: w[:, j].reshape(heads * hd, H).T
        mk_b = lambda j: b[:, j].reshape(heads * hd)
        p[f"layers_{i}"] = {
            "ln_1": _ln(sd, f"{pre}.input_layernorm"),
            "ln_2": _ln(sd, f"{pre}.post_attention_layernorm"),
            "attn": {
                "q_proj": {"kernel": mk_w(0), "bias": mk_b(0)},
                "k_proj": {"kernel": mk_w(1), "bias": mk_b(1)},
                "v_proj": {"kernel": mk_w(2), "bias": mk_b(2)},
                "o_proj": _linear(sd, f"{pre}.self_attention.dense"),
            },
            "mlp": {
                "up_proj": _linear(sd, f"{pre}.mlp.dense_h_to_4h"),
                "down_proj": _linear(sd, f"{pre}.mlp.dense_4h_to_h"),
            },
        }
    return p


def _bloom_from_params(p, c):
    sd = {
        "transformer.word_embeddings.weight": p["embed_tokens"]["embedding"],
        "transformer.word_embeddings_layernorm.weight": p["embed_layernorm"]["scale"],
        "transformer.word_embeddings_layernorm.bias": p["embed_layernorm"]["bias"],
        "transformer.ln_f.weight": p["ln_f"]["scale"],
        "transformer.ln_f.bias": p["ln_f"]["bias"],
    }
    heads, hd, H = c.num_heads, c.dim_per_head, c.hidden_size
    for i in range(c.num_layers):
        L = p[f"layers_{i}"]
        pre = f"transformer.h.{i}"
        sd[f"{pre}.input_layernorm.weight"] = L["ln_1"]["scale"]
        sd[f"{pre}.input_layernorm.bias"] = L["ln_1"]["bias"]
        sd[f"{pre}.post_attention_layernorm.weight"] = L["ln_2"]["scale"]
        sd[f"{pre}.post_attention_layernorm.bias"] = L["ln_2"]["bias"]
        ws = [L["attn"][k]["kernel"].T.reshape(heads, hd, H) for k in ("q_proj", "k_proj", "v_proj")]
        bs = [L["attn"][k]["bias"].reshape(heads, hd) for k in ("q_proj", "k_proj", "v_proj")]
        sd[f"{pre}.self_attention.query_key_value.weight"] = np.stack(ws, axis=1).reshape(3 * H, H)
        sd[f"{pre}.self_attention.query_key_value.bias"] = np.stack(bs, axis=1).reshape(3 * H)
        sd[f"{pre}.self_attention.dense.weight"] = L["attn"]["o_proj"]["kernel"].T
        sd[f"{pre}.self_attention.dense.bias"] = L["attn"]["o_proj"]["bias"]
        sd[f"{pre}.mlp.dense_h_to_4h.weight"] = L["mlp"]["up_proj"]["kernel"].T
        sd[f"{pre}.mlp.dense_h_to_4h.bias"] = L["mlp"]["up_proj"]["bias"]
        sd[f"{pre}.mlp.dense_4h_to_h.weight"] = L["mlp"]["down_proj"]["kernel"].T
        sd[f"{pre}.mlp.dense_4h_to_h.bias"] = L["mlp"]["down_proj"]["bias"]
    return sd


def _bigcode_to_params(sd, c):
    """GPTBigCode: multi-query attention — c_attn packs [q(H) | k(hd) | v(hd)].

    Only the MQA layout is supported: with ``multi_query=False`` HF interleaves
    q/k/v per head instead, which this flat slicing would scramble."""
    if c.kv_heads != 1:
        raise ValueError(
            "gpt_bigcode converter supports multi_query=True checkpoints only "
            f"(got kv_heads={c.kv_heads}); the non-MQA c_attn layout is per-head "
            "interleaved and not implemented"
        )
    p = {
        "embed_tokens": {"embedding": sd["transformer.wte.weight"]},
        "embed_positions": {"embedding": sd["transformer.wpe.weight"]},
        "ln_f": _ln(sd, "transformer.ln_f"),
    }
    H = c.hidden_size
    kv_dim = c.kv_heads * c.dim_per_head
    for i in range(c.num_layers):
        pre = f"transformer.h.{i}"
        cw = sd[f"{pre}.attn.c_attn.weight"]  # [H + 2*kv_dim, H] (nn.Linear layout)
        cb = sd[f"{pre}.attn.c_attn.bias"]
        p[f"layers_{i}"] = {
            "ln_1": _ln(sd, f"{pre}.ln_1"),
            "ln_2": _ln(sd, f"{pre}.ln_2"),
            "attn": {
                "q_proj": {"kernel": cw[:H].T, "bias": cb[:H]},
                "k_proj": {"kernel": cw[H : H + kv_dim].T, "bias": cb[H : H + kv_dim]},
                "v_proj": {"kernel": cw[H + kv_dim :].T, "bias": cb[H + kv_dim :]},
                "o_proj": _linear(sd, f"{pre}.attn.c_proj"),
            },
            "mlp": {
                "up_proj": _linear(sd, f"{pre}.mlp.c_fc"),
                "down_proj": _linear(sd, f"{pre}.mlp.c_proj"),
            },
        }
    return p


def _bigcode_from_params(p, c):
    if c.kv_heads != 1:
        raise ValueError("gpt_bigcode export supports multi_query=True configs only")
    sd = {
        "transformer.wte.weight": p["embed_tokens"]["embedding"],
        "transformer.wpe.weight": p["embed_positions"]["embedding"],
        "transformer.ln_f.weight": p["ln_f"]["scale"],
        "transformer.ln_f.bias": p["ln_f"]["bias"],
    }
    for i in range(c.num_layers):
        L = p[f"layers_{i}"]
        pre = f"transformer.h.{i}"
        sd[f"{pre}.ln_1.weight"] = L["ln_1"]["scale"]
        sd[f"{pre}.ln_1.bias"] = L["ln_1"]["bias"]
        sd[f"{pre}.ln_2.weight"] = L["ln_2"]["scale"]
        sd[f"{pre}.ln_2.bias"] = L["ln_2"]["bias"]
        sd[f"{pre}.attn.c_attn.weight"] = np.concatenate(
            [L["attn"][k]["kernel"].T for k in ("q_proj", "k_proj", "v_proj")], axis=0
        )
        sd[f"{pre}.attn.c_attn.bias"] = np.concatenate(
            [L["attn"][k]["bias"] for k in ("q_proj", "k_proj", "v_proj")]
        )
        sd[f"{pre}.attn.c_proj.weight"] = L["attn"]["o_proj"]["kernel"].T
        sd[f"{pre}.attn.c_proj.bias"] = L["attn"]["o_proj"]["bias"]
        sd[f"{pre}.mlp.c_fc.weight"] = L["mlp"]["up_proj"]["kernel"].T
        sd[f"{pre}.mlp.c_fc.bias"] = L["mlp"]["up_proj"]["bias"]
        sd[f"{pre}.mlp.c_proj.weight"] = L["mlp"]["down_proj"]["kernel"].T
        sd[f"{pre}.mlp.c_proj.bias"] = L["mlp"]["down_proj"]["bias"]
    return sd


CONVERTERS = {
    "gpt2": (_gpt2_to_params, _gpt2_from_params),
    "llama": (_llama_to_params, _llama_from_params),
    "gpt_neox": (_neox_to_params, _neox_from_params),
    "gptj": (_gptj_to_params, _gptj_from_params),
    "opt": (_opt_to_params, _opt_from_params),
    "gpt_bigcode": (_bigcode_to_params, _bigcode_from_params),
    "bloom": (_bloom_to_params, _bloom_from_params),
}


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def hf_state_dict_to_params(model_type: str, sd: Dict[str, np.ndarray], config: TransformerConfig) -> Dict[str, Any]:
    if model_type not in CONVERTERS:
        raise ValueError(f"No converter for model_type {model_type!r}")
    p = CONVERTERS[model_type][0](sd, config)
    return _tree_map(lambda x: np.asarray(x, dtype=np.float32), p)


def params_to_hf_state_dict(
    model_type: str, params: Dict[str, Any], config: TransformerConfig
) -> Dict[str, np.ndarray]:
    if model_type not in CONVERTERS:
        raise ValueError(f"No converter for model_type {model_type!r}")
    params = _tree_map(lambda x: np.asarray(x, dtype=np.float32), params)
    return CONVERTERS[model_type][1](params, config)


def state_from_params(params: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested flax-layout tree flattened to ``state_dict`` names."""
    out: Dict[str, np.ndarray] = {}
    for key, value in params.items():
        if isinstance(value, Mapping):
            out.update(state_from_params(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def params_from_state(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A ``state_dict`` (torch tensors or arrays) as the nested flax-layout
    tree of f32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, value in state.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy()
        node[leaf] = np.asarray(value, dtype=np.float32)
    return tree


def merge_loaded_state(model: torch.nn.Module, state: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """Copy checkpoint tensors over ``model``'s (seed-initialised) parameters,
    keeping the ones the checkpoint lacks (an OPT without a final norm, new
    heads): the semantics of the JAX package's ``merge_loaded_params``. A
    checkpoint tensor the module has no parameter for, or of another shape,
    raises."""
    own = model.state_dict()
    extra = sorted(set(state) - set(own))
    if extra:
        raise ValueError(f"checkpoint tensors with no parameter in {type(model).__name__}: {extra}")
    with torch.no_grad():
        for name, value in state.items():
            if tuple(value.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(value.shape)} != {tuple(own[name].shape)}")
            own[name].copy_(value)
    return model


# ------------------------------------------------------------------- top level


def _family_of(name: str) -> str:
    key = name.lower().replace("-", "").replace("_", "")
    for family in ("gptbigcode", "gptneox", "gptj", "gpt2", "llama", "opt", "bloom"):
        if family in key:
            return {"gptneox": "gpt_neox", "gptbigcode": "gpt_bigcode"}.get(family, family)
    if "pythia" in key or "neox" in key:
        return "gpt_neox"
    if "starcoder" in key or "santacoder" in key:
        return "gpt_bigcode"
    return "gpt2"


def _hf_load_retry_policy():
    """Retry policy for HF checkpoint reads: transient I/O faults (NFS blips,
    injected chaos) are retried; a definitively missing file is an answer
    and fails immediately. Budget is overridable via TRLX_HF_LOAD_RETRIES
    (and the first delay via TRLX_HF_LOAD_RETRY_DELAY) for constrained CI."""
    from trlx_tpu_torch.resilience.chaos import ChaosInjectedError
    from trlx_tpu_torch.resilience.retry import RetryPolicy

    return RetryPolicy(
        max_retries=int(os.environ.get("TRLX_HF_LOAD_RETRIES", 2)),
        base_delay_s=float(os.environ.get("TRLX_HF_LOAD_RETRY_DELAY", 1.0)),
        max_delay_s=15.0,
        retry_on=(OSError, ChaosInjectedError),
        giveup_on=(FileNotFoundError, IsADirectoryError, NotADirectoryError),
    )


def _read_hf_weights(model_path: str):
    """The torch state dict of a local HF dir, under the retry policy above,
    with the chaos ``hf-load`` fault site inside the retried body so
    injected faults take the same recovery path as real ones."""
    from trlx_tpu_torch.resilience.chaos import chaos
    from trlx_tpu_torch.resilience.retry import retry_call

    def read():
        chaos.fail_if_armed("hf-load", detail=model_path)
        return load_torch_state_dict(model_path)

    return retry_call(read, policy=_hf_load_retry_policy(), name=f"hf-load {model_path}")


def load_pretrained(
    model_path: str, overrides: Optional[Dict[str, Any]] = None
) -> Tuple[TransformerConfig, Optional[Dict[str, torch.Tensor]], str]:
    """(config, trunk state or None, model_type) for a model path.

    A native pre-converted store (:mod:`trlx_tpu_torch.checkpointing`)
    restores in its stored layout and dtype. A local dir with
    ``config.json`` and weights gives the converted checkpoint as a
    ``state_dict`` of f32 CPU tensors for :class:`TransformerLM` (lay it
    over a seed-initialised model with :func:`merge_loaded_state`); a dir
    without ``config.json`` raises ``FileNotFoundError``. Anything else
    gives the family preset and None: the caller random-inits. Dtype
    overrides may be torch dtypes or their names."""
    from trlx_tpu_torch import checkpointing

    overrides = dict(overrides or {})
    for key in _DTYPE_FIELDS:
        if key in overrides:
            overrides[key] = torch_dtype(overrides[key])
    if checkpointing.is_native_checkpoint(model_path):
        return checkpointing.restore_native(model_path, overrides, expect_seq2seq=False)
    config_path = os.path.join(model_path, "config.json")
    if os.path.isdir(model_path):
        if not os.path.exists(config_path):
            raise FileNotFoundError(
                f"{model_path!r} is a directory without config.json: an HF-format checkpoint needs config.json "
                "and model.safetensors, model.safetensors.index.json, pytorch_model.bin or "
                "pytorch_model.bin.index.json"
            )
        with open(config_path) as f:
            hf_config = json.load(f)
        model_type = hf_config.get("model_type")
        config = from_hf_config(hf_config, overrides)
        params = hf_state_dict_to_params(model_type, _read_hf_weights(model_path), config)
        state = {k: torch.from_numpy(v) for k, v in state_from_params(params).items()}
        return config, state, model_type
    config = get_preset(model_path, overrides)
    model_type = _family_of(model_path)
    logger.warning(f"No local checkpoint at {model_path!r}; using random-init {model_type} preset")
    return config, None, model_type


def save_pretrained_hf(
    out_dir: str,
    model_type: str,
    state: Mapping[str, Any],
    config: TransformerConfig,
) -> None:
    """Export a :class:`TransformerLM` ``state_dict`` as an HF-format
    directory: ``model.safetensors`` (f32) and ``config.json``
    (:func:`make_hf_config`). A stacked trunk (``layers_scan.*``) is
    unstacked first: the directory is the listed layout's."""
    if is_stacked(state):
        state = unstack_layer_params(state, config.num_layers)
    os.makedirs(out_dir, exist_ok=True)
    sd = params_to_hf_state_dict(model_type, params_from_state(state), config)
    safetensors_io.save_file(sd, os.path.join(out_dir, "model.safetensors"), metadata={"format": "pt"})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(json.dumps(make_hf_config(model_type, config), indent=2, sort_keys=True) + "\n")


def make_hf_config(model_type: str, c: TransformerConfig) -> Dict[str, Any]:
    """The ``config.json`` dict of an export: ``model_type`` and every
    field that ``transformers.AutoConfig`` and
    :func:`from_hf_config` read, written out in full (no field is left to a
    class default). The values are the ones the JAX package's
    ``make_hf_config`` passes to the ``transformers`` config classes."""
    if model_type == "gpt2":
        fields = dict(
            vocab_size=c.vocab_size, n_embd=c.hidden_size, n_layer=c.num_layers,
            n_head=c.num_heads, n_positions=c.max_position_embeddings,
            n_inner=c.ffn_dim, layer_norm_epsilon=c.norm_eps, activation_function="gelu_new",
            tie_word_embeddings=True,
        )
    elif model_type == "llama":
        fields = dict(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            num_hidden_layers=c.num_layers, num_attention_heads=c.num_heads,
            num_key_value_heads=c.kv_heads, intermediate_size=c.ffn_dim,
            max_position_embeddings=c.max_position_embeddings, rms_norm_eps=c.norm_eps,
            rope_theta=c.rope_theta, tie_word_embeddings=c.tie_word_embeddings, hidden_act="silu",
        )
    elif model_type == "gpt_neox":
        fields = dict(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            num_hidden_layers=c.num_layers, num_attention_heads=c.num_heads,
            intermediate_size=c.ffn_dim, max_position_embeddings=c.max_position_embeddings,
            rotary_pct=c.rotary_pct, layer_norm_eps=c.norm_eps,
            use_parallel_residual=c.parallel_residual, tie_word_embeddings=False, hidden_act="gelu",
        )
    elif model_type == "gptj":
        fields = dict(
            vocab_size=c.vocab_size, n_embd=c.hidden_size, n_layer=c.num_layers,
            n_head=c.num_heads, n_positions=c.max_position_embeddings,
            rotary_dim=int(c.dim_per_head * c.rotary_pct), layer_norm_epsilon=c.norm_eps,
            activation_function="gelu_new", tie_word_embeddings=False,
        )
    elif model_type == "opt":
        fields = dict(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            num_hidden_layers=c.num_layers, num_attention_heads=c.num_heads,
            ffn_dim=c.ffn_dim, max_position_embeddings=c.max_position_embeddings,
            do_layer_norm_before=True, word_embed_proj_dim=c.hidden_size,
            activation_function="relu", tie_word_embeddings=True,
        )
    elif model_type == "gpt_bigcode":
        fields = dict(
            vocab_size=c.vocab_size, n_embd=c.hidden_size, n_layer=c.num_layers,
            n_head=c.num_heads, n_positions=c.max_position_embeddings,
            n_inner=c.ffn_dim, layer_norm_epsilon=c.norm_eps,
            multi_query=c.kv_heads == 1, activation_function="gelu_pytorch_tanh",
            tie_word_embeddings=True,
        )
    elif model_type == "bloom":
        fields = dict(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size, n_layer=c.num_layers,
            n_head=c.num_heads, layer_norm_epsilon=c.norm_eps, tie_word_embeddings=True,
            apply_residual_connection_post_layernorm=False,
        )
    elif model_type == "t5":
        fields = dict(
            vocab_size=c.vocab_size, d_model=c.d_model, d_kv=c.d_kv, d_ff=c.d_ff,
            num_layers=c.num_layers, num_decoder_layers=c.num_decoder_layers, num_heads=c.num_heads,
            relative_attention_num_buckets=c.relative_attention_num_buckets,
            relative_attention_max_distance=c.relative_attention_max_distance,
            layer_norm_epsilon=c.layer_norm_epsilon,
            feed_forward_proj="gated-gelu" if c.is_gated else "relu",
            tie_word_embeddings=c.tie_word_embeddings, decoder_start_token_id=c.decoder_start_token_id,
            is_encoder_decoder=True,
        )
    else:
        raise ValueError(f"No HF config factory for {model_type!r}")
    return {"model_type": model_type, **fields}


# ------------------------------------------------------------------- T5 (seq2seq)


def _t5_attn_to_params(sd, pre, has_bias):
    p = {k: {"kernel": sd[f"{pre}.{k}.weight"].T} for k in ("q", "k", "v", "o")}
    if has_bias:
        p["relative_attention_bias"] = {"embedding": sd[f"{pre}.relative_attention_bias.weight"]}
    return p


def _t5_ffn_to_params(sd, pre, gated):
    names = ("wi_0", "wi_1", "wo") if gated else ("wi", "wo")
    return {k: {"kernel": sd[f"{pre}.{k}.weight"].T} for k in names}


def t5_state_dict_to_params(sd: Dict[str, np.ndarray], config) -> Dict[str, Any]:
    """HF T5 state dict -> the ``T5LM`` parameter tree (f32 numpy)."""
    gated = config.is_gated
    p: Dict[str, Any] = {
        "shared": {"embedding": sd["shared.weight"]},
        "encoder_ln": {"scale": sd["encoder.final_layer_norm.weight"]},
        "decoder_ln": {"scale": sd["decoder.final_layer_norm.weight"]},
    }
    if not config.tie_word_embeddings and "lm_head.weight" in sd:
        p["lm_head"] = {"kernel": sd["lm_head.weight"].T}
    for i in range(config.num_layers):
        pre = f"encoder.block.{i}"
        p[f"encoder_blocks_{i}"] = {
            "ln_1": {"scale": sd[f"{pre}.layer.0.layer_norm.weight"]},
            "attn": _t5_attn_to_params(sd, f"{pre}.layer.0.SelfAttention", i == 0),
            "ln_2": {"scale": sd[f"{pre}.layer.1.layer_norm.weight"]},
            "mlp": _t5_ffn_to_params(sd, f"{pre}.layer.1.DenseReluDense", gated),
        }
    for i in range(config.num_decoder_layers):
        pre = f"decoder.block.{i}"
        p[f"decoder_blocks_{i}"] = {
            "ln_1": {"scale": sd[f"{pre}.layer.0.layer_norm.weight"]},
            "self_attn": _t5_attn_to_params(sd, f"{pre}.layer.0.SelfAttention", i == 0),
            "ln_cross": {"scale": sd[f"{pre}.layer.1.layer_norm.weight"]},
            "cross_attn": _t5_attn_to_params(sd, f"{pre}.layer.1.EncDecAttention", False),
            "ln_2": {"scale": sd[f"{pre}.layer.2.layer_norm.weight"]},
            "mlp": _t5_ffn_to_params(sd, f"{pre}.layer.2.DenseReluDense", gated),
        }
    return _tree_map(lambda x: np.asarray(x, np.float32), p)


def _t5_attn_from_params(p, pre, sd):
    for k in ("q", "k", "v", "o"):
        sd[f"{pre}.{k}.weight"] = p[k]["kernel"].T
    if "relative_attention_bias" in p:
        sd[f"{pre}.relative_attention_bias.weight"] = p["relative_attention_bias"]["embedding"]


def _t5_ffn_from_params(p, pre, sd):
    for name in ("wi", "wi_0", "wi_1", "wo"):
        if name in p:
            sd[f"{pre}.{name}.weight"] = p[name]["kernel"].T


def _t5_from_params(p: Dict[str, Any], c) -> Dict[str, np.ndarray]:
    """The ``T5LM`` parameter tree -> an HF T5 state dict (the reverse of
    :func:`t5_state_dict_to_params`; the tied embedding under all three of
    HF's names)."""
    sd = {
        "shared.weight": p["shared"]["embedding"],
        "encoder.embed_tokens.weight": p["shared"]["embedding"],
        "decoder.embed_tokens.weight": p["shared"]["embedding"],
        "encoder.final_layer_norm.weight": p["encoder_ln"]["scale"],
        "decoder.final_layer_norm.weight": p["decoder_ln"]["scale"],
    }
    if "lm_head" in p:
        sd["lm_head.weight"] = p["lm_head"]["kernel"].T
    for i in range(c.num_layers):
        pre, L = f"encoder.block.{i}", p[f"encoder_blocks_{i}"]
        sd[f"{pre}.layer.0.layer_norm.weight"] = L["ln_1"]["scale"]
        _t5_attn_from_params(L["attn"], f"{pre}.layer.0.SelfAttention", sd)
        sd[f"{pre}.layer.1.layer_norm.weight"] = L["ln_2"]["scale"]
        _t5_ffn_from_params(L["mlp"], f"{pre}.layer.1.DenseReluDense", sd)
    for i in range(c.num_decoder_layers):
        pre, L = f"decoder.block.{i}", p[f"decoder_blocks_{i}"]
        sd[f"{pre}.layer.0.layer_norm.weight"] = L["ln_1"]["scale"]
        _t5_attn_from_params(L["self_attn"], f"{pre}.layer.0.SelfAttention", sd)
        sd[f"{pre}.layer.1.layer_norm.weight"] = L["ln_cross"]["scale"]
        _t5_attn_from_params(L["cross_attn"], f"{pre}.layer.1.EncDecAttention", sd)
        sd[f"{pre}.layer.2.layer_norm.weight"] = L["ln_2"]["scale"]
        _t5_ffn_from_params(L["mlp"], f"{pre}.layer.2.DenseReluDense", sd)
    return sd


CONVERTERS["t5"] = (t5_state_dict_to_params, _t5_from_params)


def load_pretrained_seq2seq(model_path: str, overrides: Optional[Dict[str, Any]] = None):
    """(T5Config, T5LM state or None) for a seq2seq model path: a native
    store restores and a local HF T5
    directory converts as :func:`load_pretrained` does (a directory
    without ``config.json`` raises ``FileNotFoundError``); anything else
    gives the random-init ``T5Config()`` (t5-small widths) with
    ``overrides``, as the JAX package."""
    from trlx_tpu_torch import checkpointing
    from trlx_tpu_torch.models.t5 import T5Config, from_hf_t5_config

    overrides = dict(overrides or {})
    for key in _DTYPE_FIELDS:
        if key in overrides:
            overrides[key] = torch_dtype(overrides[key])
    if checkpointing.is_native_checkpoint(model_path):
        config, state, _ = checkpointing.restore_native(model_path, overrides, expect_seq2seq=True)
        return config, state
    config_path = os.path.join(model_path, "config.json")
    if os.path.isdir(model_path):
        if not os.path.exists(config_path):
            raise FileNotFoundError(f"{model_path!r} is a directory without config.json")
        with open(config_path) as f:
            config = from_hf_t5_config(json.load(f), overrides)
        params = t5_state_dict_to_params(_read_hf_weights(model_path), config)
        return config, {k: torch.from_numpy(v) for k, v in state_from_params(params).items()}
    config = T5Config().replace(**overrides)
    logger.warning(f"No local checkpoint at {model_path!r}; using random-init T5 config")
    return config, None


# ------------------------------------------------------------------- peft

#: the leaf names that belong to peft adapters (LoRA / prefix / prompt)
ADAPTER_PARAM_NAMES = ("lora_a", "lora_b", "prefix_k", "prefix_v", "prompt_embeddings")

#: the file :func:`save_adapters` writes next to an export
ADAPTERS_FILE = "adapters.safetensors"


def extract_adapter_params(state: Mapping[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
    """The adapter-only entries of a ``state_dict`` (None when it has none):
    the reference saves peft adapters and heads instead of the whole model."""
    out = {name: value for name, value in state.items() if name.rsplit(".", 1)[-1] in ADAPTER_PARAM_NAMES}
    return out or None


def save_adapters(path: str, state: Mapping[str, torch.Tensor]) -> bool:
    """Write the adapters of ``state`` to ``adapters.safetensors`` under
    ``path``; False (and no file) when there are none."""
    adapters = extract_adapter_params(state)
    if not adapters:
        return False
    os.makedirs(path, exist_ok=True)
    safetensors_io.save_file(adapters, os.path.join(path, ADAPTERS_FILE))
    return True


def load_adapters(path: str, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state`` with the adapters of ``path``'s ``adapters.safetensors``
    laid over it (on each entry's device and in its dtype); an adapter
    ``state`` lacks, or of another shape, raises."""
    adapters = safetensors_io.load_file(os.path.join(path, ADAPTERS_FILE))
    out = dict(state)
    for name, value in adapters.items():
        if name not in out:
            raise ValueError(f"adapter {name!r} has no parameter in the model")
        if tuple(value.shape) != tuple(out[name].shape):
            raise ValueError(f"{name}: adapter shape {tuple(value.shape)} != {tuple(out[name].shape)}")
        out[name] = value.to(device=out[name].device, dtype=out[name].dtype)
    return out


def peft_overrides(peft_config: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """A reference-style peft config dict as model overrides (LORA,
    PREFIX_TUNING, PROMPT_TUNING), as the JAX package maps it."""
    if not peft_config:
        return {}
    ptype = str(peft_config.get("peft_type", "LORA")).upper()
    if ptype == "LORA":
        out = {"lora_r": int(peft_config.get("r", 8)),
               "lora_alpha": float(peft_config.get("lora_alpha", peft_config.get("alpha", 16)))}
        targets = peft_config.get("target_modules")
        if targets:
            out["lora_targets"] = tuple(targets)
        return out
    if ptype in ("PREFIX_TUNING", "PREFIX"):
        return {"peft_type": "prefix", "num_virtual_tokens": int(peft_config.get("num_virtual_tokens", 8))}
    if ptype in ("PROMPT_TUNING", "PROMPT"):
        return {"peft_type": "prompt", "num_virtual_tokens": int(peft_config.get("num_virtual_tokens", 8))}
    raise ValueError(f"Unsupported peft_type {ptype!r} (LORA / PREFIX_TUNING / PROMPT_TUNING)")


#: the T5 projections LoRA may target
T5_LORA_TARGETS = ("q", "k", "v", "o", "wi", "wi_0", "wi_1", "wo")


def t5_peft_overrides(peft_config: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """:func:`peft_overrides` for T5: LoRA only, targets ``("q", "v")`` by
    default, and a target list naming no T5 projection (a causal model's
    ``q_proj``) raises rather than building no adapter and a frozen trunk."""
    peft = peft_overrides(peft_config)
    if not peft:
        return {}
    if "lora_r" not in peft:
        raise NotImplementedError(
            "seq2seq (T5) peft supports LORA adapters; prefix/prompt tuning "
            "is implemented for causal models only")
    peft.setdefault("lora_targets", ("q", "v"))
    unknown = set(peft["lora_targets"]) - set(T5_LORA_TARGETS)
    if unknown:
        raise ValueError(
            f"peft target_modules {sorted(unknown)} match no T5 module; "
            f"valid targets: {T5_LORA_TARGETS}")
    return peft
