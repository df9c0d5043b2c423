"""Architecture presets for the generic TransformerLM, their name lookup and
the conversion of an HF ``config.json`` (copied from
``trlx_tpu/models/presets.py``; :func:`from_hf_config` reads the JSON dict
instead of a ``transformers`` config object)."""

from typing import Any, Dict, Optional

from trlx_tpu_torch.models.transformer import TransformerConfig

PRESETS: Dict[str, TransformerConfig] = {
    "gpt2": TransformerConfig(
        vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12,
        max_position_embeddings=1024, pos_embedding="learned", norm="layernorm",
        activation="gelu_new", attn_bias=True, mlp_bias=True, tie_word_embeddings=True,
    ),
    "gptj": TransformerConfig(
        vocab_size=50400, hidden_size=4096, num_layers=28, num_heads=16,
        max_position_embeddings=2048, pos_embedding="rotary", rope_style="gptj",
        rotary_pct=64 / 256, norm="layernorm", activation="gelu_new",
        parallel_residual=True, shared_parallel_ln=True, attn_bias=False, mlp_bias=True,
        head_bias=True, tie_word_embeddings=False,
    ),
    "gpt_neox": TransformerConfig(
        vocab_size=50304, hidden_size=768, num_layers=12, num_heads=12,
        max_position_embeddings=2048, pos_embedding="rotary", rope_style="neox",
        rotary_pct=0.25, norm="layernorm", activation="gelu", parallel_residual=True,
        shared_parallel_ln=False, attn_bias=True, mlp_bias=True, tie_word_embeddings=False,
    ),
    "opt": TransformerConfig(
        vocab_size=50272, hidden_size=768, num_layers=12, num_heads=12,
        max_position_embeddings=2048, pos_embedding="learned", pos_offset=2,
        norm="layernorm", activation="relu", attn_bias=True, mlp_bias=True,
        tie_word_embeddings=True,
    ),
    "llama": TransformerConfig(
        vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
        intermediate_size=11008, max_position_embeddings=4096, pos_embedding="rotary",
        rope_style="neox", norm="rmsnorm", norm_eps=1e-6, activation="silu", glu=True,
        attn_bias=False, mlp_bias=False, tie_word_embeddings=False,
    ),
    "bloom": TransformerConfig(
        vocab_size=250880, hidden_size=1024, num_layers=24, num_heads=16,
        max_position_embeddings=2048, pos_embedding="alibi", norm="layernorm",
        activation="gelu_new", attn_bias=True, mlp_bias=True, embed_ln=True,
        tie_word_embeddings=True,
    ),
    "gpt_bigcode": TransformerConfig(
        vocab_size=49152, hidden_size=2048, num_layers=24, num_heads=16,
        num_kv_heads=1, max_position_embeddings=2048, pos_embedding="learned",
        norm="layernorm", activation="gelu_new", attn_bias=True, mlp_bias=True,
        tie_word_embeddings=True,
    ),
}


def get_preset(name: str, overrides: Optional[Dict[str, Any]] = None) -> TransformerConfig:
    """Resolve a family preset by name (exact or prefix: "gpt2-imdb" -> gpt2)."""
    key = name.lower()
    config = None
    if key in PRESETS:
        config = PRESETS[key]
    else:
        for family in ("gpt_bigcode", "gpt_neox", "gptj", "gpt2", "llama", "opt", "bloom"):
            if family.replace("_", "") in key.replace("_", "").replace("-", ""):
                config = PRESETS[family]
                break
        if config is None and ("pythia" in key or "neox" in key):
            config = PRESETS["gpt_neox"]
        if config is None and ("starcoder" in key or "santacoder" in key):
            config = PRESETS["gpt_bigcode"]
    if config is None:
        raise ValueError(f"Unknown architecture preset for {name!r}; known: {sorted(PRESETS)}")
    if overrides:
        config = config.replace(**overrides)
    return config


#: the HF config classes' defaults for every field :func:`from_hf_config`
#: reads. ``transformers`` writes ``config.json`` as a diff against its
#: defaults (``tie_word_embeddings: true`` is left out, for one), so a key
#: that is missing reads as its family's class default.
HF_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "gpt2": dict(vocab_size=50257, n_embd=768, n_layer=12, n_head=12, n_inner=None, n_positions=1024,
                 layer_norm_epsilon=1e-5, tie_word_embeddings=True),
    "gptj": dict(vocab_size=50400, n_embd=4096, n_layer=28, n_head=16, n_positions=2048, rotary_dim=64,
                 layer_norm_epsilon=1e-5, tie_word_embeddings=False),
    "gpt_neox": dict(vocab_size=50432, hidden_size=6144, num_hidden_layers=44, num_attention_heads=64,
                     intermediate_size=24576, max_position_embeddings=2048, rotary_pct=0.25,
                     layer_norm_eps=1e-5, use_parallel_residual=True, tie_word_embeddings=False),
    "opt": dict(vocab_size=50272, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                ffn_dim=3072, max_position_embeddings=2048, tie_word_embeddings=True),
    "llama": dict(vocab_size=32000, hidden_size=4096, num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=None, intermediate_size=11008, max_position_embeddings=2048,
                  rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False),
    "gpt_bigcode": dict(vocab_size=50257, n_embd=768, n_layer=12, n_head=12, n_inner=None, n_positions=1024,
                        layer_norm_epsilon=1e-5, multi_query=True, tie_word_embeddings=True),
    "bloom": dict(vocab_size=250880, hidden_size=64, n_layer=2, n_head=8, layer_norm_epsilon=1e-5,
                  tie_word_embeddings=True),
}


def from_hf_config(hf_config: Dict[str, Any], overrides: Optional[Dict[str, Any]] = None) -> TransformerConfig:
    """Convert an HF ``config.json`` dict to TransformerConfig (a missing
    key reads as its family's :data:`HF_DEFAULTS` entry)."""
    mt = hf_config.get("model_type")
    if mt not in HF_DEFAULTS:
        raise ValueError(f"Unsupported HF model_type {mt!r}")
    h = {**HF_DEFAULTS[mt], **hf_config}
    if mt == "gpt2":
        config = PRESETS["gpt2"].replace(
            vocab_size=h["vocab_size"], hidden_size=h["n_embd"], num_layers=h["n_layer"],
            num_heads=h["n_head"], intermediate_size=h["n_inner"],
            max_position_embeddings=h["n_positions"], norm_eps=h["layer_norm_epsilon"],
        )
    elif mt == "gptj":
        config = PRESETS["gptj"].replace(
            vocab_size=h["vocab_size"], hidden_size=h["n_embd"], num_layers=h["n_layer"],
            num_heads=h["n_head"], max_position_embeddings=h["n_positions"],
            rotary_pct=h["rotary_dim"] / (h["n_embd"] // h["n_head"]),
            norm_eps=h["layer_norm_epsilon"],
        )
    elif mt == "gpt_neox":
        config = PRESETS["gpt_neox"].replace(
            vocab_size=h["vocab_size"], hidden_size=h["hidden_size"],
            num_layers=h["num_hidden_layers"], num_heads=h["num_attention_heads"],
            intermediate_size=h["intermediate_size"],
            max_position_embeddings=h["max_position_embeddings"],
            rotary_pct=h["rotary_pct"], norm_eps=h["layer_norm_eps"],
            parallel_residual=h["use_parallel_residual"],
            tie_word_embeddings=h["tie_word_embeddings"],
        )
    elif mt == "opt":
        config = PRESETS["opt"].replace(
            vocab_size=h["vocab_size"], hidden_size=h["hidden_size"],
            num_layers=h["num_hidden_layers"], num_heads=h["num_attention_heads"],
            intermediate_size=h["ffn_dim"], max_position_embeddings=h["max_position_embeddings"],
            tie_word_embeddings=h["tie_word_embeddings"],
        )
    elif mt == "llama":
        config = PRESETS["llama"].replace(
            vocab_size=h["vocab_size"], hidden_size=h["hidden_size"],
            num_layers=h["num_hidden_layers"], num_heads=h["num_attention_heads"],
            # the HF class sets a missing num_key_value_heads to num_attention_heads
            num_kv_heads=h["num_key_value_heads"] or h["num_attention_heads"],
            intermediate_size=h["intermediate_size"],
            max_position_embeddings=h["max_position_embeddings"],
            rope_theta=h["rope_theta"], norm_eps=h["rms_norm_eps"],
            tie_word_embeddings=h["tie_word_embeddings"],
        )
    elif mt == "bloom":
        config = PRESETS["bloom"].replace(
            vocab_size=h["vocab_size"], hidden_size=h.get("n_embed") or h["hidden_size"],
            num_layers=h["n_layer"], num_heads=h["n_head"], norm_eps=h["layer_norm_epsilon"],
            tie_word_embeddings=h["tie_word_embeddings"],
        )
    else:  # gpt_bigcode
        config = PRESETS["gpt_bigcode"].replace(
            vocab_size=h["vocab_size"], hidden_size=h["n_embd"], num_layers=h["n_layer"],
            num_heads=h["n_head"], num_kv_heads=1 if h["multi_query"] else None,
            intermediate_size=h["n_inner"], max_position_embeddings=h["n_positions"],
            norm_eps=h["layer_norm_epsilon"],
        )
    if overrides:
        config = config.replace(**overrides)
    return config
