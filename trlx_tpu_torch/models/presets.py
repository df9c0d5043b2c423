"""Architecture presets for the generic TransformerLM and their name lookup
(copied from ``trlx_tpu/models/presets.py``; HF-config conversion comes with
the checkpoint slice)."""

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
