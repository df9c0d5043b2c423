"""Model definitions: TransformerLM, presets, JAX parameter conversion."""
