"""Carry a JAX ``TransformerLM`` parameter tree across to the port.

The port's modules keep the flax names (``layers_{i}``, ``kernel [in, out]``,
``bias``, ``scale``, ``embedding``), so conversion is a flatten of the nested
tree with ``.`` joins plus a dtype cast — no transposes. The tree arrives as
numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX side), so this
module imports nothing of JAX.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch

from trlx_tpu_torch.models.transformer import TransformerConfig, TransformerLM


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def params_from_jax(params: Mapping[str, Any], config: TransformerConfig) -> Dict[str, torch.Tensor]:
    """Nested numpy parameter tree (flax layout) -> ``state_dict`` for
    :class:`TransformerLM` in ``config.param_dtype``. Raises on any leaf the
    port's module has no parameter for (LoRA adapters, prompt/prefix
    embeddings) and on any parameter the tree lacks."""
    flat = _flatten(params)
    expected = TransformerLM(config).state_dict()
    extra = sorted(set(flat) - set(expected))
    missing = sorted(set(expected) - set(flat))
    if extra or missing:
        raise ValueError(f"parameter tree mismatch: unexpected {extra}, missing {missing}")
    state = {}
    for name, value in flat.items():
        arr = np.asarray(value, dtype=np.float32)
        if arr.shape != tuple(expected[name].shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(expected[name].shape)}")
        state[name] = torch.from_numpy(arr.copy()).to(config.param_dtype)
    return state


def load_jax_params(model: TransformerLM, params: Mapping[str, Any]) -> TransformerLM:
    """Copy a JAX parameter tree into ``model`` (on whatever device it lives)."""
    model.load_state_dict(params_from_jax(params, model.config))
    return model
