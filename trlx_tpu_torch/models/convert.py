"""Carry a JAX ``TransformerLM``, ``CausalLMWithValueHead`` (with its value
branch, ``value_blocks_{i}`` and ``value_ln``) or ``CausalLMWithILQLHeads``
(``ilql_heads``) parameter tree across to the port, and the seq2seq ones:
a ``T5LM`` trunk, ``Seq2SeqLMWithValueHead`` (``t5``, ``v_head_mlp``) and
``Seq2SeqLMWithILQLHeads`` (``t5``, ``ilql_heads``).

The port's modules keep the flax names (``layers_{i}``, ``kernel [in, out]``,
``bias``, ``scale``, ``embedding``), so conversion is a flatten of the nested
tree with ``.`` joins plus a dtype cast — no transposes. A stacked tree
(``scan_layers`` / ``pipeline_stages > 1``: ``layers_scan`` with a leading
``[L]`` dim on every block leaf) maps the same way onto the port's
``layers_scan.<block path>`` tensors. The tree arrives as
numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX side), so this
module imports nothing of JAX.

:func:`shard_state` / :func:`gather_state` cut a whole ``state_dict`` into
a rank's blocks by the partition rules and put them back, over every mesh
axis: a ``layers_scan`` leaf on a ``pipe`` axis keeps its stage's layers
(its ``fsdp`` / ``model`` dims cut as the rule names), every other leaf
stays whole over ``pipe``.
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


def _state_from_tree(tree: Mapping[str, Any], model: torch.nn.Module, dtype) -> Dict[str, torch.Tensor]:
    """Flatten ``tree`` and match it leaf for leaf against ``model``'s
    ``state_dict``: raises on any leaf the module has no parameter for (an
    adapter, ``prefix_k`` / ``prefix_v`` or ``prompt_embeddings`` leaf under
    a config without that peft, value-branch blocks), on any parameter the
    tree lacks (a config with adapters the tree has not), and on any shape
    that differs. Under the matching peft config the adapters carry across
    like any other leaf (``lora_a [in, r]``, ``lora_b [r, out]``,
    ``prefix_k`` / ``prefix_v [nv, Hkv, D]``, ``prompt_embeddings [nv,
    hidden]``)."""
    flat = _flatten(tree)
    expected = model.state_dict()
    extra = sorted(set(flat) - set(expected))
    missing = sorted(set(expected) - set(flat))
    if extra or missing:
        raise ValueError(f"parameter tree mismatch: unexpected {extra}, missing {missing}")
    state = {}
    for name, value in flat.items():
        arr = np.asarray(value, dtype=np.float32)
        if arr.shape != tuple(expected[name].shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(expected[name].shape)}")
        state[name] = torch.from_numpy(arr.copy()).to(dtype)
    return state


def params_from_jax(params: Mapping[str, Any], config: TransformerConfig) -> Dict[str, torch.Tensor]:
    """Nested numpy parameter tree (flax layout) -> ``state_dict`` for
    :class:`TransformerLM` in ``config.param_dtype``."""
    return _state_from_tree(params, TransformerLM(config), config.param_dtype)


def t5_params_from_jax(params: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """Nested numpy parameter tree of a JAX ``T5LM`` -> ``state_dict`` for
    :class:`~trlx_tpu_torch.models.t5.T5LM` in ``config.param_dtype``."""
    from trlx_tpu_torch.models.t5 import T5LM

    return _state_from_tree(params, T5LM(config), config.param_dtype)


def policy_params_from_jax(tree: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """The numpy tree of a JAX policy -> ``state_dict`` for its port in
    ``config.param_dtype``: ``CausalLMWithValueHead`` (``transformer``,
    ``v_head``, and a value branch ``value_blocks_{i}`` / ``value_ln`` when
    the tree has one) or, for a tree with ``ilql_heads``,
    ``CausalLMWithILQLHeads`` (one or two Q heads, as the tree has); a tree
    with a ``t5`` trunk (``config`` a ``T5Config``) gives
    ``Seq2SeqLMWithValueHead`` or ``Seq2SeqLMWithILQLHeads``. Raises on any
    leaf that does not match."""
    from trlx_tpu_torch.models.policy import (
        CausalLMWithILQLHeads,
        CausalLMWithValueHead,
        Seq2SeqLMWithILQLHeads,
        Seq2SeqLMWithValueHead,
    )

    if "t5" in tree:
        if "ilql_heads" in tree:
            model = Seq2SeqLMWithILQLHeads(config, two_qs="q_heads_1" in tree["ilql_heads"])
        else:
            model = Seq2SeqLMWithValueHead(config)
        return _state_from_tree(tree, model, config.param_dtype)
    if "ilql_heads" in tree:
        model = CausalLMWithILQLHeads(config, two_qs="q_heads_1" in tree["ilql_heads"])
    else:
        n_value = sum(1 for key in tree if key.startswith("value_blocks_"))
        model = CausalLMWithValueHead(config, num_value_layers=n_value)
    return _state_from_tree(tree, model, config.param_dtype)


def load_jax_params(model: TransformerLM, params: Mapping[str, Any]) -> TransformerLM:
    """Copy a JAX parameter tree into ``model`` (on whatever device it lives)."""
    model.load_state_dict(params_from_jax(params, model.config))
    return model


def shard_state(full: Mapping[str, torch.Tensor], mesh, rank: int = None, rules=None) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s blocks (default the mesh's own rank) of a whole
    ``state_dict`` by the JAX package's partition rules: each tensor cut on
    the dims its spec shards, at the rank's mesh coordinates (the block the
    JAX array holds on the device with those coordinates)."""
    from trlx_tpu_torch.parallel.mesh import MESH_AXES, Mesh
    from trlx_tpu_torch.parallel.sharding import make_param_specs, shard_tensor

    at = Mesh([mesh.shape[a] for a in MESH_AXES], mesh.rank if rank is None else rank)
    specs = make_param_specs(full, mesh, rules)
    return {name: shard_tensor(t, specs[name], at).clone() for name, t in full.items()}


def gather_state(shards, mesh, shapes: Mapping[str, Any], rules=None) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` back from every rank's blocks (``shards[r]``
    is :func:`shard_state` at rank ``r``; ``shapes`` the whole shapes, which
    decide the specs): blocks concatenated along each sharded dim in mesh
    order."""
    from trlx_tpu_torch.parallel.mesh import MESH_AXES, Mesh
    from trlx_tpu_torch.parallel.sharding import _entry_axes, make_param_specs

    sizes = [mesh.shape[a] for a in MESH_AXES]
    coords = [tuple(Mesh(sizes, r).coords[a] for a in MESH_AXES) for r in range(len(shards))]
    specs = make_param_specs({name: tuple(shape) for name, shape in shapes.items()}, mesh, rules)
    out = {}
    for name, spec in specs.items():
        blocks = {c: s[name] for c, s in zip(coords, shards)}
        dims = [(i, a) for i, entry in enumerate(spec) for a in _entry_axes(entry)]

        def assemble(k, fixed):
            if k == len(dims):
                return blocks[tuple(fixed.get(a, 0) for a in MESH_AXES)]
            i, a = dims[k]
            return torch.cat([assemble(k + 1, {**fixed, a: c}) for c in range(mesh.shape[a])], dim=i)

        out[name] = assemble(0, {})
    return out
