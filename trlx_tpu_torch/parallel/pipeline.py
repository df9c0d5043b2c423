"""The stacked layer layout's host helpers (counterpart of the layout half of
``trlx_tpu/parallel/pipeline.py``).

A stacked :class:`~trlx_tpu_torch.models.transformer.TransformerLM`
(``scan_layers``, or ``pipeline_stages > 1``) keeps every block parameter
as one ``[L, ...]`` tensor under ``layers_scan.<block path>``; HF checkpoints
and the listed layout name them ``layers_{i}.<block path>``.
:func:`stack_layer_params` and :func:`unstack_layer_params` convert a flat
trunk ``state_dict`` between the two (loading an HF checkpoint into a
stacked model, and exporting one).

With no pipe axis ``pipeline_stages > 1`` is simply the stacked layout and
``pipeline_microbatches`` is ignored, as in the JAX package. The GPipe
schedule over a pipe axis (the reference's ``pipeline_apply``, which
:func:`pick_microbatches` sizes) comes with scale-out slice 2.
"""

import re
from typing import Dict, Mapping

import torch

_LAYER = re.compile(r"layers_(\d+)\.(.+)")
STACK_PREFIX = "layers_scan."


def stack_layer_params(state: Mapping[str, torch.Tensor], num_layers: int) -> Dict[str, torch.Tensor]:
    """A listed trunk ``state_dict`` (``layers_0.*`` .. ``layers_{L-1}.*``)
    in the stacked layout: each block path once under ``layers_scan.``, its
    L tensors stacked on a new leading dim (copies). Other entries pass
    through. Raises when a layer lacks a path another layer has."""
    out: Dict[str, torch.Tensor] = {}
    per_path: Dict[str, Dict[int, torch.Tensor]] = {}
    for name, value in state.items():
        m = _LAYER.fullmatch(name)
        if m is None:
            out[name] = value
        else:
            per_path.setdefault(m.group(2), {})[int(m.group(1))] = value
    for path, layers in per_path.items():
        if sorted(layers) != list(range(num_layers)):
            raise ValueError(f"{path}: layers {sorted(layers)}, expected 0..{num_layers - 1}")
        out[STACK_PREFIX + path] = torch.stack([layers[i] for i in range(num_layers)])
    return out


def unstack_layer_params(state: Mapping[str, torch.Tensor], num_layers: int) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_layer_params` (HF export): each
    ``layers_scan.<path>`` ``[L, ...]`` becomes ``layers_{i}.<path>`` for
    every i (views of the stack)."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in state.items():
        if not name.startswith(STACK_PREFIX):
            out[name] = value
            continue
        if value.shape[0] != num_layers:
            raise ValueError(f"{name}: leading dim {value.shape[0]} != num_layers {num_layers}")
        path = name[len(STACK_PREFIX):]
        for i, layer in enumerate(value.unbind(0)):
            out[f"layers_{i}.{path}"] = layer
    return out


def is_stacked(state: Mapping[str, torch.Tensor]) -> bool:
    """Whether a trunk ``state_dict`` holds the stacked layout."""
    return any(name.startswith(STACK_PREFIX) for name in state)


def pick_microbatches(batch: int, requested: int) -> int:
    """Largest microbatch count <= requested that divides the batch."""
    m = max(1, min(requested, batch))
    while batch % m:
        m -= 1
    return m
