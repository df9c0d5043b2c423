"""Model resolution by path (counterpart of ``trlx_tpu/models/hf_loading.py``
``load_pretrained``, the preset-name branch only).

A model path names a family preset (``"gpt2"``, ``"lvwerra/gpt2-imdb"`` ->
gpt2, ...) built at its published widths with random weights, which the
caller initialises from a seed; ``model_overrides`` replace config fields.
Local and HF checkpoint directories come with the checkpoint slice.
"""

import logging
import os
from typing import Any, Dict, Optional, Tuple

import torch

from trlx_tpu_torch.models.presets import get_preset
from trlx_tpu_torch.models.transformer import TransformerConfig

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


def load_pretrained(
    model_path: str, overrides: Optional[Dict[str, Any]] = None
) -> Tuple[TransformerConfig, None, str]:
    """(config, None, model_type) for a preset name: the caller random-inits
    the weights. Dtype overrides may be torch dtypes or their names."""
    if os.path.isdir(model_path):
        raise NotImplementedError(
            f"trlx_tpu_torch does not load checkpoint directories yet ({model_path!r}): "
            "checkpoint slice; name a preset (e.g. 'gpt2') for random weights from the seed"
        )
    overrides = dict(overrides or {})
    for key in _DTYPE_FIELDS:
        if key in overrides:
            overrides[key] = torch_dtype(overrides[key])
    config = get_preset(model_path, overrides)
    model_type = _family_of(model_path)
    logger.warning(f"No local checkpoint at {model_path!r}; using random-init {model_type} preset")
    return config, None, model_type
