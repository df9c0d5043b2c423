"""Prompt pipeline (counterpart of ``trlx_tpu/pipeline/offline_pipeline.py``:
``PromptPipeline`` only; the dialogue and ILQL stores come with the SFT and
ILQL slices)."""

from typing import Any, Dict, List, Union

import numpy as np

from trlx_tpu_torch.pipeline import BasePipeline, NumpyLoader, register_datapipeline


@register_datapipeline
class PromptPipeline(BasePipeline):
    """Tokenizes and stores prompts; prompts may be dicts carrying extra
    metadata keys, which are forwarded to reward/metric functions."""

    def __init__(self, prompts: List[Union[str, Dict[str, Any]]], max_prompt_length: int,
                 tokenizer, add_special_tokens: bool = False):
        super().__init__()
        self.tokenizer = tokenizer

        if prompts and isinstance(prompts[0], dict):
            metadata = [dict(p) for p in prompts]
            prompts = [m.pop("prompt") for m in metadata]
        else:
            metadata = [{}] * len(prompts)

        self.prompts = []
        for prompt, meta in zip(prompts, metadata):
            ids = tokenizer(prompt, add_special_tokens=add_special_tokens).input_ids
            if tokenizer.truncation_side == "left":
                ids = ids[-max_prompt_length:]
            else:
                ids = ids[:max_prompt_length]
            self.prompts.append({"input_ids": ids, **meta})

    def __getitem__(self, ix: int):
        return self.prompts[ix]

    def __len__(self) -> int:
        return len(self.prompts)

    def create_loader(self, batch_size: int, shuffle: bool = False, drop_last: bool = False,
                      seed: int = 0) -> NumpyLoader:
        def collate(xs: List[dict]) -> Dict[str, Any]:
            out: Dict[str, Any] = {
                "input_ids": [np.asarray(x["input_ids"], np.int32) for x in xs]
            }
            for key in xs[0]:
                if key != "input_ids":
                    out[key] = [x[key] for x in xs]
            return out

        return NumpyLoader(self, batch_size, collate, shuffle=shuffle, drop_last=drop_last, seed=seed)
