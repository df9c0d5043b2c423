"""Name->class resolution for trainers and pipelines (a copy of
``trlx_tpu/utils/loading.py``). Importing the trainer / pipeline packages
runs their registry decorators."""


def get_trainer(name: str) -> type:
    import trlx_tpu_torch.trainer  # noqa: F401 — populate registry

    from trlx_tpu_torch.trainer import _TRAINERS

    key = name.lower()
    if key in _TRAINERS:
        return _TRAINERS[key]
    raise ValueError(f"Unknown trainer {name!r}. Registered: {sorted(_TRAINERS)}")


def get_pipeline(name: str) -> type:
    import trlx_tpu_torch.pipeline  # noqa: F401 — populate registry

    from trlx_tpu_torch.pipeline import _DATAPIPELINES

    key = name.lower()
    if key in _DATAPIPELINES:
        return _DATAPIPELINES[key]
    raise ValueError(f"Unknown pipeline {name!r}. Registered: {sorted(_DATAPIPELINES)}")
