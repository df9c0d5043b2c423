"""Shared name->class registry factory used by the method / pipeline /
trainer registries (a copy of ``trlx_tpu/utils/registry.py``)."""

from typing import Dict


def make_registry(store: Dict[str, type]):
    """Return a ``register`` decorator writing (lowercased name -> class) into
    ``store``. Accepts ``@register``, ``@register("name")``, or ``register(cls)``."""

    def register(name_or_cls=None):
        def _register(cls, name=None):
            store[(name or cls.__name__).lower()] = cls
            return cls

        if isinstance(name_or_cls, str):
            return lambda cls: _register(cls, name_or_cls)
        if name_or_cls is None:
            return _register
        return _register(name_or_cls)

    return register
