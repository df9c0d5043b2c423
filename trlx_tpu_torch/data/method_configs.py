"""Method (algorithm) hyperparameter configs and their registry (a copy of
``trlx_tpu/data/method_configs.py``): every RL algorithm registers a
dataclass holding its hyperparameters by name, and the method object also
owns the algorithm's loss function."""

from dataclasses import dataclass
from typing import Any, Dict

from trlx_tpu_torch.utils.registry import make_registry

# name (lowercased) -> method config class
_METHODS: Dict[str, type] = {}

#: Decorator registering a method config class under its (lowercased) name.
register_method = make_registry(_METHODS)


def get_method(name: str) -> type:
    """Return the registered method config class for ``name``.

    Raises a helpful error listing known methods otherwise.
    """
    key = name.lower()
    if key in _METHODS:
        return _METHODS[key]
    # the registry fills when the methods package is imported
    import trlx_tpu_torch.methods  # noqa: F401

    if key in _METHODS:
        return _METHODS[key]
    raise ValueError(f"Unknown method {name!r}. Registered methods: {sorted(_METHODS)}")


@dataclass
class MethodConfig:
    """Base config for an RL method.

    :param name: registry name of the method (e.g. ``"PPOConfig"``).
    """

    name: str = "MethodConfig"

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)

    def to_dict(self) -> Dict[str, Any]:
        from dataclasses import asdict

        return asdict(self)


register_method(MethodConfig)
