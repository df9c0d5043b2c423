"""Pipeline layer: prompt/rollout dataset abstractions, a framework-free
loader, and the pipeline registry (counterpart of ``trlx_tpu/pipeline``).

Rollout data lives in host numpy; the trainer moves each batch to its
device. Gradient-accumulation microbatching happens in the trainer's step
(``MeshRLTrainer.make_grad_accum_step``), as in the JAX package.
"""

import random
from abc import abstractmethod
from typing import Any, Callable, Dict, Iterable, List

from trlx_tpu_torch.utils.registry import make_registry

# name (lowercased) -> pipeline class
_DATAPIPELINES: Dict[str, type] = {}

#: Decorator registering a pipeline class by (lowercased) name.
register_datapipeline = make_registry(_DATAPIPELINES)


class NumpyLoader:
    """Minimal re-iterable loader: dataset (sequence) -> collated batches.
    With ``shuffle`` each pass draws its permutation from
    ``random.Random(seed + epoch)``: the JAX package's exact order."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable[[List[Any]], Any],
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._epoch = 0
        self.seed = seed

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idxs = list(range(len(self.dataset)))
        if self.shuffle:
            rng = random.Random(self.seed + self._epoch)
            rng.shuffle(idxs)
        self._epoch += 1
        for start in range(0, len(idxs), self.batch_size):
            chunk = idxs[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[i] for i in chunk])


class BasePipeline:
    """Abstract prompt dataset."""

    def __init__(self, path: str = "dataset"):
        self.path = path

    @abstractmethod
    def __getitem__(self, index: int):
        ...

    @abstractmethod
    def __len__(self) -> int:
        ...

    @abstractmethod
    def create_loader(self, batch_size: int, shuffle: bool = False) -> NumpyLoader:
        ...


class BaseRolloutStore:
    """Abstract rollout/experience store."""

    def __init__(self, capacity: int = -1):
        self.history: Iterable[Any] = None
        self.capacity = capacity

    @abstractmethod
    def push(self, exps: Iterable[Any]):
        ...

    @abstractmethod
    def __getitem__(self, index: int):
        ...

    def __len__(self) -> int:
        return len(self.history)

    @abstractmethod
    def create_loader(self, batch_size: int, shuffle: bool = False) -> NumpyLoader:
        ...


from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline  # noqa: E402,F401
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage  # noqa: E402,F401
