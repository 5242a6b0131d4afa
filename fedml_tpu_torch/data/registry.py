"""Dataset registry (mirror of ``fedml_tpu/data/registry.py``): the native
object is ``FederatedDataset`` holding fixed-shape ``PackedClients``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from fedml_tpu_torch.data.packing import PackedClients


@dataclass
class FederatedDataset:
    name: str
    train: PackedClients
    test: PackedClients | None  # per-client test split (None => global only)
    train_global: tuple[np.ndarray, np.ndarray]
    test_global: tuple[np.ndarray, np.ndarray]
    class_num: int
    meta: dict = field(default_factory=dict)

    @property
    def client_num(self) -> int:
        return self.train.num_clients



_LOADERS: dict[str, Callable] = {}


def register_loader(name: str):
    def deco(fn):
        _LOADERS[name] = fn
        return fn

    return deco


def load_dataset(name: str, **kwargs) -> FederatedDataset:
    """Load a federated dataset by name."""
    import fedml_tpu_torch.data.loaders  # noqa: F401  (registers loaders)

    if name not in _LOADERS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported to fedml_tpu_torch yet "
            f"(ported: {sorted(_LOADERS)})")
    return _LOADERS[name](**kwargs)


def available_datasets() -> list[str]:
    import fedml_tpu_torch.data.loaders  # noqa: F401  (registers loaders)

    return sorted(_LOADERS)
