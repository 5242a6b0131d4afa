"""Base framework, the didactic minimal algorithm skeleton (PyTorch form of
``fedml_tpu/algorithms/base_framework.py``).

Reference fedml_api/distributed/base_framework/ (algorithm_api.py
``FedML_Base_distributed``, central_worker.py ``BaseCentralWorker.aggregate``:
a central worker sums scalar values from clients; the template new
algorithms copy). Here the round is a client value function, one
``torch.sum`` of the round's float32 values on the run's device, and the
round loop.
"""

from __future__ import annotations

from typing import Callable

import torch

from fedml_tpu_torch.utils.device import resolve_device


class BaseCentralWorker:
    """Sums client scalars (reference central_worker.py)."""

    def __init__(self, client_num: int):
        self.client_num = client_num
        self._values: dict[int, float] = {}

    def add_client_local_result(self, index: int, value: float):
        self._values[index] = value

    def check_whether_all_receive(self) -> bool:
        return len(self._values) == self.client_num

    def aggregate(self) -> float:
        out = float(sum(self._values.values()))
        self._values.clear()
        return out


def FedML_Base_simulated(client_num: int, client_value_fn: Callable[[int, int], float],
                         comm_round: int = 3, device="cuda") -> list[float]:
    """The whole base-framework flow: each round the clients' values as one
    float32 tensor on ``device`` (``cuda`` unless the caller asks for the
    CPU), summed there (replaces the MPI send/receive skeleton of
    algorithm_api.py)."""
    device = resolve_device(device)
    results = []
    for r in range(comm_round):
        values = torch.tensor([client_value_fn(i, r) for i in range(client_num)],
                              dtype=torch.float32, device=device)
        results.append(float(torch.sum(values)))
    return results
