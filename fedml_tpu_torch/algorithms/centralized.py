"""Centralized trainer, the accuracy-equivalence oracle's partner (PyTorch
form of ``fedml_tpu/algorithms/centralized.py``).

Reference fedml_api/centralized/centralized_trainer.py:10-123 trains the
union of all federated data on one device; CI asserts full-batch E=1 FedAvg
== centralized to 3 decimals (reference CI-script-fedavg.sh:44-50). Here the
engine's ``build_local_update`` runs on the union ``train_global`` as one
client, a round at a time; the round's shuffle and dropout stream come from
the round's generator ``fedavg.round_generator(seed, round)``.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.engine import (build_eval_fn, build_local_update,
                                               draw_client_randomness, pack_test_batches,
                                               test_metrics)
from fedml_tpu_torch.algorithms.fedavg import round_generator
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.utils.device import resolve_device


class CentralizedTrainer:
    """``train(rounds)`` runs ``rounds`` passes of cfg.epochs local epochs
    over the whole union, on ``device`` (``cuda`` unless the caller asks for
    the CPU), and returns one Test/Acc, Test/Loss record a round."""

    def __init__(self, dataset: FederatedDataset, config: FedConfig, model_trainer,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = config.validate(device=self.device)
        self.trainer = model_trainer
        self.local_update = build_local_update(model_trainer, config)
        self.eval_fn = build_eval_fn(model_trainer)
        x, y = dataset.train_global
        self.x = torch.from_numpy(x).to(self.device)
        self.y = torch.from_numpy(y).to(self.device)
        self.count = len(x)
        self.global_variables = model_trainer.init(
            torch.Generator().manual_seed(config.seed), self.device)
        self._test_batches = pack_test_batches(dataset.test_global, config.batch_size,
                                               self.device)

    def train_one_round(self, round_idx: int) -> dict:
        """cfg.epochs epochs over the union; returns the epoch's train
        metric sums as 0-d tensors on the device."""
        rng = round_generator(self.cfg.seed, round_idx)
        perms, seeds = draw_client_randomness(rng, [self.count], self.count,
                                              self.cfg.epochs, self.cfg.shuffle)
        gen = torch.Generator(device=self.device).manual_seed(int(seeds[0]))
        result = self.local_update(self.global_variables, self.x, self.y, self.count, gen,
                                   None if perms is None else perms[0])
        self.global_variables = result.variables
        return result.metrics

    def train(self, rounds: int | None = None):
        rounds = rounds if rounds is not None else self.cfg.comm_round
        history = []
        for r in range(rounds):
            self.train_one_round(r)
            history.append(self.eval_global())
        return history

    def eval_global(self):
        return test_metrics(self.eval_fn, self.global_variables, self._test_batches)
