"""FedAvg simulator API — PyTorch form of ``fedml_tpu/algorithms/fedavg.py``
(reference fedml_api/standalone/fedavg/fedavg_api.py:13-215).

Ported: ``client_sampling`` (bitwise), and ``FedAvgAPI`` with ``__init__``,
``train_one_round``, the eager ``train`` loop, ``test_global`` and
``local_test_on_all_clients``. Chaos faults, the round guard, checkpoints,
tracers, the client ledger, the adapter bank and the pipelined, superstep
and buffered drives raise ``NotImplementedError`` when asked for.
"""

from __future__ import annotations

import logging
import time
from typing import Any

import numpy as np
import torch

from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import build_eval_fn, build_round_fn
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.packing import pack_eval_batches, pad_clients
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.utils.device import resolve_device, synchronize

log = logging.getLogger(__name__)

# local_test_on_all_clients evaluates whole clients, several per forward
# pass: at most _EVAL_ROWS rows and _EVAL_LOGITS logits (rows x outputs per
# row) a pass. 4096 FEMNIST rows make 254k logits; one NWP row makes
# 20 x 10,004, so there the logits bound the pass (512 MiB of float32).
_EVAL_ROWS = 4096
_EVAL_LOGITS = 2 ** 27


def client_sampling(round_idx: int, client_num_in_total: int,
                    client_num_per_round: int) -> np.ndarray:
    """Seeded per-round sampling (reference FedAVGAggregator.py:89-97):
    np.random.seed(round_idx), then choice without replacement."""
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total)
    num = min(client_num_per_round, client_num_in_total)
    rng = np.random.RandomState(round_idx)
    return rng.choice(client_num_in_total, num, replace=False)


def round_generator(seed: int, round_idx: int, salt: int = 0) -> torch.Generator:
    """The CPU generator of one round, a pure function of (seed, round,
    salt)."""
    state = np.random.SeedSequence([seed, round_idx, salt]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & (2 ** 63 - 1))


class FedAvgAPI:
    """Single-controller federated simulator on one device (``cuda`` unless
    the caller passes ``device="cpu"``). ``global_variables`` holds the
    model's parameters and its state (a BatchNorm's running statistics);
    the rounds carry both, and the evaluations read the running
    statistics (eval mode)."""

    def __init__(self, dataset: FederatedDataset, config: FedConfig,
                 model_trainer, aggregator_name: str = "fedavg",
                 device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = config.validate()
        self.trainer = model_trainer
        self.aggregator = make_aggregator(aggregator_name, config)
        self.round_fn = build_round_fn(model_trainer, config, self.aggregator,
                                       device=self.device)
        self.eval_fn = build_eval_fn(model_trainer)
        self.history: list[dict[str, Any]] = []
        self.global_variables = model_trainer.init(
            torch.Generator().manual_seed(config.seed), self.device)
        self.agg_state = self.aggregator.init_state(self.global_variables)
        bs = config.batch_size if config.batch_size > 0 else 256
        self._test_batches = tuple(
            torch.from_numpy(a).to(self.device)
            for a in pack_eval_batches(*dataset.test_global, max(bs, 64)))

    # ------------------------------------------------------------------ train
    def train_one_round(self, round_idx: int, faults=None, rng_salt: int = 0,
                        tracer=None) -> dict[str, float]:
        """One synchronous round: sample, gather, run the round, return the
        summed train metrics (one host transfer)."""
        if faults is not None or tracer is not None:
            raise NotImplementedError(
                "chaos faults and tracers are not ported to fedml_tpu_torch yet")
        cfg = self.cfg
        idx = client_sampling(round_idx, self.dataset.client_num,
                              cfg.client_num_per_round)
        x, y, counts = self.dataset.train.select(idx)
        dev = self.device
        x = torch.from_numpy(np.ascontiguousarray(x)).to(dev, non_blocking=True)
        y = torch.from_numpy(np.ascontiguousarray(y)).to(dev, non_blocking=True)
        counts = torch.from_numpy(np.ascontiguousarray(counts)).to(dev)
        rng = round_generator(cfg.seed, round_idx, rng_salt)
        self.global_variables, self.agg_state, metrics = self.round_fn(
            self.global_variables, self.agg_state, x, y, counts, rng)
        keys = list(metrics)
        values = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
        return dict(zip(keys, values))

    def train(self, ckpt_dir: str | None = None, ckpt_every: int = 25,
              metrics_logger=None, chaos=None, guard=None, tracer=None,
              ledger=None, bank=None) -> list[dict[str, Any]]:
        """Eager drive loop: for each round, run it, wait for the device,
        record its time and train metrics, and evaluate on test rounds."""
        unported = {"ckpt_dir": ckpt_dir, "metrics_logger": metrics_logger,
                    "chaos": chaos, "guard": guard, "tracer": tracer,
                    "ledger": ledger, "bank": bank}
        for name, value in unported.items():
            if value is not None:
                raise NotImplementedError(
                    f"train({name}=...) is not ported to fedml_tpu_torch yet")
        cfg = self.cfg
        for round_idx in range(cfg.comm_round):
            t0 = time.perf_counter()
            train_metrics = self.train_one_round(round_idx)
            synchronize(self.device)
            record = {"round": round_idx, "round_time": time.perf_counter() - t0}
            record.update(train_metrics)
            if round_idx % cfg.frequency_of_the_test == 0 or round_idx == cfg.comm_round - 1:
                record.update(self.local_test_on_all_clients(round_idx))
                record.update(self.test_global(round_idx))
            self.history.append(record)
            log.info("round %d: %s", round_idx,
                     {k: v for k, v in record.items() if k != "round"})
        return self.history

    # ------------------------------------------------------------------- eval
    def test_global(self, round_idx: int) -> dict[str, float]:
        m = self.eval_fn(self.global_variables, *self._test_batches)
        m = {k: float(v) for k, v in m.items()}
        total = max(m.get("test_total", 1.0), 1.0)
        return {"Test/Acc": m.get("test_correct", 0.0) / total,
                "Test/Loss": m.get("test_loss", 0.0) / total}

    def local_test_on_all_clients(self, round_idx: int) -> dict[str, float]:
        """The global model on every client's train and test split,
        sample-weighted (reference fedavg_api.py:119-183); CI mode
        evaluates one client. Each forward pass takes whole clients, their
        padded rows masked, as the JAX drive's vmap over clients does: the
        NWP trainer's reported loss is a per-client quantity."""
        ds = self.dataset
        out = {}
        for split_name, packed in (("Train", ds.train), ("Test", ds.test or ds.train)):
            sums = None
            for bx, by, bm, clients in self._client_chunks(packed):
                m = self.eval_fn(self.global_variables, bx, by, bm, clients)
                sums = m if sums is None else {k: sums[k] + m[k] for k in m}
            sums = {k: float(v) for k, v in sums.items()}
            total = max(sums.get("test_total", 0.0), 1.0)
            out[f"{split_name}/Acc"] = sums.get("test_correct", 0.0) / total
            out[f"{split_name}/Loss"] = sums.get("test_loss", 0.0) / total
        return out

    def _client_chunks(self, packed):
        """(x [1, k * n_max, ...], y, mask, k) on the device for each run of
        k clients of a split; the last run is padded with empty clients."""
        num = 1 if self.cfg.ci else packed.num_clients
        n_max = packed.n_max
        per_row = self.dataset.class_num * int(np.prod(packed.y.shape[2:], dtype=np.int64))
        rows = min(_EVAL_ROWS, _EVAL_LOGITS // max(per_row, 1))
        k = max(1, min(num, rows // max(n_max, 1)))
        for start in range(0, num, k):
            x, y, counts = packed.select(np.arange(start, min(start + k, num)))
            x, y, counts = pad_clients(x, y, counts, k)
            mask = (np.arange(n_max)[None] < counts[:, None]).astype(np.float32)
            yield (*(torch.from_numpy(np.ascontiguousarray(
                a.reshape((1, k * n_max) + a.shape[2:]))).to(self.device)
                for a in (x, y, mask)), k)
