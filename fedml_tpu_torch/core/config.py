"""Typed run configuration for the PyTorch port.

A mirror of ``fedml_tpu/core/config.py::FedConfig`` holding the fields the
ported paths read (FedAvg, FedOpt, FedNova, robust aggregation, FedProx and
the stateful client optimizers), with the same names and defaults so
experiment configs transfer verbatim. The switches of features the port does not run
yet (codecs, LoRA, buffered aggregation, superstep, sharding,
personalization) are kept so that ``validate`` can reject one
that is on with ``NotImplementedError``; other keys of a JAX config land in
``extra``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class FedConfig:
    """Knobs of the FedAvg drive; field names follow the reference's
    ``add_args`` (main_fedavg.py:46-112)."""

    # data
    dataset: str = "mnist"
    data_dir: str = "./data"
    partition_method: str = "hetero"
    partition_alpha: float = 0.5
    client_num_in_total: int = 10
    client_num_per_round: int = 10

    # model
    model: str = "lr"

    # local training
    batch_size: int = 10  # -1 = full batch
    client_optimizer: str = "sgd"
    lr: float = 0.03
    momentum: float = 0.0
    wd: float = 0.0
    epochs: int = 1
    # global-norm clip of every local step; None disables it
    grad_clip: float | None = 1.0
    # False iterates each client's samples in stored order (valid prefix)
    shuffle: bool = True
    # caller-asserted: every packed client row is full and n_max % batch == 0
    assume_full_clients: bool = False

    # federated loop
    comm_round: int = 10
    frequency_of_the_test: int = 1

    # server optimizer (FedOpt; reference main_fedopt.py:54-60)
    server_optimizer: str = "sgd"
    server_lr: float = 1.0
    server_momentum: float = 0.0

    # FedProx / FedNova
    fedprox_mu: float = 0.0

    # robust aggregation (reference robust_aggregation.py:32-55)
    norm_bound: float = 5.0
    stddev: float = 0.025

    # systems
    seed: int = 0
    ci: int = 0  # evaluate a single client in local_test_on_all_clients
    backend: str = "vmap"
    pipeline_depth: int = 0
    silo_threshold: int = 0
    tensor_shards: int = 0
    shard_step: bool = False
    personalize: bool = False
    lora_rank: int = 0
    # route the local epoch through the hand-written fused CUDA kernel
    # (ops/fused_sgd.py) — CNN_DropOut only
    fused_kernel: bool = False
    fast_sampling: bool = False
    rounds_per_dispatch: int = 1
    buffer_size: int = 0
    update_codec: str = "none"
    dtype: str = "float32"  # compute dtype; params stay float32

    extra: dict[str, Any] = field(default_factory=dict, hash=False, compare=False)

    def replace(self, **kw) -> "FedConfig":
        return dataclasses.replace(self, **kw)

    def validate(self, chaos: bool = False) -> "FedConfig":
        """Raise ``NotImplementedError`` for a feature the port has not
        ported yet, and ``ValueError`` for a fused-kernel exclusion or
        requirement of ``fedml_tpu/core/spec.py`` (the subset that can arise
        among the features the port runs). ``chaos`` says whether the drive
        arms a fault plan, which is not a config field (the JAX package's
        ``validate(chaos="on")`` overlay). Returns self."""
        unported = {
            "backend='shard_map'": self.backend != "vmap",
            "silo_threshold > 0": self.silo_threshold > 0,
            "tensor_shards > 0": self.tensor_shards > 0,
            "shard_step": self.shard_step,
            "personalize": self.personalize,
            "lora_rank > 0": self.lora_rank > 0,
            "fast_sampling": self.fast_sampling,
            "rounds_per_dispatch > 1": self.rounds_per_dispatch > 1,
            "buffer_size > 0": self.buffer_size > 0,
            "update_codec": self.update_codec != "none",
        }
        for name, on in unported.items():
            if on:
                raise NotImplementedError(
                    f"{name} is not ported to fedml_tpu_torch yet "
                    f"(see ROADMAP.md Queue 1)")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0 (0 = the eager drive), got "
                f"{self.pipeline_depth}")
        if self.fused_kernel:
            if not (self.client_optimizer == "sgd" and not self.momentum
                    and not self.wd and not self.fedprox_mu):
                raise ValueError(
                    "the fused kernel implements plain SGD with global-norm "
                    "clip — sgd, momentum 0, wd 0, fedprox_mu 0 required")
            if self.epochs != 1:
                raise ValueError("the fused kernel runs exactly one local epoch")
            if self.grad_clip is None:
                raise ValueError(
                    "the fused kernel clips unconditionally (reference "
                    "semantics) — grad_clip must be set")
            if chaos:
                # spec.py's (fused, chaos) exclusion, its reason verbatim
                raise ValueError(
                    "the fused kernel round has no participation/quarantine "
                    "stage — run without chaos faults or cohort padding, or "
                    "drop --fused_kernel")
        return self

    @classmethod
    def from_dict(cls, d: dict) -> "FedConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in names}
        extra = {k: v for k, v in d.items() if k not in names}
        if extra:
            known.setdefault("extra", {}).update(extra)
        return cls(**known)
