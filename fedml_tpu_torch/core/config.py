"""Typed run configuration for the PyTorch port.

A mirror of ``fedml_tpu/core/config.py::FedConfig`` holding the fields the
ported paths read (FedAvg, FedOpt, FedNova, robust aggregation, FedProx,
the stateful client optimizers, the update codecs, buffered aggregation,
the superstep, federated LoRA, personalization and the silo-grouped round),
with the same names and defaults so experiment configs transfer verbatim.
The switches of features the port does not run yet (tensor sharding, a
mesh of more than one device) are kept so that ``validate`` can reject one
that is on with ``NotImplementedError``; other keys of a JAX config land in
``extra``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any

from fedml_tpu_torch.utils.device import device_count


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
    # "shard_map" runs the clients over a mesh of devices: on a mesh of one
    # device that is the vmap round (a psum over one member), which the
    # port runs; a mesh over more devices is not ported
    backend: str = "vmap"
    mesh_shape: tuple[int, ...] = ()  # () = every device of the run's type
    pipeline_depth: int = 0
    silo_threshold: int = 0
    tensor_shards: int = 0
    shard_step: bool = False
    # per-client personal adapter rows from the mmap bank
    # (models/adapter_bank.py) on top of the shared adapters; needs
    # lora_rank > 0 and a bank attached to the drive
    personalize: bool = False
    # with personalize: > 0 shares K bank rows, one per EMA-loss cluster of
    # the client ledger, instead of one row per client
    adapter_clusters: int = 0
    # > 0 wraps the trainer in LoRA (models/lora.py): the base frozen under
    # "lora_base/", rank-r adapters federated, aggregated and checkpointed
    # alone; 0 leaves the trainer unwrapped
    lora_rank: int = 0
    # route the local epoch through the hand-written fused CUDA kernel
    # (ops/fused_sgd.py) — CNN_DropOut only
    fused_kernel: bool = False
    # O(cohort) Feistel cohort sampler (another seeded trajectory than the
    # default O(N) one)
    fast_sampling: bool = False
    # >1 runs K rounds per dispatch from the device-resident train store
    # (the superstep, engine.build_superstep_fn); 1 = the eager loop
    rounds_per_dispatch: int = 1
    # >0: staleness-aware buffered aggregation (FedBuff,
    # algorithms/buffered.py) with a buffer of this many updates
    buffer_size: int = 0
    # an update born at round b and committed at round t weighs
    # count * (1 + (t - b)) ** -staleness_alpha
    staleness_alpha: float = 0.5
    # update transport codec: "none", "int8" or "topk" (fedml_tpu_torch.codecs)
    update_codec: str = "none"
    codec_k: int = 64  # top-k: entries kept per leaf (clamped to its size)
    codec_bits: int = 8  # int8: quantization width in bits, 2-8
    dtype: str = "float32"  # compute dtype; params stay float32

    extra: dict[str, Any] = field(default_factory=dict, hash=False, compare=False)

    def replace(self, **kw) -> "FedConfig":
        return dataclasses.replace(self, **kw)

    def mesh_size(self, device=None) -> int:
        """The devices a ``shard_map`` round spans: ``mesh_shape``'s product,
        or every device of ``device``'s type (the card's count for
        ``cuda``, 1 for the CPU or when no device is given)."""
        if self.mesh_shape:
            return math.prod(self.mesh_shape)
        return device_count(device) if device is not None else 1

    def validate(self, chaos: bool = False, device=None) -> "FedConfig":
        """Raise ``NotImplementedError`` for a feature the port has not
        ported yet, and ``ValueError`` for a fused-kernel exclusion or
        requirement of ``fedml_tpu/core/spec.py`` (the subset that can arise
        among the features the port runs). ``chaos`` says whether the drive
        arms a fault plan, which is not a config field (the JAX package's
        ``validate(chaos="on")`` overlay); ``device`` is the run's device,
        whose type sets the default mesh of ``backend="shard_map"``. Returns
        self."""
        if self.backend not in ("vmap", "shard_map"):
            raise ValueError(f"unknown backend {self.backend!r} (vmap or shard_map)")
        for reason, clash in _exclusions(self, chaos):
            if clash:
                raise ValueError(reason)
        unported = {
            "backend='shard_map' over more than one device (ROADMAP.md Queue 1 "
            "item 5, multi-device)":
                self.backend == "shard_map" and self.mesh_size(device) > 1,
            "tensor_shards > 0": self.tensor_shards > 0,
            "shard_step": self.shard_step,
        }
        for name, on in unported.items():
            if on:
                raise NotImplementedError(
                    f"{name} is not ported to fedml_tpu_torch yet "
                    f"(see ROADMAP.md Queue 1)")
        if self.personalize and self.lora_rank <= 0:
            # spec.py's REQUIREMENTS row (the exclusion above fires first)
            raise ValueError(
                "personalize requires lora_rank > 0 — the personal row "
                "is a rank-r adapter tree (models/adapter_bank.py)")
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
        return self

    @classmethod
    def from_dict(cls, d: dict) -> "FedConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in names}
        if known.get("mesh_shape") is not None:
            known["mesh_shape"] = tuple(int(n) for n in known["mesh_shape"])
        extra = {k: v for k, v in d.items() if k not in names}
        if extra:
            known.setdefault("extra", {}).update(extra)
        return cls(**known)


# The exclusions of ``fedml_tpu/core/spec.py`` (``EXCLUSIONS`` and
# ``CONSTRAINTS``) that involve the update codec, buffered aggregation, the
# superstep, LoRA or personalization, in its order and with its reasons
# verbatim.
_BUFFER_REASON = (
    "buffer_size (staleness-aware buffered aggregation) drives "
    "the single-controller vmap engine; the sharded admit/commit "
    "twin (parallel.sharded.build_sharded_buffer_fns) is a "
    "program-level building block — combine buffer_size with "
    "neither backend='shard_map', tensor_shards, nor "
    "silo_threshold")
_SUPERSTEP_REASON = (
    "rounds_per_dispatch (the multi-round superstep) fuses K "
    "rounds into ONE program on the single-chip vmap engine — "
    "there is no per-round host gap left for the pipeline or "
    "buffer to exploit, and the sharded/silo/fused lowerings "
    "have no superstep twin; combine it with none of "
    "pipeline_depth / buffer_size / backend='shard_map' / "
    "tensor_shards / silo_threshold / fused_kernel")
_PFL_REASON = (
    "personalize (per-client adapter rows, models/adapter_bank.py) "
    "drives the single-chip vmap engine's eager or pipelined loop — "
    "the fused/superstep/buffered/shard_map/tensor/silo lowerings "
    "have no personal-row seam; drop personalize or the conflicting "
    "setting")


def _exclusions(cfg: FedConfig, chaos: bool = False) -> list:
    """[(reason, clashes)] for ``cfg`` (``chaos``: whether the drive arms
    a fault plan), in spec.py's order."""
    codec = cfg.update_codec != "none"
    buffer = cfg.buffer_size > 0
    superstep = cfg.rounds_per_dispatch > 1
    silo = cfg.silo_threshold > 0
    tensor = cfg.tensor_shards > 0
    shard_map = cfg.backend == "shard_map"
    fused = cfg.fused_kernel
    lora = cfg.lora_rank > 0
    pfl = cfg.personalize
    return [
        ("update_codec has no seam in the silo-grouped lowering "
         "(silos merge clients before any update crosses a wire) — "
         "drop one of update_codec / silo_threshold", codec and silo),
        (_BUFFER_REASON, buffer and shard_map),
        (_BUFFER_REASON, buffer and tensor),
        (_BUFFER_REASON, buffer and silo),
        (_SUPERSTEP_REASON, superstep and cfg.pipeline_depth > 0),
        (_SUPERSTEP_REASON, superstep and buffer),
        (_SUPERSTEP_REASON, superstep and shard_map),
        (_SUPERSTEP_REASON, superstep and tensor),
        (_SUPERSTEP_REASON, superstep and silo),
        (_SUPERSTEP_REASON, superstep and fused),
        ("--fused_kernel is mutually exclusive with --update_codec",
         fused and codec),
        ("--fused_kernel is mutually exclusive with --buffer_size "
         "(buffered admission consumes per-client LocalResults)",
         fused and buffer),
        ("--fused_kernel is mutually exclusive with --lora_rank "
         "(the kernel trains the raw CNN param layout)",
         fused and lora),
        ("--shard_step runs under GSPMD automatic partitioning — the "
         "codec transports are manual shard_map collectives and do "
         "not compose with it. Drop --shard_step (the storage-sharded "
         "tensor round supports codecs) or --update_codec.",
         codec and tensor and cfg.shard_step),
        ("the fused kernel round has no participation/quarantine "
         "stage — run without chaos faults or cohort padding, or "
         "drop --fused_kernel", fused and chaos),
        (_PFL_REASON, pfl and fused),
        (_PFL_REASON, pfl and superstep),
        (_PFL_REASON, pfl and buffer),
        (_PFL_REASON, pfl and shard_map),
        (_PFL_REASON, pfl and tensor),
        (_PFL_REASON, pfl and silo),
        ("update codecs compress the WIRE tree, and personal rows "
         "never reach the wire — a codec on the personalized round "
         "would stage deltas for a tree the client step does not "
         "ship; drop one of update_codec / personalize",
         pfl and codec),
        ("personalize trains a PERSONAL rank-r adapter per client on "
         "top of the shared adapters — it requires lora_rank > 0 "
         "(models/adapter_bank.py rows are LoRA adapter trees)",
         pfl and not lora),
        ("update codecs reach LoRA runs only through the tensor-sharded "
         "round or buffered admission (the adapter-aware transports in "
         "parallel/tensor.py and the buffered admit) — the vmap/shard_map "
         "CodecAggregator stages deltas for the full federated tree while "
         "the LoRA client step ships adapters only; drop one of "
         "update_codec / lora_rank, or add --tensor_shards / --buffer_size",
         codec and lora and not tensor and not buffer),
    ]
