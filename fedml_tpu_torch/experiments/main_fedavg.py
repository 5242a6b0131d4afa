"""FedAvg experiment main of the PyTorch port (mirror of
``fedml_tpu/experiments/main_fedavg.py`` with the subset of
``experiments/common.py``'s flags that the port runs).

As the JAX CLI, a run writes ``history.jsonl``, ``wandb-summary.json``,
``config.json`` and ``TRACE.jsonl`` (the run's flight recorder) into
``--run_dir``, drives the pipelined loop (``--pipeline_depth`` 2; 0 is the
eager loop), resumes from ``--ckpt_dir`` when given, and takes the chaos
harness (``--chaos 1 --chaos_drop_rate ...``) and the round guard
(``--guard 1``).

Usage (the flagship, through the fused CUDA kernel):
  python -m fedml_tpu_torch.experiments.main_fedavg --dataset femnist \
      --model cnn --client_num_in_total 3400 --client_num_per_round 10 \
      --batch_size 20 --lr 0.1 --comm_round 100 --fused_kernel 1

Next-word prediction with the transformer LM (through the flash-attention
kernels):
  python -m fedml_tpu_torch.experiments.main_fedavg --dataset stackoverflow_nwp \
      --model transformer_nwp --client_num_in_total 200 \
      --client_num_per_round 50 --batch_size 16 --lr 0.3 --comm_round 100

FedML's benchmark rows beyond FEMNIST (``fedml_tpu/experiments/configs/``):
  cross-silo CIFAR-10 ResNet-56 (BatchNorm state carried and averaged):
      --dataset cifar10 --model resnet56 --partition_method hetero \
      --client_num_in_total 10 --client_num_per_round 10 --comm_round 100 \
      --epochs 20 --batch_size 64 --lr 0.001 --momentum 0.9 --wd 0.0001
  fed_CIFAR-100 ResNet-18-GN: --dataset fed_cifar100 --model resnet18_gn \
      --client_num_in_total 500 --client_num_per_round 10 --batch_size 20 --lr 0.1
  Shakespeare LSTM: --dataset shakespeare --model rnn --client_num_in_total 715 \
      --client_num_per_round 10 --batch_size 10 --lr 0.8
  (``--dataset fed_shakespeare`` trains it per position with NWPTrainer)
With no flags but ``--device cpu`` it runs MNIST logistic regression.

The transport and asynchronous axes (any of them on any config):
  --update_codec int8|topk [--codec_bits 8] [--codec_k 64]   (codec residuals
      ride the aggregator state), --buffer_size 5 --staleness_alpha 0.5
      --chaos 1 --chaos_straggler_rate 0.3 --chaos_straggler_rounds 2
      (FedBuff under the straggler plan), --rounds_per_dispatch 4 (the
      superstep: each round's cohort gathered on the device from the
      resident train store)

Federated LoRA, the client ledger and personalization:
  --lora_rank 8 (the base frozen, rank-8 adapters federated; the scale is
      alpha / rank, alpha from the config's ``lora_alpha`` extra, default
      the rank), --client_ledger_dir DIR (the
      per-client health ledger, resumable), --adapter_bank_dir DIR (turns
      personalization on: one personal adapter row a client in a sparse
      mmap bank; needs --lora_rank > 0), --adapter_clusters K (K shared rows,
      one per EMA-loss bucket of the ledger)

Fault-tolerance drive (the participation mask, the quarantine and the
guard's rollback in one run; ``quarantined_count`` lands in the run
directory's ``wandb-summary.json``):
  python -m fedml_tpu_torch.experiments.main_fedavg --device cpu \
      --run_dir /tmp/run --ckpt_dir /tmp/ckpt --chaos 1 --chaos_seed 7 \
      --chaos_drop_rate 0.3 --chaos_nan_rate 0.4 --guard 1 --trace_summary 1
"""

from __future__ import annotations

import argparse
import logging
import os
import random

import numpy as np
import torch

from fedml_tpu_torch import telemetry
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ClassificationTrainer, NWPTrainer, TagPredictionTrainer
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.models.lora import maybe_wrap_lora
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.robustness.chaos import FaultPlan
from fedml_tpu_torch.robustness.guard import RoundGuard
from fedml_tpu_torch.utils.logging import MetricsLogger

# flags that configure the drive's sinks and devices, not the round
_DRIVE_FLAGS = ("data_dir", "device", "ckpt_dir", "run_dir", "trace_summary",
                "trace_wandb", "profile_rounds", "profile_dir", "trace_max_mb",
                "client_ledger_dir", "adapter_bank_dir")


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The reference's add_args (main_fedavg.py:46-112), ported subset."""
    parser.add_argument("--model", type=str, default="lr")
    parser.add_argument("--dataset", type=str, default="mnist")
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--partition_method", type=str, default="hetero")
    parser.add_argument("--partition_alpha", type=float, default=0.5)
    parser.add_argument("--client_num_in_total", type=int, default=10)
    parser.add_argument("--client_num_per_round", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=10)
    parser.add_argument("--client_optimizer", type=str, default="sgd")
    parser.add_argument("--lr", type=float, default=0.03)
    parser.add_argument("--wd", type=float, default=0.0)
    parser.add_argument("--momentum", type=float, default=0.0)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--comm_round", type=int, default=10)
    parser.add_argument("--frequency_of_the_test", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ci", type=int, default=0)
    # the JAX CLI's mesh flags (common.py:46-48): a shard_map round over a
    # mesh of one device is the vmap round, which runs; a mesh over more
    # devices raises (ROADMAP.md Queue 1 item 5)
    parser.add_argument("--backend", type=str, default="vmap", choices=["vmap", "shard_map"])
    parser.add_argument("--mesh_shape", type=int, nargs="*", default=None,
                        help="devices of the shard_map mesh (default: every device "
                             "of --device's type)")
    parser.add_argument("--fedprox_mu", type=float, default=0.0)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--fused_kernel", type=int, default=0,
                        help="1 = run the local epoch through the fused CUDA "
                             "kernel (femnist CNN_DropOut only)")
    parser.add_argument("--fast_sampling", type=int, default=0,
                        help="1 = O(cohort) Feistel-permutation cohort "
                             "sampler (different seeded trajectory than the "
                             "default O(N) sampler)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--run_dir", type=str, default="./wandb/latest-run/files")
    # fault-tolerance knobs of the drive loop (fedml_tpu_torch.robustness)
    parser.add_argument("--chaos", type=int, default=0,
                        help="1 = inject a seeded deterministic fault "
                             "schedule (drops/NaN/corruption) per round")
    parser.add_argument("--chaos_seed", type=int, default=0)
    parser.add_argument("--chaos_drop_rate", type=float, default=0.0)
    parser.add_argument("--chaos_nan_rate", type=float, default=0.0)
    parser.add_argument("--chaos_corrupt_rate", type=float, default=0.0)
    # the seeded straggler plan (buffered aggregation): a straggling
    # client's update arrives 1..straggler_rounds dispatch rounds late
    parser.add_argument("--chaos_straggler_rate", type=float, default=0.0)
    parser.add_argument("--chaos_straggler_rounds", type=int, default=0)
    parser.add_argument("--guard", type=int, default=0,
                        help="1 = roll back + re-run rounds whose loss goes "
                             "non-finite or spikes")
    parser.add_argument("--guard_spike_factor", type=float, default=4.0)
    parser.add_argument("--guard_max_retries", type=int, default=2)
    # the pipelined drive: cohort t+k staged while round t runs, metrics
    # fetched in deferred transfers; equal to the eager loop bit for bit,
    # so on by default, as in the JAX CLI. 0 = the eager loop.
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help="cohort prefetch depth of the drive loop "
                             "(0 = eager)")
    # the superstep: K rounds a dispatch from the device-resident store,
    # equal to K eager rounds bit for bit; > 1 sets --pipeline_depth to 0
    parser.add_argument("--rounds_per_dispatch", type=int, default=1,
                        help="federated rounds a dispatch (1 = eager; needs "
                             "pipeline_depth 0)")
    # staleness-aware buffered aggregation (algorithms/buffered.py)
    parser.add_argument("--buffer_size", type=int, default=0,
                        help="update-buffer size K for FedBuff-style "
                             "buffered aggregation (0 = synchronous)")
    parser.add_argument("--staleness_alpha", type=float, default=0.5,
                        help="staleness-discount exponent: committed weight "
                             "= count * (1 + staleness) ** -alpha")
    # the update transport codec (fedml_tpu_torch.codecs); none = the round
    # without a codec, bit for bit
    parser.add_argument("--update_codec", type=str, default="none",
                        choices=["none", "int8", "topk"],
                        help="update transport codec: int8 quantization "
                             "with error feedback, or top-k sparsification "
                             "with static-shape payloads")
    parser.add_argument("--codec_k", type=int, default=64,
                        help="top-k codec: entries kept per leaf (clamped "
                             "to the leaf size)")
    parser.add_argument("--codec_bits", type=int, default=8,
                        help="int8 codec: quantization width in bits (2-8; "
                             "wire dtype stays int8)")
    # the tracer: TRACE.jsonl is always written to <run_dir>/TRACE.jsonl
    parser.add_argument("--trace_summary", type=int, default=0,
                        help="1 = print an end-of-run per-phase p50/p95 "
                             "span table")
    parser.add_argument("--trace_wandb", type=int, default=0,
                        help="1 = mirror per-round phase durations into the "
                             "metrics logger as trace/<phase>_s")
    parser.add_argument("--profile_rounds", type=str, default=None,
                        help="A:B = capture a torch.profiler trace window "
                             "covering rounds [A, B) into --profile_dir")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="directory of the --profile_rounds Chrome trace "
                             "(default <run_dir>/trace)")
    parser.add_argument("--trace_max_mb", type=float, default=0,
                        help="rotate TRACE.jsonl when it exceeds this many "
                             "MB (archived as TRACE.jsonl.NNN; 0 = never)")
    # federated LoRA (models/lora.py): frozen base + rank-r adapters; only
    # the adapters cross the wire, reach the aggregator and are checkpointed
    parser.add_argument("--lora_rank", type=int, default=0,
                        help="LoRA adapter rank; 0 = full fine-tuning (the "
                             "trainer is not wrapped)")
    # the per-client health ledger (telemetry/client_ledger.py)
    parser.add_argument("--client_ledger_dir", type=str, default=None,
                        help="directory of the mmap-backed per-client health "
                             "ledger (None = ledger off)")
    # personalization (models/adapter_bank.py): per-client rank-r adapter
    # rows in a sparse mmap bank, O(cohort) gather and scatter a round
    parser.add_argument("--adapter_bank_dir", type=str, default=None,
                        help="directory of the personal adapter bank; "
                             "setting it turns personalization ON (requires "
                             "--lora_rank > 0); reopening checks rows and "
                             "layout")
    parser.add_argument("--adapter_clusters", type=int, default=0,
                        help="share K cluster rows instead of one row per "
                             "client (assignment: a static EMA-loss bucket "
                             "from the client ledger; 0 = per-client rows)")
    return parser


def robustness_from_args(args):
    """(FaultPlan | None, RoundGuard | None) from the --chaos/--guard flags."""
    chaos = guard = None
    if args.chaos:
        chaos = FaultPlan(seed=args.chaos_seed, drop_rate=args.chaos_drop_rate,
                          nan_rate=args.chaos_nan_rate,
                          corrupt_rate=args.chaos_corrupt_rate,
                          straggler_rate=args.chaos_straggler_rate,
                          straggler_rounds=args.chaos_straggler_rounds)
    if args.guard:
        guard = RoundGuard(spike_factor=args.guard_spike_factor,
                           max_retries=args.guard_max_retries)
    return chaos, guard


def tracer_from_args(args, metrics_logger=None) -> telemetry.Tracer:
    """The run's Tracer: TRACE.jsonl in --run_dir (always: it is the run's
    flight recorder), the optional metrics-logger mirror (--trace_wandb)
    and torch.profiler window (--profile_rounds A:B)."""
    run_dir = args.run_dir
    jsonl = os.path.join(run_dir, "TRACE.jsonl") if run_dir else None
    profile_dir = args.profile_dir
    if profile_dir is None and run_dir:
        profile_dir = os.path.join(run_dir, "trace")
    return telemetry.Tracer(
        jsonl_path=jsonl,
        metrics_logger=metrics_logger if args.trace_wandb else None,
        profile_rounds=args.profile_rounds,
        profile_dir=profile_dir,
        max_bytes=int(args.trace_max_mb * 2 ** 20) or None,
        run_meta={"model": args.model, "dataset": args.dataset,
                  "clients": args.client_num_in_total,
                  "clients_per_round": args.client_num_per_round,
                  "batch_size": args.batch_size,
                  "pipeline_depth": args.pipeline_depth})


def ledger_from_args(args, num_clients: int):
    """The run's ClientLedger (``--client_ledger_dir``), or None. It is
    opened against the dataset's whole population: its disk is
    O(num_clients) (sparse), its writes O(cohort) a round."""
    ledger_dir = getattr(args, "client_ledger_dir", None)
    if not ledger_dir:
        return None
    from fedml_tpu_torch.telemetry.client_ledger import open_or_create

    return open_or_create(ledger_dir, num_clients)


def bank_from_args(args, num_clients: int, api):
    """The run's AdapterBank (``--adapter_bank_dir``), or None. Its rows are
    the whole population (or ``--adapter_clusters`` K); the row template is
    the API's live adapter dict, so a resumed bank's layout is checked
    against this run's model and rank."""
    bank_dir = getattr(args, "adapter_bank_dir", None)
    if not bank_dir:
        return None
    from fedml_tpu_torch.models.adapter_bank import open_or_create
    from fedml_tpu_torch.models.lora import strip_lora_base
    from fedml_tpu_torch.utils.pytree import split_variables

    template = split_variables(strip_lora_base(api.global_variables))[0]
    clusters = int(getattr(args, "adapter_clusters", 0) or 0)
    return open_or_create(bank_dir, clusters if clusters > 0 else num_clients, template)


def start_run(args) -> FedConfig:
    """Logging + seeds; the run's FedConfig from the parsed flags (flags
    that are not its fields land in ``extra``)."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    d = {k: v for k, v in vars(args).items()
         if k not in _DRIVE_FLAGS and v is not None}
    # --adapter_bank_dir is the personalization switch: the bank's place is
    # the drive's concern, the personalize bit the config's
    if getattr(args, "adapter_bank_dir", None):
        d["personalize"] = True
    d["fused_kernel"] = bool(d.get("fused_kernel", 0))
    d["fast_sampling"] = bool(d.get("fast_sampling", 0))
    # the superstep leaves no per-round host gap for the pipeline: a run
    # with it drops the pipeline's default (experiments/common.py:279)
    if int(d.get("rounds_per_dispatch", 1)) > 1:
        d["pipeline_depth"] = 0
    return FedConfig.from_dict(d)


def setup_run(args):
    """Seeds + logging + data + model + trainer (wrapped in LoRA when
    ``--lora_rank`` > 0)."""
    cfg = start_run(args)
    extra_load = {}
    if args.dataset == "mnist":
        # the reference feeds lr a flat 784 vector and the CNNs 28x28
        # images (standalone main_fedavg.py:318-325)
        extra_load["flatten"] = args.model in ("lr", "mlp")
    ds = load_dataset(args.dataset, data_dir=args.data_dir,
                      client_num_in_total=args.client_num_in_total,
                      partition_method=args.partition_method,
                      partition_alpha=args.partition_alpha, seed=args.seed, **extra_load)
    name, model_kwargs = contextual_model(args)
    module = create_model(name, output_dim=ds.class_num, dtype=cfg.dtype,
                          input_shape=ds.train.x.shape[2:], **model_kwargs)
    # task trainer by dataset (reference FedAvgAPI.py:33-39)
    if ds.meta.get("task") == "nwp" or args.dataset in ("fed_shakespeare",
                                                       "stackoverflow_nwp"):
        trainer = NWPTrainer(module, pad_id=0)
    elif ds.meta.get("task") == "tag_prediction" or args.dataset == "stackoverflow_lr":
        trainer = TagPredictionTrainer(module)
    else:
        trainer = ClassificationTrainer(module)
    # after the task trainer, so the adapter seam is task-agnostic;
    # --lora_rank 0 returns the trainer unchanged
    return cfg, ds, maybe_wrap_lora(trainer, cfg)


def contextual_model(args) -> tuple[str, dict]:
    """(model name, model kwargs) by dataset, as the JAX CLI dispatches
    (``fedml_tpu/experiments/common.py:316-331``; reference standalone
    main_fedavg.py:315-340): Shakespeare gets the 90-character vocab and
    per-position logits for fed_shakespeare; ``cnn`` on har is HAR_CNN and
    on cifar10 CNNCifar."""
    kwargs = {}
    if args.dataset in ("shakespeare", "fed_shakespeare"):
        kwargs = {"vocab_size": 90, "per_position": args.dataset == "fed_shakespeare"}
    name = args.model
    if name == "cnn":
        if args.dataset in ("har", "har_subject"):
            name = "har_cnn"
        elif args.dataset == "cifar10":
            name = "cnn_cifar"
    return name, kwargs


def main(argv=None, aggregator_name: str = "fedavg", extra_args=None):
    """Parse ``argv`` (with the flags ``extra_args(parser)`` adds), train
    with ``aggregator_name`` and return the history."""
    parser = add_args(argparse.ArgumentParser())
    if extra_args:
        extra_args(parser)
    args = parser.parse_args(argv)
    cfg, ds, trainer = setup_run(args)
    logger = MetricsLogger(run_dir=args.run_dir, config=vars(args))
    api = FedAvgAPI(ds, cfg, trainer, aggregator_name=aggregator_name,
                    device=args.device)
    chaos, guard = robustness_from_args(args)
    tracer = tracer_from_args(args, metrics_logger=logger)
    ledger = ledger_from_args(args, ds.client_num)
    bank = bank_from_args(args, ds.client_num, api)
    try:
        history = api.train(ckpt_dir=args.ckpt_dir, metrics_logger=logger,
                            chaos=chaos, guard=guard, tracer=tracer, ledger=ledger,
                            bank=bank)
    finally:
        tracer.close()
        if ledger is not None:
            ledger.close()
        if bank is not None:
            bank.close()
    logger.finish()
    if args.trace_summary:
        print(tracer.summary_table(), flush=True)
    return history


if __name__ == "__main__":
    main()
