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
from fedml_tpu_torch.core.trainer import ClassificationTrainer, NWPTrainer
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.robustness.chaos import FaultPlan
from fedml_tpu_torch.robustness.guard import RoundGuard
from fedml_tpu_torch.utils.logging import MetricsLogger

# flags that configure the drive's sinks and devices, not the round
_DRIVE_FLAGS = ("data_dir", "device", "ckpt_dir", "run_dir", "trace_summary",
                "trace_wandb", "profile_rounds", "profile_dir", "trace_max_mb")


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
    parser.add_argument("--fedprox_mu", type=float, default=0.0)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--fused_kernel", type=int, default=0,
                        help="1 = run the local epoch through the fused CUDA "
                             "kernel (femnist CNN_DropOut only)")
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
    return parser


def robustness_from_args(args):
    """(FaultPlan | None, RoundGuard | None) from the --chaos/--guard flags."""
    chaos = guard = None
    if args.chaos:
        chaos = FaultPlan(seed=args.chaos_seed, drop_rate=args.chaos_drop_rate,
                          nan_rate=args.chaos_nan_rate,
                          corrupt_rate=args.chaos_corrupt_rate)
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


def setup_run(args):
    """Seeds + logging + data + model + trainer."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    d = {k: v for k, v in vars(args).items()
         if k not in _DRIVE_FLAGS and v is not None}
    d["fused_kernel"] = bool(d.get("fused_kernel", 0))
    cfg = FedConfig.from_dict(d)
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
        return cfg, ds, NWPTrainer(module, pad_id=0)
    return cfg, ds, ClassificationTrainer(module)


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
    try:
        history = api.train(ckpt_dir=args.ckpt_dir, metrics_logger=logger,
                            chaos=chaos, guard=guard, tracer=tracer)
    finally:
        tracer.close()
    logger.finish()
    if args.trace_summary:
        print(tracer.summary_table(), flush=True)
    return history


if __name__ == "__main__":
    main()
