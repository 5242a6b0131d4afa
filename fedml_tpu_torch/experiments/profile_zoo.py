"""FedML's benchmark rows beyond FEMNIST on the card: each path's rounds
through the CLI's ``setup_run`` and ``FedAvgAPI``, then one more round
under ``torch.profiler``.

    python -m fedml_tpu_torch.experiments.profile_zoo [--paths cross_silo,shakespeare]
        [--rounds 2] [--epochs 20] [--dtype float32]

The configurations (``fedml_tpu/experiments/configs/``, run on the seeded
surrogates), each as the CLI flags its yaml sets (``FLAGS``):

  cross_silo       cross_silo_cifar10_resnet56.yaml: CIFAR-10 ResNet-56
                   (BatchNorm), 10 silos, hetero alpha 0.5, batch 64, SGD
                   lr 0.001, momentum 0.9, wd 1e-4, ``--epochs`` local
                   epochs (the config's 20 unless cut)
  fed_cifar100     fed_cifar100_resnet18_gn.yaml: ResNet-18-GN, 500
                   clients, 10 a round, batch 20, lr 0.1, E = 1
  shakespeare      shakespeare_rnn.yaml: the LSTM next-char model, 715
                   clients, 10 a round, batch 10, lr 0.8, E = 1
  fed_shakespeare  the same LSTM per position (the CLI picks NWPTrainer)

Prints the card's name and power limit, each round's time and training
loss, and for the profiled round its wall time, the device's busy share
and the device time of each kind of kernel. TF32 is off, as in
``chip_smoke.py``. Needs a GPU.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.experiments import main_fedavg, main_fedopt
from fedml_tpu_torch.experiments.profile_fused import measure_rounds

PATHS = ("cross_silo", "fed_cifar100", "shakespeare", "fed_shakespeare")
_SHAKESPEARE = ["--model", "rnn", "--client_num_in_total", "715", "--client_num_per_round",
                "10", "--batch_size", "10", "--lr", "0.8", "--epochs", "1"]
FLAGS = {
    "cross_silo": ["--dataset", "cifar10", "--model", "resnet56", "--partition_method",
                   "hetero", "--partition_alpha", "0.5", "--client_num_in_total", "10",
                   "--client_num_per_round", "10", "--comm_round", "2", "--epochs", "20",
                   "--batch_size", "64", "--lr", "0.001", "--momentum", "0.9",
                   "--wd", "0.0001", "--client_optimizer", "sgd"],
    "fed_cifar100": ["--dataset", "fed_cifar100", "--model", "resnet18_gn",
                     "--client_num_in_total", "500", "--client_num_per_round", "10",
                     "--comm_round", "3", "--epochs", "1", "--batch_size", "20",
                     "--lr", "0.1"],
    "shakespeare": ["--dataset", "shakespeare", "--comm_round", "3", *_SHAKESPEARE],
    "fed_shakespeare": ["--dataset", "fed_shakespeare", "--comm_round", "2", *_SHAKESPEARE],
}


def make_api(path: str, *flags: str, aggregator: str = "fedavg",
             device: str = "cuda") -> FedAvgAPI:
    """FedAvgAPI for ``path`` as the CLI builds it from the config's flags,
    ``flags`` (e.g. ``"--epochs", "4"``) overriding them; ``fedopt`` takes
    the server optimizer's flags too."""
    parser = main_fedavg.add_args(argparse.ArgumentParser())
    if aggregator == "fedopt":
        main_fedopt._extra(parser)
    args = parser.parse_args(FLAGS[path] + list(flags))
    cfg, ds, trainer = main_fedavg.setup_run(args)
    return FedAvgAPI(ds, cfg, trainer, aggregator_name=aggregator, device=device)


def losses(hist) -> list:
    return [h["loss_sum"] / max(h["total"], 1.0) for h in hist]


def profiled_round(api, round_idx: int, host_events: bool = True) -> dict:
    """One more round of ``api`` under the profiler: wall, busy and kinds
    (``host_events``: see ``measure_rounds``)."""
    return measure_rounds(lambda r: api.train_one_round(round_idx + r), 1, host_events)


def summary(tag: str, hist, prof: dict) -> str:
    times = [h["round_time"] * 1e3 for h in hist]
    kinds = sorted(prof["kinds"].items(), key=lambda kv: -kv[1][0])[:4]
    top = ", ".join(f"{k} {us / 1e3:.2f} ms" for k, (us, _) in kinds)
    return (f"{tag}: rounds {[round(t, 2) for t in times]} ms (median "
            f"{statistics.median(times):.2f}), train loss "
            f"{[round(v, 4) for v in losses(hist)]}; profiled round wall "
            f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms "
            f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
            f"{prof['launches']:.0f} launches; {top}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--paths", default=",".join(PATHS))
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=20,
                        help="cross_silo local epochs (the config's 20)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = parser.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    # float32 means float32, as chip_smoke.py runs it: no TF32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for path in args.paths.split(","):
        flags = ["--comm_round", str(args.rounds), "--dtype", args.dtype]
        if path == "cross_silo":
            flags += ["--epochs", str(args.epochs)]
        t0 = time.perf_counter()
        api = make_api(path, *flags)
        t1 = time.perf_counter()
        hist = api.train()
        prof = profiled_round(api, args.rounds)
        print(summary(f"{path} ({args.dtype}, epochs {api.cfg.epochs}, "
                      f"set-up {t1 - t0:.1f} s)", hist, prof), flush=True)


if __name__ == "__main__":
    main()
