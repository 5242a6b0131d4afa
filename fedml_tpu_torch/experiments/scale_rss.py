"""Peak host RSS against federation size, the port's counterpart of
``tools/bench_scale.py``: a FedAvg drive over an mmap shard store
(``data/packed_store.py``) whose staging is O(cohort), so the peak should
stay flat from 100k to 1M clients.

    python -m fedml_tpu_torch.experiments.scale_rss [--points 10000,100000,1000000]
        [--rounds 5] [--device cuda]

Each point runs in its own subprocess (``--point --clients N``): a peak
is a per-process high-water mark, so points swept in one process would all
read the largest one's. A point reports its own peak (``peak_rss_mb``,
sampled by ``PeakRss``) and ``ru_maxrss``, which a child inherits from the
process that started it (see ``PeakRss``). A point builds a sparse
synthetic store (``create_synthetic_store``: holes read as zeros, seconds
and near-zero disk at 1M clients) with the JAX point's geometry (LR over
flat 32-float samples, n_max 20, 64 clients a round, batch 20,
``fast_sampling``: the O(cohort) sampler), trains one warm-up round and
then ``--rounds`` timed rounds on the device, each ended by its metrics
fetch, and prints one JSON line. The sweep prints the points' lines, then
one line with the ratio of the last point's peak RSS to the one before.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# the JAX point's geometry (tools/bench_scale.py): staging-bound on purpose
SHAPE, CLASSES, N_MAX, CPR, BATCH = (32,), 10, 20, 64, 20


def resident_bytes() -> int:
    """This process's resident set now (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class PeakRss:
    """This process's peak resident set over a ``with`` block, sampled
    every ``interval`` seconds on a daemon thread. ``ru_maxrss`` does not
    give it: a child made by fork or vfork starts from its parent's peak,
    so a point started by a large process would read the parent's; and
    ``VmHWM`` is not in every kernel's ``/proc/self/status``."""

    def __init__(self, interval: float = 0.005):
        self.interval = interval
        self.start = self.peak = resident_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval):
            self.peak = max(self.peak, resident_bytes())

    def __enter__(self) -> "PeakRss":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, resident_bytes())

    @property
    def peak_mb(self) -> float:
        return self.peak / 2 ** 20

    @property
    def start_mb(self) -> float:
        """The resident set when the block began: the floor the peak
        stands on (the interpreter, torch, a CUDA context)."""
        return self.start / 2 ** 20


def _disk_bytes(d: str, physical: bool) -> int:
    """Bytes of the directory's files: allocated on disk (sparse holes
    excluded) or logical."""
    stats = [os.stat(os.path.join(d, f)) for f in os.listdir(d)]
    return sum(s.st_blocks * 512 if physical else s.st_size for s in stats)


def run_point(clients: int, rounds: int, device: str) -> dict:
    """One scale point in this process; returns its JSON record."""
    import torch

    from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, create_model
    from fedml_tpu_torch.data.packed_store import MmapPackedStore, create_synthetic_store
    from fedml_tpu_torch.data.registry import FederatedDataset

    store_dir = tempfile.mkdtemp(prefix=f"scale_rss_{clients}_")
    torch.empty(0, device=device)  # the device's context, before the floor is read
    try:
        with PeakRss() as rss:
            t0 = time.perf_counter()
            create_synthetic_store(store_dir, clients, n_max=N_MAX, sample_shape=SHAPE)
            build_s = time.perf_counter() - t0
            store = MmapPackedStore(store_dir)
            rng = np.random.RandomState(0)
            gx = rng.rand(64, *SHAPE).astype(np.float32)
            gy = rng.randint(0, CLASSES, size=64).astype(np.int32)
            ds = FederatedDataset(name="scale_surrogate", train=store, test=None,
                                  train_global=(gx, gy), test_global=(gx, gy),
                                  class_num=CLASSES)
            cfg = FedConfig(dataset="scale_surrogate", model="lr", comm_round=rounds + 1,
                            batch_size=BATCH, epochs=1, lr=0.1, client_num_in_total=clients,
                            client_num_per_round=CPR, seed=0, ci=1,
                            frequency_of_the_test=10 ** 9, fast_sampling=True)
            model = create_model("lr", output_dim=CLASSES, input_shape=SHAPE)
            api = FedAvgAPI(ds, cfg, ClassificationTrainer(model), device=device)
            api.train_one_round(0)  # warm-up, outside the timed window
            t0 = time.perf_counter()
            for r in range(1, rounds + 1):
                # the round's metrics fetch waits for its work: completed rounds
                api.train_one_round(r)
            timed_s = time.perf_counter() - t0
            store.close()
        return {
            "clients": clients,
            "rounds": rounds,
            "rounds_per_sec": rounds / timed_s,
            "peak_rss_mb": rss.peak_mb,
            "start_rss_mb": rss.start_mb,
            "ru_maxrss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
            "store_build_s": build_s,
            "store_logical_mb": _disk_bytes(store_dir, False) / 2 ** 20,
            "store_physical_mb": _disk_bytes(store_dir, True) / 2 ** 20,
            "device": (torch.cuda.get_device_name(api.device) if api.device.type == "cuda"
                       else "cpu"),
            "fast_sampling": True,
        }
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def run_sweep(points, rounds: int, device: str) -> dict:
    """Every point in its own subprocess; prints each point's line and
    returns the summary (the points and the last-over-previous ratio)."""
    results = []
    for n in points:
        cmd = [sys.executable, "-m", "fedml_tpu_torch.experiments.scale_rss", "--point",
               "--clients", str(n), "--rounds", str(rounds), "--device", device]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise RuntimeError(f"scale point clients={n} failed (rc {proc.returncode})")
        results.append(json.loads(lines[-1]))
        print(lines[-1], flush=True)
    ratio = (results[-1]["peak_rss_mb"] / results[-2]["peak_rss_mb"]
             if len(results) >= 2 else None)
    return {"metric": "scale_rss", "points": results, "rss_ratio_last_over_prev": ratio,
            "clients_per_round": CPR, "n_max": N_MAX, "sample_shape": list(SHAPE),
            "model": "lr", "rounds": rounds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--point", action="store_true",
                    help="run one point in this process and print its JSON line")
    ap.add_argument("--clients", type=int, default=10000)
    ap.add_argument("--points", type=str, default="10000,100000,1000000")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.point:
        print(json.dumps(run_point(args.clients, args.rounds, args.device)), flush=True)
        return 0
    summary = run_sweep([int(s) for s in args.points.split(",")], args.rounds, args.device)
    print(json.dumps({k: v for k, v in summary.items() if k != "points"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
