"""Time FedGKT rounds through ``main_fedgkt``'s own path, phase by phase.

    python -m fedml_tpu_torch.experiments.time_gkt [main_fedgkt flags]

runs ``main_fedgkt.main`` with the given flags (default: the CIFAR-10
surrogate's 5,000 rows over 8 hetero clients, uncapped, batch 64, 1 local
epoch, 2 server epochs, 1 round) and prints one JSON line: the card's name
and power limit (``nvidia-smi``), each round's client-phase and
server-phase seconds (the device synchronised at each phase's ends), the
bytes of the features the client phase leaves on the device, the peak
device memory, the server's epoch losses and ``Test/Acc``. On the CPU
(``--device cpu``) the card fields read "not measured".
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI

DEFAULT_FLAGS = ["--dataset", "cifar10", "--client_num_in_total", "8",
                 "--partition_method", "hetero", "--comm_round", "1", "--batch_size", "64",
                 "--epochs", "1", "--epochs_server", "2", "--temperature", "3.0",
                 "--alpha", "1.0"]


class PhaseTimes:
    """Wraps ``FedGKTAPI.client_phase`` and ``server_phase`` while in use:
    the APIs that ran (``apis``), each call's seconds with the device
    synchronised before and after (``client_s``, ``server_s``) and the bytes
    of the features each client phase returned (``feature_bytes``)."""

    def __enter__(self):
        self.apis, self.client_s, self.server_s, self.feature_bytes = [], [], [], []
        self._saved = FedGKTAPI.client_phase, FedGKTAPI.server_phase
        client_phase, server_phase = self._saved
        runs = self

        def timed(fn, seconds):
            def wrapper(api, *args, **kwargs):
                if api not in runs.apis:
                    runs.apis.append(api)
                sync(api.device)
                t0 = time.perf_counter()
                out = fn(api, *args, **kwargs)
                sync(api.device)
                seconds.append(time.perf_counter() - t0)
                return out
            return wrapper

        timed_client = timed(client_phase, self.client_s)

        def client(api, *args, **kwargs):
            logits, feats = timed_client(api, *args, **kwargs)
            self.feature_bytes.append(feats.numel() * feats.element_size())
            return logits, feats

        FedGKTAPI.client_phase = client
        FedGKTAPI.server_phase = timed(server_phase, self.server_s)
        return self

    def __exit__(self, *exc):
        FedGKTAPI.client_phase, FedGKTAPI.server_phase = self._saved


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card() -> str:
    """``nvidia-smi``'s name and power limit, or "not measured"."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def main(argv=None) -> dict:
    from fedml_tpu_torch.experiments import main_fedgkt

    flags = DEFAULT_FLAGS + list(sys.argv[1:] if argv is None else argv)
    on_card = torch.cuda.is_available() and "cpu" not in flags
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with PhaseTimes() as times:
        history = main_fedgkt.main(flags)
    api = times.apis[-1]
    out = {"card": card() if on_card else "not measured", "flags": flags,
           "wall_s": time.perf_counter() - t0,
           "clients": api.dataset.client_num, "rows": int(api.dataset.train.counts.sum()),
           "n_max": api.dataset.train.n_max,
           "client_phase_s": times.client_s, "server_phase_s": times.server_s,
           "feature_bytes": times.feature_bytes,
           "peak_device_bytes": torch.cuda.max_memory_allocated() if on_card else
           "not measured",
           "server_epoch_losses": api.server_loss_history,
           "test_acc": [h["Test/Acc"] for h in history]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
