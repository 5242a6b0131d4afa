"""Backdoor-attack tooling for robust-FL evaluation (numpy and a torch
forward; mirror of ``fedml_tpu/algorithms/backdoor.py``).

The reference's fedavg_robust evaluation (FedAvgRobustAggregator.py:14-112)
scores main-task accuracy beside backdoor success on fixed poisoned sets
(the edge-case pickles). Without them the poison is the classic
pixel-pattern trigger: a bright patch stamped in a corner, with the labels
flipped to the attacker's target.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.data import readers


def apply_trigger(x: np.ndarray, size: int = 3, value: float | None = None) -> np.ndarray:
    """Stamp a square trigger in the bottom-right corner of [n, h, w, c]
    images (value defaults to the array's max, saturated pixels). Flat
    square images [n, d] with d = s*s are reshaped, stamped and flattened
    back."""
    x = np.array(x, copy=True)
    v = float(x.max()) if value is None else value
    if x.ndim == 2:
        side = int(round(x.shape[1] ** 0.5))
        if side * side != x.shape[1]:
            raise ValueError(
                f"cannot stamp a 2-D trigger on flat features of dim "
                f"{x.shape[1]} (not a square image)")
        img = x.reshape(-1, side, side)
        img[:, -size:, -size:] = v
        return img.reshape(x.shape)
    x[..., -size:, -size:, :] = v
    return x


def poison_client_data(x: np.ndarray, y: np.ndarray, count: int,
                       target_label: int, poison_frac: float = 0.5,
                       trigger_size: int = 3,
                       rng: np.random.RandomState | None = None):
    """Poison a fraction of one packed client's valid samples (trigger +
    target label). Returns new (x, y)."""
    rng = rng or np.random.RandomState(0)
    n_poison = int(count * poison_frac)
    x = np.array(x, copy=True)
    y = np.array(y, copy=True)
    if n_poison == 0:  # a tiny client at a small fraction has none to poison
        return x, y
    idx = rng.choice(count, n_poison, replace=False)
    x[idx] = apply_trigger(x[idx], trigger_size)
    y[idx] = target_label
    return x, y


def load_edge_case_sets(data_dir: str = "./data", normalize=True):
    """The reference's edge-case backdoor sets, when present (the southwest
    pickles, reference edge_case_examples/data_loader.py:329-385): returns
    (x_poison_train, x_poison_test, target_label), or None so callers use
    the pixel trigger.

    ``normalize=True`` applies CIFAR-10's channel statistics, so the images
    match what a model trained on ``sources.load_cifar_arrays`` sees (the
    reference normalises these sets with its CIFAR transform too); False
    keeps raw [0, 1] pixels, and a (mean, std) pair applies other
    statistics."""
    out = readers.read_southwest(data_dir)
    if out is None or normalize is False:
        return out
    mean, std = ((readers.CIFAR10_MEAN, readers.CIFAR10_STD) if normalize is True
                 else normalize)
    xtr, xte, target = out
    return (xtr - mean) / std, (xte - mean) / std, target


def backdoor_metrics(predict_fn, x_clean: np.ndarray, y_clean: np.ndarray,
                     target_label: int, trigger_size: int = 3) -> dict[str, float]:
    """Main-task accuracy and backdoor success rate (reference
    test_on_server_for_all_clients + the poisoned-task eval): the trigger is
    stamped on the samples not already of the target class. ``predict_fn``
    maps a numpy batch to logits (a tensor)."""
    x_clean, y_clean = np.asarray(x_clean), np.asarray(y_clean)
    with torch.no_grad():
        pred = predict_fn(x_clean).argmax(-1).cpu().numpy()
        main_acc = float((pred == y_clean).mean())
        keep = y_clean != target_label
        pred_t = predict_fn(apply_trigger(x_clean[keep], trigger_size)).argmax(-1)
        backdoor_rate = float((pred_t.cpu().numpy() == target_label).mean())
    return {"MainTask/Acc": main_acc, "Backdoor/SuccessRate": backdoor_rate}
