"""Train-time data augmentation on the device (PyTorch form of
``fedml_tpu/data/augment.py``).

The reference augments in torchvision transforms on the host (reference
cifar10/data_loader.py:49-69: RandomCrop(32, pad 4), RandomHorizontalFlip,
Cutout(16)). Here, as in the JAX package, the same augmentations transform
a training batch [n, h, w, c] on its own device inside the local step, as
tensor ops that never wait for the host (the crop is an index gather, not
a slice at host offsets).

Each function draws from an explicit ``torch.Generator`` on the batch's
device, or takes its draws injected (``flip``, ``offsets``, ``center``),
so that a test can feed it the JAX package's draws: JAX's threefry stream
cannot be reproduced in PyTorch. With the same draws the outputs are the
JAX functions' bit for bit.

Use: ``ClassificationTrainer(module, augment_fn=cifar_train_augment)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _randint(generator, high: int, device) -> torch.Tensor:
    return torch.randint(0, high, (), generator=generator, device=device)


def random_flip(generator, x, flip=None):
    """Per-sample horizontal flip with p = 0.5 (``flip``: a [n] bool draw)."""
    if flip is None:
        flip = torch.rand(x.shape[0], generator=generator, device=x.device) < 0.5
    flip = torch.as_tensor(flip, device=x.device)
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def random_crop(generator, x, pad: int = 4, offsets=None):
    """Zero-pad by ``pad`` then crop back at one offset for the batch
    (``offsets``: the (row, column) draw, each in [0, 2 * pad])."""
    n, h, w, c = x.shape
    if offsets is None:
        offsets = (_randint(generator, 2 * pad + 1, x.device),
                   _randint(generator, 2 * pad + 1, x.device))
    oy, ox = (torch.as_tensor(o, device=x.device) for o in offsets)
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    rows = oy + torch.arange(h, device=x.device)
    cols = ox + torch.arange(w, device=x.device)
    return xp.index_select(1, rows).index_select(2, cols)


def cutout(generator, x, length: int = 16, center=None):
    """Zero one random ``length`` x ``length`` square for the batch
    (reference Cutout, cifar10/data_loader.py:49-69; ``center``: the
    (row, column) draw in [0, h) x [0, w))."""
    n, h, w, c = x.shape
    if center is None:
        center = (_randint(generator, h, x.device), _randint(generator, w, x.device))
    cy, cx = (torch.as_tensor(o, device=x.device) for o in center)
    ys = torch.arange(h, device=x.device)
    xs = torch.arange(w, device=x.device)
    mask_y = (ys >= cy - length // 2) & (ys < cy + length // 2)
    mask_x = (xs >= cx - length // 2) & (xs < cx + length // 2)
    hole = mask_y[:, None] & mask_x[None, :]
    return x * (1.0 - hole[None, :, :, None].to(x.dtype))


def cifar_train_augment(generator, x, crop_pad: int = 4, cutout_len: int = 16,
                        draws=None):
    """Crop, flip, then cutout: the reference CIFAR train transform.
    ``draws`` injects all three (``{"offsets", "flip", "center"}``)."""
    draws = draws or {}
    x = random_crop(generator, x, crop_pad, draws.get("offsets"))
    x = random_flip(generator, x, draws.get("flip"))
    return cutout(generator, x, cutout_len, draws.get("center"))
