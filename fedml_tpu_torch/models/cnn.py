"""The FedAvg-paper CNNs, PyTorch form of ``fedml_tpu/models/cnn.py``:
CNN_DropOut (reference fedml_api/model/cv/cnn.py:77, the FEMNIST
flagship), CNN_OriginalFedAvg (cnn.py:8), CNNCifar (cnn.py:243) and
HAR_CNN (linear/har_cnn.py:49).

Inputs are channels-last (NHWC, or [b, seq, channels] for HAR_CNN), as in
the JAX package, so the two take the same arrays; the modules move
channels first for their convolutions and back to channels-last before
the flatten, so the first dense layer's rows are in flax's (h, w, c) order
and the converted weights line up.

dtype rule (flax's): parameters stay float32; inputs and weights are cast to
the compute dtype, a conv or matmul output is in the compute dtype before
its bias is added in the compute dtype (``dense``, ``conv2d``); the FedAvg
CNNs cast their logits to float32, CNNCifar and HAR_CNN keep the compute
dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[dtype]


def dense(layer, x, cd):
    """A flax Dense in the compute dtype ``cd``: input and weight cast to
    it, the product rounded, then the bias added in it."""
    return F.linear(x.to(cd), layer.weight.to(cd)) + layer.bias.to(cd)


def embed(ids, weight):
    """flax ``nn.Embed``: rows of ``weight`` gathered at ``ids``, as
    ``jnp.take``'s fill mode gathers: an id in [-V, 0) counts from the end,
    and an id outside [-V, V) gives a NaN row and no gradient
    (``F.embedding`` alone raises on the CPU and asserts on the card).
    Ids in [0, V) give ``F.embedding``'s bits."""
    n = weight.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    valid = (ids >= 0) & (ids < n)
    rows = F.embedding(torch.where(valid, ids, 0), weight)
    return torch.where(valid[..., None], rows,
                       torch.full((), float("nan"), dtype=rows.dtype, device=rows.device))


def conv2d(layer, x, cd):
    """A flax Conv (with bias) in the compute dtype, as ``dense``."""
    return (F.conv2d(x.to(cd), layer.weight.to(cd), None, layer.stride, layer.padding)
            + layer.bias.to(cd)[:, None, None])


def _dropout(x, rate, generator):
    """flax Dropout: keep with probability 1 - rate, scale kept values by
    1 / (1 - rate) in the compute dtype."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


class CNN_DropOut(nn.Module):
    """3x3 VALID convs 32/64 -> 2x2 maxpool -> dropout .25 -> dense 128 ->
    dropout .5 -> dense ``output_dim``. ``input_hw`` is the input's side
    (28 for FEMNIST); ``drop1``/``drop2`` are module attributes so a
    dropout-free twin runs through the same class, as in the JAX package."""

    def __init__(self, output_dim: int = 10, dtype="float32",
                 drop1: float = 0.25, drop2: float = 0.5, input_hw: int = 28):
        super().__init__()
        self.output_dim = output_dim
        self.dtype = compute_dtype(dtype)
        self.drop1, self.drop2 = drop1, drop2
        self.input_hw = input_hw
        pooled = (input_hw - 4) // 2
        self.conv2d_1 = nn.Conv2d(1, 32, 3)
        self.conv2d_2 = nn.Conv2d(32, 64, 3)
        self.linear_1 = nn.Linear(pooled * pooled * 64, 128)
        self.linear_2 = nn.Linear(128, output_dim)

    def forward(self, x, train: bool = False, generator=None):
        cd = self.dtype
        x = x.to(cd).permute(0, 3, 1, 2)
        x = F.relu(conv2d(self.conv2d_1, x, cd))
        x = F.relu(conv2d(self.conv2d_2, x, cd))
        x = F.max_pool2d(x, 2)
        if train and self.drop1:
            x = _dropout(x, self.drop1, generator)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's channels-last flatten
        x = F.relu(dense(self.linear_1, x, cd))
        if train and self.drop2:
            x = _dropout(x, self.drop2, generator)
        return dense(self.linear_2, x, cd).float()


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator) -> None:
    """flax's default kernel init: variance_scaling(1, fan_in,
    truncated_normal) — a normal truncated at two standard deviations,
    rescaled so the truncated distribution has variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        sample = torch.empty(weight.shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(sample, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        weight.copy_(sample * std)


class CNN_OriginalFedAvg(nn.Module):
    """McMahan et al.'s CNN (reference cnn.py:8): 2x (5x5 SAME conv + 2x2
    max-pool) 32/64 -> dense 512 -> dense ``output_dim``; NHWC input of
    side ``input_hw``, flattened channels-last; logits in float32."""

    def __init__(self, output_dim: int = 10, dtype="float32", input_hw: int = 28):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        pooled = input_hw // 4
        self.conv2d_1 = nn.Conv2d(1, 32, 5, padding=2)
        self.conv2d_2 = nn.Conv2d(32, 64, 5, padding=2)
        self.linear_1 = nn.Linear(pooled * pooled * 64, 512)
        self.linear_2 = nn.Linear(512, output_dim)

    def forward(self, x, train: bool = False, generator=None):
        cd = self.dtype
        x = x.to(cd).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(conv2d(self.conv2d_1, x, cd)), 2)
        x = F.max_pool2d(F.relu(conv2d(self.conv2d_2, x, cd)), 2)
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = F.relu(dense(self.linear_1, x, cd))
        return dense(self.linear_2, x, cd).float()


class CNNCifar(nn.Module):
    """The small CIFAR CNN (reference cnn.py:243): 5x5 VALID convs 6/16,
    each + relu + 2x2 max-pool, dense 120 -> 84 -> ``output_dim``; NHWC
    32x32x3 input; logits in the compute dtype."""

    def __init__(self, output_dim: int = 10, dtype="float32", input_hw: int = 32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        side = ((input_hw - 4) // 2 - 4) // 2
        self.conv1 = nn.Conv2d(3, 6, 5)
        self.conv2 = nn.Conv2d(6, 16, 5)
        self.fc1 = nn.Linear(side * side * 16, 120)
        self.fc2 = nn.Linear(120, 84)
        self.fc3 = nn.Linear(84, output_dim)

    def forward(self, x, train: bool = False, generator=None):
        cd = self.dtype
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(conv2d(self.conv1, x, cd)), 2)
        x = F.max_pool2d(F.relu(conv2d(self.conv2, x, cd)), 2)
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = F.relu(dense(self.fc1, x, cd))
        x = F.relu(dense(self.fc2, x, cd))
        return dense(self.fc3, x, cd)


class HAR_CNN(nn.Module):
    """The UCI-HAR 1-D CNN (reference linear/har_cnn.py:49-84): two k3
    VALID convs of 32 channels, dropout 0.5, max-pool 2, dense 100 ->
    ``output_dim``. Input [b, seq, channels] (channels-last, as flax's);
    logits in the compute dtype."""

    def __init__(self, output_dim: int = 6, dtype="float32", seq_len: int = 128,
                 channels: int = 9):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.conv1 = nn.Conv1d(channels, 32, 3)
        self.conv2 = nn.Conv1d(32, 32, 3)
        self.lin3 = nn.Linear((seq_len - 4) // 2 * 32, 100)
        self.lin4 = nn.Linear(100, output_dim)

    def forward(self, x, train: bool = False, generator=None):
        cd = self.dtype
        x = x.permute(0, 2, 1)
        x = F.relu(F.conv1d(x.to(cd), self.conv1.weight.to(cd)) + self.conv1.bias.to(cd)[:, None])
        x = F.relu(F.conv1d(x, self.conv2.weight.to(cd)) + self.conv2.bias.to(cd)[:, None])
        if train:
            x = _dropout(x, 0.5, generator)
        x = F.max_pool1d(x, 2).permute(0, 2, 1).flatten(1)
        x = F.relu(dense(self.lin3, x, cd))
        if train:
            x = _dropout(x, 0.5, generator)
        return dense(self.lin4, x, cd)


