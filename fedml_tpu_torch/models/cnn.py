"""CNN_DropOut (reference fedml_api/model/cv/cnn.py:77), PyTorch form of
``fedml_tpu/models/cnn.py::CNN_DropOut``.

Inputs are NHWC [b, H, W, 1], as in the JAX package, so the two take the
same arrays; the module moves channels first for its convolutions and back
to channels-last before the flatten, so ``linear_1``'s 9216 rows are in
flax's (h, w, c) order and the converted weights line up.

dtype rule (flax's): parameters stay float32; inputs and weights are cast to
the compute dtype, a conv or matmul output is in the compute dtype before
its bias is added in the compute dtype, and the logits are cast to float32.
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

    def _conv(self, layer, x):
        cd = self.dtype
        return F.conv2d(x, layer.weight.to(cd)) + layer.bias.to(cd)[:, None, None]

    def _dense(self, layer, x):
        cd = self.dtype
        return F.linear(x, layer.weight.to(cd)) + layer.bias.to(cd)

    def forward(self, x, train: bool = False, generator=None):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self._conv(self.conv2d_1, x))
        x = F.relu(self._conv(self.conv2d_2, x))
        x = F.max_pool2d(x, 2)
        if train and self.drop1:
            x = _dropout(x, self.drop1, generator)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's channels-last flatten
        x = F.relu(self._dense(self.linear_1, x))
        if train and self.drop2:
            x = _dropout(x, self.drop2, generator)
        return self._dense(self.linear_2, x).float()


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
