"""MobileNet v1, PyTorch form of ``fedml_tpu/models/mobilenet.py``
(reference fedml_api/model/cv/mobilenet.py:60-209).

Depthwise-separable stacks with width multiplier ``alpha``: a 3x3/1 stem
(CIFAR-size inputs), stages 32 -> 64 -> 128 -> 256 -> 512 (x5) -> 1024,
global average pool, dense ``fc``. flax's depthwise conv
(``feature_group_count=C``, kernel [3, 3, 1, C]) is a ``groups=C`` conv
here (weight [C, 1, 3, 3]; ``utils/convert.py`` maps the two). Every conv
is bias-free and followed by a flax-style BatchNorm (momentum 0.9) and a
ReLU. Module names are flax's (``stem``, ``stem_bn``, ``dw{i}.depthwise``,
``dw{i}.dw_bn``, ``dw{i}.pointwise``, ``dw{i}.pw_bn``, ``fc``). dtype rule as
the ResNets': convolutions and ``fc`` in the compute dtype, normalisation
in float32, logits in the compute dtype.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.cnn import compute_dtype, dense
from fedml_tpu_torch.models.resnet import BatchNorm, _apply_conv

# (output channels, stride) of the 13 depthwise-separable blocks
PLAN = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1), (512, 1),
        (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1))


class _DWSep(nn.Module):
    """3x3 depthwise (stride ``stride``) -> BN -> ReLU -> 1x1 pointwise ->
    BN -> ReLU."""

    def __init__(self, cin: int, cout: int, stride: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.depthwise = nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False)
        self.dw_bn = BatchNorm(cin)
        self.pointwise = nn.Conv2d(cin, cout, 1, bias=False)
        self.pw_bn = BatchNorm(cout)

    def forward(self, x, train: bool = False):
        x = F.relu(self.dw_bn(_apply_conv(self.depthwise, x, self.dtype), train))
        return F.relu(self.pw_bn(_apply_conv(self.pointwise, x, self.dtype), train))


class MobileNet(nn.Module):
    def __init__(self, output_dim: int = 100, alpha: float = 1.0, dtype="float32",
                 in_channels: int = 3):
        super().__init__()
        self.dtype = compute_dtype(dtype)

        def c(n):
            return int(n * alpha)

        self.stem = nn.Conv2d(in_channels, c(32), 3, padding=1, bias=False)
        self.stem_bn = BatchNorm(c(32))
        cin = c(32)
        for i, (ch, s) in enumerate(PLAN):
            self.add_module(f"dw{i}", _DWSep(cin, c(ch), s, self.dtype))
            cin = c(ch)
        self.fc = nn.Linear(cin, output_dim)

    def forward(self, x, train: bool = False, generator=None):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn(_apply_conv(self.stem, x, self.dtype), train))
        for i in range(len(PLAN)):
            x = getattr(self, f"dw{i}")(x, train)
        return dense(self.fc, x.mean((2, 3)), self.dtype)
