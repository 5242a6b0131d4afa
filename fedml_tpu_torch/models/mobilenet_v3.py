"""MobileNetV3 (LARGE and SMALL), PyTorch form of
``fedml_tpu/models/mobilenet_v3.py`` (reference
fedml_api/model/cv/mobilenet_v3.py: MobileNetV3 at :137 with the LARGE and
SMALL plans at :143-247, MobileBlock at :84, SqueezeBlock at :64,
h_swish/h_sigmoid at :35-51, _make_divisible at :54).

With the reference's quirks, as the JAX package keeps them: the depthwise
and project convs carry biases, the squeeze-excite runs at the expansion
width with two dense layers, and the classifier is a pair of 1x1 convs on
the pooled map. Module names are flax's (``init_conv``, ``init_bn``,
``block{i}.expand`` / ``expand_bn`` / ``depthwise`` / ``depthwise_bn`` /
``se.fc1`` / ``se.fc2`` / ``project`` / ``project_bn``, ``out_conv1``,
``out_se``, ``out_bn1``, ``out_conv2``, ``classifier``).

dtype rule (flax's, with every BatchNorm given the compute dtype): the
input, the convs and dense layers run in the compute dtype; a BatchNorm
normalises in float32 and rounds its output to the compute dtype, so the
whole trunk and the logits are in the compute dtype. Dropout before the
classifier draws from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.cnn import _dropout, compute_dtype, conv2d, dense
from fedml_tpu_torch.models.resnet import BatchNorm, _apply_conv


def _make_divisible(v: float, divisor: int = 8, min_value: int | None = None) -> int:
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def h_sigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def h_swish(x):
    return x * h_sigmoid(x)


class SqueezeBlock(nn.Module):
    """Squeeze-excite over channels: mean over H, W -> dense C/4 -> ReLU ->
    dense C -> h_sigmoid -> scale (reference SqueezeBlock, :64-82)."""

    def __init__(self, channels: int, dtype, divide: int = 4):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(channels, channels // divide)
        self.fc2 = nn.Linear(channels // divide, channels)

    def forward(self, x):
        s = x.mean((2, 3))
        s = F.relu(dense(self.fc1, s, self.dtype))
        s = h_sigmoid(dense(self.fc2, s, self.dtype))
        return x * s[:, :, None, None].to(x.dtype)


class MobileBlock(nn.Module):
    """Inverted residual: 1x1 expand (no bias) -> BN -> act -> kxk depthwise
    (bias) -> BN -> (SE) -> 1x1 project (bias) -> BN -> act, with the input
    added when the stride is 1 and the widths match (reference MobileBlock,
    :84-135)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, nonlinear: str,
                 se: bool, exp: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.act = F.relu if nonlinear == "RE" else h_swish
        self.use_connect = stride == 1 and cin == cout
        self.expand = nn.Conv2d(cin, exp, 1, bias=False)
        self.expand_bn = BatchNorm(exp)
        self.depthwise = nn.Conv2d(exp, exp, kernel, stride, (kernel - 1) // 2, groups=exp)
        self.depthwise_bn = BatchNorm(exp)
        if se:
            self.se = SqueezeBlock(exp, dtype)
        self.project = nn.Conv2d(exp, cout, 1)
        self.project_bn = BatchNorm(cout)

    def forward(self, x, train: bool = False):
        cd = self.dtype
        out = self.act(self.expand_bn(_apply_conv(self.expand, x, cd), train).to(cd))
        out = self.depthwise_bn(conv2d(self.depthwise, out, cd), train).to(cd)
        if hasattr(self, "se"):
            out = self.se(out)
        out = self.act(self.project_bn(conv2d(self.project, out, cd), train).to(cd))
        return x + out if self.use_connect else out


# (in, out, kernel, stride, nonlinearity, SE, expansion), reference :143-161
LARGE_PLAN = (
    (16, 16, 3, 1, "RE", False, 16),
    (16, 24, 3, 2, "RE", False, 64),
    (24, 24, 3, 1, "RE", False, 72),
    (24, 40, 5, 2, "RE", True, 72),
    (40, 40, 5, 1, "RE", True, 120),
    (40, 40, 5, 1, "RE", True, 120),
    (40, 80, 3, 2, "HS", False, 240),
    (80, 80, 3, 1, "HS", False, 200),
    (80, 80, 3, 1, "HS", False, 184),
    (80, 80, 3, 1, "HS", False, 184),
    (80, 112, 3, 1, "HS", True, 480),
    (112, 112, 3, 1, "HS", True, 672),
    (112, 160, 5, 1, "HS", True, 672),
    (160, 160, 5, 2, "HS", True, 672),
    (160, 160, 5, 1, "HS", True, 960),
)

# reference :196-208
SMALL_PLAN = (
    (16, 16, 3, 2, "RE", True, 16),
    (16, 24, 3, 2, "RE", False, 72),
    (24, 24, 3, 1, "RE", False, 88),
    (24, 40, 5, 2, "RE", True, 96),
    (40, 40, 5, 1, "RE", True, 240),
    (40, 40, 5, 1, "RE", True, 240),
    (40, 48, 5, 1, "HS", True, 120),
    (48, 48, 5, 1, "HS", True, 144),
    (48, 96, 5, 2, "HS", True, 288),
    (96, 96, 5, 1, "HS", True, 576),
    (96, 96, 5, 1, "HS", True, 576),
)


class MobileNetV3(nn.Module):
    def __init__(self, output_dim: int = 1000, mode: str = "LARGE", multiplier: float = 1.0,
                 dropout_rate: float = 0.0, dtype="float32", in_channels: int = 3):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.dropout_rate = dropout_rate
        self.large = mode.upper() == "LARGE"
        plan = LARGE_PLAN if self.large else SMALL_PLAN

        def d(v):
            return _make_divisible(v * multiplier)

        self.init_conv = nn.Conv2d(in_channels, d(16), 3, 2, 1)
        self.init_bn = BatchNorm(d(16))
        cin = d(16)
        self.num_blocks = len(plan)
        for i, (_, out_ch, k, s, nl, se, exp) in enumerate(plan):
            self.add_module(f"block{i}",
                            MobileBlock(cin, d(out_ch), k, s, nl, se, d(exp), self.dtype))
            cin = d(out_ch)
        c1 = d(960 if self.large else 576)
        self.out_conv1 = nn.Conv2d(cin, c1, 1)
        if not self.large:
            # the reference's SMALL puts an SE between this conv and its BN
            # (:227-233)
            self.out_se = SqueezeBlock(c1, self.dtype)
        self.out_bn1 = BatchNorm(c1)
        self.out_conv2 = nn.Conv2d(c1, d(1280), 1)
        self.classifier = nn.Conv2d(d(1280), output_dim, 1)

    def forward(self, x, train: bool = False, generator=None):
        cd = self.dtype
        x = x.to(cd).permute(0, 3, 1, 2)
        x = h_swish(self.init_bn(conv2d(self.init_conv, x, cd), train).to(cd))
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x, train)
        x = conv2d(self.out_conv1, x, cd)
        if not self.large:
            x = self.out_se(x)
        x = h_swish(self.out_bn1(x, train).to(cd))
        x = x.mean((2, 3), keepdim=True)
        x = h_swish(conv2d(self.out_conv2, x, cd))
        if train and self.dropout_rate:
            x = _dropout(x, self.dropout_rate, generator)
        return conv2d(self.classifier, x, cd).flatten(1)
