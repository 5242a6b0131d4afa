"""EfficientNet b0-b7 (and the b8 / l2 scalings), PyTorch form of
``fedml_tpu/models/efficientnet.py`` (reference
fedml_api/model/cv/efficientnet.py: EfficientNet at :138, MBConvBlock at
:36; efficientnet_utils.py: round_filters :79, round_repeats :105,
drop_connect :121, the b0 block strings and the compound-scaling table).

As the JAX package: BatchNorm with momentum 0.99 and epsilon 1e-3; the
squeeze-excite's width comes from the block's input filters, and only its
two 1x1 convs have biases; swish activations; drop-connect on the residual
branch, ramped linearly over the blocks, drawn per sample from the
caller's ``torch.Generator``.

flax's ``padding="SAME"`` pads a strided conv asymmetrically: total =
max((ceil(n / s) - 1) * s + k - n, 0), low = total // 2, high = total -
low. A symmetric ``Conv2d(padding=k // 2)`` shifts the window of a stride-2
conv by one pixel, so every SAME conv here pads explicitly (``same_pad``).

Module names are flax's (``conv_stem``, ``bn_stem``, ``block{i}.expand_conv``
/ ``bn0`` / ``depthwise_conv`` / ``bn1`` / ``se_reduce`` / ``se_expand`` /
``project_conv`` / ``bn2``, ``conv_head``, ``bn_head``, ``fc``). dtype rule
as MobileNetV3's: every BatchNorm rounds its output to the compute dtype,
so the trunk and the logits are in it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.cnn import _dropout, compute_dtype, conv2d, dense
from fedml_tpu_torch.models.resnet import BatchNorm, _apply_conv


class BlockArgs(NamedTuple):
    num_repeat: int
    kernel: int
    stride: int
    expand_ratio: int
    input_filters: int
    output_filters: int
    se_ratio: float


# b0's blocks (the reference's 'r1_k3_s11_e1_i32_o16_se0.25', ... strings)
B0_BLOCKS = (
    BlockArgs(1, 3, 1, 1, 32, 16, 0.25),
    BlockArgs(2, 3, 2, 6, 16, 24, 0.25),
    BlockArgs(2, 5, 2, 6, 24, 40, 0.25),
    BlockArgs(3, 3, 2, 6, 40, 80, 0.25),
    BlockArgs(3, 5, 1, 6, 80, 112, 0.25),
    BlockArgs(4, 5, 2, 6, 112, 192, 0.25),
    BlockArgs(1, 3, 1, 6, 192, 320, 0.25),
)

# name -> (width coefficient, depth coefficient, resolution, dropout rate)
SCALING = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
    "efficientnet-b8": (2.2, 3.6, 672, 0.5),
    "efficientnet-l2": (4.3, 5.3, 800, 0.5),
}


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """Compound width scaling (reference round_filters)."""
    if not width:
        return filters
    f = filters * width
    new_f = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * f:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    """Compound depth scaling (reference round_repeats)."""
    return int(math.ceil(depth * repeats)) if depth else repeats


def same_pad(x, kernel: int, stride: int):
    """``x`` [N, C, H, W] padded with zeros as flax's ``padding="SAME"``
    pads it for a ``kernel`` x ``kernel`` conv of stride ``stride``: the
    smaller half of each side's padding before, the larger after."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _bn(channels: int) -> BatchNorm:
    # the reference's batch_norm_momentum=0.99, epsilon=1e-3
    return BatchNorm(channels, momentum=0.99, eps=1e-3)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-excite (reference
    MBConvBlock, efficientnet.py:36-135)."""

    def __init__(self, args: BlockArgs, drop_connect_rate: float, dtype):
        super().__init__()
        self.args, self.drop_connect_rate, self.dtype = args, drop_connect_rate, dtype
        inp, oup = args.input_filters, args.input_filters * args.expand_ratio
        if args.expand_ratio != 1:
            self.expand_conv = nn.Conv2d(inp, oup, 1, bias=False)
            self.bn0 = _bn(oup)
        self.depthwise_conv = nn.Conv2d(oup, oup, args.kernel, args.stride, groups=oup,
                                        bias=False)
        self.bn1 = _bn(oup)
        self.has_se = 0.0 < args.se_ratio <= 1.0
        if self.has_se:
            sq = max(1, int(inp * args.se_ratio))
            self.se_reduce = nn.Conv2d(oup, sq, 1)
            self.se_expand = nn.Conv2d(sq, oup, 1)
        self.project_conv = nn.Conv2d(oup, args.output_filters, 1, bias=False)
        self.bn2 = _bn(args.output_filters)

    def forward(self, x, train: bool = False, generator=None):
        a, cd = self.args, self.dtype
        out = x
        if a.expand_ratio != 1:
            out = F.silu(self.bn0(_apply_conv(self.expand_conv, out, cd), train).to(cd))
        out = _apply_conv(self.depthwise_conv, same_pad(out.to(cd), a.kernel, a.stride), cd)
        out = F.silu(self.bn1(out, train).to(cd))
        if self.has_se:
            s = out.mean((2, 3), keepdim=True)
            s = F.silu(conv2d(self.se_reduce, s, cd))
            s = conv2d(self.se_expand, s, cd)
            out = (torch.sigmoid(s) * out).to(out.dtype)
        out = self.bn2(_apply_conv(self.project_conv, out, cd), train).to(cd)
        if a.stride == 1 and a.input_filters == a.output_filters:
            if train and self.drop_connect_rate > 0.0:
                # stochastic depth on the residual branch (reference
                # drop_connect, efficientnet_utils.py:121-144)
                keep = 1.0 - self.drop_connect_rate
                mask = (torch.rand((out.shape[0], 1, 1, 1), generator=generator,
                                   device=out.device) < keep).to(out.dtype)
                out = out / keep * mask
            out = out + x
        return out


class EfficientNet(nn.Module):
    def __init__(self, output_dim: int = 1000, width_coefficient: float = 1.0,
                 depth_coefficient: float = 1.0, dropout_rate: float = 0.2,
                 drop_connect_rate: float = 0.2, dtype="float32", in_channels: int = 3):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.dropout_rate = dropout_rate
        w, d = width_coefficient, depth_coefficient
        plan = [a._replace(input_filters=round_filters(a.input_filters, w),
                           output_filters=round_filters(a.output_filters, w),
                           num_repeat=round_repeats(a.num_repeat, d)) for a in B0_BLOCKS]
        # drop-connect ramps linearly over the true total block count
        # (reference forward, :118-124)
        total = sum(a.num_repeat for a in plan)
        stem = round_filters(32, w)
        self.conv_stem = nn.Conv2d(in_channels, stem, 3, 2, bias=False)
        self.bn_stem = _bn(stem)
        idx = 0
        for a in plan:
            for r in range(a.num_repeat):
                block = a._replace(input_filters=a.input_filters if r == 0 else a.output_filters,
                                   stride=a.stride if r == 0 else 1, num_repeat=1)
                self.add_module(f"block{idx}", MBConvBlock(
                    block, drop_connect_rate * idx / total, self.dtype))
                idx += 1
        self.num_blocks = idx
        head = round_filters(1280, w)
        self.conv_head = nn.Conv2d(plan[-1].output_filters, head, 1, bias=False)
        self.bn_head = _bn(head)
        self.fc = nn.Linear(head, output_dim)

    @classmethod
    def from_name(cls, name: str, output_dim: int = 1000, dtype="float32",
                  in_channels: int = 3) -> "EfficientNet":
        w, d, _res, drop = SCALING[name]
        return cls(output_dim=output_dim, width_coefficient=w, depth_coefficient=d,
                   dropout_rate=drop, dtype=dtype, in_channels=in_channels)

    def forward(self, x, train: bool = False, generator=None):
        cd = self.dtype
        x = x.to(cd).permute(0, 3, 1, 2)
        x = _apply_conv(self.conv_stem, same_pad(x, 3, 2), cd)
        x = F.silu(self.bn_stem(x, train).to(cd))
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x, train, generator)
        x = F.silu(self.bn_head(_apply_conv(self.conv_head, x, cd), train).to(cd))
        x = x.mean((2, 3))
        if train and self.dropout_rate:
            x = _dropout(x, self.dropout_rate, generator)
        return dense(self.fc, x, cd)
