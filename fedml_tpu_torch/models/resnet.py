"""CIFAR and ImageNet-style ResNets, PyTorch form of
``fedml_tpu/models/resnet.py``.

  resnet20/32/44    BasicBlock, layers 3/5/7 per stage, stem 16, stages
                    16/32/64 (reference resnet_cifar.py:164-208)
  resnet56/110      Bottleneck, layers 6/12 per stage (reference
                    resnet.py:218,241): the cross-silo CIFAR-10 models
  resnet56_s2d      resnet56 on a 2x2 space-to-depth input
  resnet18/34/50    ImageNet-style, 7x7/2 stem 64, 3x3/2 max-pool, stages
                    64/128/256/512 (reference resnet_gn.py:109-135); with
                    ``group_norm`` > 0 GroupNorm replaces BatchNorm
                    (``resnet18_gn``, the fed_CIFAR-100 model)

Inputs are NHWC, as in the JAX package; the module moves channels first
once. Module names are flax's (``conv1``, ``_Norm_0.BatchNorm_0``,
``Bottleneck_3.Conv_1``, ``fc``), so the converter maps the trees one to
one.

Normalisation follows flax, not ``torch.nn.BatchNorm2d``:

  - the running statistics are updated from float32 batch statistics with
    the biased variance, where torch would blend the unbiased one;
    momentum 0.9 keeps 0.9 of the old statistic; epsilon 1e-5. The
    normalisation is one ``F.batch_norm`` call (batch statistics, biased
    variance, as flax normalises); the same call hands the batch's
    statistics out, and the blend is two ``_foreach`` launches;
  - GroupNorm's ``group_norm`` is channels per group, its epsilon 1e-6
    (torch's default is 1e-5);
  - the result is float32, whatever the compute dtype (flax promotes
    against the float32 parameters).

``F.batch_norm`` and ``F.group_norm`` take their variance in another order
of summation than flax's fast variance E[x^2] - E[x]^2, a difference of
rounding (``tests/test_torch_zoo.py`` holds both against flax); each is
one kernel a way where the spelled-out formula took about twenty small
launches.

A BatchNorm in train mode leaves its updated statistics in ``updated``;
``core/trainer.py::ModelTrainer.apply`` collects them as the new model
state. The running statistics are buffers named ``mean`` and ``var``
(``utils/pytree.py::STATE_LEAVES``).

dtype rule: parameters stay float32; convolutions and the head run in the
compute dtype (inputs and weights cast to it), normalisation in float32, so
the residual trunk is float32 and the logits come out in the compute dtype.

Silo-stacked forward (``ResNetCifar``, the silo-grouped round of
``algorithms/silo_grouped.py``): given variables stacked over S silos
(every leaf [S, ...], substituted by ``functional_call``) and an input [S,
B, H, W, C], the model runs the S silos in one forward on the packed
layout [B, S*C, H, W] (``ops/silo_conv.py``): its convolutions through
``packed_silo_conv`` (grouped where ``silo_threshold`` admits them, per
silo otherwise), each BatchNorm or GroupNorm over the packed channels (so
every silo keeps its own statistics and running buffers, [S, C]), the head
a product a silo; the logits come out [S, B, classes]. ``silo_threshold``
> 0 builds the convolutions as ``GroupableConv``, the same variables as
the plain model's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.cnn import compute_dtype, dense
from fedml_tpu_torch.ops.silo_conv import GroupableConv, packed_silo_conv


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW."""

    flax_leaf = "scale"  # the weight's flax leaf name

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.updated = None

    def flax_init_(self, leaf: str, t: torch.Tensor, generator) -> None:
        t.fill_(1.0 if leaf in ("weight", "var") else 0.0)

    def forward(self, x, train: bool = False):
        x = x.float()
        # silo-stacked leaves [S, C] normalise the packed [B, S*C, ...] layout
        # channel by channel: each silo by its own statistics
        shape = self.mean.shape
        weight, bias, running_mean, running_var = (
            t.reshape(-1) for t in (self.weight, self.bias, self.mean, self.var))
        if train:
            # the batch's statistics come out of the normalising call itself:
            # at momentum 1 it writes the batch mean and unbiased variance
            # into these zeroed buffers; flax blends the biased variance
            c = x.shape[1]
            n = x.numel() // c
            batch = x.new_zeros(2, c)
            # torch.batch_norm, not F.batch_norm, which refuses a batch of one
            # value a channel (a 1x1 map of one row): flax normalises it to
            # the bias
            y = torch.batch_norm(x, weight, bias, batch[0], batch[1], True, 1.0,
                                 self.eps, torch.backends.cudnn.enabled)
            with torch.no_grad():
                m = self.momentum
                mean, var = torch._foreach_mul([running_mean, running_var], m)
                # the biased variance; of one value it is 0 (torch's unbiased
                # one is then NaN)
                biased = batch[1] * ((n - 1) / n) if n > 1 else torch.zeros_like(batch[1])
                torch._foreach_add_([mean, var], [batch[0], biased], alpha=1 - m)
                self.updated = {"mean": mean.reshape(shape), "var": var.reshape(shape)}
            return y
        return F.batch_norm(x, running_mean, running_var, weight, bias, False, 0.0,
                            self.eps)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` (epsilon 1e-6) over NCHW."""

    flax_leaf = "scale"

    def __init__(self, channels: int, groups: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def flax_init_(self, leaf: str, t: torch.Tensor, generator) -> None:
        t.fill_(1.0 if leaf == "weight" else 0.0)

    def forward(self, x, train: bool = False):
        # silo-stacked leaves [S, C]: the packed layout's S * groups groups,
        # each within one silo's channels
        silos = self.weight.shape[0] if self.weight.dim() == 2 else 1
        return F.group_norm(x.float(), silos * self.groups, self.weight.reshape(-1),
                            self.bias.reshape(-1), self.eps)


class _Norm(nn.Module):
    """BatchNorm (``group_norm`` 0) or GroupNorm with ``group_norm``
    channels per group, under flax's submodule name."""

    def __init__(self, channels: int, group_norm: int = 0):
        super().__init__()
        if group_norm > 0:
            self.GroupNorm_0 = GroupNorm(channels, max(1, channels // group_norm))
        else:
            self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, x, train: bool = False):
        norm = self.GroupNorm_0 if hasattr(self, "GroupNorm_0") else self.BatchNorm_0
        return norm(x, train)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          silo_threshold: int = 0) -> nn.Conv2d:
    """A bias-free convolution (flax ``nn.Conv(use_bias=False)``), or with
    ``silo_threshold`` > 0 its silo-grouped drop-in ``GroupableConv``
    (the same weight)."""
    if silo_threshold > 0:
        return GroupableConv(cin, cout, k, stride, padding, threshold=silo_threshold)
    return nn.Conv2d(cin, cout, k, stride, padding, bias=False)


def _norms(module: nn.Module, channels) -> None:
    for i, c in enumerate(channels):
        module.add_module(f"_Norm_{i}", _Norm(c, module.group_norm))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, group_norm: int = 0,
                 dtype=torch.float32, silo_threshold: int = 0):
        super().__init__()
        self.stride, self.group_norm, self.dtype = stride, group_norm, dtype
        st = silo_threshold
        self.Conv_0 = _conv(cin, planes, 3, stride, 1, st)
        self.Conv_1 = _conv(planes, planes, 3, 1, 1, st)
        self.shortcut = stride != 1 or cin != planes
        if self.shortcut:
            self.Conv_2 = _conv(cin, planes, 1, stride, 0, st)
        _norms(self, [planes] * (3 if self.shortcut else 2))

    def forward(self, x, train: bool = False):
        cd = self.dtype
        out = F.relu(self._Norm_0(_apply_conv(self.Conv_0, x, cd), train))
        out = self._Norm_1(_apply_conv(self.Conv_1, out, cd), train)
        identity = x
        if self.shortcut:
            identity = self._Norm_2(_apply_conv(self.Conv_2, x, cd), train)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, group_norm: int = 0,
                 dtype=torch.float32, silo_threshold: int = 0):
        super().__init__()
        self.stride, self.group_norm, self.dtype = stride, group_norm, dtype
        st = silo_threshold
        cout = planes * self.expansion
        self.Conv_0 = _conv(cin, planes, 1, 1, 0, st)
        self.Conv_1 = _conv(planes, planes, 3, stride, 1, st)
        self.Conv_2 = _conv(planes, cout, 1, 1, 0, st)
        self.shortcut = stride != 1 or cin != cout
        if self.shortcut:
            self.Conv_3 = _conv(cin, cout, 1, stride, 0, st)
        _norms(self, [planes, planes, cout] + ([cout] if self.shortcut else []))

    def forward(self, x, train: bool = False):
        cd = self.dtype
        out = F.relu(self._Norm_0(_apply_conv(self.Conv_0, x, cd), train))
        out = F.relu(self._Norm_1(_apply_conv(self.Conv_1, out, cd), train))
        out = self._Norm_2(_apply_conv(self.Conv_2, out, cd), train)
        identity = x
        if self.shortcut:
            identity = self._Norm_3(_apply_conv(self.Conv_3, x, cd), train)
        return F.relu(out + identity)


def _apply_conv(layer: nn.Conv2d, x, cd):
    """A bias-free flax Conv in the compute dtype ``cd`` (input and weight
    cast to it); a grouped layer is flax's ``feature_group_count``. A
    silo-stacked weight [S, O, C, kh, kw] convolves the packed layout
    (``ops/silo_conv.py::packed_silo_conv``, grouped up to the layer's
    threshold: 0 for a plain conv)."""
    w = layer.weight.to(cd)
    if w.dim() == 5:
        return packed_silo_conv(x.to(cd), w, layer.stride, layer.padding,
                                getattr(layer, "threshold", 0))
    return F.conv2d(x.to(cd), w, None, layer.stride, layer.padding, layer.dilation,
                    layer.groups)


def _stages(module: nn.Module, block, cin: int, widths, layers, group_norm, dtype,
            silo_threshold: int = 0) -> int:
    """Add the residual stages under flax's block names; returns the output
    channels."""
    i = 0
    for stage, (planes, blocks) in enumerate(zip(widths, layers)):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            module.add_module(f"{block.__name__}_{i}",
                              block(cin, planes, stride, group_norm, dtype, silo_threshold))
            cin = planes * block.expansion
            i += 1
    module.num_blocks = i
    return cin


class ResNetCifar(nn.Module):
    """3-stage CIFAR ResNet: 3x3 stem conv -> stages -> global average pool
    -> fc. ``widths`` sets the stage widths, ``s2d`` a 2x2 space-to-depth
    input transform (32x32x3 -> 16x16x12). ``silo_threshold`` > 0 builds
    its convolutions as ``GroupableConv`` for the silo-grouped round: an
    input [S, B, H, W, C] with silo-stacked variables then runs the S silos
    in one forward (module docstring)."""

    def __init__(self, block, layers, output_dim: int = 10, group_norm: int = 0,
                 widths=(16, 32, 64), s2d: bool = False, in_channels: int = 3,
                 dtype="float32", silo_threshold: int = 0):
        super().__init__()
        self._init_args = dict(block=block, layers=tuple(layers), output_dim=output_dim,
                               group_norm=group_norm, widths=tuple(widths), s2d=s2d,
                               in_channels=in_channels, dtype=dtype,
                               silo_threshold=silo_threshold)
        self.block, self.s2d = block, s2d
        self.dtype = compute_dtype(dtype)
        self.group_norm = group_norm
        self.silo_threshold = silo_threshold
        cin = in_channels * (4 if s2d else 1)
        self.conv1 = _conv(cin, widths[0], 3, 1, 1, silo_threshold)
        _norms(self, [widths[0]])
        cout = _stages(self, block, widths[0], widths, layers, group_norm, self.dtype,
                       silo_threshold)
        self.fc = nn.Linear(cout, output_dim)

    def clone(self, **changes) -> "ResNetCifar":
        """A new module of the same architecture with ``changes`` to its
        constructor's arguments (flax's ``Module.clone``)."""
        return ResNetCifar(**{**self._init_args, **changes})

    def forward(self, x, train: bool = False, generator=None):
        silos = x.shape[0] if x.dim() == 5 else 0
        if silos:
            x = x.flatten(0, 1)
        if self.s2d:
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(b, h // 2, w // 2, 4 * c)
        if silos:
            # [S*B, H, W, C] -> the packed layout [B, S*C, H, W]
            b, h, w, c = x.shape
            x = x.reshape(silos, b // silos, h, w, c).permute(1, 0, 4, 2, 3)
            x = x.reshape(b // silos, silos * c, h, w)
        else:
            x = x.permute(0, 3, 1, 2)
        x = F.relu(self._Norm_0(_apply_conv(self.conv1, x, self.dtype), train))
        name = self.block.__name__
        for i in range(self.num_blocks):
            x = getattr(self, f"{name}_{i}")(x, train)
        pooled = x.mean((2, 3))
        if not silos:
            return dense(self.fc, pooled, self.dtype)
        # a dense head a silo: [S, B, C] x [S, K, C] -> [S, B, K]
        cd = self.dtype
        pooled = pooled.reshape(pooled.shape[0], silos, -1).transpose(0, 1)
        return (torch.bmm(pooled.to(cd), self.fc.weight.to(cd).transpose(1, 2))
                + self.fc.bias.to(cd)[:, None])


class ResNetImageNet(nn.Module):
    """4-stage ImageNet-style ResNet: 7x7/2 stem 64, 3x3/2 max-pool, stages
    64/128/256/512, global average pool, fc."""

    def __init__(self, block, layers, output_dim: int = 1000, group_norm: int = 0,
                 in_channels: int = 3, dtype="float32"):
        super().__init__()
        self.block = block
        self.dtype = compute_dtype(dtype)
        self.group_norm = group_norm
        self.conv1 = _conv(in_channels, 64, 7, 2, 3)
        _norms(self, [64])
        cout = _stages(self, block, 64, (64, 128, 256, 512), layers, group_norm, self.dtype)
        self.fc = nn.Linear(cout, output_dim)

    def forward(self, x, train: bool = False, generator=None):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self._Norm_0(_apply_conv(self.conv1, x, self.dtype), train))
        x = F.max_pool2d(x, 3, 2, 1)
        name = self.block.__name__
        for i in range(self.num_blocks):
            x = getattr(self, f"{name}_{i}")(x, train)
        return dense(self.fc, x.mean((2, 3)), self.dtype)


def resnet20(output_dim=10, group_norm=0, dtype="float32", in_channels=3):
    return ResNetCifar(BasicBlock, (3, 3, 3), output_dim, group_norm,
                       in_channels=in_channels, dtype=dtype)


def resnet32(output_dim=10, group_norm=0, dtype="float32", in_channels=3):
    return ResNetCifar(BasicBlock, (5, 5, 5), output_dim, group_norm,
                       in_channels=in_channels, dtype=dtype)


def resnet44(output_dim=10, group_norm=0, dtype="float32", in_channels=3):
    return ResNetCifar(BasicBlock, (7, 7, 7), output_dim, group_norm,
                       in_channels=in_channels, dtype=dtype)


def resnet56(output_dim=10, group_norm=0, s2d=False, dtype="float32", in_channels=3):
    return ResNetCifar(Bottleneck, (6, 6, 6), output_dim, group_norm, s2d=s2d,
                       in_channels=in_channels, dtype=dtype)


def resnet56_s2d(output_dim=10, group_norm=0, dtype="float32", in_channels=3):
    """ResNet-56 on a space-to-depth input: an architecture variant of the
    reference model, not the model itself."""
    return resnet56(output_dim, group_norm, s2d=True, dtype=dtype, in_channels=in_channels)


def resnet110(output_dim=10, group_norm=0, dtype="float32", in_channels=3):
    return ResNetCifar(Bottleneck, (12, 12, 12), output_dim, group_norm,
                       in_channels=in_channels, dtype=dtype)


def resnet18(output_dim=1000, group_norm=0, dtype="float32", in_channels=3):
    return ResNetImageNet(BasicBlock, (2, 2, 2, 2), output_dim, group_norm,
                          in_channels=in_channels, dtype=dtype)


def resnet34(output_dim=1000, group_norm=0, dtype="float32", in_channels=3):
    return ResNetImageNet(BasicBlock, (3, 4, 6, 3), output_dim, group_norm,
                          in_channels=in_channels, dtype=dtype)


def resnet50(output_dim=1000, group_norm=0, dtype="float32", in_channels=3):
    return ResNetImageNet(Bottleneck, (3, 4, 6, 3), output_dim, group_norm,
                          in_channels=in_channels, dtype=dtype)
