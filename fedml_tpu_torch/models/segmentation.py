"""Segmentation models of the FedSeg path, PyTorch form of
``fedml_tpu/models/segmentation.py``:

- ``DeepLabV3Plus``: a depthwise-separable strided backbone (output stride
  16) -> ASPP with atrous rates (6, 12, 18) and image pooling -> the
  DeepLabV3+ decoder with a low-level skip at stride 4 -> bilinear
  upsampling to the input's size;
- ``SimpleFCN``: the small stand-in of the JAX package's tests.

Both take NHWC input and return per-pixel logits [b, h, w, classes], as the
port's CNNs do; they move channels first once. Module names are flax's
(``stage1a.dw_bn``, ``aspp.img_pool``, ``dec1``), so the converter maps the
trees one to one, ``batch_stats`` included.

Padding follows flax. ``"SAME"`` pads the smaller half of a side's padding
before and the larger after (``models/efficientnet.py::same_pad``, with the
dilated kernel's extent): asymmetric at stride 2 (DeepLab's stem and its
strided separable convs), symmetric for the dilated stride-1 ones. flax's
``ConvTranspose`` (``lax.conv_transpose``, ``transpose_kernel=False``) is a
correlation of the zero-inserted input, its kernel not flipped, padded
(k + s - 2) split as lax splits it: (2, 1) for 3x3 stride 2. ``ConvTranspose``
keeps that kernel in a conv's [out, in, kh, kw] layout (the converter's
rule for any conv kernel) and runs ``F.conv_transpose2d`` on it flipped,
cropped to lax's size. The bilinear resize is ``jax.image.resize``'s:
half-pixel centres, the edge sample clamped, at any scale; two products
with interpolation matrices, so that its backward is deterministic.

BatchNorm is ``models/resnet.py::BatchNorm`` (flax's momentum 0.9 and
epsilon 1e-5, its running-average rule); the image-pool branch normalises
a 1x1 map over the batch.

dtype rule (flax's): parameters stay float32; convolutions, the resize and
the classifier run in the compute dtype, BatchNorm in float32. DeepLab's
logits are float32; the FCN's stay in the compute dtype.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.cnn import compute_dtype, conv2d
from fedml_tpu_torch.models.efficientnet import same_pad
from fedml_tpu_torch.models.resnet import BatchNorm


def _bare(cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1,
          groups: int = 1) -> nn.Conv2d:
    """A bias-free convolution whose padding is ``_same``'s to apply."""
    return nn.Conv2d(cin, cout, kernel, stride, 0, dilation, groups, bias=False)


def _same(layer: nn.Conv2d, x, cd):
    """A bias-free flax Conv with ``padding="SAME"`` in the compute dtype."""
    k = (layer.kernel_size[0] - 1) * layer.dilation[0] + 1
    x = same_pad(x.to(cd), k, layer.stride[0])
    return F.conv2d(x, layer.weight.to(cd), None, layer.stride, 0, layer.dilation,
                    layer.groups)


class _SepConv(nn.Module):
    """Depthwise-separable conv + BN + ReLU, twice (depthwise 3x3, then
    pointwise 1x1)."""

    def __init__(self, cin: int, out_ch: int, stride: int = 1, dilation: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.dw = _bare(cin, cin, 3, stride, dilation, groups=cin)
        self.dw_bn = BatchNorm(cin)
        self.pw = _bare(cin, out_ch, 1)
        self.pw_bn = BatchNorm(out_ch)

    def forward(self, x, train: bool = False):
        x = F.relu(self.dw_bn(_same(self.dw, x, self.dtype), train))
        return F.relu(self.pw_bn(_same(self.pw, x, self.dtype), train))


class _ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, three dilated 3x3
    branches and global image pooling, concatenated and projected."""

    def __init__(self, cin: int, out_ch: int = 128, rates=(6, 12, 18), dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.rates = tuple(rates)
        self.b0, self.b0_bn = _bare(cin, out_ch, 1), BatchNorm(out_ch)
        for i, r in enumerate(self.rates):
            self.add_module(f"b{i + 1}", _bare(cin, out_ch, 3, dilation=r))
            self.add_module(f"b{i + 1}_bn", BatchNorm(out_ch))
        self.img_pool, self.img_pool_bn = _bare(cin, out_ch, 1), BatchNorm(out_ch)
        self.project = _bare(out_ch * (len(self.rates) + 2), out_ch, 1)
        self.project_bn = BatchNorm(out_ch)

    def _branch(self, name: str, x, train: bool):
        bn = getattr(self, f"{name}_bn")
        return F.relu(bn(_same(getattr(self, name), x, self.dtype), train))

    def forward(self, x, train: bool = False):
        branches = [self._branch(f"b{i}", x, train) for i in range(len(self.rates) + 1)]
        pool = self._branch("img_pool", x.mean((2, 3), keepdim=True), train)
        branches.append(pool.expand_as(branches[0]))
        return self._branch("project", torch.cat(branches, 1), train)


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype):
    """[n_out, n_in]: row i weighs the two inputs around the half-pixel
    centre (i + 0.5) * n_in / n_out - 0.5, clamped to the edge."""
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5).clamp(min=0)
    lo = src.floor().long().clamp(max=n_in - 1)
    hi = (lo + 1).clamp(max=n_in - 1)
    frac = src - lo
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    rows = torch.arange(n_out)
    m.index_put_((rows, lo), 1 - frac, accumulate=True)
    m.index_put_((rows, hi), frac, accumulate=True)
    return m.to(device=device, dtype=dtype)


def _resize(x, hw):
    """NCHW ``x`` resized bilinearly to ``hw``: ``jax.image.resize``'s
    bilinear upsampling (``F.interpolate(..., align_corners=False)``'s
    weights), as two products with interpolation matrices, as JAX lowers
    it: their backward is two products too, deterministic on the card,
    where ``F.interpolate``'s backward adds with atomics."""
    (h, w), (ho, wo) = x.shape[2:], tuple(hw)
    if (h, w) == (ho, wo):
        return x
    rows = _bilinear_matrix(h, ho, x.device, x.dtype)
    cols = _bilinear_matrix(w, wo, x.device, x.dtype)
    return torch.matmul(torch.matmul(rows, x), cols.T)


class DeepLabV3Plus(nn.Module):
    """Compact DeepLabV3+ (encoder output stride 16, decoder skip at
    stride 4): per-pixel float32 logits at the input's size [b, h, w, C]."""

    def __init__(self, output_dim: int = 21, width: int = 32, dtype="float32",
                 in_channels: int = 3):
        super().__init__()
        w = width
        self.output_dim, self.width = output_dim, width
        self.dtype = dt = compute_dtype(dtype)
        self.stem, self.stem_bn = _bare(in_channels, w, 3, 2), BatchNorm(w)
        # stage 1: stride 4, the decoder's low-level source; stages 2-3:
        # stride 16, the last atrous
        self.stage1a = _SepConv(w, 2 * w, stride=2, dtype=dt)
        self.stage1b = _SepConv(2 * w, 2 * w, dtype=dt)
        self.stage2a = _SepConv(2 * w, 4 * w, stride=2, dtype=dt)
        self.stage2b = _SepConv(4 * w, 4 * w, dtype=dt)
        self.stage3a = _SepConv(4 * w, 8 * w, stride=2, dtype=dt)
        self.stage3b = _SepConv(8 * w, 8 * w, dilation=2, dtype=dt)
        self.aspp = _ASPP(8 * w, 4 * w, dtype=dt)
        self.ll_reduce, self.ll_bn = _bare(2 * w, w, 1), BatchNorm(w)
        self.dec1 = _SepConv(5 * w, 4 * w, dtype=dt)
        self.dec2 = _SepConv(4 * w, 4 * w, dtype=dt)
        self.classifier = nn.Conv2d(4 * w, output_dim, 1)

    def forward(self, x, train: bool = False, generator=None):
        cd = self.dtype
        in_hw = x.shape[1:3]
        h = F.relu(self.stem_bn(_same(self.stem, x.permute(0, 3, 1, 2), cd), train))
        h = self.stage1b(self.stage1a(h, train), train)
        low_level = h
        h = self.stage2b(self.stage2a(h, train), train)
        h = self.stage3b(self.stage3a(h, train), train)
        h = self.aspp(h, train)
        # the decoder: upsample x4 in the compute dtype, concat the reduced
        # low-level features, refine
        h = _resize(h.to(cd), low_level.shape[2:])
        ll = F.relu(self.ll_bn(_same(self.ll_reduce, low_level, cd), train))
        h = torch.cat([h, ll.to(h.dtype)], 1)
        h = self.dec2(self.dec1(h, train), train)
        h = conv2d(self.classifier, h, cd)
        return _resize(h, in_hw).float().permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (k, k), (s, s))`` with its default
    ``padding="SAME"`` and bias. ``weight`` is flax's kernel in a conv's
    [out, in, kh, kw] layout: the kernel the layer correlates with the
    zero-inserted input."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, cd):
        k, s = self.kernel, self.stride
        # lax.conv_transpose's "SAME" padding of the dilated input
        total = k + s - 2
        before = k - 1 if s > k - 1 else -(-total // 2)
        after = total - before
        # F.conv_transpose2d pads k - 1 - padding a side and flips the kernel
        extra = max(after - before, 0)
        y = F.conv_transpose2d(x.to(cd), self.weight.to(cd).transpose(0, 1).flip(2, 3),
                               None, s, k - 1 - before, extra)
        n_out = [(n - 1) * s + 1 + total - k + 1 for n in x.shape[2:]]
        return y[:, :, :n_out[0], :n_out[1]] + self.bias.to(cd)[:, None, None]


class SimpleFCN(nn.Module):
    """The small FCN of the JAX package's segmentation tests: two stride-2
    3x3 convs, one more, two stride-2 transposed convs; logits [b, h, w,
    C] in the compute dtype."""

    def __init__(self, output_dim: int = 21, width: int = 32, dtype="float32",
                 in_channels: int = 3):
        super().__init__()
        w = width
        self.output_dim, self.width = output_dim, width
        self.dtype = compute_dtype(dtype)
        self.enc1 = nn.Conv2d(in_channels, w, 3, 2, 1)
        self.enc2 = nn.Conv2d(w, 2 * w, 3, 2, 1)
        self.mid = nn.Conv2d(2 * w, 2 * w, 3, 1, 1)
        self.dec1 = ConvTranspose(2 * w, w, 3, 2)
        self.dec2 = ConvTranspose(w, output_dim, 3, 2)

    def forward(self, x, train: bool = False, generator=None):
        cd = self.dtype
        x = F.relu(conv2d(self.enc1, x.permute(0, 3, 1, 2), cd))
        x = F.relu(conv2d(self.enc2, x, cd))
        x = F.relu(conv2d(self.mid, x, cd))
        x = F.relu(self.dec1(x, cd))
        return self.dec2(x, cd).permute(0, 2, 3, 1)
