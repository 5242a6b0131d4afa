"""DARTS search space, PyTorch form of ``fedml_tpu/models/darts.py`` (the
FedNAS model; reference fedml_api/model/cv/darts/ operations.py OPS,
genotypes.py PRIMITIVES, model_search.py MixedOp/Cell/Network/genotype).

The architecture parameters (alphas) are inputs of ``forward``, not
parameters of the module, so the bi-level search holds them in an
optimizer state of their own (``algorithms/fednas.py``).

The search network's normalisation is affine-free batch standardization,
always from the batch's own statistics (in float32), in training and in
evaluation alike: every row of a batch, padding included, enters them.

Inputs are NHWC, as in the JAX package; the network moves channels first
once. Submodules carry flax's automatic names (``cell0.MixedOp_3.SepConv_1
.Conv_2``: each class counted in creation order inside its parent), so
``utils/convert.py::flax_to_torch(..., module=...)`` maps the JAX
package's variables one to one. In a cell after a reduction, s0 goes
through ``FactorizedReduce_0`` and s1 through ``ReLUConvBN_0``; otherwise
they take ``ReLUConvBN_0`` and ``ReLUConvBN_1``. A stride-2 ``MixedOp``
holds a ``FactorizedReduce_0`` (its skip) that a stride-1 one does not.

dtype rule (flax's): parameters stay float32; the convolutions and the
classifier run in the compute dtype, the standardization in float32 with
the result cast back, and the mix of a ``MixedOp`` in the compute dtype.
The 'none' op's zeros add nothing to the mix and are not computed.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.cnn import compute_dtype, dense

PRIMITIVES = (
    "none",
    "max_pool_3x3",
    "avg_pool_3x3",
    "skip_connect",
    "sep_conv_3x3",
    "sep_conv_5x5",
    "dil_conv_3x3",
    "dil_conv_5x5",
)

Genotype = namedtuple("Genotype", "normal normal_concat reduce reduce_concat")


def _bn(x):
    """Stateless affine-free batch standardization of NCHW ``x`` over (N, H,
    W), its statistics in float32 (biased variance, epsilon 1e-5); the
    result in ``x``'s dtype. ``torch.batch_norm`` is called directly: a map
    of one value a channel standardizes to 0, as in flax, where
    ``F.batch_norm`` refuses it."""
    y = torch.batch_norm(x.float(), None, None, None, None, True, 0.0, 1e-5,
                         torch.backends.cudnn.enabled)
    return y.to(x.dtype)


class _Depthwise(torch.autograd.Function):
    """A depthwise conv (``groups`` = channels) whose backward is written
    in differentiable ops: the input's gradient a grouped transposed conv,
    the weight's a product with the unfolded input when the backward
    itself is differentiated (``create_graph``: the unrolled search step),
    else PyTorch's own. Differentiating a grouped conv's native backward
    loops over the groups, one convolution a channel: on an H100, 12,732
    launches and 10.0 of the 11.2 busy seconds of an unrolled step at the
    search widths (``experiments/profile_nas.py``)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation)
        return F.conv2d(x, w, None, stride, padding, dilation, x.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation = ctx.conf
        c, k = x.shape[1], w.shape[-1]
        if not torch.is_grad_enabled():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [stride] * 2, [padding] * 2, [dilation] * 2, False, [0, 0], c,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
            return gx, gw, None, None, None
        gx = gw = None
        if ctx.needs_input_grad[0]:
            extent = dilation * (k - 1) + 1
            out_pad = [n + 2 * padding - extent - (m - 1) * stride
                       for n, m in zip(x.shape[2:], g.shape[2:])]
            gx = F.conv_transpose2d(g, w, None, stride, padding, out_pad, c, dilation)
        if ctx.needs_input_grad[1]:
            cols = F.unfold(x, k, dilation, padding, stride).view(x.shape[0], c, k * k, -1)
            gw = torch.einsum("bckl,bcl->ck", cols, g.reshape(g.shape[0], c, -1))
            gw = gw.reshape(w.shape)
        return gx, gw, None, None, None


def _conv(layer: nn.Conv2d, x, cd):
    """A bias-free flax Conv in the compute dtype ``cd``; a depthwise one
    through ``_Depthwise``."""
    x, w = x.to(cd), layer.weight.to(cd)
    if layer.groups > 1:
        return _Depthwise.apply(x, w, layer.stride[0], layer.padding[0], layer.dilation[0])
    return F.conv2d(x, w, None, layer.stride, layer.padding, layer.dilation)


def _bare(cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
          dilation: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding, dilation, groups, bias=False)


class ReLUConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.Conv_0 = _bare(cin, cout, kernel, stride, kernel // 2)

    def forward(self, x):
        return _bn(_conv(self.Conv_0, F.relu(x), self.dtype))


class FactorizedReduce(nn.Module):
    """Stride-2 reduce: two 1x1/2 convs, the second one pixel over,
    concatenated (reference operations.py FactorizedReduce). flax's
    ``"SAME"`` padding of a 1x1 kernel is none at any side."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.Conv_0 = _bare(cin, cout // 2, 1, 2)
        self.Conv_1 = _bare(cin, cout // 2, 1, 2)

    def forward(self, x):
        return self.body(F.relu(x))

    def body(self, r):
        """The op on an input already through its ReLU."""
        a = _conv(self.Conv_0, r, self.dtype)
        b = _conv(self.Conv_1, r[:, :, 1:, 1:], self.dtype)
        return _bn(torch.cat([a, b], 1))


class SepConv(nn.Module):
    """ReLU-sepconv-BN twice (reference SepConv)."""

    def __init__(self, c: int, cout: int, kernel: int, stride: int, dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        pad = kernel // 2
        self.Conv_0 = _bare(c, c, kernel, stride, pad, groups=c)
        self.Conv_1 = _bare(c, c, 1)
        self.Conv_2 = _bare(c, c, kernel, 1, pad, groups=c)
        self.Conv_3 = _bare(c, cout, 1)

    def forward(self, x):
        return self.body(F.relu(x))

    def body(self, r):
        cd = self.dtype
        x = _bn(_conv(self.Conv_1, _conv(self.Conv_0, r, cd), cd))
        x = _conv(self.Conv_2, F.relu(x), cd)
        return _bn(_conv(self.Conv_3, x, cd))


class DilConv(nn.Module):
    """ReLU-dilated-sepconv-BN (reference DilConv)."""

    def __init__(self, c: int, cout: int, kernel: int, stride: int, dilation: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        pad = (kernel - 1) * dilation // 2
        self.Conv_0 = _bare(c, c, kernel, stride, pad, dilation, groups=c)
        self.Conv_1 = _bare(c, cout, 1)

    def forward(self, x):
        return self.body(F.relu(x))

    def body(self, r):
        return _bn(_conv(self.Conv_1, _conv(self.Conv_0, r, self.dtype), self.dtype))


def _pool(x, kind: str, stride: int):
    """3x3 pooling, padding 1: max (the padding never wins) or average
    over the window's in-bounds values (count_include_pad=False)."""
    if kind == "max":
        return F.max_pool2d(x, 3, stride, 1)
    return F.avg_pool2d(x, 3, stride, 1, count_include_pad=False)


class MixedOp(nn.Module):
    """Weighted sum of the candidate ops (reference model_search.py:10-23;
    the pools get the affine-free standardization the reference appends).
    The ops that start with a ReLU share one."""

    def __init__(self, c: int, stride: int, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = compute_dtype(dtype)
        if stride != 1:
            self.FactorizedReduce_0 = FactorizedReduce(c, c, dtype)
        self.SepConv_0 = SepConv(c, c, 3, stride, dtype)
        self.SepConv_1 = SepConv(c, c, 5, stride, dtype)
        self.DilConv_0 = DilConv(c, c, 3, stride, 2, dtype)
        self.DilConv_1 = DilConv(c, c, 5, stride, 2, dtype)

    def forward(self, x, weights):
        s = self.stride
        r = F.relu(x)
        skip = x if s == 1 else self.FactorizedReduce_0.body(r)
        outs = [_bn(_pool(x, "max", s)), _bn(_pool(x, "avg", s)), skip,
                self.SepConv_0.body(r), self.SepConv_1.body(r),
                self.DilConv_0.body(r), self.DilConv_1.body(r)]
        stacked = torch.stack(outs)  # [ops - 1, b, c, h, w], 'none' left out
        return torch.tensordot(weights[1:].to(stacked.dtype), stacked, dims=1)


class Cell(nn.Module):
    """DARTS cell: 2 input nodes and ``steps`` intermediate nodes; the
    output is the channel concat of the last ``multiplier`` states
    (reference model_search.py:26-60)."""

    def __init__(self, c_pp: int, c_p: int, channels: int, reduction: bool,
                 reduction_prev: bool, steps: int = 4, multiplier: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.reduction, self.reduction_prev = reduction, reduction_prev
        self.steps, self.multiplier = steps, multiplier
        if reduction_prev:
            self.FactorizedReduce_0 = FactorizedReduce(c_pp, channels, dtype)
            self.ReLUConvBN_0 = ReLUConvBN(c_p, channels, dtype=dtype)
        else:
            self.ReLUConvBN_0 = ReLUConvBN(c_pp, channels, dtype=dtype)
            self.ReLUConvBN_1 = ReLUConvBN(c_p, channels, dtype=dtype)
        edge = 0
        for i in range(steps):
            for j in range(2 + i):
                self.add_module(f"MixedOp_{edge}",
                                MixedOp(channels, 2 if reduction and j < 2 else 1, dtype))
                edge += 1

    def forward(self, s0, s1, weights):
        if self.reduction_prev:
            s0, s1 = self.FactorizedReduce_0(s0), self.ReLUConvBN_0(s1)
        else:
            s0, s1 = self.ReLUConvBN_0(s0), self.ReLUConvBN_1(s1)
        states = [s0, s1]
        offset = 0
        for _ in range(self.steps):
            s = sum(getattr(self, f"MixedOp_{offset + j}")(h, weights[offset + j])
                    for j, h in enumerate(states))
            offset += len(states)
            states.append(s)
        return torch.cat(states[-self.multiplier:], 1)


class DARTSNetwork(nn.Module):
    """Search network (reference Network, model_search.py:172-240): stem,
    ``layers`` cells (reductions at 1/3 and 2/3), global average pool,
    classifier.

    ``forward(x, alphas_normal, alphas_reduce, weights_normal=None,
    weights_reduce=None)`` with alphas [k, |PRIMITIVES|], k =
    sum_{i<steps}(2+i) (14 at steps 4). Given mixing weights replace the
    alphas' softmax (GDAS passes straight-through gumbel samples); a 3-D
    [layers, k, ops] weight gives cell i its own row i. ``train`` and
    ``generator`` change nothing (the standardization always uses the
    batch's statistics); they let the port's trainers call it."""

    def __init__(self, output_dim: int = 10, channels: int = 16, layers: int = 8,
                 steps: int = 4, multiplier: int = 4, stem_multiplier: int = 3,
                 dtype="float32", in_channels: int = 3):
        super().__init__()
        self.output_dim, self.channels, self.layers = output_dim, channels, layers
        self.steps, self.multiplier = steps, multiplier
        self.dtype = compute_dtype(dtype)
        c_curr = stem_multiplier * channels
        self.stem = _bare(in_channels, c_curr, 3, 1, 1)
        c_pp, c_p, c_curr = c_curr, c_curr, channels
        reduction_prev = False
        for i in range(layers):
            reduction = i in (layers // 3, 2 * layers // 3)
            if reduction:
                c_curr *= 2
            self.add_module(f"cell{i}", Cell(c_pp, c_p, c_curr, reduction, reduction_prev,
                                             steps, multiplier, dtype))
            c_pp, c_p = c_p, multiplier * c_curr
            reduction_prev = reduction
        self.classifier = nn.Linear(c_p, output_dim)

    @property
    def num_edges(self) -> int:
        return sum(2 + i for i in range(self.steps))

    def forward(self, x, alphas_normal, alphas_reduce, weights_normal=None,
                weights_reduce=None, train: bool = False, generator=None):
        wn = weights_normal if weights_normal is not None else torch.softmax(alphas_normal, -1)
        wr = weights_reduce if weights_reduce is not None else torch.softmax(alphas_reduce, -1)
        cd = self.dtype
        s0 = s1 = _bn(_conv(self.stem, x.permute(0, 3, 1, 2).to(cd), cd))
        for i in range(self.layers):
            cell = getattr(self, f"cell{i}")
            w = wr if cell.reduction else wn
            if w.dim() == 3:
                w = w[i]
            s0, s1 = s1, cell(s0, s1, w)
        return dense(self.classifier, s1.mean((2, 3)), cd)


def gumbel_softmax_st(alphas, tau: float = 5.0, num: int | None = None,
                      generator: torch.Generator | None = None, uniform=None):
    """Hard straight-through gumbel-softmax over the primitive axis
    (``F.gumbel_softmax(alphas, tau, hard=True)`` semantics, reference
    model_search_gdas.py:127-129): the forward is the one-hot of the
    perturbed argmax, the gradient the soft sample's.

    ``num`` draws that many independent samples at once ([num, k, ops]),
    one a cell. The uniforms in [1e-10, 1) come from ``generator`` (on the
    CPU, then moved to ``alphas``' device), or are given as ``uniform``."""
    shape = tuple(alphas.shape) if num is None else (num,) + tuple(alphas.shape)
    if uniform is None:
        uniform = (torch.rand(shape, generator=generator) * (1.0 - 1e-10) + 1e-10)
    u = uniform.to(device=alphas.device, dtype=alphas.dtype)
    g = -torch.log(-torch.log(u + 1e-10))
    soft = torch.softmax((alphas + g) / tau, -1)
    hard = F.one_hot(soft.argmax(-1), alphas.shape[-1]).to(soft.dtype)
    return hard + soft - soft.detach()


def init_alphas(generator: torch.Generator, steps: int = 4, scale: float = 1e-3,
                device="cpu"):
    """(normal, reduce): 1e-3 * randn of [k, |PRIMITIVES|] each (reference
    _initialize_alphas, model_search.py:241)."""
    k = sum(2 + i for i in range(steps))
    return tuple((scale * torch.randn(k, len(PRIMITIVES), generator=generator)).to(device)
                 for _ in range(2))


def parse_genotype(alphas_normal, alphas_reduce, steps: int = 4, multiplier: int = 4):
    """argmax-over-alpha genotype (reference Network.genotype,
    model_search.py:268-306): for each node the 2 strongest input edges,
    each with its best op other than 'none'. numpy, on host copies."""

    def softmax(a):
        e = np.exp(a - a.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    none_idx = PRIMITIVES.index("none")

    def _parse(weights):
        gene, start, n = [], 0, 2
        for i in range(steps):
            W = weights[start:start + n]
            edges = sorted(
                range(n),
                key=lambda j: -max(W[j][k] for k in range(len(PRIMITIVES)) if k != none_idx),
            )[:2]
            for j in sorted(edges):
                k_best = max(
                    (k for k in range(len(PRIMITIVES)) if k != none_idx),
                    key=lambda k: W[j][k],
                )
                gene.append((PRIMITIVES[k_best], j))
            start += n
            n += 1
        return gene

    def host(a):
        return a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    concat = list(range(2 + steps - multiplier, steps + 2))
    return Genotype(
        normal=_parse(softmax(host(alphas_normal))), normal_concat=concat,
        reduce=_parse(softmax(host(alphas_reduce))), reduce_concat=concat,
    )
