"""The silo-grouped convolution, PyTorch form of
``fedml_tpu/ops/silo_conv.py``.

A cross-silo CIFAR ResNet runs 16-64 channel stages. Trained one silo at a
time, each of its convolutions is a narrow launch of its own. Stacked over
the round's S silos, the convolutions whose channels are narrow merge into
ONE ``F.conv2d(groups=S)`` with the silos' channel blocks side by side:
group g is silo g, so the result is each silo's convolution exactly as
math, in one launch. Wide convolutions (``min(cin, cout) > threshold``)
take the per-silo path: one ``F.conv2d`` a silo, the blocks concatenated.

Layouts (NCHW activations, OIHW kernels, as the port's models hold them):

- one model: ``x`` [B, C, H, W], ``w`` [O, C, kh, kw]: ``F.conv2d``'s
  bits, whatever the threshold (the eval paths);
- silo-stacked: ``x`` [S, B, C, H, W], ``w`` [S, O, C, kh, kw] ->
  [S, B, O, H', W'] (``silo_conv``);
- packed, the layout the silo-stacked ResNets keep between layers:
  ``x`` [B, S*C, H, W] with silo s's channels at [s*C, (s+1)*C), ``w``
  [S, O, C, kh, kw] -> [B, S*O, H', W'] (``packed_silo_conv``). A
  per-channel BatchNorm over it is each silo's own BatchNorm.

The JAX package decides grouped or not inside a ``custom_vmap`` batching
rule. The port needs no rule: the silo-stacked model calls
``packed_silo_conv`` itself, so the "else" branch is the explicit per-silo
loop and the threshold chooses between two launch shapes on the card.

This is not a hand kernel and counts no launches: like the JAX package's
``lax.conv`` it runs the library's convolution (cuDNN on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def packed_silo_conv(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
                     threshold: int = 32) -> torch.Tensor:
    """The silos' convolutions on the packed layout: ``x`` [B, S*C, H, W],
    ``w`` [S, O, C, kh, kw] -> [B, S*O, H', W']. One grouped
    ``F.conv2d(groups=S)`` when min(C, O) <= ``threshold``, else one
    ``F.conv2d`` a silo."""
    s, cout, cin = w.shape[:3]
    if min(cin, cout) <= threshold:
        return F.conv2d(x, w.reshape((s * cout,) + tuple(w.shape[2:])), None, stride,
                        padding, 1, s)
    return torch.cat([F.conv2d(xs, ws, None, stride, padding)
                      for xs, ws in zip(x.split(cin, 1), w.unbind(0))], 1)


def silo_conv(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
              threshold: int = 32) -> torch.Tensor:
    """A bias-free convolution of one model (``x`` [B, C, H, W], ``w``
    [O, C, kh, kw]: ``F.conv2d`` exactly) or of S silos at once (``x``
    [S, B, C, H, W], ``w`` [S, O, C, kh, kw] -> [S, B, O, H', W'], through
    ``packed_silo_conv``)."""
    if w.dim() == 4:
        return F.conv2d(x, w, None, stride, padding)
    s, b = x.shape[:2]
    packed = x.transpose(0, 1).reshape((b, -1) + tuple(x.shape[3:]))
    out = packed_silo_conv(packed, w, stride, padding, threshold)
    return out.reshape((b, s, -1) + tuple(out.shape[2:])).transpose(0, 1)


class GroupableConv(nn.Conv2d):
    """The bias-free ``nn.Conv2d`` drop-in with the silo-grouped lowering:
    its ``weight`` has ``nn.Conv2d``'s name, shape and initializer, so a
    variables dict of a model built with it is the plain model's, and
    ``utils/convert.py`` maps both alike. Called on one model's tensors it
    is ``F.conv2d``; on silo-stacked ones (a weight [S, O, C, kh, kw]
    substituted by ``functional_call``) it is ``silo_conv``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 threshold: int = 32):
        super().__init__(cin, cout, k, stride, padding, bias=False)
        self.threshold = threshold

    def forward(self, x):
        return silo_conv(x, self.weight, self.stride, self.padding, self.threshold)
