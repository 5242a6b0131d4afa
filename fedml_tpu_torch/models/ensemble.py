"""AdaptiveCNN and the heterogeneous branch architectures of the fork's
ensembles, PyTorch form of ``fedml_tpu/models/ensemble.py`` (reference
fedml_api/model/ensemble/cnn.py:15-310).

A CNN_DropOut-shaped base whose blocks (conv1 / conv2 / linear1 / linear2)
can each be deepened or widened per branch. Every variant keeps its
block's *output* width, so same-architecture blocks can be averaged across
branches while hetero blocks differ inside.

An architecture is data (``ArchSpec``: each block's internal widths; () is
the base single-layer block). ``build_hetero_archs(n)`` returns n specs
cycling the reference's widen (+16 channels) and deepen (one more layer)
variants.

The layers carry flax's module names as attribute names (``conv1_0``,
``conv1_out``, ...), so the block of a parameter is its key's prefix and
``utils/convert.py`` carries weights across. Input is NHWC as in the JAX
package; the convolutions run channels-first and the activations return to
channels-last before the flatten, so ``linear1_*``'s rows are in flax's
(h, w, c) order. The dtype rule is ``models/cnn.py``'s; the logits stay in
the compute dtype, as the flax module's last Dense leaves them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.cnn import _dropout, compute_dtype, conv2d, dense


@dataclass(frozen=True)
class ArchSpec:
    conv1: tuple = ()    # internal conv widths before the fixed 32-ch output conv
    conv2: tuple = ()    # ... before the fixed 64-ch output conv
    linear1: tuple = ()  # internal dense widths before the fixed 128-d output

    def describe(self) -> str:
        return f"conv1{list(self.conv1)}--conv2{list(self.conv2)}--lin1{list(self.linear1)}"


CONV1_VARIANTS = ((), (16,), (32,), (48, 48))
CONV2_VARIANTS = ((), (48,), (64,), (80, 80))
LINEAR1_VARIANTS = ((), (512,))

#: the block outputs the joint trainer's feature matching reads, in
#: sorted-name order (flax's ``capture_intermediates`` order)
FEATURE_LAYERS = ("conv1_out", "conv2_out", "linear1_out")


def build_hetero_archs(num_branch: int) -> list[ArchSpec]:
    """One ArchSpec per branch, cycling each block's variants (reference
    build_hetero_archs)."""
    return [
        ArchSpec(
            conv1=CONV1_VARIANTS[b % len(CONV1_VARIANTS)],
            conv2=CONV2_VARIANTS[(b // 2) % len(CONV2_VARIANTS)],
            linear1=LINEAR1_VARIANTS[b % len(LINEAR1_VARIANTS)],
        )
        for b in range(num_branch)
    ]


class AdaptiveCNN(nn.Module):
    """conv1 block -> conv2 block + 2x2 max-pool -> dropout .25 -> linear1
    block -> dropout .5 -> linear2 (reference AdaptiveCNN.forward,
    cnn.py:68-110). Internal convs are 3x3 with padding 1, the block
    output convs 3x3 VALID; every layer but the last is followed by a ReLU.
    ``input_hw`` and ``in_channels`` are the input's side and channels
    (flax infers them at init)."""

    def __init__(self, output_dim: int = 10, arch: ArchSpec | None = None,
                 dtype="float32", input_hw: int = 28, in_channels: int = 1):
        super().__init__()
        self.output_dim = output_dim
        self.arch = arch or ArchSpec()
        self.dtype = compute_dtype(dtype)
        convs, linears = [], []

        def add(group, name, layer):
            setattr(self, name, layer)
            group.append(name)

        c = in_channels
        for i, w in enumerate(self.arch.conv1):
            add(convs, f"conv1_{i}", nn.Conv2d(c, w, 3, padding=1))
            c = w
        add(convs, "conv1_out", nn.Conv2d(c, 32, 3))
        c = 32
        for i, w in enumerate(self.arch.conv2):
            add(convs, f"conv2_{i}", nn.Conv2d(c, w, 3, padding=1))
            c = w
        add(convs, "conv2_out", nn.Conv2d(c, 64, 3))
        pooled = (input_hw - 4) // 2
        d = pooled * pooled * 64
        for i, w in enumerate(self.arch.linear1):
            add(linears, f"linear1_{i}", nn.Linear(d, w))
            d = w
        add(linears, "linear1_out", nn.Linear(d, 128))
        self.linear2_out = nn.Linear(128, output_dim)
        self._convs, self._linears = tuple(convs), tuple(linears)

    def forward(self, x, train: bool = False, generator=None, features: bool = False):
        """Logits; with ``features`` also the pre-ReLU outputs of
        ``FEATURE_LAYERS`` (what flax's ``capture_intermediates`` records of
        those modules), conv outputs channels-last."""
        cd = self.dtype
        feats = []
        x = x.to(cd).permute(0, 3, 1, 2)
        for name in self._convs:
            out = conv2d(getattr(self, name), x, cd)
            if features and name in FEATURE_LAYERS:
                feats.append(out.permute(0, 2, 3, 1))
            x = F.relu(out)
        x = F.max_pool2d(x, 2)
        if train:
            x = _dropout(x, 0.25, generator)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's channels-last flatten
        for name in self._linears:
            out = dense(getattr(self, name), x, cd)
            if features and name in FEATURE_LAYERS:
                feats.append(out)
            x = F.relu(out)
        if train:
            x = _dropout(x, 0.5, generator)
        logits = dense(self.linear2_out, x, cd)
        return (logits, feats) if features else logits
