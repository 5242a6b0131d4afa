"""VGG for CIFAR, PyTorch form of ``fedml_tpu/models/vgg.py`` (reference
fedml_api/model/cv/vgg.py:6-38): 3x3 convolutions with bias, each followed
by a flax-style BatchNorm (momentum 0.9, ``resnet.BatchNorm``) and a ReLU,
with 2x2 max-pools at the ``M`` entries, then a dense ``classifier`` on the
flattened map.

Inputs are NHWC, as in the JAX package; the map is flattened channels-last
(flax's order), so the classifier's rows line up with the converted
weights. Module names are flax's (``conv{i}``, ``bn{i}``, ``classifier``,
``i`` the entry's index in ``CFG``). dtype rule as the ResNets': convolutions
and the classifier in the compute dtype, normalisation in float32, logits
in the compute dtype.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.cnn import compute_dtype, conv2d, dense
from fedml_tpu_torch.models.resnet import BatchNorm

CFG = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
              512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    """``variant`` of ``CFG`` on NHWC inputs of side ``input_hw`` with
    ``in_channels`` channels."""

    def __init__(self, variant: str = "vgg11", output_dim: int = 10, dtype="float32",
                 input_hw: int = 32, in_channels: int = 3):
        super().__init__()
        self.variant = variant
        self.dtype = compute_dtype(dtype)
        cin, side = in_channels, input_hw
        for i, v in enumerate(CFG[variant]):
            if v == "M":
                side //= 2
            else:
                self.add_module(f"conv{i}", nn.Conv2d(cin, v, 3, padding=1))
                self.add_module(f"bn{i}", BatchNorm(v))
                cin = v
        self.classifier = nn.Linear(side * side * cin, output_dim)

    def forward(self, x, train: bool = False, generator=None):
        cd = self.dtype
        x = x.permute(0, 3, 1, 2)
        for i, v in enumerate(CFG[self.variant]):
            if v == "M":
                x = F.max_pool2d(x, 2)
            else:
                x = F.relu(getattr(self, f"bn{i}")(conv2d(getattr(self, f"conv{i}"), x, cd),
                                                   train))
        x = x.permute(0, 2, 3, 1).flatten(1)
        return dense(self.classifier, x, cd)
