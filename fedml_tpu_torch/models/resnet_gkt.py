"""GKT split ResNets, PyTorch form of ``fedml_tpu/models/resnet_gkt.py``
(reference fedml_api/model/cv/resnet56_gkt/): a small edge model that
returns (logits, feature maps) and a large server model over the feature
maps (resnet_client.py:250 / resnet_server.py:220: a ResNet-8 client and a
ResNet-55 server).

Inputs are NHWC, as in the JAX package; the client returns its features
channels-last ([b, h, w, 16]) and the server takes them so. Submodules
carry flax's names (``conv1``, ``_Norm_0``, ``BasicBlock_0``,
``Bottleneck_k``, ``fc``), so ``utils/convert.py::flax_to_torch(...,
module=...)`` maps the JAX variables, ``batch_stats`` included, one to one.
The blocks and the normalisation are ``models/resnet.py``'s.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.cnn import compute_dtype, dense
from fedml_tpu_torch.models.resnet import (BasicBlock, Bottleneck, _apply_conv, _conv,
                                           _norms, _stages)


class GKTClientResNet(nn.Module):
    """Edge model: a 3x3 stem and ``num_blocks`` 16-channel BasicBlocks;
    returns (logits, features [b, h, w, 16]). ``num_blocks`` 1 is the
    reference's ResNet-8 client."""

    def __init__(self, output_dim: int = 10, num_blocks: int = 1, in_channels: int = 3,
                 dtype="float32"):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.group_norm = 0
        self.conv1 = _conv(in_channels, 16, 3, 1, 1)
        _norms(self, [16])
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"BasicBlock_{i}", BasicBlock(16, 16, 1, 0, self.dtype))
        self.fc = nn.Linear(16, output_dim)

    def forward(self, x, train: bool = False, generator=None):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self._Norm_0(_apply_conv(self.conv1, x, self.dtype), train))
        for i in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x, train)
        logits = dense(self.fc, x.mean((2, 3)), self.dtype)
        return logits, x.permute(0, 2, 3, 1)


class GKTServerResNet(nn.Module):
    """Server model over the client's features: Bottleneck stages of
    ``layers`` blocks at 16/32/64 planes (the reference's ResNet-55, 56
    less the client's stage, at the default (5, 6, 6))."""

    def __init__(self, output_dim: int = 10, layers=(5, 6, 6), in_channels: int = 16,
                 dtype="float32"):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        cout = _stages(self, Bottleneck, in_channels, (16, 32, 64), layers, 0, self.dtype)
        self.fc = nn.Linear(cout, output_dim)

    def forward(self, features, train: bool = False, generator=None):
        x = features.permute(0, 3, 1, 2)
        for i in range(self.num_blocks):
            x = getattr(self, f"Bottleneck_{i}")(x, train)
        return dense(self.fc, x.mean((2, 3)), self.dtype)
