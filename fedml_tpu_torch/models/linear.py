"""Linear and MLP models, PyTorch form of ``fedml_tpu/models/linear.py``.

  LogisticRegression  reference linear/lr.py:4, raw logits (the
                      reference's sigmoid before the cross-entropy is left
                      out, as in the JAX package)
  DenseMLP            a tanh MLP, hidden (1024, 512, 256, 128)
  ReferenceMLP        relu(fc) -> dropout 0.5 per hidden layer, then a
                      linear head: PurchaseMLP (hidden (256,), input 600)
                      and TexasMLP ((1024, 512), input 6169), reference
                      dense_mlp.py:11,53

flax infers a Dense layer's input width from its first call; a PyTorch
layer needs it up front, so each model takes ``input_dim`` (the flattened
width of one sample). Layers run in the compute dtype (the product rounded,
then the bias added); the logits come out in it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.cnn import _dropout, compute_dtype, dense


class LogisticRegression(nn.Module):
    def __init__(self, input_dim: int = 784, output_dim: int = 10, flatten: bool = True,
                 dtype="float32"):
        super().__init__()
        self.flatten = flatten
        self.dtype = compute_dtype(dtype)
        self.linear = nn.Linear(input_dim, output_dim)

    def forward(self, x, train: bool = False, generator=None):
        if self.flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        return dense(self.linear, x, self.dtype)


class DenseMLP(nn.Module):
    def __init__(self, input_dim: int = 784, output_dim: int = 10,
                 hidden=(1024, 512, 256, 128), dtype="float32"):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.depth = len(hidden)
        for i, (cin, cout) in enumerate(zip((input_dim,) + tuple(hidden), hidden)):
            self.add_module(f"fc{i + 1}", nn.Linear(cin, cout))
        self.out = nn.Linear(hidden[-1], output_dim)

    def forward(self, x, train: bool = False, generator=None):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.depth):
            x = torch.tanh(dense(getattr(self, f"fc{i + 1}"), x, self.dtype))
        return dense(self.out, x, self.dtype)


class ReferenceMLP(nn.Module):
    def __init__(self, input_dim: int = 600, output_dim: int = 100, hidden=(256,),
                 dropout: float = 0.5, dtype="float32"):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.dropout = dropout
        self.depth = len(hidden)
        for i, (cin, cout) in enumerate(zip((input_dim,) + tuple(hidden), hidden)):
            self.add_module(f"fc{i + 1}", nn.Linear(cin, cout))
        self.out = nn.Linear(hidden[-1], output_dim)

    def forward(self, x, train: bool = False, generator=None):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.depth):
            x = F.relu(dense(getattr(self, f"fc{i + 1}"), x, self.dtype))
            if train and self.dropout:
                x = _dropout(x, self.dropout, generator)
        return dense(self.out, x, self.dtype)
