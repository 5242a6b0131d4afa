"""Federated language LSTMs, PyTorch form of ``fedml_tpu/models/rnn.py``.

  RNN_OriginalFedAvg  Shakespeare next-char (reference nlp/rnn.py:4):
                      embed 90 -> 8, two LSTM layers of 256, fc to the
                      vocab; ``per_position=False`` keeps the last
                      position's logits (LEAF shakespeare), True every
                      position's (fed_shakespeare)
  RNN_StackOverFlow   StackOverflow NWP (reference rnn.py:39): embed the
                      extended vocab (10,000 + pad/bos/eos + oov) -> 96, one
                      LSTM of 670, fc 670 -> 96 -> vocab, per position

An LSTM layer is flax's ``nn.RNN(nn.OptimizedLSTMCell(...))``: the carry
starts at zeros, input kernels ``ii, if, ig, io`` carry no bias, hidden
kernels ``hi, hf, hg, ho`` do. The port stacks them in the gate order
i, f, g, o as ``weight_ih`` [4H, in], ``weight_hh`` [4H, H] and ``bias``
[4H] (the hidden kernels' bias) under flax's cell name
(``OptimizedLSTMCell_0``); ``utils/convert.py`` maps the two layouts.
flax's ``nn.Embed`` has no padding index: row 0 trains like any other.

The compute dtype picks the layer's route, on every device:

  - float32: the whole sequence in one ``torch._VF.lstm`` call (cuDNN on
    the card, the native kernel on the CPU), its input bias a zero
    constant so that only ``bias`` trains;
  - bfloat16: one step at a time in PyTorch ops (``_cell``), with flax's
    dtype promotion: the products and gates in bf16, the carry in float32
    (bf16 gates times a float32 cell promote to float32), which
    ``torch._VF.lstm`` cannot keep.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.cnn import compute_dtype, dense, embed, lecun_normal_


def orthogonal_(t: torch.Tensor, generator) -> None:
    """flax's ``initializers.orthogonal()`` law for a square [H, H] kernel:
    Q of the QR of a standard normal matrix, its columns' signs fixed by
    R's diagonal."""
    a = torch.randn(t.shape, generator=generator, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    t.copy_(q * torch.sign(torch.diagonal(r))[None])


class OptimizedLSTMCell(nn.Module):
    """One LSTM layer over [b, T, in] -> [b, T, H]."""

    def __init__(self, in_features: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.hidden, self.dtype = hidden, dtype
        # torch.nn.LSTM's init until a trainer draws flax's (flax_init_)
        bound = hidden ** -0.5
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_features).uniform_(-bound, bound))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def flax_init_(self, leaf: str, t: torch.Tensor, generator) -> None:
        """Each gate's kernel as flax draws it: lecun-normal input kernels,
        orthogonal hidden kernels, zero bias."""
        h = self.hidden
        for gate in range(4):
            block = t[gate * h:(gate + 1) * h]
            if leaf == "weight_ih":
                lecun_normal_(block, t.shape[1], generator)
            elif leaf == "weight_hh":
                orthogonal_(block, generator)

    def forward(self, x):
        return self._cudnn(x) if self.dtype == torch.float32 else self._cell(x)

    def _cell(self, x):
        cd = self.dtype
        b, t, _ = x.shape
        xi = F.linear(x.to(cd), self.weight_ih.to(cd))  # every step's input product
        w_hh, bias = self.weight_hh.to(cd), self.bias.to(cd)
        c = torch.zeros(b, self.hidden, dtype=torch.float32, device=x.device)
        h = torch.zeros_like(c)
        outs = []
        for step in range(t):
            gates = (F.linear(h.to(cd), w_hh) + bias) + xi[:, step]
            i, f, g, o = gates.chunk(4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, 1)

    def _cudnn(self, x):
        if self.dtype != torch.float32:
            raise ValueError("torch._VF.lstm runs the float32 LSTM only")
        b = x.shape[0]
        h0 = torch.zeros(1, b, self.hidden, dtype=torch.float32, device=x.device)
        weights = [self.weight_ih, self.weight_hh, torch.zeros_like(self.bias), self.bias]
        out, _, _ = torch._VF.lstm(x.float(), (h0, h0), weights, True, 1, 0.0,
                                   torch.is_grad_enabled(), False, True)
        return out


class RNN_OriginalFedAvg(nn.Module):
    """tokens [b, T] -> logits [b, vocab] (or [b, T, vocab] with
    ``per_position``) in the compute dtype."""

    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8, hidden_size: int = 256,
                 per_position: bool = False, dtype="float32"):
        super().__init__()
        self.per_position = per_position
        self.dtype = compute_dtype(dtype)
        self.embeddings = nn.Embedding(vocab_size, embedding_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(embedding_dim, hidden_size, self.dtype)
        self.OptimizedLSTMCell_1 = OptimizedLSTMCell(hidden_size, hidden_size, self.dtype)
        self.fc = nn.Linear(hidden_size, vocab_size)

    def forward(self, x, train: bool = False, generator=None):
        cd = self.dtype
        h = embed(x, self.embeddings.weight.to(cd))
        h = self.OptimizedLSTMCell_1(self.OptimizedLSTMCell_0(h))
        if not self.per_position:
            h = h[:, -1]
        return dense(self.fc, h, cd)


class RNN_StackOverFlow(nn.Module):
    """tokens [b, T] -> per-position logits [b, T, vocab + 4]."""

    def __init__(self, vocab_size: int = 10000, num_oov_buckets: int = 1,
                 embedding_size: int = 96, latent_size: int = 670, num_layers: int = 1,
                 dtype="float32"):
        super().__init__()
        extended = vocab_size + 3 + num_oov_buckets
        self.dtype = compute_dtype(dtype)
        self.num_layers = num_layers
        self.word_embeddings = nn.Embedding(extended, embedding_size)
        for i in range(num_layers):
            cin = embedding_size if i == 0 else latent_size
            self.add_module(f"OptimizedLSTMCell_{i}",
                            OptimizedLSTMCell(cin, latent_size, self.dtype))
        self.fc1 = nn.Linear(latent_size, embedding_size)
        self.fc2 = nn.Linear(embedding_size, extended)

    def forward(self, x, train: bool = False, generator=None):
        cd = self.dtype
        h = embed(x, self.word_embeddings.weight.to(cd))
        for i in range(self.num_layers):
            h = getattr(self, f"OptimizedLSTMCell_{i}")(h)
        return dense(self.fc2, dense(self.fc1, h, cd), cd)
