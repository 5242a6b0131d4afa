"""Transformer LM for federated next-word prediction, PyTorch form of
``fedml_tpu/models/transformer.py``.

Pre-norm blocks, learned positional embeddings, per-position logits (the
NWP trainer's layout). Attention goes through the flash kernels
(ops/attention.py): causal, any T up to ``max_len`` with one tile shape.

Module names are flax's (``tok_emb``, ``pos_emb``, ``block{i}.{ln1, qkv,
proj, ln2, mlp_up, mlp_down}``, ``ln_f``, ``lm_head``), so the converter
maps the two parameter trees one to one.

Numerics as in flax: LayerNorm with epsilon 1e-6, its statistics and
affine map in float32 and the result cast to the compute dtype; GELU is
the tanh approximation (flax's ``nn.gelu`` default); Dense layers cast
inputs, weights and bias to the compute dtype; the embeddings are read in
the compute dtype; the logits come out in the compute dtype. Parameters
stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.cnn import compute_dtype, embed
from fedml_tpu_torch.ops.attention import flash_attention

LN_EPS = 1e-6  # flax's LayerNorm default


def _layer_norm(layer: nn.LayerNorm, x, cd):
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias,
                        LN_EPS).to(cd)


def _dense(layer: nn.Linear, x, cd):
    bias = None if layer.bias is None else layer.bias.to(cd)
    return F.linear(x.to(cd), layer.weight.to(cd), bias)


class _Block(nn.Module):
    def __init__(self, d_model: int, heads: int, mlp_ratio: int = 4, dtype=torch.float32):
        super().__init__()
        if d_model % heads:
            raise ValueError(f"d_model {d_model} is not a multiple of heads {heads}")
        self.heads, self.dtype = heads, dtype
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.qkv = nn.Linear(d_model, 3 * d_model, bias=False)
        self.proj = nn.Linear(d_model, d_model, bias=False)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp_up = nn.Linear(d_model, mlp_ratio * d_model)
        self.mlp_down = nn.Linear(mlp_ratio * d_model, d_model)

    def forward(self, x):
        b, t, dm = x.shape
        cd = self.dtype
        h = _layer_norm(self.ln1, x, cd)
        # flax's split: q is the first dm output columns, head i at i*hd
        q, k, v = _dense(self.qkv, h, cd).reshape(b, t, 3 * self.heads, dm // self.heads
                                                   ).split(self.heads, dim=2)
        attn = flash_attention(q, k, v, True)
        x = x + _dense(self.proj, attn.reshape(b, t, dm), cd)
        h = _layer_norm(self.ln2, x, cd)
        h = F.gelu(_dense(self.mlp_up, h, cd), approximate="tanh")
        return x + _dense(self.mlp_down, h, cd)


class TransformerLM(nn.Module):
    """tokens [B, T] int -> logits [B, T, vocab] in the compute dtype."""

    def __init__(self, vocab_size: int = 10004, d_model: int = 128, heads: int = 4,
                 num_layers: int = 2, max_len: int = 512, dtype="float32"):
        super().__init__()
        self.vocab_size, self.max_len = vocab_size, max_len
        self.dtype = compute_dtype(dtype)
        self.tok_emb = nn.Embedding(vocab_size, d_model)
        self.pos_emb = nn.Embedding(max_len, d_model)
        for i in range(num_layers):
            self.add_module(f"block{i}", _Block(d_model, heads, dtype=self.dtype))
        self.num_layers = num_layers
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self.lm_head = nn.Linear(d_model, vocab_size, bias=False)

    def forward(self, tokens, train: bool = False, generator=None):
        b, t = tokens.shape
        if t > self.max_len:
            # an embedding gather past max_len would fail or clamp
            raise ValueError(f"sequence length {t} exceeds max_len {self.max_len}; "
                             f"raise max_len")
        cd = self.dtype
        x = (embed(tokens, self.tok_emb.weight.to(cd))
             + self.pos_emb.weight[:t].to(cd)[None])
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x)
        return _dense(self.lm_head, _layer_norm(self.ln_f, x, cd), cd)
