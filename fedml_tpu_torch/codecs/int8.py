"""int8 update codec: a per-leaf scale and error-feedback residuals (PyTorch
form of ``fedml_tpu/codecs/int8.py``).

``encode`` adds the carried residual to the update, quantizes each leaf of
each client row to ``bits`` signed levels stored as int8, and returns the
exact quantization error as the new residual, so that

    decode(payload) + new_residual == update + old_residual     (bitwise)

holds leaf by leaf in float32: the residual is ``t - decode(payload)`` of
the very same ``t``. Rounding is round half to even, as ``jnp.round``.
Leaves carry a leading client axis; amax is taken per row (over every
dimension but the first), in one pass per leaf.
"""

from __future__ import annotations

import torch


def _inexact(leaf: torch.Tensor) -> bool:
    return leaf.is_floating_point() or leaf.is_complex()


def _rows(t: torch.Tensor) -> tuple:
    """The shape that broadcasts a per-row [C] value over a [C, ...] leaf."""
    return (t.shape[0],) + (1,) * (t.dim() - 1)


class Int8Codec:
    """Quantize inexact leaves to int8 with a per-row, per-leaf scale."""

    kind = "int8"

    def __init__(self, bits=8, headroom=1):
        if not 2 <= int(bits) <= 8:
            raise ValueError("codec_bits must be in [2, 8], got %r" % (bits,))
        self.bits = int(bits)
        # range reserved so that `headroom` contributors could be summed in
        # int8 on a wire (the sharded transport, not ported)
        self.headroom = max(1, int(headroom))
        self.levels = max(1, (2 ** (self.bits - 1) - 1) // self.headroom)
        self.name = "int8" if self.bits == 8 else "int%d" % self.bits

    def init_state(self, tree: dict) -> dict:
        """Zero residuals shaped like one update (a 0-d zero for a leaf
        that is not inexact)."""
        return {k: torch.zeros_like(v) if _inexact(v)
                else torch.zeros((), dtype=v.dtype, device=v.device)
                for k, v in tree.items()}

    def _encode_leaf(self, leaf, resid):
        t = leaf + resid
        amax = t.abs().reshape(t.shape[0], -1).amax(1)
        # t / scale stays a division (a multiply by the reciprocal rounds
        # differently), and the clip comes before the int8 cast
        scale = torch.where(amax > 0, amax / self.levels,
                            torch.ones((), dtype=t.dtype, device=t.device))
        s = scale.reshape(_rows(t))
        q = torch.clamp(torch.round(t / s), -self.levels, self.levels).to(torch.int8)
        return q, scale, t - q.to(t.dtype) * s

    def encode(self, tree: dict, residual: dict) -> tuple:
        """(payload {"q", "scale"}, new residual) of client-stacked leaves;
        a leaf that is not inexact passes through with a zero float32
        scale per row."""
        qs, scales, resids = {}, {}, {}
        for k, leaf in tree.items():
            if _inexact(leaf):
                qs[k], scales[k], resids[k] = self._encode_leaf(leaf, residual[k])
            else:
                qs[k], resids[k] = leaf, residual[k]
                scales[k] = torch.zeros(leaf.shape[0], dtype=torch.float32,
                                        device=leaf.device)
        return {"q": qs, "scale": scales}, resids

    def decode(self, payload: dict, like=None) -> dict:
        out = {}
        for k, q in payload["q"].items():
            s = payload["scale"][k]
            if q.dtype == torch.int8:
                out[k] = q.to(s.dtype) * s.reshape(_rows(q))
            else:
                out[k] = q
        return out

    def wire_bytes(self, tree: dict) -> int:
        """Wire bytes of one update: 1 a quantized element and a 4-byte
        scale a leaf; a leaf that is not inexact at its own width."""
        total = 0
        for leaf in tree.values():
            if _inexact(leaf):
                total += leaf.numel() + 4
            else:
                total += leaf.numel() * leaf.element_size()
        return total
