"""top-k update codec: static-shape sparse payloads and error feedback
(PyTorch form of ``fedml_tpu/codecs/topk.py``).

Each inexact leaf of each client row is flattened and its ``k``
largest-magnitude entries (k clamped to the leaf's size) become a
``(values [k], idx int32 [k])`` payload; the rest stays in the residual.
Ties at the k-th magnitude go to the lower index, as ``lax.top_k`` orders
them: a stable descending sort, whose first k entries are the selection.
``decode(payload) + new_residual == update + old_residual`` holds bitwise
(the residual is ``t`` with the selected entries zeroed).
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.codecs.int8 import _inexact


class TopKCodec:
    """Keep the k largest-magnitude entries per leaf; carry the rest."""

    kind = "topk"

    def __init__(self, k=64):
        if int(k) < 1:
            raise ValueError("codec_k must be >= 1, got %r" % (k,))
        self.k = int(k)
        self.name = "topk%d" % self.k

    def init_state(self, tree: dict) -> dict:
        return {k: torch.zeros_like(v) if _inexact(v)
                else torch.zeros((), dtype=v.dtype, device=v.device)
                for k, v in tree.items()}

    def leaf_k(self, numel: int) -> int:
        return min(self.k, int(numel))

    def _encode_leaf(self, leaf, resid):
        t = leaf + resid
        flat = t.reshape(t.shape[0], -1)
        k = self.leaf_k(flat.shape[1])
        order = torch.sort(flat.abs(), dim=1, descending=True, stable=True).indices
        idx = order[:, :k]
        values = torch.gather(flat, 1, idx)
        dec = torch.zeros_like(flat).scatter(1, idx, values)
        return values, idx.to(torch.int32), t - dec.reshape(t.shape)

    def encode(self, tree: dict, residual: dict) -> tuple:
        """(payload {"values", "idx"}, new residual) of client-stacked
        leaves; a leaf that is not inexact passes through with an empty
        index row."""
        vals, idxs, resids = {}, {}, {}
        for k, leaf in tree.items():
            if _inexact(leaf):
                vals[k], idxs[k], resids[k] = self._encode_leaf(leaf, residual[k])
            else:
                vals[k], resids[k] = leaf, residual[k]
                idxs[k] = torch.zeros((leaf.shape[0], 0), dtype=torch.int32,
                                      device=leaf.device)
        return {"values": vals, "idx": idxs}, resids

    def decode(self, payload: dict, like: dict) -> dict:
        """Scatter-add the payloads into zeros shaped like ``like``."""
        out = {}
        for k, ref in like.items():
            v = payload["values"][k]
            if not _inexact(ref):
                out[k] = v
                continue
            flat = torch.zeros((ref.shape[0], ref[0].numel()), dtype=ref.dtype,
                               device=ref.device)
            flat.scatter_add_(1, payload["idx"][k].long(), v.to(ref.dtype))
            out[k] = flat.reshape(ref.shape)
        return out

    def wire_bytes(self, tree: dict) -> int:
        """Wire bytes of one update: 8 (a float32 value and an int32 index)
        a kept entry."""
        total = 0
        for leaf in tree.values():
            if _inexact(leaf):
                total += 8 * self.leaf_k(leaf.numel())
            else:
                total += leaf.numel() * leaf.element_size()
        return total
