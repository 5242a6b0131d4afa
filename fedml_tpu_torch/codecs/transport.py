"""The codec stage of the synchronous round (PyTorch form of
``fedml_tpu/codecs/transport.py``'s ``slot_residual`` and
``CodecAggregator``, its ``sharded`` rule included).

``CodecAggregator`` wraps any aggregator with a per-client encode and
decode between the client step and the wrapped rule. The error-feedback
residual rides the aggregator state as ``{"agg": inner_state, "codec":
residual_rows}``, so checkpoints and the guard's snapshot carry it as they
carry FedOpt's moments. One residual row per cohort slot, as in the
reference: slot i's quantization error feeds slot i's next encode (a
slot-level approximation of per-client error feedback).

In the clients-sharded round (``parallel/sharded.py``) each rank holds the
residual rows of its own block of the padded cohort, so the ranks' blocks
together span the padded cohort (JAX ``fedavg.py:164-171``): the encode
and decode stay local and only the decoded rows' weighted sums cross the
ranks. The tensor-sharded wire transports (``transport_wsum``,
``masked_row_transport``) belong to ROADMAP.md Queue 1 item 2.6 and are not
ported.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.codecs.int8 import _inexact


def slot_residual(codec, tree: dict, slots: int) -> dict:
    """Per-slot residual state: zeros of (slots, *leaf.shape) for inexact
    leaves, (slots,) for the rest."""
    return {k: v.new_zeros((int(slots),) + tuple(v.shape))
            for k, v in codec.init_state(tree).items()}


class CodecAggregator:
    """Encode and decode per-client update deltas before the wrapped rule,
    carrying per-slot residuals in the extended state. Built by
    ``core.builder.wrap_codec``."""

    def __init__(self, codec, inner, slots):
        self.codec = codec
        self.inner = inner
        self.slots = int(slots)

    def init_state(self, global_variables) -> dict:
        return {"agg": self.inner.init_state(global_variables),
                "codec": slot_residual(self.codec, global_variables, self.slots)}

    def _stage(self, global_variables, result, weights, resid):
        """Per-row encode, wire, decode: (decoded result, new residual).
        Rows whose update is dead (weight 0) or not finite keep their old
        residual: garbage must not enter the carry."""
        from fedml_tpu_torch.algorithms.aggregators import client_finite_mask

        codec = self.codec
        deltas = {k: p - global_variables[k][None] if _inexact(p) else p
                  for k, p in result.variables.items()}
        payload, r_new = codec.encode(deltas, resid)
        decoded = codec.decode(payload, deltas)
        alive = (weights > 0) & client_finite_mask(result.variables)

        def keep(n, o):
            return torch.where(alive.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

        r_new = {k: keep(r_new[k], resid[k]) for k in r_new}
        dec_vars = {k: (global_variables[k][None] + decoded[k]).to(p.dtype)
                    if _inexact(p) else p
                    for k, p in result.variables.items()}
        return result._replace(variables=dec_vars), r_new

    def __call__(self, global_variables, result, weights, rng, state):
        dec_result, r_new = self._stage(global_variables, result, weights,
                                        state["codec"])
        new_global, new_inner = self.inner(global_variables, dec_result,
                                           weights, rng, state["agg"])
        return new_global, {"agg": new_inner, "codec": r_new}

    def sharded(self, global_variables, result, weights, rng, state, group=None):
        # the rows and their residual slots are this rank's block
        dec_result, r_new = self._stage(global_variables, result, weights,
                                        state["codec"])
        new_global, new_inner = self.inner.sharded(global_variables, dec_result,
                                                   weights, rng, state["agg"], group)
        return new_global, {"agg": new_inner, "codec": r_new}
