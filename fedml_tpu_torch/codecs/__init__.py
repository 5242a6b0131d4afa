"""Compressed update transport (PyTorch form of ``fedml_tpu/codecs``).

A codec sits between the client step and the aggregator and shrinks the
bytes an update puts on the wire:

- ``int8``: deterministic int8 quantization with a per-leaf scale and
  error-feedback residuals (round half to even; the carried residual
  removes the bias a stochastic rounder would otherwise be needed for);
- ``topk``: top-k sparsification with static-shape ``(values, idx)``
  payloads and error feedback.

Codecs are built through ``make_codec``. ``make_codec("none")`` returns
None, and every seam treats ``codec=None`` as the round without a codec,
bit for bit.

Encode and decode take trees whose leaves carry a leading client axis
[C, ...] (the stacked cohort): each row is encoded on its own, in one
batched pass per leaf, as the JAX package's ``vmap(codec.encode)``.
"""

from fedml_tpu_torch.codecs.int8 import Int8Codec
from fedml_tpu_torch.codecs.topk import TopKCodec

CODECS = {
    "int8": Int8Codec,
    "topk": TopKCodec,
}


def make_codec(name, cfg=None):
    """Build an update codec by name; ``none``, empty or None turns the
    seam off. ``cfg`` is a FedConfig (``codec_k``, ``codec_bits``) or a
    dict with those keys."""
    if name is None or name in ("", "none"):
        return None
    if name not in CODECS:
        raise ValueError(
            "unknown update codec %r (have: %s)" % (name, sorted(CODECS)))

    def _get(key, default):
        if cfg is None:
            return default
        if isinstance(cfg, dict):
            return cfg.get(key, default)
        return getattr(cfg, key, default)

    if name == "int8":
        return Int8Codec(bits=int(_get("codec_bits", 8)))
    return TopKCodec(k=int(_get("codec_k", 64)))


__all__ = ["CODECS", "make_codec", "Int8Codec", "TopKCodec"]
