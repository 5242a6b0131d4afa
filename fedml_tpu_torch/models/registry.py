"""Model registry (mirror of ``fedml_tpu/models/registry.py::create_model``).

Ported so far: the FedAvg flagship's ``cnn`` (CNN_DropOut) and the NWP
``transformer_nwp`` (TransformerLM); the rest of the zoo is listed in
ROADMAP.md Queue 1."""

from __future__ import annotations

from fedml_tpu_torch.models.cnn import CNN_DropOut
from fedml_tpu_torch.models.transformer import TransformerLM


def create_model(model_name: str, output_dim: int, dtype="float32", **kwargs):
    """Build a module by reference model name. ``dtype`` is the compute
    dtype ("float32" or "bfloat16"); parameters stay float32."""
    if model_name == "cnn":
        return CNN_DropOut(output_dim=output_dim, dtype=dtype, **kwargs)
    if model_name == "transformer_nwp":
        # models/zoo.py::_transformer_nwp's defaults
        return TransformerLM(vocab_size=kwargs.get("vocab_size", output_dim),
                             d_model=kwargs.get("d_model", 128),
                             heads=kwargs.get("heads", 4),
                             num_layers=kwargs.get("num_layers", 2),
                             max_len=kwargs.get("max_len", 512), dtype=dtype)
    raise NotImplementedError(
        f"model {model_name!r} is not ported to fedml_tpu_torch yet "
        f"(ported: 'cnn', 'transformer_nwp')")
