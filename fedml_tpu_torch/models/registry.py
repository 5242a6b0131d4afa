"""Model registry (mirror of ``fedml_tpu/models/registry.py::create_model``).

Only the FedAvg flagship's ``cnn`` (CNN_DropOut) is ported so far; the rest
of the zoo is listed in ROADMAP.md Queue 1."""

from __future__ import annotations

from fedml_tpu_torch.models.cnn import CNN_DropOut


def create_model(model_name: str, output_dim: int, dtype="float32", **kwargs):
    """Build a module by reference model name. ``dtype`` is the compute
    dtype ("float32" or "bfloat16"); parameters stay float32."""
    if model_name == "cnn":
        return CNN_DropOut(output_dim=output_dim, dtype=dtype, **kwargs)
    raise NotImplementedError(
        f"model {model_name!r} is not ported to fedml_tpu_torch yet "
        f"(ported: 'cnn')")
