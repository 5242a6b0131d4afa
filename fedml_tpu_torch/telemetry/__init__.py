"""Structured telemetry for the drive loop (PyTorch form of
``fedml_tpu/telemetry``): the tracer and its module-level seam. Importing
the package loads no torch; ``records`` is imported by its users."""

from fedml_tpu_torch.telemetry.tracer import (  # noqa: F401
    EVENT_SCHEMAS,
    NULL_TRACER,
    NullTracer,
    Tracer,
    current_job,
    emit,
    gauge,
    get_tracer,
    install,
    job_scope,
    parse_profile_rounds,
    uninstall,
)
