"""The multi-tenant federated serving plane (PyTorch form of
``fedml_tpu/serving``).

One card, N concurrent tenant jobs (different models, algorithms,
aggregators, buffer configs) multiplexed by a deterministic scheduler. A job
is declared (``JobDescriptor``), built into a runtime (``Job``) whose round
is a schedulable unit, and dispatched by a ``Scheduler`` whose policies
(round-robin, deficit-weighted fair share) are seeded and repeat bit for
bit: each tenant's final parameters are its solo run's, however the tenants
interleave.
"""

from fedml_tpu_torch.serving.evict_store import EvictionStore  # noqa: F401
from fedml_tpu_torch.serving.job import Job, JobDescriptor, params_equal  # noqa: F401
from fedml_tpu_torch.serving.scheduler import JobQueue, Scheduler  # noqa: F401
