"""Multi-process parallelism: the process-group mesh, the clients-sharded
round and the multi-process control plane (PyTorch form of
``fedml_tpu/parallel/``).

The JAX package's "cluster" is a ``jax.sharding.Mesh`` and the server's
weighted average an XLA collective; the port's is a ``torch.distributed``
process group, one process a rank, with the average an ``all_reduce``.
Ported: ``mesh.py``, ``sharded.py`` and ``multihost.py``. The hierarchical,
gossip, sequence and tensor-parallel modules are ROADMAP.md Queue 1 items
2.3-2.6.
"""

from fedml_tpu_torch.parallel.mesh import Mesh, all_reduce_tree, make_mesh  # noqa: F401
from fedml_tpu_torch.parallel.sharded import (  # noqa: F401
    build_sharded_buffer_fns,
    build_sharded_round_fn,
)
