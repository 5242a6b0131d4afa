"""The multi-process control plane (PyTorch form of
``fedml_tpu/parallel/multihost.py``): one process a rank over a
``torch.distributed`` process group, the mpirun replacement.

``init_multihost`` starts the group from a coordinator address, the world
size and the rank (``tcp://<coordinator>`` rendezvous, nothing read from a
cluster's environment). Control data (metrics, agreement checks, barriers)
moves through CPU collectives: the group itself under gloo, or a gloo side
group under nccl. The model average rides the sharded round's tensor
``all_reduce`` (``parallel/sharded.py``).

One process without a group keeps the JAX package's no-ops, so the same
script runs on one card and over many.

Sharded cohort sampling: a round's cohort is a pure function of the round
(``algorithms/fedavg.py::client_sampling``), so every rank derives the
whole cohort with no communication, pads it to ``block * world`` rows and
stages only its own contiguous block (``stage_local_cohort``); ``-1``
sentinels stage as zero-count clients, which take no step and weigh 0.
"""

from __future__ import annotations

import datetime
import logging
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from fedml_tpu_torch.parallel import mesh as _mesh

log = logging.getLogger(__name__)

# bounded by default: a peer that never comes up (or dies) must surface as
# an error in minutes, not hang the run (the reference's mpirun deployment
# hangs)
DEFAULT_INIT_TIMEOUT = 300

_CONTROL: list = [None]  # the gloo side group under an nccl group


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   initialization_timeout: float | None = None,
                   backend: str = "gloo") -> dict[str, Any]:
    """Initialize the process group (idempotent; a no-op without a
    ``coordinator_address``). Returns the topology.

    ``initialization_timeout`` (seconds, default ``DEFAULT_INIT_TIMEOUT``)
    bounds the wait for missing peers at startup, and every collective of
    the group after it: a dead rank then surfaces as a RuntimeError naming
    the coordinator, this rank and the world size. ``backend`` is the
    group's: ``gloo`` for CPU tensors or ranks that share a card, ``nccl``
    for one card a rank."""
    if coordinator_address is not None:
        if _mesh.group_initialized():
            log.info("torch.distributed already initialized — skipping")
        else:
            timeout = (DEFAULT_INIT_TIMEOUT if initialization_timeout is None
                       else initialization_timeout)
            try:
                dist.init_process_group(
                    backend, init_method=f"tcp://{coordinator_address}",
                    world_size=int(num_processes), rank=int(process_id),
                    timeout=datetime.timedelta(seconds=float(timeout)))
            except Exception as e:  # noqa: BLE001 — any rendezvous failure
                raise RuntimeError(
                    f"torch.distributed.init_process_group timed out or failed after "
                    f"{timeout}s (coordinator={coordinator_address}, "
                    f"process_id={process_id}, num_processes={num_processes}, "
                    f"backend={backend}): {e}. Check that every process slot is up and "
                    f"can reach the coordinator address, then relaunch.") from e
            _mesh._COORDINATOR[0] = coordinator_address
            _CONTROL[0] = None
            if backend != "gloo":
                # every rank runs this in the same order: new_group is a
                # collective
                _CONTROL[0] = dist.new_group(backend="gloo")
    return {
        "process_index": _mesh.rank(),
        "process_count": _mesh.world_size(),
        "backend": dist.get_backend() if _mesh.group_initialized() else None,
        "local_device_count": torch.cuda.device_count(),
    }


def _control_group():
    """The group control data moves on: a CPU (gloo) group."""
    if _CONTROL[0] is None and dist.get_backend() != "gloo":
        _CONTROL[0] = dist.new_group(backend="gloo")
    return _CONTROL[0]


def broadcast_from_server(value: Any) -> Any:
    """Rank 0's value on every rank (the reference's send_init_msg / sync
    broadcast, FedAvgServerManager.py:31-37)."""
    if _mesh.world_size() == 1:
        return value
    box = [value]
    with _mesh.peer_errors("broadcast_from_server"):
        dist.broadcast_object_list(box, src=0, group=_control_group())
    return box[0]


def _gather(value) -> list:
    out = [None] * _mesh.world_size()
    with _mesh.peer_errors("all_gather"):
        dist.all_gather_object(out, value, group=_control_group())
    return out


def allgather_metrics(local_metrics: dict[str, float]) -> dict[str, float]:
    """Scalar metrics summed across ranks, in rank order in float64 (the
    JAX package's process_allgather then sum)."""
    if _mesh.world_size() == 1:
        return dict(local_metrics)
    keys = sorted(local_metrics)
    vec = np.asarray([local_metrics[k] for k in keys], np.float64)
    summed = np.asarray(_gather(vec)).sum(axis=0)
    return {k: float(v) for k, v in zip(keys, summed)}


def assert_same_across_processes(value, name: str = "value") -> None:
    """Raise AssertionError unless ``value`` (an array, or a dict of
    tensors or arrays) has the same bytes on every rank."""
    if _mesh.world_size() == 1:
        return
    if isinstance(value, dict):
        value = {k: _host(v) for k, v in sorted(value.items())}
    else:
        value = _host(value)
    gathered = _gather(value)
    for r, other in enumerate(gathered[1:], 1):
        if not _same(gathered[0], other):
            raise AssertionError(f"{name} differs across processes (rank 0 vs rank {r})")


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes())


def round_barrier(name: str, round_idx: int) -> None:
    """Named sync point between rounds (replaces the implicit MPI ordering)."""
    if _mesh.world_size() == 1:
        return
    with _mesh.peer_errors(f"round_barrier {name}_{round_idx}"):
        dist.barrier(group=_control_group())


# --------------------------------------------------- sharded cohort sampling


@dataclass(frozen=True)
class ShardedCohort:
    """One round's cohort partitioned across ranks.

    ``full_idx`` is the seed-derived cohort, the same on every rank.
    ``padded_idx`` appends ``-1`` sentinels up to ``block * process_count``
    (``block`` rounded up to ``multiple``); sentinels stage as zero-count
    no-op clients."""

    round_idx: int
    full_idx: np.ndarray
    padded_idx: np.ndarray
    block: int
    process_index: int
    process_count: int

    @property
    def local_slice(self) -> slice:
        return slice(self.process_index * self.block,
                     (self.process_index + 1) * self.block)

    @property
    def local_idx(self) -> np.ndarray:
        """This rank's contiguous block of the padded cohort (-1 = pad)."""
        return self.padded_idx[self.local_slice]


def sample_sharded_cohort(round_idx: int, client_num_in_total: int,
                          client_num_per_round: int, multiple: int = 1,
                          process_index: int | None = None,
                          process_count: int | None = None,
                          sampler=None) -> ShardedCohort:
    """The round's cohort from the round seed, partitioned across ranks
    with no communication, bit for bit the JAX package's: the canonical
    ``client_sampling`` (or ``sampler``), padded to ``block *
    process_count`` where ``block = ceil(n / P)`` rounded up to
    ``multiple``. Topology defaults to the live group's."""
    from fedml_tpu_torch.algorithms.fedavg import client_sampling

    if sampler is None:
        sampler = client_sampling
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    pc = _mesh.world_size() if process_count is None else int(process_count)
    pi = _mesh.rank() if process_index is None else int(process_index)
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} out of range [0, {pc})")
    full_idx = np.asarray(sampler(round_idx, client_num_in_total, client_num_per_round),
                          np.int64)
    block = -(-len(full_idx) // pc)  # ceil(n / P)
    block = -(-block // multiple) * multiple  # ... up to the multiple
    padded_idx = np.full(block * pc, -1, np.int64)
    padded_idx[: len(full_idx)] = full_idx
    return ShardedCohort(round_idx=round_idx, full_idx=full_idx, padded_idx=padded_idx,
                         block=block, process_index=pi, process_count=pc)


def stage_local_cohort(store, cohort: ShardedCohort):
    """This rank's slice of the cohort from a PackedClients-like store
    (in RAM, streaming or mmap): ``select`` touches only the local real
    clients, and ``-1`` sentinels become zero-count rows. Returns host
    (x, y, counts)."""
    ids = cohort.local_idx
    real = ids[ids >= 0]
    x, y, counts = store.select(real)
    pad = len(ids) - len(real)
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
        counts = np.concatenate([counts, np.zeros(pad, counts.dtype)])
    return x, y, counts
