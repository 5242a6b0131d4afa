"""The process-group scaffold: the port's counterpart of
``fedml_tpu/parallel/mesh.py::make_mesh``.

The JAX package shards a round's clients over a ``jax.sharding.Mesh`` of
devices, in one program. The port runs one process a rank over an
initialized ``torch.distributed`` process group (``parallel/multihost.py::
init_multihost``): the 1-D ``clients`` axis is the group, a member is a
rank, and a ``psum`` over the axis is an ``all_reduce(SUM)`` over the group.

The backend is the group's, chosen by whoever initialized it; nothing here
switches it:

- ``gloo`` for CPU tensors, and for several ranks that share one card
  (gloo reduces CUDA tensors through the host);
- ``nccl`` for one card a rank (NCCL refuses two ranks on one device).

Gloo supports ``all_reduce`` and ``broadcast`` on CUDA tensors, so the
tensor collectives of a round use only these two (``all_reduce_tree``);
metrics and control data move through ``parallel/multihost.py``'s CPU
helpers.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

#: what the collectives of ``all_reduce_tree`` did in this process: calls,
#: bytes reduced and host seconds inside the calls (a gloo reduction of
#: CUDA tensors also waits there for the work queued before it)
COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0}

#: the coordinator address ``init_multihost`` was given (named in errors)
_COORDINATOR: list = [None]


def group_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The initialized process group's world size, or 1 without one."""
    return dist.get_world_size() if group_initialized() else 1


def rank() -> int:
    """This process's rank in the initialized group, or 0 without one."""
    return dist.get_rank() if group_initialized() else 0


@dataclass(frozen=True)
class Mesh:
    """The 1-D ``clients`` mesh over the ranks of the initialized process
    group: its ``world_size``, this process's ``rank``, the group's
    ``backend`` (None without a group), the rank's ``device`` and the
    ``group`` the round's collectives run over (None: the default group)."""

    world_size: int
    rank: int
    backend: str | None
    device: torch.device
    group: Any = None


def rank_device(device="cuda", backend: str | None = None, rank_: int = 0) -> torch.device:
    """The rank's device: a CPU device stays as it is, and so does a CUDA
    device with an index; ``cuda`` without one is card ``rank % cards``
    (every rank on card 0 of a one-card host). NCCL needs a card a rank:
    a CPU device under it raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend reduces CUDA tensors only: run the ranks "
                             "on cards, or initialize the group with gloo")
        return dev
    if dev.index is not None:
        return dev
    cards = torch.cuda.device_count()
    return torch.device("cuda", rank_ % cards if cards else 0)


def make_mesh(shape: tuple[int, ...] | None = None, device="cuda") -> Mesh:
    """The mesh of the initialized process group (a group of one without
    one). ``shape``, when given, must have the world size as its product:
    any shape flattens onto the 1-D ``clients`` axis, as the JAX
    ``FedAvgAPI`` flattens ``mesh_shape``."""
    world, r = world_size(), rank()
    if shape is not None and math.prod(shape) != world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {math.prod(shape)} ranks, the "
                         f"process group has {world}: launch one process a rank")
    backend = dist.get_backend() if group_initialized() else None
    return Mesh(world, r, backend, rank_device(device, backend, r))


@contextlib.contextmanager
def peer_errors(op: str):
    """Rewrap a failed collective as a RuntimeError naming the
    coordinator, this rank and the world size: a peer that died surfaces
    as an error an operator can act on, not a hang or a bare transport
    message. The original error rides along as ``__cause__``."""
    try:
        yield
    except Exception as e:  # noqa: BLE001 — any transport failure
        raise RuntimeError(
            f"{op} failed on rank {rank()} of {world_size()} (coordinator="
            f"{_COORDINATOR[0]}): {e}. A peer process may have died or be "
            f"unreachable; check that every rank is up, then relaunch.") from e


def all_reduce_tree(tree: dict, op: str = "sum", group=None) -> dict:
    """``jax.lax.psum`` (or ``pmax`` with ``op="max"``) of a flat dict of
    tensors over the process group: the leaves of one dtype and device
    are packed into one buffer and reduced by one ``all_reduce``, then cut
    back, over ``group`` (None: the default group). Without an initialized
    group the dict returns as it is; in a group of one the collective still
    runs (so a one-rank group exercises its backend)."""
    if not group_initialized():
        return dict(tree)
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    buckets: dict[Any, list] = {}
    for k, v in tree.items():
        buckets.setdefault((v.dtype, v.device), []).append(k)
    out = {}
    for keys in buckets.values():
        flat = torch.cat([tree[k].reshape(-1) for k in keys])
        t0 = time.perf_counter()
        with peer_errors("all_reduce"):
            dist.all_reduce(flat, op=reduce_op, group=group)
        COLLECTIVES["seconds"] += time.perf_counter() - t0
        COLLECTIVES["calls"] += 1
        COLLECTIVES["bytes"] += flat.numel() * flat.element_size()
        offset = 0
        for k in keys:
            n = tree[k].numel()
            out[k] = flat[offset:offset + n].reshape(tree[k].shape)
            offset += n
    return {k: out[k] for k in tree}
