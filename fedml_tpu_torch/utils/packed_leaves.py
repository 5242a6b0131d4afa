"""The packed-binary leaf format: flat array leaves at fixed offsets (a
copy of ``fedml_tpu/utils/packed_leaves.py``; the bytes are the JAX
package's, so a bank row or a tenant spill written by either package reads
the same in the other).

Two consumers share this layout:

  - ``serving.evict_store.EvictionStore`` spills an evicted tenant's
    snapshot leaves into one packed binary per tenant and rehydrates them
    as ``np.memmap`` views;
  - ``models.adapter_bank.AdapterBank`` packs a client's personal adapter
    tree into one fixed-width row of a sparse mmap shard file, using
    ``leaf_layout`` for the offsets within a row and ``pack_rows`` /
    ``unpack_rows`` for the O(cohort) byte transposition.

The format is positional: entry ``i`` indexes the leaf order of the spilled
tree (for an adapter tree, ``models.lora.adapter_order``: the JAX package's
``jax.tree.flatten`` order), each entry records ``(i, offset, dtype,
shape)`` and the payload is the C-contiguous bytes of the leaf at
``offset``. Only non-empty ndarray leaves go out of line; everything else
(None placeholders, Python scalars) stays inline. Entries record the
ORIGINAL leaf shape: ``np.ascontiguousarray`` promotes 0-d scalars to 1-d,
so the writer's ``data.shape`` would lie.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


def _is_packed(leaf: Any) -> bool:
    return isinstance(leaf, np.ndarray) and leaf.size


def leaf_layout(leaves: Sequence[Any]) -> Tuple[List[Dict], int]:
    """The (entries, total_bytes) layout of `leaves` WITHOUT writing —
    leaves may be anything with .shape and a numpy-compatible .dtype
    (numpy arrays, or abstract stand-ins). The adapter bank derives its
    fixed row width from the template adapter tree this way."""
    entries: List[Dict] = []
    offset = 0
    for i, leaf in enumerate(leaves):
        shape = tuple(int(s) for s in leaf.shape)
        dtype = np.dtype(leaf.dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if nbytes == 0:
            continue
        entries.append({"i": i, "offset": offset, "dtype": dtype.name,
                        "shape": list(shape)})
        offset += nbytes
    return entries, offset


def spill_leaves(bin_path: str, leaves: Sequence[Any]
                 ) -> Tuple[List[Dict], List[Any], int]:
    """Write the packed binary at `bin_path`; returns (entries, inline
    leaves with None placeholders at packed positions, total bytes)."""
    entries: List[Dict] = []
    inline: List[Any] = []
    offset = 0
    with open(bin_path, "wb") as f:
        for i, leaf in enumerate(leaves):
            if _is_packed(leaf):
                data = np.ascontiguousarray(leaf)
                f.write(data.tobytes())
                entries.append({"i": i, "offset": offset,
                                "dtype": str(data.dtype),
                                "shape": list(leaf.shape)})
                offset += data.nbytes
                inline.append(None)
            else:
                inline.append(leaf)
    return entries, inline, offset


def load_leaves(bin_path: str, entries: Sequence[Dict],
                inline: Sequence[Any]) -> List[Any]:
    """Rehydrate a spill: packed positions come back as read-only
    `np.memmap` views (flat map + reshape — memmap cannot express 0-d
    shapes), inline positions pass through."""
    leaves = list(inline)
    for e in entries:
        shape = tuple(e["shape"])
        flat = np.memmap(
            bin_path, mode="r", dtype=np.dtype(e["dtype"]),
            shape=(int(np.prod(shape, dtype=np.int64)),),
            offset=e["offset"])
        leaves[e["i"]] = flat.reshape(shape)
    return leaves


def pack_rows(stacked_leaves: Sequence[np.ndarray], entries: Sequence[Dict],
              row_nbytes: int) -> np.ndarray:
    """[C, row_nbytes] uint8 rows from [C, ...]-stacked leaves: row c is
    exactly the bytes `spill_leaves` would write for client c's tree, so
    a bank row and a tenant spill of the same adapters are byte-equal."""
    n = int(stacked_leaves[0].shape[0]) if stacked_leaves else 0
    buf = np.empty((n, row_nbytes), dtype=np.uint8)
    for e, leaf in zip(entries, stacked_leaves):
        a = np.ascontiguousarray(
            np.asarray(leaf, dtype=np.dtype(e["dtype"])))
        width = a.nbytes // max(n, 1)
        buf[:, e["offset"]:e["offset"] + width] = \
            a.reshape(n, -1).view(np.uint8)
    return buf


def unpack_rows(buf: np.ndarray, entries: Sequence[Dict]
                ) -> List[np.ndarray]:
    """Inverse of `pack_rows`: [C, row_nbytes] uint8 -> [C, *shape]
    leaves in entry order (fresh contiguous copies)."""
    n = int(buf.shape[0])
    out: List[np.ndarray] = []
    for e in entries:
        shape = tuple(e["shape"])
        dtype = np.dtype(e["dtype"])
        width = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        chunk = np.ascontiguousarray(
            buf[:, e["offset"]:e["offset"] + width])
        out.append(chunk.view(dtype).reshape((n,) + shape))
    return out


def coalesced_runs(rows: np.ndarray):
    """Group SORTED local row indices into (start_row, count) runs of
    strictly consecutive rows — the pread/pwrite coalescing the packed
    store's row gathers use (one syscall per run instead of per row).
    A duplicate breaks its run (diff 0 != 1), so every run covers
    `count` distinct rows `start..start+count-1`."""
    rows = np.asarray(rows, np.int64)
    if not rows.size:
        return
    breaks = np.flatnonzero(np.diff(rows) != 1)
    start = 0
    for b in np.append(breaks, rows.size - 1):
        yield int(rows[start]), int(b - start + 1)
        start = int(b) + 1


def read_rows(fd: int, rows: np.ndarray, row_nbytes: int) -> np.ndarray:
    """[len(rows), row_nbytes] uint8 via sorted/coalesced `os.pread` —
    rows need not be sorted or unique; holes in sparse files read as
    zeros (the adapter bank's lazy zero-init)."""
    rows = np.asarray(rows, np.int64)
    out = np.empty((rows.size, row_nbytes), np.uint8)
    order = np.argsort(rows, kind="stable")
    sorted_rows = rows[order]
    pos = 0
    for start, count in coalesced_runs(sorted_rows):
        data = os.pread(fd, count * row_nbytes, start * row_nbytes)
        out[order[pos:pos + count]] = \
            np.frombuffer(data, np.uint8).reshape(count, row_nbytes)
        pos += count
    return out


def write_rows(fd: int, rows: np.ndarray, buf: np.ndarray) -> None:
    """Scatter [len(rows), row_nbytes] uint8 rows via sorted/coalesced
    `os.pwrite`; duplicate row ids resolve last-position-wins (the
    stable sort keeps the caller's order among equal rows, and later
    runs overwrite earlier ones)."""
    rows = np.asarray(rows, np.int64)
    row_nbytes = int(buf.shape[1])
    order = np.argsort(rows, kind="stable")
    sorted_rows = rows[order]
    pos = 0
    for start, count in coalesced_runs(sorted_rows):
        block = np.ascontiguousarray(buf[order[pos:pos + count]])
        os.pwrite(fd, block.tobytes(), start * row_nbytes)
        pos += count
