"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. When
``cuda`` is asked for and no GPU is found they raise: a run never drops to
the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch finds no CUDA "
            f"device; pass device='cpu' to run on the CPU")
    return dev


def device_count(device) -> int:
    """How many devices of ``device``'s type the run can use: the visible
    cards for ``cuda``, 1 for the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A CPU tensor on ``device`` without a host sync inside a round. On the
    card the tensor goes through pinned memory with a ``non_blocking``
    copy: a copy from pageable memory synchronises the stream. The pinned
    block comes from PyTorch's caching host allocator, which hands it out
    again only after the copy is done. Elsewhere the tensor moves as is."""
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
