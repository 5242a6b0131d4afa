"""Adversarial-robustness evaluation: FGSM and PGD, PyTorch form of
``fedml_tpu/privacy/adv_attack.py``.

The reference's privacy_fedml/adv_attack/adv_attack.py:36 wraps foolbox
(LinfPGD etc.); here the attacks are written out with autograd's gradient
of the cross-entropy with respect to the input, under the same L-inf
threat model.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _input_grad(predict_fn: Callable, x, y) -> torch.Tensor:
    """d mean-CE(predict_fn(x), y) / dx."""
    x = x.detach().requires_grad_(True)
    loss = F.cross_entropy(predict_fn(x), y.long())
    (g,) = torch.autograd.grad(loss, [x])
    return g


def fgsm(predict_fn: Callable, x, y, eps: float):
    """Single-step L-inf attack: x + eps * sign(grad_x CE), clipped to the
    batch's own value range [x.min(), x.max()]."""
    g = _input_grad(predict_fn, x, y)
    return torch.clamp(x + eps * torch.sign(g), x.min(), x.max()).detach()


def pgd(predict_fn: Callable, x, y, eps: float, step_size: float | None = None,
        steps: int = 10, rng: torch.Generator | None = None):
    """Projected gradient descent in the L-inf ball (foolbox LinfPGD
    analog); with ``rng`` the start is uniform in the ball, drawn from it."""
    step_size = step_size if step_size is not None else 2.5 * eps / steps
    x0 = x.detach()
    if rng is not None:
        u = torch.rand(x.shape, generator=rng, device=rng.device, dtype=x.dtype)
        x = x0 + (u.to(x.device) * (2 * eps) - eps)
    for _ in range(steps):
        x = x + step_size * torch.sign(_input_grad(predict_fn, x, y))
        x = torch.clamp(x, x0 - eps, x0 + eps)
    return x.detach()


@torch.no_grad()
def _accuracy(predict_fn: Callable, x, y) -> float:
    return float((predict_fn(x).argmax(-1) == y).float().mean())


def robust_accuracy(predict_fn: Callable, x, y, eps_list, attack: str = "pgd",
                    steps: int = 10, rng: torch.Generator | None = None) -> dict[float, float]:
    """Accuracy under attack per epsilon (reference adv_attack eval loop)."""
    out = {}
    for eps in eps_list:
        if eps == 0:
            adv = x
        elif attack == "fgsm":
            adv = fgsm(predict_fn, x, y, eps)
        else:
            adv = pgd(predict_fn, x, y, eps, steps=steps, rng=rng)
        out[float(eps)] = _accuracy(predict_fn, adv, y)
    return out
