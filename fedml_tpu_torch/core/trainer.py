"""ClassificationTrainer — PyTorch form of
``fedml_tpu/core/trainer.py::ClassificationTrainer``.

The trainer is a bundle of functions over a parameter dict (the port's
"variables": ``{"layer.weight": tensor, ...}``), evaluated with
``torch.func.functional_call`` so one module serves every client's
parameters:

  - ``init(generator, device)``                   -> variables
  - ``loss_fn(variables, batch, generator, train)`` -> (loss, aux)
  - ``eval_fn(variables, batch)``                 -> dict of metric sums

A batch is a dict with ``x``, ``y`` and a float ``mask`` of per-sample
validity (padding rows have mask 0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call

from fedml_tpu_torch.models.cnn import lecun_normal_


class ClassificationTrainer:
    """Cross-entropy classification: the loss is the masked mean of
    per-sample CE; metric sums are float32; argmax ties go to the first
    index (``torch.argmax`` returns the first maximal index)."""

    def __init__(self, module):
        self.module = module

    def init(self, generator: torch.Generator, device) -> dict:
        """flax-style init: lecun-normal weights, zero biases."""
        out = {}
        for name, p in self.module.named_parameters():
            t = torch.zeros(p.shape, dtype=torch.float32)
            if name.endswith("weight"):
                fan_in = p[0].numel()
                lecun_normal_(t, fan_in, generator)
            out[name] = t.to(device)
        return out

    def apply(self, variables, x, generator=None, train: bool = False):
        return functional_call(self.module, variables, (x,),
                               {"train": train, "generator": generator})

    def loss_fn(self, variables, batch, generator, train: bool = True):
        logits = self.apply(variables, batch["x"], generator, train)
        per = F.cross_entropy(logits, batch["y"].long(), reduction="none")
        mask = batch["mask"].to(per.dtype)
        loss = (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        with torch.no_grad():
            mask32 = batch["mask"].float()
            correct = ((logits.argmax(-1) == batch["y"]).float() * mask32).sum()
            aux = {"loss_sum": (per.detach().float() * mask32).sum(),
                   "correct": correct, "total": mask32.sum()}
        return loss, aux

    @torch.no_grad()
    def eval_fn(self, variables, batch):
        logits = self.apply(variables, batch["x"], None, False)
        per = F.cross_entropy(logits, batch["y"].long(), reduction="none")
        mask = batch["mask"].to(per.dtype)
        correct = ((logits.argmax(-1) == batch["y"]).to(per.dtype) * mask).sum()
        return {"test_correct": correct, "test_loss": (per * mask).sum(),
                "test_total": mask.sum()}
