"""Trainers — PyTorch form of ``fedml_tpu/core/trainer.py``'s
``ClassificationTrainer``, ``NWPTrainer`` and ``TagPredictionTrainer``.

A trainer is a bundle of functions over a variables dict (the port's
"variables": ``{"layer.weight": tensor, ...}``, a model's parameters and
its state), evaluated with ``torch.func.functional_call`` so one module
serves every client's variables:

  - ``init(generator, device)``                   -> variables
  - ``apply(variables, x, generator, train)``     -> (output, new_state)
  - ``loss_fn(variables, batch, generator, train)`` -> (loss, (new_state, aux))
  - ``eval_fn(variables, batch)``                 -> dict of metric sums

Model state is what flax keeps outside ``params``: a BatchNorm's running
``mean`` and ``var``, buffers of the module. ``utils/pytree.py::is_param``
is the one rule that tells a parameter's key from state's. A train-mode
``apply`` returns the updated state (every BatchNorm's new running
statistics), as the JAX package's ``_module_apply`` does with the non-param
collections mutable; an eval-mode one reads the running statistics and
returns ``{}``.

A batch is a dict with ``x``, ``y`` and a float ``mask`` of per-sample
validity (padding rows have mask 0; they still enter a BatchNorm's batch
statistics, as in the JAX engine). An eval batch may also carry
``clients``: its rows are then that many equal consecutive blocks, one per
client, as the JAX drive evaluates one client per vmapped call.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fedml_tpu_torch.models.cnn import lecun_normal_


def flax_default_init(module: nn.Module, generator: torch.Generator, device) -> dict:
    """flax's default initialisers by layer kind, drawn in parameter order,
    then the state buffers: Embed normal with std 1/sqrt(features),
    LayerNorm scale 1 and bias 0, every other weight (Dense, Conv)
    lecun-normal, biases 0. A module with a ``flax_init_(leaf, tensor,
    generator)`` method fills its own leaves (norm scales and the BatchNorm
    state, the LSTM's kernels)."""
    kinds = dict(module.named_modules())
    out = {}
    for name, p in list(module.named_parameters()) + list(module.named_buffers()):
        owner_name, _, leaf = name.rpartition(".")
        owner = kinds[owner_name]
        t = torch.zeros(p.shape, dtype=torch.float32)
        if hasattr(owner, "flax_init_"):
            owner.flax_init_(leaf, t, generator)
        elif leaf == "weight":
            if isinstance(owner, nn.LayerNorm):
                t.fill_(1.0)
            elif isinstance(owner, nn.Embedding):
                t = torch.randn(p.shape, generator=generator) / math.sqrt(p.shape[1])
            else:
                lecun_normal_(t, p[0].numel(), generator)
        out[name] = t.to(device)
    return out


class ModelTrainer:
    """A module plus its init and apply; the task trainers add the loss.
    ``aux_keys`` names the train metric sums of ``loss_fn``'s aux (the
    engine gives a client that takes no step zeros under these keys)."""

    aux_keys = ("loss_sum", "correct", "total")

    def __init__(self, module):
        self.module = module
        # the modules that leave updated state behind a train-mode call
        self._stateful = [(name, m) for name, m in module.named_modules()
                          if hasattr(m, "updated")]

    def init(self, generator: torch.Generator, device) -> dict:
        return flax_default_init(self.module, generator, device)

    def apply(self, variables, x, generator=None, train: bool = False):
        out = functional_call(self.module, variables, (x,),
                              {"train": train, "generator": generator})
        state = {}
        for name, m in self._stateful:
            if m.updated is not None:
                state.update({f"{name}.{leaf}": t for leaf, t in m.updated.items()})
                m.updated = None
        return out, state


class ClassificationTrainer(ModelTrainer):
    """Cross-entropy classification: the loss is the masked mean of
    per-sample CE; metric sums are float32; argmax ties go to the first
    index (``torch.argmax`` returns the first maximal index).

    ``augment_fn(generator, x) -> x`` (``data/augment.py``) transforms a
    training batch on its device before the forward pass, drawing from the
    client's generator; it runs only when training with a generator, as
    the JAX trainer's hook does."""

    def __init__(self, module, augment_fn=None):
        super().__init__(module)
        self.augment_fn = augment_fn

    def loss_fn(self, variables, batch, generator, train: bool = True):
        x = batch["x"]
        if train and self.augment_fn is not None and generator is not None:
            x = self.augment_fn(generator, x)
        logits, state = self.apply(variables, x, generator, train)
        per = F.cross_entropy(logits, batch["y"].long(), reduction="none")
        mask = batch["mask"].to(per.dtype)
        loss = (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        with torch.no_grad():
            mask32 = batch["mask"].float()
            correct = ((logits.argmax(-1) == batch["y"]).float() * mask32).sum()
            aux = {"loss_sum": (per.detach().float() * mask32).sum(),
                   "correct": correct, "total": mask32.sum()}
        return loss, (state, aux)

    @torch.no_grad()
    def eval_fn(self, variables, batch):
        logits, _ = self.apply(variables, batch["x"], None, False)
        per = F.cross_entropy(logits, batch["y"].long(), reduction="none")
        mask = batch["mask"].to(per.dtype)
        correct = ((logits.argmax(-1) == batch["y"]).to(per.dtype) * mask).sum()
        return {"test_correct": correct, "test_loss": (per * mask).sum(),
                "test_total": mask.sum()}


class NWPTrainer(ModelTrainer):
    """Next-word prediction with pad-id masking (reference
    my_model_trainer_nwp.py: CE with ignore_index=0, accuracy over non-pad).

    ``y`` is [b, T]; logits [b, T, vocab]. Tokens equal to ``pad_id`` count
    in neither loss nor accuracy, nor do padding rows. The CE is taken in
    float32 whatever the compute dtype."""

    def __init__(self, module, pad_id: int = 0):
        super().__init__(module)
        self.pad_id = pad_id

    def _masked_ce(self, variables, batch, generator, train):
        """Per-token CE [b, T], the token mask [b, T], the logits and the
        new state."""
        logits, state = self.apply(variables, batch["x"], generator, train)
        y = batch["y"].long()
        per = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]), y.reshape(-1),
                              reduction="none").reshape(y.shape)
        mask = (y != self.pad_id).float() * batch["mask"].float()[:, None]
        return per, mask, logits, state

    def loss_fn(self, variables, batch, generator, train: bool = True):
        per, mask, logits, state = self._masked_ce(variables, batch, generator, train)
        loss_sum = (per * mask).sum()
        loss = loss_sum / torch.clamp(mask.sum(), min=1.0)
        with torch.no_grad():
            correct = ((logits.argmax(-1) == batch["y"]).float() * mask).sum()
            aux = {"loss_sum": loss_sum.detach(), "correct": correct, "total": mask.sum()}
        return loss, (state, aux)

    @torch.no_grad()
    def eval_fn(self, variables, batch):
        """The reference's reported-loss contract (my_model_trainer_nwp.py:
        72-80): each client's batch adds its mean CE over non-pad tokens
        times its sample count, later divided by test_total (non-pad
        tokens)."""
        per, mask, logits, _ = self._masked_ce(variables, batch, None, False)
        clients = batch.get("clients", 1)
        loss = (per * mask).sum(1).reshape(clients, -1).sum(1)
        tokens = mask.sum(1).reshape(clients, -1).sum(1)
        samples = batch["mask"].float().reshape(clients, -1).sum(1)
        correct = ((logits.argmax(-1) == batch["y"]).float() * mask).sum()
        return {"test_correct": correct,
                "test_loss": (loss / torch.clamp(tokens, min=1.0) * samples).sum(),
                "test_total": mask.sum()}


class TagPredictionTrainer(ModelTrainer):
    """Multi-label tag prediction (reference
    my_model_trainer_tag_prediction.py): ``y`` is a multi-hot [b, tags]
    row; the loss is the BCE-with-logits mean over tags, masked per
    sample. Its aux has no ``correct``: a train round records
    ``loss_sum`` and ``total`` only, as the JAX trainer's does."""

    aux_keys = ("loss_sum", "total")

    def loss_fn(self, variables, batch, generator, train: bool = True):
        logits, state = self.apply(variables, batch["x"], generator, train)
        y = batch["y"].to(logits.dtype)
        per = F.binary_cross_entropy_with_logits(logits, y, reduction="none").mean(-1)
        mask = batch["mask"].to(per.dtype)
        loss_sum = (per * mask).sum()
        loss = loss_sum / torch.clamp(mask.sum(), min=1.0)
        aux = {"loss_sum": loss_sum.detach(), "total": mask.detach().sum()}
        return loss, (state, aux)

    @torch.no_grad()
    def eval_fn(self, variables, batch):
        """The reference metric contract (my_model_trainer_tag_prediction.py
        test():75-96), in float32: the BCE summed over every tag with the
        1e-7 clamp, times the client's sample count (divided back out by
        ``test_total``); exact-match ``test_correct``; per-sample precision
        and recall sums at threshold 0.5 with the 1e-13 guard. A batch of
        ``clients`` blocks scales each block's BCE by its own count, as the
        JAX drive evaluates one client per vmapped call."""
        logits, _ = self.apply(variables, batch["x"], None, False)
        y = batch["y"].float()
        probs = torch.sigmoid(logits).float()
        predicted = (probs > 0.5).float()
        samp = batch["mask"].float()
        eps = 1e-7
        bce = -(y * torch.log(torch.clamp(probs, min=eps))
                + (1 - y) * torch.log(torch.clamp(1 - probs, min=eps)))
        clients = batch.get("clients", 1)
        loss = (bce.sum(-1) * samp).reshape(clients, -1).sum(1)
        n_valid = samp.reshape(clients, -1).sum(1)
        exact = ((predicted - y).abs().amax(-1) < 0.5).float()
        tp = ((y * predicted) > 0.1).float().sum(-1)
        precision = tp / (predicted.sum(-1) + 1e-13)
        recall = tp / (y.sum(-1) + 1e-13)
        return {"test_correct": (exact * samp).sum(),
                "test_loss": (loss * n_valid).sum(),
                "test_precision": (precision * samp).sum(),
                "test_recall": (recall * samp).sum(),
                "test_total": samp.sum()}
