"""FedSeg — federated semantic segmentation, PyTorch form of
``fedml_tpu/algorithms/fedseg.py`` (reference fedml_api/distributed/
fedseg/utils.py: SegmentationLosses, LR_Scheduler, Evaluator,
EvaluationMetricsKeeper).

FedAvg over an encoder-decoder model runs on the port's round engine
(``FedSegAPI`` composes ``FedAvgAPI``, as the JAX class does); this module
supplies the segmentation task: ``SegmentationTrainer`` (per-pixel CE or
the reference's focal loss, ignore index 255), the confusion-matrix
evaluator (pixel accuracy, class accuracy, mIoU, FWIoU) and the
reference's learning-rate schedules.

The confusion matrix is an integer (int64) count, equal to the JAX
package's bit for bit; the scores are float32 as there, NaN for a class
that never occurs (nanmean).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.trainer import ModelTrainer
from fedml_tpu_torch.telemetry.records import fetch_scalars


@dataclass
class EvaluationMetricsKeeper:
    """Reference utils.py:62-69: a plain value carrier."""

    accuracy: float
    accuracy_class: float
    mIoU: float
    FWIoU: float
    loss: float


def segmentation_ce(logits, target, ignore_index: int = 255):
    """(per-pixel CE [b, h, w] zeroed at ignored pixels, the pixel mask)
    (reference CrossEntropyLoss, utils.py:86-95); logits [b, h, w, c],
    target [b, h, w]."""
    valid = target != ignore_index
    safe_t = torch.where(valid, target, 0).long()
    per = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), safe_t.reshape(-1),
                          reduction="none").reshape(target.shape)
    m = valid.to(per.dtype)
    return per * m, m


def segmentation_focal(logits, target, gamma: float = 2.0, alpha: float = 0.5,
                       ignore_index: int = 255):
    """Per-pixel focal transform of the CE (the standard form; the
    reference's FocalLoss transforms the batch-mean CE instead, which
    ``reference_focal_scalar`` and ``SegmentationTrainer`` reproduce)."""
    ce, m = segmentation_ce(logits, target, ignore_index)
    logpt = -ce
    pt = torch.exp(logpt)
    return -((1 - pt) ** gamma) * alpha * logpt, m


def reference_focal_scalar(mean_ce, gamma: float = 2.0, alpha: float = 0.5):
    """The reference's focal loss (utils.py:97-110): logpt = -mean_ce,
    loss = -alpha * (1 - exp(logpt))^gamma * logpt."""
    logpt = -mean_ce
    pt = torch.exp(logpt)
    return -((1 - pt) ** gamma) * alpha * logpt


class SegmentationTrainer(ModelTrainer):
    """Per-pixel classification; a batch's ``y`` is [b, h, w] int labels,
    ``ignore_index`` (255) ignored.

    The training loss has the reference's scale, so its launch scripts'
    learning rates carry over: the CE is averaged over valid pixels, then
    divided again by the batch's valid sample count (the reference's
    ``batch_average``, utils.py:90-95, which never pads: the valid count,
    not the padded batch); ``"focal"`` transforms the batch-mean CE."""

    def __init__(self, module, loss_type: str = "ce", ignore_index: int = 255,
                 batch_average: bool = True):
        super().__init__(module)
        if loss_type not in ("ce", "focal"):
            raise ValueError(f"unknown loss_type {loss_type!r} (ce or focal)")
        self.loss_type = loss_type
        self.ignore_index = ignore_index
        self.batch_average = batch_average

    def _masked_ce(self, logits, batch):
        per, pix_mask = segmentation_ce(logits, batch["y"], self.ignore_index)
        m = pix_mask * batch["mask"].to(per.dtype).reshape(-1, 1, 1)
        return per, m

    def loss_fn(self, variables, batch, generator, train: bool = True):
        logits, state = self.apply(variables, batch["x"], generator, train)
        per, m = self._masked_ce(logits, batch)
        mean_ce = (per * m).sum() / torch.clamp(m.sum(), min=1.0)
        loss = reference_focal_scalar(mean_ce) if self.loss_type == "focal" else mean_ce
        if self.batch_average:
            loss = loss / torch.clamp(batch["mask"].sum(), min=1.0)
        with torch.no_grad():
            m32 = m.float()
            correct = ((logits.argmax(-1) == batch["y"]).float() * m32).sum()
            aux = {"loss_sum": (per.detach().float() * m32).sum(), "correct": correct,
                   "total": m32.sum()}
        return loss, (state, aux)

    @torch.no_grad()
    def eval_fn(self, variables, batch):
        logits, _ = self.apply(variables, batch["x"], None, False)
        per, m = self._masked_ce(logits, batch)
        return {"test_correct": ((logits.argmax(-1) == batch["y"]).to(per.dtype) * m).sum(),
                "test_loss": (per * m).sum(), "test_total": m.sum()}


# ----------------------------------------------------------------- metrics

def confusion_matrix(pred, target, num_classes: int, ignore_index: int = 255):
    """[num_classes, num_classes] int64 counts, rows the ground truth
    (reference Evaluator._generate_matrix)."""
    valid = (target != ignore_index) & (target >= 0) & (target < num_classes)
    idx = target.long() * num_classes + pred.long()
    idx = torch.where(valid, idx, num_classes * num_classes)  # the dump bin
    counts = torch.bincount(idx.reshape(-1), minlength=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes)


def evaluator_scores(cm) -> dict[str, float]:
    """Pixel accuracy, class accuracy, mIoU and FWIoU of a confusion matrix
    (reference Evaluator.Pixel_Accuracy etc.), in float32; a class with no
    pixel has a NaN class accuracy and IoU, left out of the means."""
    cm = cm.detach().cpu().float()
    total = torch.clamp(cm.sum(), min=1.0)
    tp = torch.diagonal(cm)
    gt = cm.sum(1)
    class_acc = torch.where(gt > 0, tp / torch.clamp(gt, min=1.0), torch.nan)
    union = gt + cm.sum(0) - tp
    iou = torch.where(union > 0, tp / torch.clamp(union, min=1.0), torch.nan)
    freq = gt / total
    fwiou = torch.nansum(torch.where(freq > 0, freq * iou, 0.0))
    return {"Acc": float(tp.sum() / total), "Acc_class": float(torch.nanmean(class_acc)),
            "mIoU": float(torch.nanmean(iou)), "FWIoU": float(fwiou)}


# ---------------------------------------------------------------- FedSegAPI


class FedSegAPI:
    """Federated segmentation (reference FedSegAPI.py and
    FedSegAggregator.py:65-199): FedAvg rounds of the port's engine over an
    encoder-decoder, with the segmentation evaluator on test rounds. The
    round loop is ``FedAvgAPI``'s (composition, as in the JAX package);
    only the evaluation differs. Runs on ``cuda`` unless the caller passes
    ``device="cpu"``."""

    def __init__(self, dataset, config, model_trainer=None, loss_type: str = "ce",
                 aggregator_name: str = "fedavg", device="cuda"):
        if model_trainer is None:
            from fedml_tpu_torch.models.registry import create_model

            # extra["seg_width"] scales the encoder (default 32): the
            # compute-bound rung, 128 px at width 64, uses it
            module = create_model("deeplab", output_dim=dataset.class_num, dtype=config.dtype,
                                  input_shape=dataset.train.x.shape[2:],
                                  width=int(config.extra.get("seg_width", 32)))
            model_trainer = SegmentationTrainer(module, loss_type=loss_type)
        self.trainer = model_trainer
        self._inner = FedAvgAPI(dataset, config, model_trainer,
                                aggregator_name=aggregator_name, device=device)
        self.device = self._inner.device
        self.dataset = dataset
        self.cfg = config
        self.history = self._inner.history
        self.num_classes = dataset.class_num

    @property
    def global_variables(self):
        return self._inner.global_variables

    def train_one_round(self, round_idx: int):
        return self._inner.train_one_round(round_idx)

    def train(self, ckpt_dir: str | None = None, metrics_logger=None):
        """Rounds with the evaluator on test rounds; ``ckpt_dir`` resumes from
        the inner FedAvg state (model and aggregator), the records riding
        the checkpoint's metadata, and saves after every round."""
        cfg = self.cfg
        start = 0
        if ckpt_dir:
            start = self._inner.maybe_restore(ckpt_dir)
            self.history = list(self._inner.history)
            self._inner.history = []
        for r in range(start, cfg.comm_round):
            rec = {"round": r, **self._inner.train_one_round(r)}
            if r % cfg.frequency_of_the_test == 0 or r == cfg.comm_round - 1:
                ev = self.evaluate()
                rec.update({f"Test/{k}": v for k, v in ev.__dict__.items()})
            self.history.append(rec)
            if metrics_logger is not None:
                metrics_logger.log({k: v for k, v in rec.items() if k != "round"}, step=r)
            if ckpt_dir:
                self._inner.history = self.history  # our records persist
                self._inner.save_checkpoint(ckpt_dir, r + 1)
        return self.history

    @torch.no_grad()
    def confusion_and_loss(self, variables=None):
        """One sweep over the packed test batches: (the confusion matrix, the
        masked CE over valid pixels). Padded samples count as
        ``ignore_index``."""
        variables = self.global_variables if variables is None else variables
        trainer, nc = self.trainer, self.num_classes
        ignore = trainer.ignore_index
        bx, by, bm = self._inner._test_batches
        cm = torch.zeros((nc, nc), dtype=torch.int64, device=self.device)
        loss_sum = n_sum = torch.zeros((), device=self.device)
        for i in range(bx.shape[0]):
            x, y, m = bx[i], by[i], bm[i]
            logits, _ = trainer.apply(variables, x, None, False)
            per, pix_mask = segmentation_ce(logits, y, ignore)
            mm = pix_mask * m.to(per.dtype).reshape(-1, 1, 1)
            y = torch.where(m.reshape(-1, 1, 1) > 0, y, torch.full_like(y, ignore))
            cm += confusion_matrix(logits.argmax(-1), y, nc, ignore)
            loss_sum = loss_sum + (per * mm).sum().float()
            n_sum = n_sum + mm.sum().float()
        return cm, loss_sum / torch.clamp(n_sum, min=1.0)

    def evaluate(self) -> EvaluationMetricsKeeper:
        """Global test-set scores (reference
        FedSegAggregator.output_global_acc_and_loss:160-199)."""
        cm, loss = self.confusion_and_loss()
        scores = evaluator_scores(cm)
        return EvaluationMetricsKeeper(
            accuracy=scores["Acc"], accuracy_class=scores["Acc_class"],
            mIoU=scores["mIoU"], FWIoU=scores["FWIoU"], loss=fetch_scalars([loss])[0])


# -------------------------------------------------------------- lr schedule

def make_lr_schedule(mode: str, base_lr: float, num_epochs: int, iters_per_epoch: int,
                     lr_step: int = 0, warmup_epochs: int = 0):
    """step -> the learning rate (a float32 0-d tensor) of the reference's
    LR_Scheduler (utils.py:114-160): cos, poly(0.9) or step, with linear
    warmup."""
    if mode not in ("cos", "poly", "step"):
        raise NotImplementedError(mode)
    if mode == "step" and not lr_step:
        raise ValueError("the step schedule needs lr_step")
    n = max(1, num_epochs * iters_per_epoch)
    warmup_iters = warmup_epochs * iters_per_epoch

    def schedule(step):
        t = torch.as_tensor(step, dtype=torch.float32)
        if mode == "cos":
            lr = 0.5 * base_lr * (1 + torch.cos(t / n * math.pi))
        elif mode == "poly":
            lr = base_lr * torch.pow(torch.clamp(1 - t / n, min=0.0), 0.9)
        else:
            epoch = torch.div(t, iters_per_epoch, rounding_mode="floor")
            lr = base_lr * torch.pow(torch.tensor(0.1),
                                     torch.div(epoch, lr_step, rounding_mode="floor"))
        if warmup_iters > 0:
            lr = torch.where(t < warmup_iters, lr * t / warmup_iters, lr)
        return lr

    return schedule
