"""FedSeg (``fedml_tpu_torch/algorithms/fedseg.py``), its models
(``models/segmentation.py``) and the Pascal VOC reader and loader against
the JAX package's on the CPU, at small sizes: DeepLabV3+ at width 4 and
the FCN at width 4, 16 px and 20 px (a side 16 does not divide, so the
bilinear resizes run at scales that are not whole numbers), batch 8; the
round at 32 px.

Both sides run from the same variables (the port's initialisation,
converted with ``torch_to_flax``). The round runs with ``shuffle`` off
(the two packages draw their shuffles from their own streams). Tolerances:
rtol 2e-5 / atol 1e-5 for the losses, the eval-mode forwards, the
schedules, the FCN and the round's variables. DeepLabV3+'s train-mode
forward and gradients hold rtol 2e-5 with an atol of 2e-5 of the array's
(or the whole gradient's) largest magnitude: its batch statistics of a
1x1 map at stride 16 (8 values a channel) are where flax's fast variance
and the port's two-pass one part (``_train_close``). The confusion
matrix, the surrogate and the VOC reader's arrays are exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedseg as jseg
from fedml_tpu.algorithms.fedseg import FedSegAPI as JaxFedSegAPI
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.data import readers as jreaders
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models import segmentation as jsm
from fedml_tpu_torch.algorithms import fedseg as tseg
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ModelTrainer
from fedml_tpu_torch.data import readers as treaders
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.models import segmentation as tsm
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax

RTOL, ATOL = 2e-5, 1e-5
CLASSES, BATCH, WIDTH = 5, 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite's workers share
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _logits_and_target(seed=0, shape=(3, 6, 6), classes=CLASSES):
    rng = np.random.RandomState(seed)
    logits = rng.normal(size=shape + (classes,)).astype(np.float32) * 2
    target = rng.randint(0, classes, size=shape).astype(np.int32)
    target[rng.rand(*shape) < 0.2] = 255
    return logits, target


def test_pixel_losses_match_jax():
    """The per-pixel CE and focal losses with the ignore mask, and the
    reference's focal transform of a scalar."""
    logits, target = _logits_and_target()
    tl, tt = torch.from_numpy(logits), torch.from_numpy(target)
    for tfn, jfn in ((tseg.segmentation_ce, jseg.segmentation_ce),
                     (tseg.segmentation_focal, jseg.segmentation_focal)):
        (got, gm), (want, wm) = tfn(tl, tt), jfn(jnp.asarray(logits), jnp.asarray(target))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert float(gm.sum()) < gm.numel()  # some pixels ignored
    for v in (0.01, 0.7, 2.5):
        np.testing.assert_allclose(float(tseg.reference_focal_scalar(torch.tensor(v))),
                                   float(jseg.reference_focal_scalar(jnp.float32(v))),
                                   rtol=RTOL, atol=ATOL)


def _variables(module, seed=0):
    tv = ModelTrainer(module).init(torch.Generator().manual_seed(seed), "cpu")
    return tv, jax.tree.map(jnp.asarray, torch_to_flax(tv, module))


def _images(side, seed=1, n=BATCH):
    return np.random.RandomState(seed).normal(size=(n, side, side, 3)).astype(np.float32)


@pytest.mark.parametrize("loss_type", ["ce", "focal"])
def test_trainer_loss_and_eval_on_padded_batches(loss_type):
    """``SegmentationTrainer.loss_fn`` (loss, its gradient, the aux sums)
    and ``eval_fn`` on a batch whose last three samples are padding, under
    ``ce`` and ``focal``: the reference's batch-average divides by the 5
    valid samples."""
    tm, jm = tsm.SimpleFCN(CLASSES, WIDTH), jsm.SimpleFCN(output_dim=CLASSES, width=WIDTH)
    tv, jv = _variables(tm, seed=2)
    x = _images(16, seed=3)
    _, y = _logits_and_target(seed=4, shape=(BATCH, 16, 16))
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    tt, jt = (tseg.SegmentationTrainer(tm, loss_type=loss_type),
              jseg.SegmentationTrainer(jm, loss_type=loss_type))
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y), "mask": jnp.asarray(mask)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "mask": torch.from_numpy(mask)}
    (jloss, (_, jaux)), jgrad = jax.jit(jax.value_and_grad(
        lambda v: jt.loss_fn({"params": v}, jb, None), has_aux=True))(jv["params"])
    params = {k: v.clone().requires_grad_() for k, v in tv.items()}
    tloss, (_, taux) = tt.loss_fn(params, tb, None)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=RTOL, atol=ATOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=RTOL, atol=ATOL)
    want = flax_to_torch(jgrad, module=tm)
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    got, wanted = tt.eval_fn(tv, tb), jt.eval_fn(jv, jb)
    for k in wanted:
        np.testing.assert_allclose(float(got[k]), float(wanted[k]), rtol=RTOL, atol=ATOL)
    assert float(taux["total"]) < 5 * 16 * 16


def test_confusion_matrix_is_bit_for_bit():
    """Counts of (target, prediction) pairs, the ignore index and targets
    outside [0, classes) left out, exactly the JAX package's."""
    rng = np.random.RandomState(5)
    target = rng.randint(-1, CLASSES + 2, size=(4, 9, 9)).astype(np.int32)
    target[rng.rand(4, 9, 9) < 0.1] = 255
    pred = rng.randint(0, CLASSES, size=(4, 9, 9)).astype(np.int32)
    got = tseg.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(target), CLASSES)
    want = np.asarray(jseg.confusion_matrix(jnp.asarray(pred), jnp.asarray(target), CLASSES))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    valid = (target != 255) & (target >= 0) & (target < CLASSES)
    assert int(got.sum()) == int(valid.sum())


def test_evaluator_scores_with_an_absent_class():
    """A class with no pixel gives a NaN class accuracy and IoU, left out
    of the means, as in the JAX package."""
    rng = np.random.RandomState(6)
    cm = rng.randint(0, 50, size=(CLASSES, CLASSES)).astype(np.int64)
    cm[2, :] = 0  # class 2 never occurs
    cm[:, 2] = 0  # and is never predicted: its union is empty
    got = tseg.evaluator_scores(torch.from_numpy(cm))
    want = jseg.evaluator_scores(jnp.asarray(cm.astype(np.int32)))
    assert set(got) == set(want) == {"Acc", "Acc_class", "mIoU", "FWIoU"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert all(math.isfinite(v) for v in got.values())
    empty = tseg.evaluator_scores(torch.zeros(CLASSES, CLASSES, dtype=torch.int64))
    assert math.isnan(empty["Acc_class"]) and math.isnan(empty["mIoU"])
    assert math.isnan(jseg.evaluator_scores(jnp.zeros((CLASSES, CLASSES), jnp.int32))["mIoU"])


@pytest.mark.parametrize("mode,warmup,lr_step", [("cos", 0, 0), ("cos", 2, 0), ("poly", 1, 0),
                                                 ("step", 0, 2), ("step", 1, 3)])
def test_lr_schedule_matches_jax(mode, warmup, lr_step):
    """The reference's cos, poly and step schedules with linear warmup."""
    kw = dict(mode=mode, base_lr=0.007, num_epochs=6, iters_per_epoch=5, lr_step=lr_step,
              warmup_epochs=warmup)
    got, want = tseg.make_lr_schedule(**kw), jseg.make_lr_schedule(**kw)
    for step in (0, 1, 4, 5, 9, 10, 17, 29, 30, 35):
        np.testing.assert_allclose(float(got(step)), float(want(step)), rtol=RTOL, atol=1e-9,
                                   err_msg=f"step {step}")
    with pytest.raises(NotImplementedError):
        tseg.make_lr_schedule("exp", 0.1, 1, 1)


MODELS = {"deeplab": (lambda: tsm.DeepLabV3Plus(CLASSES, WIDTH),
                      lambda: jsm.DeepLabV3Plus(output_dim=CLASSES, width=WIDTH)),
          "fcn": (lambda: tsm.SimpleFCN(CLASSES, WIDTH),
                  lambda: jsm.SimpleFCN(output_dim=CLASSES, width=WIDTH))}


@pytest.mark.parametrize("side", [16, 20])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name, side):
    """The eval-mode logits, the train-mode logits, the gradients of a
    probe of them and the train-mode ``batch_stats`` (DeepLab's every
    BatchNorm, the image-pool branch's over a 1x1 map), from one jitted
    JAX program."""
    tm, jm = (f() for f in MODELS[name])
    tv, jv = _variables(tm, seed=7)
    x = _images(side, seed=8)
    probe = np.random.RandomState(9).normal(size=(BATCH, side, side, CLASSES)).astype(np.float32)

    def jax_side(variables):
        def loss(params):
            out, upd = jm.apply({**variables, "params": params}, x, train=True,
                                mutable=["batch_stats"])
            return (out * probe).sum(), (out, upd)

        (_, (out, upd)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
        return jm.apply(variables, x, train=False), out, upd, grads

    evaluated, trained, upd, grads = jax.jit(jax_side)(jv)
    trainer = ModelTrainer(tm)
    got, _ = trainer.apply(tv, torch.from_numpy(x), None, False)
    assert got.shape == (BATCH, side, side, CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(evaluated), rtol=RTOL, atol=ATOL)
    params = {k: v.clone().requires_grad_() for k, v in tv.items() if not k.endswith(
        (".mean", ".var"))}
    state = {k: v for k, v in tv.items() if k not in params}
    out, new_state = trainer.apply({**params, **state}, torch.from_numpy(x), None, True)
    (out * torch.from_numpy(probe)).sum().backward()
    _train_close(name, out.detach().numpy(), np.asarray(trained))
    want = flax_to_torch({"params": grads}, module=tm)
    assert set(want) == set(params)
    scale = max(float(v.abs().max()) for v in want.values())
    for k, p in params.items():
        _train_close(name, p.grad.numpy(), want[k].numpy(), err_msg=k, scale=scale)
    stats = flax_to_torch({"batch_stats": upd.get("batch_stats", {})}, module=tm)
    assert set(stats) == set(new_state) == set(state)
    for k, v in stats.items():
        np.testing.assert_allclose(new_state[k].numpy(), v.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    if name == "deeplab":
        assert "aspp.img_pool_bn.var" in stats


def _train_close(name, got, want, err_msg="", scale=None):
    """Train-mode agreement: rtol 2e-5 / atol 1e-5, DeepLab's with an atol
    of 2e-5 of ``scale`` (the largest magnitude of the output, or of the
    whole gradient): flax normalises with its fast variance E[x^2] - E[x]^2,
    the port with the two-pass one, and at stride 16 a 1x1 map gives each
    channel 8 values, where the two differ in the 6th digit. The
    gradient of a BatchNorm scale whose output reaches the next BatchNorm
    through a ReLU and a depthwise conv alone is 0 by scale invariance:
    what both sides compute there is rounding noise of the gradient's
    scale."""
    scale = float(np.abs(want).max()) if scale is None else scale
    atol = max(2e-5 * scale, ATOL) if name == "deeplab" else ATOL
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=err_msg)


def test_registry_builds_the_zoo_defaults():
    """``deeplab`` at width 32 and ``fcn`` at width 16 (``models/zoo.py``),
    their channels from the input, in the compute dtype asked for."""
    deeplab = create_model("deeplab", 21)
    fcn = create_model("fcn", 21, dtype="bfloat16", input_shape=(16, 16, 1))
    assert deeplab.width == 32 and deeplab.stem.in_channels == 3
    assert fcn.width == 16 and fcn.enc1.in_channels == 1 and fcn.dtype == torch.bfloat16
    out, _ = ModelTrainer(fcn).apply(ModelTrainer(fcn).init(torch.Generator(), "cpu"),
                                     torch.zeros(2, 16, 16, 1))
    assert out.shape == (2, 16, 16, 21) and out.dtype == torch.bfloat16


def test_pascal_voc_surrogate_is_bit_for_bit():
    """The seeded blob-mask surrogate (40 + 10 images, 21 classes, a 255
    ring) and its homo partition, exactly the JAX loader's."""
    kw = dict(data_dir="/nonexistent", client_num_in_total=4, image_size=24, seed=3)
    got, want = load_dataset("pascal_voc", **kw), jax_load_dataset("pascal_voc", **kw)
    assert got.class_num == want.class_num == 21
    for a, b in ((got.train.x, want.train.x), (got.train.y, want.train.y),
                 (got.train.counts, want.train.counts), (got.test.x, want.test.x),
                 (got.test_global[0], want.test_global[0]),
                 (got.test_global[1], want.test_global[1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert got.train.counts.sum() == 40 and got.test_global[0].shape == (10, 24, 24, 3)
    assert 255 in got.train.y


def _voc_tree(root):
    """A three-image VOCdevkit tree: two training images, one val, JPEGs
    and palette PNG masks with a 255 border."""
    from PIL import Image

    base = root / "VOCdevkit" / "VOC2012"
    for sub in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        (base / sub).mkdir(parents=True)
    rng = np.random.RandomState(10)
    palette = list(rng.randint(0, 256, 3 * 256).astype(int))
    for i, (h, w) in enumerate([(40, 30), (33, 47), (25, 25)]):
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            base / "JPEGImages" / f"img{i}.jpg", quality=90)
        mask = rng.randint(0, 21, (h, w)).astype(np.uint8)
        mask[:4, :] = 255
        m = Image.fromarray(mask, mode="P")
        m.putpalette(palette)
        m.save(base / "SegmentationClass" / f"img{i}.png")
    (base / "ImageSets" / "Segmentation" / "train.txt").write_text("img0\nimg1\n")
    (base / "ImageSets" / "Segmentation" / "val.txt").write_text("img2\n")


def test_read_pascal_voc_is_bit_for_bit(tmp_path):
    """The reader on a VOCdevkit tree written with PIL: the same arrays as
    the JAX reader's, bit for bit; the loader takes it over the
    surrogate."""
    _voc_tree(tmp_path)
    got = treaders.read_pascal_voc(str(tmp_path), size=16)
    want = jreaders.read_pascal_voc(str(tmp_path), size=16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[0].shape == (2, 16, 16, 3) and got[3].shape == (1, 16, 16)
    assert 255 in got[1]
    ds = load_dataset("pascal_voc", data_dir=str(tmp_path), client_num_in_total=2,
                      image_size=16)
    np.testing.assert_array_equal(ds.test_global[1], got[3])
    assert treaders.read_pascal_voc(str(tmp_path / "missing")) is None


ROUND = dict(client_num_in_total=4, client_num_per_round=4, batch_size=8, lr=0.007,
             epochs=1, comm_round=1, shuffle=False, seed=0, frequency_of_the_test=1)


@pytest.fixture(scope="module")
def seg_datasets():
    kw = dict(data_dir="/nonexistent", client_num_in_total=4, image_size=32)
    return jax_load_dataset("pascal_voc", **kw), load_dataset("pascal_voc", **kw)


class _PresetTrainer(jseg.SegmentationTrainer):
    """JAX's trainer starting from given variables (flax's eager init of
    DeepLabV3+ takes seconds on the CPU)."""

    def __init__(self, module, variables):
        super().__init__(module)
        self.variables = variables

    def init(self, rng, example_input):
        return self.variables


def test_fedseg_round_and_evaluate_match_jax(seg_datasets):
    """One FedSegAPI round of DeepLabV3+ (width 4) on the 32 px surrogate's
    4 clients of 10 images at batch 8 (a 2x2 map at stride 16: at 16 px and
    batch 4 each channel's statistics over 4 values, padding rows among
    them, turn float32 rounding into differences of the first digit on
    both sides), from the port's initial variables, converted: the globals
    (parameters and running statistics), the round's sums, then
    ``evaluate``'s confusion matrix (exact) and scores."""
    jds, tds = seg_datasets
    jm = jsm.DeepLabV3Plus(output_dim=21, width=WIDTH)
    tm = tsm.DeepLabV3Plus(21, WIDTH)
    tapi = tseg.FedSegAPI(tds, FedConfig(**ROUND), tseg.SegmentationTrainer(tm), device="cpu")
    start = jax.tree.map(jnp.asarray, torch_to_flax(tapi.global_variables, tm))
    japi = JaxFedSegAPI(jds, JaxConfig(**ROUND), _PresetTrainer(jm, start))
    jrec, trec = japi.train_one_round(0), tapi.train_one_round(0)
    for k in ("loss_sum", "correct", "total"):
        np.testing.assert_allclose(trec[k], float(jrec[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    want = flax_to_torch(japi.global_variables, module=tm)
    assert set(want) == set(tapi.global_variables)
    for k, v in want.items():
        np.testing.assert_allclose(tapi.global_variables[k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    tapi._inner.global_variables = want
    cm, loss = tapi.confusion_and_loss()
    bx, by, bm = japi._inner._test_batches
    jcm, jloss = japi._cm_fn(japi.global_variables, jnp.asarray(bx), jnp.asarray(by),
                             jnp.asarray(bm))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    got, wanted = tapi.evaluate(), japi.evaluate()
    for k, v in wanted.__dict__.items():
        np.testing.assert_allclose(getattr(got, k), v, rtol=RTOL, atol=ATOL, err_msg=k)


def _seg_api(tds, rounds):
    cfg = FedConfig(**{**ROUND, "comm_round": rounds, "shuffle": True})
    return tseg.FedSegAPI(tds, cfg, tseg.SegmentationTrainer(tsm.DeepLabV3Plus(21, WIDTH)),
                          device="cpu")


def test_fedseg_resume_is_bit_for_bit(seg_datasets, tmp_path):
    """A 1 + 1 run resumed from its checkpoint equals the 2-round run: the
    globals (running statistics included) and the records."""
    _, tds = seg_datasets
    straight = _seg_api(tds, 2)
    hist = straight.train()
    _seg_api(tds, 1).train(ckpt_dir=str(tmp_path))
    resumed = _seg_api(tds, 2)
    rhist = resumed.train(ckpt_dir=str(tmp_path))
    for k, v in straight.global_variables.items():
        assert torch.equal(resumed.global_variables[k], v), k
    assert [r["round"] for r in rhist] == [0, 1]
    for a, b in zip(rhist, hist):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])), k
    assert "Test/mIoU" in hist[-1]


def test_main_fedseg_cpu(tmp_path):
    """``main_fedseg`` with the FCN and the focal loss on the CPU, one
    round on the 16 px surrogate; its records in the wandb summary."""
    import json

    from fedml_tpu_torch.experiments import main_fedseg

    hist = main_fedseg.main(["--model", "fcn", "--loss_type", "focal", "--image_size", "16",
                             "--model_width", "4", "--comm_round", "1", "--batch_size", "8",
                             "--device", "cpu", "--run_dir", str(tmp_path / "run")])
    assert len(hist) == 1 and math.isfinite(hist[0]["Test/loss"])
    summary = json.loads((tmp_path / "run" / "wandb-summary.json").read_text())
    assert 0.0 <= summary["Test/accuracy"] <= 1.0
