"""The port's VGG, MobileNet, MobileNetV3 and EfficientNet against the JAX
package's, from flax-initialised weights carried across with the converter
(``utils/convert.py``; flax's depthwise kernels [kh, kw, 1, C] become
``groups=C`` weights [C, 1, kh, kw] and back), on the same seeded numpy
inputs. MobileNet and MobileNetV3 run at narrow widths (``alpha``,
``multiplier``); VGG-11/16 and EfficientNet-b0 at their published ones.
Dropout and drop-connect are off: the two packages' random streams differ.

What is held, and at which tolerance:

- the parameter count, exactly, and the conversion both ways bit for bit;
- train mode (batch statistics) from zero running statistics: the logits
  and the new running statistics within the float32 contract rtol 2e-5 /
  atol 1e-5 (``tests/test_fused_sgd.py:76``), here and below with the atol
  scaled by the reference's largest magnitude where that is over 1;
- eval mode at running statistics equal to that batch's own (the new
  statistics over 1 - momentum, so the logits are of order 1, not the
  near-zero ones of flax's 0 / 1 init), each variance plus 1e-2: a
  channel whose variance over the batch is near 0 would scale its
  rounding by 1 / sqrt(epsilon), as in train mode below (MobileNet v1's
  plus 1: at 1e-2 its 27 BatchNorms with no residual path still move its
  float32 gradients by 0.5-1.6% of a leaf, the JAX package's own by 6.7%
  against its float64 run; at 1 both agree to 4e-7). The logits and every
  gradient of the eval-mode loss within the contract (each leaf's atol
  scaled by its largest element);
- bf16 (compute dtype bfloat16, parameters and normalisation float32) eval
  logits within 0.2 absolute at magnitudes about 1: XLA and PyTorch round
  the products of different summation orders to bf16 at every layer, and
  the JAX package's own bf16 logits lie 0.15 (MobileNet) and 0.13
  (EfficientNet) from its float32 ones (the port's bf16: 0.12 and 0.021
  from the JAX package's);
- EfficientNet's SAME padding: at 32x32 every stride-2 conv pads one more
  row and column after than before, and a symmetric padding moves the
  logits by orders of magnitude more than the contract (the control); at
  33x33 the sides stay odd and each pad is symmetric; both held within the
  contract.

A train-mode BatchNorm over a few values is ill-conditioned in float32:
each side sums in its own order and every layer passes the difference on,
scaled by 1 / std. On a 32x32 input the nets with five stride-2 stages
end at 1x1, a statistic over a batch of 4 values, where both packages'
float32 runs miss the JAX package's float64 run by up to 1.3e-4 on the
logits; so those nets run at 64x64 (last stage 2x2) and VGG, whose last
BatchNorm is at 2x2 already, at 32x32. MobileNet v1, 27 BatchNorms with no
residual path, stays ill-conditioned there: the JAX package's own float32
train logits miss its float64 run by 2.5x the contract, the port's by
4.5x, so its train-mode logits and statistics are held at 5x the
contract. For the same reason the gradients are those of the eval-mode
loss: through train-mode BatchNorms at init the JAX package's float32
gradients miss its float64 run by up to 2,000x the contract (VGG) and
7-16% of a leaf's largest element (MobileNet). The
train-mode BatchNorm's own backward is ``F.batch_norm``'s, held against
flax in the ResNets' gradient tests (``test_torch_zoo.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.models.zoo  # noqa: F401  (registers the JAX zoo)
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from fedml_tpu.models.mobilenet_v3 import MobileNetV3 as JaxMobileNetV3
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch.core.trainer import ClassificationTrainer
from fedml_tpu_torch.models import efficientnet
from fedml_tpu_torch.models.efficientnet import EfficientNet
from fedml_tpu_torch.models.mobilenet_v3 import MobileNetV3
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.utils.pytree import is_param

RTOL, ATOL = 2e-5, 1e-5
CLASSES = 10
# added to the eval-mode running variances (see the module docstring);
# MobileNet v1's is 1
VAR_FLOOR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs several
    workers, and a full PyTorch thread pool in each oversubscribes the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(name, dtype="float32", side=32):
    """(JAX module, port module, BatchNorm momentum) with dropout and
    drop-connect off."""
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else None
    if name == "efficientnet":
        return (JaxEfficientNet(output_dim=CLASSES, dropout_rate=0.0, drop_connect_rate=0.0,
                                dtype=jdtype),
                EfficientNet(output_dim=CLASSES, dropout_rate=0.0, drop_connect_rate=0.0,
                             dtype=dtype), 0.99)
    if name.startswith("mobilenet_v3"):
        mode = name.rpartition("-")[2]
        return (JaxMobileNetV3(output_dim=CLASSES, mode=mode, multiplier=0.5, dtype=jdtype),
                MobileNetV3(CLASSES, mode=mode, multiplier=0.5, dtype=dtype), 0.9)
    kw = {"alpha": 0.25} if name == "mobilenet" else {}
    return (jax_create_model(name, output_dim=CLASSES, dtype=dtype, **kw),
            create_model(name, output_dim=CLASSES, dtype=dtype, input_shape=(side, side, 3),
                         **kw), 0.9)


def _batch(side, seed=0, batch=4):
    rng = np.random.RandomState(seed)
    return {"x": rng.normal(size=(batch, side, side, 3)).astype(np.float32),
            "y": rng.randint(0, CLASSES, size=batch).astype(np.int32),
            "mask": np.ones(batch, np.float32)}


def _flax_init(jm, x):
    """flax's init, with the running statistics set to 0."""
    v = jax.jit(lambda r, x: jm.init({"params": r, "dropout": r}, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    v = jax.tree.map(np.asarray, v)
    return {"params": v["params"],
            "batch_stats": jax.tree.map(np.zeros_like, v["batch_stats"])}


def _jax_run(jm, gv, batch, momentum, grads=True, var_floor=VAR_FLOOR):
    """The JAX package on ``batch``, one jit: the train-mode logits and new
    statistics; eval-mode logits at the batch's own statistics (the new
    ones over 1 - momentum: the old ones are 0), and (``grads``) the
    gradients of that eval-mode loss. The running variances get
    ``var_floor`` added."""
    jt = JaxTrainer(jm)

    def run(v, b):
        logits, state = jt.apply(v, b["x"], None, True)
        ev = {**v, "batch_stats": jax.tree_util.tree_map_with_path(
            lambda path, a: a / (1 - momentum) + (var_floor if path[-1].key == "var" else 0),
            state["batch_stats"])}
        out = {"train": logits, "state": state, "eval_stats": ev["batch_stats"],
               "eval": jt.apply(ev, b["x"], None, False)[0]}
        if grads:
            out["eval_grads"] = jax.grad(
                lambda p: jt.loss_fn({**ev, "params": p}, b, None, False)[0])(v["params"])
        return out

    b = {k: jnp.asarray(a) for k, a in batch.items()}
    return jax.tree.map(np.asarray, jax.jit(run)(gv, b))


def _close(got, want, loose=1, err_msg=""):
    """The float32 contract, its atol scaled by the reference's largest
    magnitude where that is over 1 (``loose`` times it where stated)."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=loose * RTOL,
                               atol=loose * ATOL * max(1.0, np.abs(want).max()),
                               err_msg=err_msg)


def _port_grads(tt, variables, batch, train):
    leaves = {k: v.clone().requires_grad_(is_param(k)) for k, v in variables.items()}
    loss, _ = tt.loss_fn(leaves, {k: torch.from_numpy(a) for k, a in batch.items()}, None,
                         train)
    keys = [k for k in leaves if is_param(k)]
    return dict(zip(keys, torch.autograd.grad(loss, [leaves[k] for k in keys])))


CASES = ["vgg11", "vgg16", "mobilenet", "mobilenet_v3-LARGE", "mobilenet_v3-SMALL",
         "efficientnet"]


@pytest.mark.parametrize("name", CASES)
def test_parameter_count_and_conversion_round_trip(name):
    """Equal parameter counts; flax variables (params and batch_stats, drawn
    at the shapes of flax's init) -> the port -> flax, bit for bit,
    depthwise kernels included."""
    jm, tm, _ = _models(name)
    shapes = jax.eval_shape(lambda r, x: jm.init({"params": r, "dropout": r}, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.RandomState(0)
    gv = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), shapes)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree.leaves(gv["params"]))
    tv = flax_to_torch(gv, module=tm)
    assert set(tv) == set(tm.state_dict())
    assert all(tv[k].shape == v.shape for k, v in tm.state_dict().items())
    back = torch_to_flax(tv, module=tm)
    assert jax.tree.structure(back) == jax.tree.structure(gv)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(gv)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", [c for c in CASES if c != "vgg16"])
def test_forward_statistics_and_gradients_match_flax(name):
    """From flax's init: train-mode logits and new statistics; eval-mode
    logits and every gradient of the eval-mode loss at the batch's own
    statistics (see the module docstring for the tolerances)."""
    side = 32 if name.startswith("vgg") else 64
    jm, tm, momentum = _models(name, side=side)
    batch = _batch(side, seed=1)
    gv = _flax_init(jm, batch["x"])
    want = _jax_run(jm, gv, batch, momentum,
                    var_floor=1.0 if name == "mobilenet" else VAR_FLOOR)
    tt = ClassificationTrainer(tm)
    x = torch.from_numpy(batch["x"])
    got, state = tt.apply(flax_to_torch(gv, module=tm), x, None, True)
    loose = 5 if name == "mobilenet" else 1
    _close(got.detach().numpy(), want["train"], loose)
    want_state = flax_to_torch(want["state"], module=tm)
    assert set(state) == set(want_state) and state
    for k, w in want_state.items():
        _close(state[k].numpy(), w.numpy(), loose, k)
    ev = flax_to_torch({"params": gv["params"], "batch_stats": want["eval_stats"]}, module=tm)
    got, new = tt.apply(ev, x, None, False)
    assert new == {} and np.abs(want["eval"]).max() > 0.3
    _close(got.detach().numpy(), want["eval"])
    grads = _port_grads(tt, ev, batch, train=False)
    want_grads = flax_to_torch({"params": want["eval_grads"]}, module=tm)
    assert set(grads) == set(want_grads)
    for k, w in want_grads.items():
        _close(grads[k].numpy(), w.numpy(), err_msg=k)


@pytest.mark.parametrize("name", ["mobilenet", "efficientnet"])
def test_bf16_eval_forward_matches_flax(name):
    """bfloat16 compute: eval logits at the batch's own statistics within
    0.2 absolute (see the module docstring), in the compute dtype."""
    jm, tm, momentum = _models(name, "bfloat16", side=64)
    batch = _batch(64)
    gv = _flax_init(jm, batch["x"])
    want = _jax_run(jm, gv, batch, momentum, grads=False)
    ev = flax_to_torch({"params": gv["params"], "batch_stats": want["eval_stats"]}, module=tm)
    got, _ = ClassificationTrainer(tm).apply(ev, torch.from_numpy(batch["x"]), None, False)
    assert got.dtype == torch.bfloat16 and np.abs(want["eval"]).max() > 0.3
    np.testing.assert_allclose(got.float().numpy(), want["eval"].astype(np.float32), rtol=0,
                               atol=0.2)


@pytest.mark.parametrize("side", [32, 33])
def test_efficientnet_same_padding(side):
    """flax's SAME padding, at an even and an odd input side. At 32 every
    stride-2 conv pads asymmetrically (the 3x3 stem 0 before and 1 after,
    the 5x5 depthwise of an 8x8 map 1 and 2), and a symmetric padding (a
    ``Conv2d(padding=k // 2)``'s) moves the eval logits far outside the
    contract (the control); at 33 the sides stay odd down the net and each
    pad is symmetric. Eval logits at both sides, train logits at 33 (whose
    last stage is 2x2), within the contract."""
    jm, tm, momentum = _models("efficientnet")
    batch = _batch(side, seed=2)
    gv = _flax_init(jm, batch["x"])
    want = _jax_run(jm, gv, batch, momentum, grads=False)
    tt = ClassificationTrainer(tm)
    x = torch.from_numpy(batch["x"])
    ev = flax_to_torch({"params": gv["params"], "batch_stats": want["eval_stats"]}, module=tm)
    got = tt.apply(ev, x, None, False)[0].detach().numpy()
    _close(got, want["eval"])
    probe = torch.ones(1, 1, side, side)
    padded = efficientnet.same_pad(probe, 3, 2)
    if side == 32:
        assert padded.shape[-2:] == (33, 33) and padded[0, 0, 0, 0] == 1
        assert padded[0, 0, -1].abs().sum() == 0 and padded[0, 0, :, -1].abs().sum() == 0
        assert efficientnet.same_pad(torch.ones(1, 1, 8, 8), 5, 2).shape[-2:] == (11, 11)
        assert efficientnet.same_pad(torch.ones(1, 1, 8, 8), 5, 2)[0, 0, 1, 1] == 1

        def symmetric(x, kernel, stride):
            return torch.nn.functional.pad(x, [kernel // 2] * 4)

        orig = efficientnet.same_pad
        efficientnet.same_pad = symmetric
        try:
            wrong = tt.apply(ev, x, None, False)[0].detach().numpy()
        finally:
            efficientnet.same_pad = orig
        assert np.abs(wrong - want["eval"]).max() > 100 * ATOL * np.abs(want["eval"]).max()
    else:
        assert padded.shape[-2:] == (35, 35)
        got, _ = tt.apply(flax_to_torch(gv, module=tm), x, None, True)
        _close(got.detach().numpy(), want["train"])
