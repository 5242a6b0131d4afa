"""The port's model zoo beyond the FEMNIST CNN and the NWP transformer —
the linear models, the FedAvg, CIFAR and HAR CNNs, the ResNets with their
BatchNorm state or GroupNorm, and the LSTMs — against the JAX package's, on
the same seeded numpy inputs and weights (drawn at the shapes of flax's
init), carried across with the converter.

Tolerances: float32 forwards rtol 2e-5 / atol 1e-5 (the reference's
contract, tests/test_fused_sgd.py:76) unless a case states more. A
train-mode BatchNorm normalises by statistics of the batch, which each
side sums in its own order; every layer passes the difference on, scaled
by 1/std. So train-mode ResNet logits and statistics differ by more, and
more with depth (see ``test_small_resnet_gradients_match_jax`` for when
float32 is itself ill-conditioned there). Measured largest absolute gaps
in train mode, one PyTorch thread (logits; statistics): resnet20 6.7e-5;
1.2e-5, resnet32 3.9e-5; 6.2e-6, resnet44 1.5e-4; 3.3e-5, resnet56_s2d
7.2e-4; 1.2e-4, resnet110 3.8e-3; 3.7e-3, resnet18 6.2e-5; 2.7e-5,
resnet34 3.5e-4; 3.7e-5, resnet50 4.1e-3; 3.5e-4, resnet18_gn 8.5e-6;
each case's tolerance is 2.5-7.5x its gap. Eval mode holds every model
within the float32 contract (largest gap 9.5e-6, resnet34). With a last
stage of 1x1 (a 24x24 input to the ImageNet-style nets) a statistic over
2 values is ill-conditioned (E[x^2] - E[x]^2 cancels) and the two sides
part by 1e-1, so those cases run at 64x64. bf16 forwards are held at
5e-2 absolute on logits of magnitude about 1, as ``test_torch_models.py``
holds the CNN: XLA and PyTorch round bf16 products of different summation
orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.models.zoo  # noqa: F401  (registers the JAX zoo)
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.core.trainer import NWPTrainer as JaxNWPTrainer
from fedml_tpu.models import resnet as jax_resnet
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch.core.trainer import ClassificationTrainer, NWPTrainer
from fedml_tpu_torch.models import resnet
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs several
    workers on the machine's cores, and PyTorch's CPU thread pool, sized to
    every core in each worker, oversubscribes them (these tests' many small
    ops then run many times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# name, sample shape, output_dim, kwargs, integer tokens, (train rtol, atol)
CASES = [
    ("lr", (784,), 10, {}, False, (2e-5, 1e-5)),
    ("mlp", (784,), 10, {}, False, (2e-5, 1e-5)),
    ("purchasemlp", (600,), 100, {}, False, None),
    ("texasmlp", (6169,), 100, {}, False, None),
    ("cnn_fedavg", (28, 28, 1), 10, {}, False, (2e-5, 1e-5)),
    ("cnn_cifar", (32, 32, 3), 10, {}, False, (2e-5, 1e-5)),
    ("har_cnn", (128, 9), 6, {}, False, None),
    ("resnet20", (32, 32, 3), 10, {}, False, (5e-4, 5e-4)),
    ("resnet32", (16, 16, 3), 10, {}, False, (2e-4, 2e-4)),
    ("resnet44", (16, 16, 3), 10, {}, False, (5e-4, 5e-4)),
    ("resnet56_s2d", (32, 32, 3), 10, {}, False, (2e-3, 2e-3)),
    ("resnet110", (16, 16, 3), 10, {}, False, (1e-2, 1e-2)),
    ("resnet18", (64, 64, 3), 10, {}, False, (3e-4, 3e-4)),
    ("resnet34", (64, 64, 3), 10, {}, False, (1e-3, 1e-3)),
    ("resnet50", (64, 64, 3), 10, {}, False, (1e-2, 1e-2)),
    ("resnet18_gn", (64, 64, 3), 100, {}, False, (5e-5, 5e-5)),
    ("rnn", (80,), 90, {"vocab_size": 90}, True, (2e-5, 1e-5)),
    ("rnn", (80,), 90, {"vocab_size": 90, "per_position": True}, True, (2e-5, 1e-5)),
    ("rnn_stackoverflow", (20,), 10004, {}, True, (2e-5, 1e-5)),
]
_ID = [f"{c[0]}{'-per_position' if c[3].get('per_position') else ''}" for c in CASES]


def _inputs(shape, batch, tokens, vocab, seed=0):
    rng = np.random.RandomState(seed)
    if tokens:
        return rng.randint(0, vocab, size=(batch,) + shape).astype(np.int32)
    return rng.normal(size=(batch,) + shape).astype(np.float32)


def _variables(jm, x0, seed=0):
    """A flax variables tree for ``jm`` of seeded numpy draws, at the
    shapes ``jm.init`` gives (``jax.eval_shape``: compiling a deep net's
    init costs more than the test): kernels and embeddings normal over
    sqrt(fan-in), biases and BatchNorm means 0.1 normal, scales and
    variances 1 + 0.1 |normal|, so eval mode reads non-trivial running
    statistics."""
    shapes = jax.eval_shape(lambda r, x: jm.init({"params": r, "dropout": r}, x, train=False),
                            jax.random.PRNGKey(0), jnp.asarray(x0))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        z = rng.normal(size=leaf.shape).astype(np.float32)
        name = path[-1].key
        if name in ("scale", "var"):
            return jnp.asarray(1 + 0.1 * np.abs(z))
        if name in ("bias", "mean"):
            return jnp.asarray(0.1 * z)
        return jnp.asarray(z / np.sqrt(max(1, int(np.prod(leaf.shape[:-1])))))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(name, shape, out, kw, dtype="float32", seed=0, tokens=False):
    jm = jax_create_model(name, output_dim=out, dtype=dtype, **kw)
    gv = _variables(jm, _inputs(shape, 1, tokens, kw.get("vocab_size", 10000), seed), seed)
    tm = create_model(name, output_dim=out, dtype=dtype, input_shape=shape, **kw)
    return jm, gv, tm, flax_to_torch(gv, module=tm)


def _japply(jm, gv, x, train):
    """The JAX trainer's apply, jitted (XLA compiles a ResNet faster than
    it runs one eagerly)."""
    return jax.jit(lambda v, x: JaxTrainer(jm).apply(v, x, None, train))(gv, jnp.asarray(x))


def _state_close(tstate, jstate, module, rtol, atol):
    want = flax_to_torch({"batch_stats": jstate["batch_stats"]}, module=module)
    assert set(tstate) == set(want)
    for k in want:
        np.testing.assert_allclose(tstate[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("name,shape,out,kw,tokens,train_tol", CASES, ids=_ID)
def test_forward_matches_flax(name, shape, out, kw, tokens, train_tol):
    """Eval mode (running statistics) and, where the model has no dropout,
    train mode with the new BatchNorm state; in train mode a BatchNorm
    net's batch ends in a padding row, which goes through whole, as the
    engine feeds it."""
    batch = 2 if name in ("resnet110", "resnet34", "resnet50") else 4
    jm, gv, tm, tv = _pair(name, shape, out, kw, tokens=tokens)
    x = _inputs(shape, batch, tokens, kw.get("vocab_size", 10000), seed=1)
    tt = ClassificationTrainer(tm)
    want, _ = _japply(jm, gv, x, False)
    got, state = tt.apply(tv, torch.from_numpy(x), None, False)
    assert state == {} and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=1e-5)
    if train_tol is None:  # dropout: the two packages' streams differ
        return
    if name in ("resnet34", "resnet50", "resnet18_gn", "resnet18"):
        batch = 8  # enough values per channel at the last 2x2 stage
        x = _inputs(shape, batch, tokens, 10, seed=1)
    if "resnet" in name and "_gn" not in name:
        # a padding row enters the batch statistics (a GroupNorm's are per
        # sample, and an all-zero sample's are ill-conditioned: var ~ 0)
        x[-1] = 0
    want, jstate = _japply(jm, gv, x, True)
    got, state = tt.apply(tv, torch.from_numpy(x), None, True)
    rtol, atol = train_tol
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)
    if jstate:
        _state_close(state, jstate, tm, rtol, atol)
    else:
        assert state == {}


def test_resnet56_full_depth_batch_two():
    """The cross-silo model at its published depth and widths (58
    BatchNorms: the stem, three a block and three shortcuts) on a batch of 2 CIFAR images: eval logits,
    train logits and the 116 new statistics. Tolerance 3e-4 (measured
    6.0e-5 on the logits, 1.2e-5 on the statistics): 57 train-mode
    normalisations, see the module docstring."""
    jm, gv, tm, tv = _pair("resnet56", (32, 32, 3), 10, {})
    assert sum(v.numel() for k, v in tv.items() if k.rpartition(".")[2] not in
               ("mean", "var")) == sum(a.size for a in jax.tree.leaves(gv["params"]))
    x = _inputs((32, 32, 3), 2, False, 10, seed=3)
    tt = ClassificationTrainer(tm)
    for train in (False, True):
        want, jstate = _japply(jm, gv, x, train)
        got, state = tt.apply(tv, torch.from_numpy(x), None, train)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=3e-4,
                                   atol=3e-4)
        assert len(state) == (116 if train else 0)
        if train:
            _state_close(state, jstate, tm, 3e-4, 3e-4)


def _small(kind, group_norm):
    """(JAX module, port module, sample shape) with one block a stage."""
    if kind == "cifar":
        return (jax_resnet.ResNetCifar(block=jax_resnet.BasicBlock, layers=(1, 1, 1),
                                       output_dim=5, group_norm=group_norm),
                resnet.ResNetCifar(resnet.BasicBlock, (1, 1, 1), 5, group_norm), (16, 16, 3))
    jblock, tblock = ((jax_resnet.Bottleneck, resnet.Bottleneck) if kind == "bottleneck"
                      else (jax_resnet.BasicBlock, resnet.BasicBlock))
    return (jax_resnet.ResNetImageNet(block=jblock, layers=(1, 1, 1, 1), output_dim=5,
                                      group_norm=group_norm),
            resnet.ResNetImageNet(tblock, (1, 1, 1, 1), 5, group_norm), (64, 64, 3))


@pytest.mark.parametrize("kind,group_norm", [("cifar", 0), ("cifar", 2), ("imagenet", 0),
                                             ("imagenet", 2), ("bottleneck", 0)])
def test_small_resnet_gradients_match_jax(kind, group_norm):
    """ResNetCifar and ResNetImageNet (BasicBlock; Bottleneck, resnet50's)
    with one block a stage, BatchNorm and GroupNorm, at flax's init: the
    masked train loss, every parameter's gradient and the new statistics.
    A padding row (mask 0) enters the batch statistics but not the loss.
    Gradients within 1e-4 of each one's largest element (measured 2.0e-6
    to 2.9e-5); the loss within rtol 1e-5.

    Two conditions keep float32 meaningful here. In the ImageNet-style
    BatchNorm nets an all-zero row leaves channels whose batch statistics
    it alone sets, and the gradients then hang on summation order (the
    port with one thread moves 5-8% of a leaf's largest element from a
    float64 run), so those two cases run without one; and drawn weights
    with running statistics away from 0 and 1 do the same to the
    Bottleneck net, so these cases start from flax's init. The JAX
    package's own float32 gradients of the Bottleneck net on the CPU still
    miss its float64 run by 0.30 of Bottleneck_3.Conv_3's largest element
    where the port is within 2.9e-5 (ROADMAP Queue 3), so that case is held
    to the JAX package run in float64; the rest to its float32 run."""
    jm, tm, shape = _small(kind, group_norm)
    rng = np.random.RandomState(5)
    x = rng.normal(size=(6,) + shape).astype(np.float32)
    y = rng.randint(0, 5, size=6).astype(np.int32)
    mask = np.ones(6, np.float32)
    if kind == "cifar" or group_norm:
        x[-1], mask[-1] = 0, 0  # a padding row
    gv = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))  # flax's init
    tv = flax_to_torch(gv, module=tm)
    ftype = jnp.float64 if kind == "bottleneck" else jnp.float32
    with jax.enable_x64(ftype == jnp.float64):
        jv = jax.tree.map(lambda a: jnp.asarray(a, ftype), gv)

        def jloss(params):
            return JaxTrainer(jm).loss_fn(
                {**jv, "params": params},
                {"x": jnp.asarray(x, ftype), "y": jnp.asarray(y),
                 "mask": jnp.asarray(mask, ftype)}, None, True)

        (jl, (jstate, _)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jv["params"])
        want = flax_to_torch({"params": jgrads}, module=tm)
        jl = float(jl)
        want_state = (flax_to_torch({"batch_stats": jstate["batch_stats"]}, module=tm)
                      if jstate else {})
    leaves = {k: v.clone().requires_grad_(k.rpartition(".")[2] not in ("mean", "var"))
              for k, v in tv.items()}
    tl, (state, _) = ClassificationTrainer(tm).loss_fn(
        leaves, {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                 "mask": torch.from_numpy(mask)}, None, True)
    keys = [k for k, v in leaves.items() if v.requires_grad]
    grads = dict(zip(keys, torch.autograd.grad(tl, [leaves[k] for k in keys])))
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-5)
    assert set(want) == set(grads)
    for k in want:
        gap = float((grads[k] - want[k]).abs().max())
        assert gap <= 1e-4 * float(want[k].abs().max()), (k, gap)
    assert set(state) == set(want_state) and bool(state) == (group_norm == 0)
    for k in want_state:
        np.testing.assert_allclose(state[k].numpy(), want_state[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name,per_position", [("rnn", False), ("rnn", True),
                                               ("rnn_stackoverflow", True)])
def test_lstm_gradients_match_jax(name, per_position):
    """Both LSTMs through their trainers' losses (the next-char classifier,
    or NWP over positions with pad id 0): loss and every gradient, the
    embedding's row 0 included (flax's Embed has no padding index)."""
    kw = {"vocab_size": 90, "per_position": per_position} if name == "rnn" else {}
    seq = 80 if name == "rnn" else 20
    vocab = 90 if name == "rnn" else 10004
    jm, gv, tm, tv = _pair(name, (seq,), vocab, kw, tokens=True)
    rng = np.random.RandomState(2)
    x = rng.randint(0, vocab, size=(3, seq)).astype(np.int32)
    x[:, :3] = 0
    y = (rng.randint(0, vocab, size=(3, seq)) if per_position
         else rng.randint(0, vocab, size=3)).astype(np.int32)
    mask = np.array([1, 1, 0], np.float32)
    if per_position:
        jt, tt = JaxNWPTrainer(jm), NWPTrainer(tm)
    else:
        jt, tt = JaxTrainer(jm), ClassificationTrainer(tm)

    def jloss(params):
        return jt.loss_fn({"params": params}, {"x": jnp.asarray(x), "y": jnp.asarray(y),
                                               "mask": jnp.asarray(mask)}, None, True)

    (jl, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(gv["params"])
    leaves = {k: v.clone().requires_grad_(True) for k, v in tv.items()}
    tl, _ = tt.loss_fn(leaves, {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                                "mask": torch.from_numpy(mask)}, None, True)
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    want = flax_to_torch({"params": jgrads}, module=tm)
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    emb = "embeddings.weight" if name == "rnn" else "word_embeddings.weight"
    assert grads[emb][0].abs().sum() > 0


def test_lstm_cudnn_route_matches_the_cell():
    """The float32 route (``torch._VF.lstm``; on the CPU its native kernel)
    computes what the per-step cell, bf16's route, does in float32, forward
    and gradients; it refuses bf16, whose carry it cannot keep in float32."""
    from fedml_tpu_torch.core.trainer import flax_default_init
    from fedml_tpu_torch.models.rnn import OptimizedLSTMCell

    model = create_model("rnn", 90)
    model.load_state_dict(flax_default_init(model, torch.Generator().manual_seed(0), "cpu"))
    layer = model.OptimizedLSTMCell_1
    x = torch.randn(4, 80, 256, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    a, b = layer._cell(x), layer._cudnn(x)
    torch.testing.assert_close(b, a, rtol=2e-5, atol=1e-5)
    wrt = [x, *layer.parameters()]
    ga = torch.autograd.grad(a.square().sum(), wrt)
    gb = torch.autograd.grad(b.square().sum(), wrt)
    for u, w in zip(ga, gb):
        torch.testing.assert_close(w, u, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="float32 LSTM only"):
        OptimizedLSTMCell(8, 16, torch.bfloat16)._cudnn(torch.zeros(2, 3, 8))


@pytest.mark.parametrize("name,shape,out,kw,tokens", [
    ("lr", (784,), 10, {}, False),
    ("cnn_cifar", (32, 32, 3), 10, {}, False),
    ("resnet20", (32, 32, 3), 10, {}, False),
    ("resnet18_gn", (64, 64, 3), 100, {}, False),
    ("rnn", (80,), 90, {"vocab_size": 90}, True),
], ids=["linear", "cnn", "resnet-bn", "resnet-gn", "lstm"])
def test_bfloat16_forward(name, shape, out, kw, tokens):
    """bf16 compute with float32 parameters, eval mode, one model of each
    family: the logits' dtype is the JAX model's, and they agree within
    5e-2 absolute (see the module docstring), 1e-1 for the 18-layer
    GroupNorm ResNet (measured 5.5e-2 in one of 400 logits: more bf16
    roundings in a row)."""
    jm, gv, tm, tv = _pair(name, shape, out, kw, dtype="bfloat16", tokens=tokens)
    x = _inputs(shape, 4, tokens, kw.get("vocab_size", 10), seed=4)
    want, _ = _japply(jm, gv, x, False)
    got, _ = ClassificationTrainer(tm).apply(tv, torch.from_numpy(x))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert all(v.dtype == torch.float32 for v in tv.values())
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=1e-1 if name == "resnet18_gn" else 5e-2)


@pytest.mark.parametrize("name,shape,kw,tokens", [
    ("resnet20", (16, 16, 3), {}, False), ("resnet18_gn", (32, 32, 3), {}, False),
    ("rnn", (10,), {"vocab_size": 90}, True), ("har_cnn", (128, 9), {}, False)])
def test_convert_round_trip_stacked(name, shape, kw, tokens):
    """flax -> port -> flax gives the same tree, bit for bit, for a single
    model and for a client-stacked one (leading axis 3): BatchNorm state,
    norm scales, LSTM gates and 1-D conv kernels included."""
    jm, gv, tm, tv = _pair(name, shape, 10 if name != "rnn" else 90, kw, tokens=tokens)
    gv = jax.tree.map(np.asarray, dict(gv))
    stacked = jax.tree.map(lambda a: np.stack([a, a + 1, a * 2]), gv)
    for tree in (gv, stacked):
        back = torch_to_flax(flax_to_torch(tree, module=tm), tm)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a, b)
    module_keys = set(dict(tm.named_parameters())) | set(dict(tm.named_buffers()))
    assert set(tv) == module_keys


def test_init_follows_flax_laws():
    """The port's own init: BatchNorm scale 1, bias 0, mean 0, var 1; GroupNorm
    scale 1; each LSTM gate's hidden kernel orthogonal, input kernels at
    lecun-normal scale, bias 0."""
    from fedml_tpu_torch.core.trainer import flax_default_init

    gen = torch.Generator().manual_seed(0)
    v = flax_default_init(create_model("resnet20", 10), gen, "cpu")
    assert torch.equal(v["_Norm_0.BatchNorm_0.weight"], torch.ones(16))
    assert torch.equal(v["_Norm_0.BatchNorm_0.var"], torch.ones(16))
    assert torch.equal(v["BasicBlock_3._Norm_1.BatchNorm_0.mean"], torch.zeros(32))
    g = flax_default_init(create_model("resnet18_gn", 100), gen, "cpu")
    assert torch.equal(g["_Norm_0.GroupNorm_0.weight"], torch.ones(64))
    r = flax_default_init(create_model("rnn", 90), gen, "cpu")
    for gate in range(4):
        w = r["OptimizedLSTMCell_1.weight_hh"][gate * 256:(gate + 1) * 256]
        torch.testing.assert_close(w @ w.T, torch.eye(256), atol=1e-4, rtol=0)
    std = float(r["OptimizedLSTMCell_0.weight_ih"].std())
    assert abs(std - 1 / np.sqrt(8)) < 0.05
    assert torch.equal(r["OptimizedLSTMCell_0.bias"], torch.zeros(1024))


def test_unported_zoo_names_raise():
    """Every name of the JAX zoo builds (FedSeg's ``deeplab`` and ``fcn``
    were the last: ``test_torch_fedseg.py``; the CV nets:
    ``test_torch_cv_models.py``); a name outside it raises."""
    import re

    import fedml_tpu.models.zoo as jax_zoo

    names = re.findall(r'register_model\("(\w+)"\)', open(jax_zoo.__file__).read())
    assert {"deeplab", "fcn"} <= set(names)
    for name in ("deeplab", "fcn"):
        assert create_model(name, output_dim=10).output_dim == 10
    with pytest.raises(NotImplementedError):
        create_model("no_such_model", output_dim=10)
