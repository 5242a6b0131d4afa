"""The DARTS search space of the port (``fedml_tpu_torch/models/darts.py``)
against the JAX package's (``fedml_tpu/models/darts.py``) on the CPU, at
tiny sizes: 4 channels, 8x8 inputs, and for the network 3 cells (cells 1
and 2 reduce, cell 2 after a reduction) of steps 2 and multiplier 2.

Both sides run from the same variables: the port's initialisation,
converted with ``utils/convert.py::torch_to_flax`` (flax's own init of the
search network takes tens of seconds eagerly on the CPU). Inputs are made
with numpy from a seed. Tolerances: rtol 2e-5 / atol 1e-5 for forwards and
for the network's gradients, rtol 1e-4 / atol 1e-5 for the gumbel sample's
gradient through its 1/tau softmax; the genotype and the hard one-hot are
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from fedml_tpu.models import darts as jd
from fedml_tpu_torch.core.trainer import flax_default_init
from fedml_tpu_torch.models import darts as td
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax

RTOL, ATOL = 2e-5, 1e-5
C, SIDE, BATCH = 4, 8, 4
LAYERS, STEPS, MULT, CLASSES = 3, 2, 2, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite's workers share
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(module, seed=0):
    """(port variables, the same as a flax params tree of jnp arrays)."""
    tv = flax_default_init(module, torch.Generator().manual_seed(seed), "cpu")
    return tv, jax.tree.map(jnp.asarray, torch_to_flax(tv, module)["params"])


def _x(shape, seed=0):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _close(got_nchw, want_nhwc, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got_nchw.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_nhwc), rtol=rtol, atol=atol)


#: each candidate op but 'none' (the MixedOp test weights 'none' too):
#: (port module or None for a pool, flax module or None)
def _op(prim, stride):
    if prim == "skip_connect":
        return (td.FactorizedReduce(C, C), jd.FactorizedReduce(C)) if stride == 2 else None
    kind, _, k = prim.partition("_conv_")
    if kind == "sep":
        return td.SepConv(C, C, int(k[0]), stride), jd.SepConv(C, int(k[0]), stride)
    if kind == "dil":
        return td.DilConv(C, C, int(k[0]), stride, 2), jd.DilConv(C, int(k[0]), stride, 2)
    return None


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("prim", td.PRIMITIVES[1:])
def test_each_primitive_matches_jax(prim, stride):
    """Each candidate op at stride 1 and 2 (the pools with the affine-free
    standardization the MixedOp gives them; skip at stride 1 is the
    identity)."""
    x = _x((BATCH, SIDE, SIDE, C), seed=td.PRIMITIVES.index(prim))
    if prim in ("max_pool_3x3", "avg_pool_3x3"):
        kind = prim[:3]
        got = td._bn(td._pool(_nchw(x), kind, stride))
        want = jd._bn(jd._pool(jnp.asarray(x), kind, stride))
    elif prim == "skip_connect" and stride == 1:
        return
    else:
        tm, jm = _op(prim, stride)
        tv, jv = _variables(tm, seed=stride)
        got = functional_call(tm, tv, (_nchw(x),))
        want = jm.apply({"params": jv}, jnp.asarray(x))
    assert tuple(got.shape) == (BATCH, C, SIDE // stride, SIDE // stride)
    _close(got, want)


@pytest.mark.parametrize("stride", [1, 2])
def test_mixed_op_matches_jax(stride):
    """The weighted mix of the ops, 'none' given a weight of its own."""
    x = _x((BATCH, SIDE, SIDE, C), seed=3)
    w = np.random.RandomState(4).dirichlet(np.ones(len(td.PRIMITIVES))).astype(np.float32)
    tm, jm = td.MixedOp(C, stride), jd.MixedOp(stride=stride)
    tv, jv = _variables(tm, seed=5)
    assert ("FactorizedReduce_0.Conv_0.weight" in tv) == (stride == 2)
    got = functional_call(tm, tv, (_nchw(x), torch.from_numpy(w)))
    _close(got, jm.apply({"params": jv}, jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("reduction,reduction_prev", [(False, False), (True, False),
                                                      (True, True), (False, True)])
def test_cell_matches_jax(reduction, reduction_prev):
    """A cell with and without a reduction before it (s0 then comes at
    twice s1's side through ``FactorizedReduce_0``, s1 through
    ``ReLUConvBN_0``), reducing or not."""
    c_pp, c_p = 6, 8
    side0 = SIDE * (2 if reduction_prev else 1)
    s0 = _x((BATCH, side0, side0, c_pp), seed=6)
    s1 = _x((BATCH, SIDE, SIDE, c_p), seed=7)
    k = sum(2 + i for i in range(STEPS))
    w = np.random.RandomState(8).dirichlet(np.ones(len(td.PRIMITIVES)), k).astype(np.float32)
    tm = td.Cell(c_pp, c_p, C, reduction, reduction_prev, STEPS, MULT)
    jm = jd.Cell(channels=C, reduction=reduction, reduction_prev=reduction_prev,
                 steps=STEPS, multiplier=MULT)
    tv, jv = _variables(tm, seed=9)
    first = {"FactorizedReduce_0" if reduction_prev else "ReLUConvBN_1"}
    assert first < {key.split(".")[0] for key in tv}
    got = functional_call(tm, tv, (_nchw(s0), _nchw(s1), torch.from_numpy(w)))
    want = jm.apply({"params": jv}, jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(w))
    assert tuple(got.shape) == (BATCH, MULT * C) + (SIDE // (2 if reduction else 1),) * 2
    _close(got, want)


@pytest.fixture(scope="module")
def network_case():
    """The network at the tiny size, its variables, inputs, alphas and a
    probe of the logits; the JAX side's logits and gradients of
    sum(logits * probe) with respect to params and both alphas (one jitted
    program)."""
    tm = td.DARTSNetwork(CLASSES, C, LAYERS, STEPS, MULT)
    jm = jd.DARTSNetwork(output_dim=CLASSES, channels=C, layers=LAYERS, steps=STEPS,
                         multiplier=MULT)
    tv, jv = _variables(tm, seed=10)
    rng = np.random.RandomState(11)
    x = rng.normal(size=(BATCH, SIDE, SIDE, 3)).astype(np.float32)
    k = tm.num_edges
    an, ar = (rng.normal(size=(k, len(td.PRIMITIVES))).astype(np.float32) for _ in range(2))
    probe = rng.normal(size=(BATCH, CLASSES)).astype(np.float32)

    def loss(p, a_n, a_r):
        logits = jm.apply({"params": p}, jnp.asarray(x), a_n, a_r)
        return (logits * probe).sum(), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jv, jnp.asarray(an), jnp.asarray(ar))
    return dict(tm=tm, tv=tv, x=x, an=an, ar=ar, probe=probe, logits=np.asarray(logits),
                grads=grads)


def test_network_logits_and_gradients_match_jax(network_case):
    """DARTSNetwork's logits, and the gradients of a probe of them with
    respect to every parameter and to both alphas."""
    case = network_case
    tm = case["tm"]
    assert {k for k in case["tv"] if k.startswith("cell2.")} >= {
        "cell2.FactorizedReduce_0.Conv_0.weight", "cell2.ReLUConvBN_0.Conv_0.weight",
        "cell2.MixedOp_0.FactorizedReduce_0.Conv_1.weight"}
    params = {k: v.clone().requires_grad_() for k, v in case["tv"].items()}
    an = torch.from_numpy(case["an"]).requires_grad_()
    ar = torch.from_numpy(case["ar"]).requires_grad_()
    logits = functional_call(tm, params, (torch.from_numpy(case["x"]), an, ar))
    np.testing.assert_allclose(logits.detach().numpy(), case["logits"], rtol=RTOL, atol=ATOL)
    (logits * torch.from_numpy(case["probe"])).sum().backward()
    gp, g_an, g_ar = case["grads"]
    want = flax_to_torch(gp, module=tm)
    assert set(want) == set(params)
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(an.grad.numpy(), np.asarray(g_an), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ar.grad.numpy(), np.asarray(g_ar), rtol=RTOL, atol=ATOL)


def test_given_mixing_weights_replace_the_softmax(network_case):
    """Weights equal to the alphas' softmax give the same logits, as 2-D
    rows for every cell or as a 3-D [layers, k, ops] stack; another row
    for one cell changes them."""
    case = network_case
    tm, tv = case["tm"], case["tv"]
    x, an, ar = (torch.from_numpy(case[k]) for k in ("x", "an", "ar"))
    base = functional_call(tm, tv, (x, an, ar))
    wn, wr = torch.softmax(an, -1), torch.softmax(ar, -1)
    got = functional_call(tm, tv, (x, an, ar), {"weights_normal": wn, "weights_reduce": wr})
    torch.testing.assert_close(got, base, rtol=0, atol=0)
    wn3, wr3 = wn.expand(LAYERS, -1, -1).clone(), wr.expand(LAYERS, -1, -1).clone()
    got = functional_call(tm, tv, (x, an, ar), {"weights_normal": wn3, "weights_reduce": wr3})
    torch.testing.assert_close(got, base, rtol=0, atol=0)
    wn3[0] = torch.flip(wn3[0], [-1])
    got = functional_call(tm, tv, (x, an, ar), {"weights_normal": wn3, "weights_reduce": wr3})
    assert not torch.allclose(got, base)


@pytest.mark.parametrize("steps,multiplier,seed", [(2, 2, 0), (4, 4, 1), (4, 4, 2), (3, 2, 3)])
def test_parse_genotype_matches_jax(steps, multiplier, seed):
    """The genotype of the same alphas (as float32 tensors and as numpy),
    exactly."""
    k = sum(2 + i for i in range(steps))
    rng = np.random.RandomState(seed)
    an, ar = (rng.normal(size=(k, len(td.PRIMITIVES))).astype(np.float32) for _ in range(2))
    want = jd.parse_genotype(jnp.asarray(an), jnp.asarray(ar), steps, multiplier)
    assert td.parse_genotype(torch.from_numpy(an), torch.from_numpy(ar), steps,
                             multiplier) == want
    assert td.parse_genotype(an, ar, steps, multiplier) == want
    assert want.normal_concat == list(range(2 + steps - multiplier, steps + 2))


@pytest.mark.parametrize("num", [None, LAYERS])
def test_gumbel_softmax_st_matches_jax_with_injected_noise(num):
    """JAX's uniforms (from its key) injected into the port: the forward is
    the same hard one-hot, the gradient of a probe that of the soft
    sample."""
    k = sum(2 + i for i in range(STEPS))
    rng = np.random.RandomState(12)
    alphas = rng.normal(size=(k, len(td.PRIMITIVES))).astype(np.float32)
    shape = alphas.shape if num is None else (num,) + alphas.shape
    probe = rng.normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, shape, minval=1e-10, maxval=1.0))

    def f(a):
        out = jd.gumbel_softmax_st(key, a, 5.0, num=num)
        return (out * probe).sum(), out

    (_, want), g_want = jax.value_and_grad(f, has_aux=True)(jnp.asarray(alphas))
    a = torch.from_numpy(alphas).requires_grad_()
    got = td.gumbel_softmax_st(a, 5.0, num=num, uniform=torch.from_numpy(u.copy()))
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    hard = got.detach().round()
    assert bool((hard.sum(-1) == 1).all()) and float((got.detach() - hard).abs().max()) < 1e-6
    (got * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g_want), rtol=1e-4, atol=ATOL)


def test_gumbel_draws_and_init_alphas_come_from_the_generator():
    """The port's own draws: a generator gives the same sample twice and a
    one-hot a row; init_alphas is 1e-3 * randn of [k, ops] twice."""
    alphas = torch.zeros(5, len(td.PRIMITIVES))
    a = td.gumbel_softmax_st(alphas, num=LAYERS, generator=torch.Generator().manual_seed(1))
    b = td.gumbel_softmax_st(alphas, num=LAYERS, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (LAYERS, 5, len(td.PRIMITIVES))
    assert bool((a.round().sum(-1) == 1).all()) and float((a - a.round()).abs().max()) < 1e-6
    an, ar = td.init_alphas(torch.Generator().manual_seed(0), steps=4)
    assert an.shape == ar.shape == (14, len(td.PRIMITIVES))
    assert 0 < float(an.abs().max()) < 1e-2 and not torch.equal(an, ar)


@pytest.mark.parametrize("kernel,stride,dilation", [(3, 1, 1), (5, 2, 1), (3, 1, 2),
                                                    (5, 2, 2)])
def test_depthwise_conv_differentiates_twice(kernel, stride, dilation):
    """``_Depthwise``: its forward and first derivatives are
    ``F.conv2d(groups=C)``'s bit for bit, and its backward, written in
    differentiable ops for the unrolled step, passes float64 gradcheck and
    gradgradcheck."""
    pad = (kernel - 1) * dilation // 2
    gen = torch.Generator().manual_seed(kernel + stride + dilation)
    x = torch.randn(2, 3, 9, 9, generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn(3, 1, kernel, kernel, generator=gen, dtype=torch.float64,
                    requires_grad=True)

    def conv(a, b):
        return td._Depthwise.apply(a, b, stride, pad, dilation)

    got, want = conv(x, w), torch.nn.functional.conv2d(x, w, None, stride, pad, dilation, 3)
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=gen, dtype=torch.float64)
    for a, b in zip(torch.autograd.grad(got, (x, w), g), torch.autograd.grad(want, (x, w), g)):
        assert torch.equal(a, b)
    assert torch.autograd.gradcheck(conv, (x, w))
    assert torch.autograd.gradgradcheck(conv, (x, w))
