"""The port's server rules (FedOpt with every server optimizer, FedNova,
robust aggregation) against the JAX package's aggregators, and the fused
round under FedOpt and FedNova against the port's engine round."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.aggregators import FedOptAggregator as JaxFedOpt
from fedml_tpu.algorithms.aggregators import RobustAggregator as JaxRobust
from fedml_tpu.algorithms.aggregators import make_aggregator as jax_aggregator
from fedml_tpu.algorithms.engine import LocalResult as JaxLocalResult
from fedml_tpu.algorithms.engine import build_round_fn as jax_round_fn
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import LocalResult, build_round_fn
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.utils.convert import flax_to_torch, optax_state_to_torch
from test_torch_engine import COUNTS, _assert_globals_close, _setup
from test_torch_fused_sgd import _no_drop_setup

# name: (server_optimizer, server_lr, server_momentum). Adam and Adagrad
# run at main_fedopt's default lr 1e-3: their first step is lr * g / |g|, so
# in a whole round a pseudo-gradient element that the two sides' float32
# sums leave within rounding of 0 can move by up to 2 * lr. At lr 1e-3 and
# the suite's XLA settings (tests/conftest.py: opt level 0, which contracts
# no multiply-add into an FMA, as torch's CPU kernels do not) every element
# stays inside the FedOpt tolerance; at lr 1e-2, 10 of 18432 conv2 weights
# missed it, and with XLA's FMAs a few conv1 biases miss it at 1e-3 too.
SERVER = {
    "sgd": ("sgd", 0.1, 0.0),
    "sgd_momentum": ("sgd", 0.1, 0.9),
    "adam": ("adam", 1e-3, 0.0),
    "yogi": ("yogi", 0.01, 0.0),
    "adagrad": ("adagrad", 1e-3, 0.0),
}
SERVER_FIELDS = ("server_optimizer", "server_lr", "server_momentum")
# flax-shaped leaves of a small tree (conv HWIO, dense [in, out])
SHAPES = {"conv2d_1": (3, 3, 1, 4), "linear_1": (16, 5)}
# weights whose normalised values (1/4, 1/4, 1/2) keep the mean of dyadic
# rows exact in any summation order
WEIGHTS = np.array([1.0, 1.0, 2.0], np.float32)


def _server_cfgs(name):
    opt, lr, momentum = SERVER[name]
    kw = dict(server_optimizer=opt, server_lr=lr, server_momentum=momentum)
    return JaxConfig(**kw), FedConfig(**kw)


def _dyadic(rng, shape, lo, hi):
    """Multiples of 1/256 with magnitude in [lo, hi] and random sign."""
    mag = rng.randint(int(lo * 256), int(hi * 256) + 1, size=shape) / 256.0
    return (mag * rng.choice([-1.0, 1.0], size=shape)).astype(np.float32)


def _server_inputs(seed, zero):
    """(globals tree, stacked client tree [3, ...]) whose weighted mean and
    pseudo-gradient are exact in float32: globals of magnitude 0.5-1,
    pseudo-gradients of magnitude 0.25-1 (or exactly 0 with ``zero``)."""
    rng = np.random.RandomState(seed)
    glob, stacked = {}, {}
    for layer, shape in SHAPES.items():
        glob[layer], stacked[layer] = {}, {}
        for kind, s in (("kernel", shape), ("bias", shape[-1:])):
            g = _dyadic(rng, s, 0.5, 1.0)
            if zero:
                rows = np.stack([g, g, g])
            else:
                avg = g - _dyadic(rng, s, 0.25, 1.0)
                r0, r1 = _dyadic(rng, s, 0.0, 1.0), _dyadic(rng, s, 0.0, 1.0)
                rows = np.stack([r0, r1, 2 * avg - (r0 + r1) / 2])
            glob[layer][kind], stacked[layer][kind] = g, rows.astype(np.float32)
    return {"params": glob}, {"params": stacked}


def _assert_state_close(tstate, jstate, rtol, atol=0.0):
    want = optax_state_to_torch(jstate)
    assert sorted(tstate) == sorted(want)
    for name, value in want.items():
        if name == "count":
            assert int(tstate[name]) == int(value)
            continue
        for k, v in value.items():
            np.testing.assert_allclose(tstate[name][k].numpy(), v.numpy(), rtol=rtol,
                                       atol=atol, err_msg=f"{name} {k}")


@pytest.mark.parametrize("zero", [False, True], ids=["away_from_0", "exact_0"])
@pytest.mark.parametrize("name", sorted(SERVER))
def test_server_step_matches_optax(name, zero):
    """Three aggregator calls on the same stacked updates. Pseudo-gradients
    are held away from 0, where Adam's and Adagrad's first step lr * g / |g|
    amplifies any rounding, or are exactly 0: then every rule but Yogi
    leaves the globals as they are (Yogi's moments start at 1e-6, so its
    step is not zero there, in optax either)."""
    jcfg, tcfg = _server_cfgs(name)
    jgv, stacked = _server_inputs(3, zero)
    jagg, tagg = JaxFedOpt(jcfg), make_aggregator("fedopt", tcfg)
    jres = JaxLocalResult(jax.tree.map(jnp.asarray, stacked), jnp.ones(3, jnp.int32), {})
    tres = LocalResult(flax_to_torch(stacked), torch.ones(3, dtype=torch.int32), {})
    tgv = flax_to_torch(jgv)
    g0 = {k: v.clone() for k, v in tgv.items()}
    jstate, tstate = jagg.init_state(jgv), tagg.init_state(tgv)
    for _ in range(3):
        jgv, jstate = jagg(jgv, jres, jnp.asarray(WEIGHTS), jax.random.PRNGKey(0), jstate)
        tgv, tstate = tagg(tgv, tres, torch.from_numpy(WEIGHTS), torch.Generator(), tstate)
    _assert_globals_close(tgv, jgv, rtol=1e-6, atol=0.0)
    _assert_state_close(tstate, jstate, rtol=1e-6)
    if zero and name != "yogi":
        for k, v in tgv.items():
            torch.testing.assert_close(v, g0[k], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["sgd_momentum", "adam", "yogi", "adagrad"])
def test_fedopt_rounds_match_jax(name):
    """Three whole FedOpt rounds (3 ragged clients, 2 epochs) at the JAX
    package's own FedOpt tolerance (test_reference_parity.py:304), globals
    and server state."""
    x, y, jcfg, tcfg, jt, tt, gv = _setup()
    scfg_j, scfg_t = _server_cfgs(name)
    jcfg = jcfg.replace(**{k: getattr(scfg_j, k) for k in SERVER_FIELDS})
    tcfg = tcfg.replace(**{k: getattr(scfg_t, k) for k in SERVER_FIELDS})
    jagg, tagg = jax_aggregator("fedopt", jcfg), make_aggregator("fedopt", tcfg)
    jround = jax_round_fn(jt, jcfg, jagg)
    tround = build_round_fn(tt, tcfg, tagg, device="cpu")
    jgv, tgv = gv, flax_to_torch(gv)
    jstate, tstate = jagg.init_state(jgv), tagg.init_state(tgv)
    xs, ys, cs = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(COUNTS)
    for r in range(3):
        jgv, jstate, _ = jround(jgv, jstate, jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(COUNTS), jax.random.PRNGKey(r))
        tgv, tstate, _ = tround(tgv, tstate, xs, ys, cs, torch.Generator().manual_seed(r))
    _assert_globals_close(tgv, jgv, rtol=1e-3, atol=1e-4)
    _assert_state_close(tstate, jstate, rtol=1e-3, atol=1e-4)


def test_fednova_heterogeneous_taus_match_jax():
    """Ragged counts at batch 8 and 2 epochs give the clients 8, 6 and 2
    steps; FedNova's tau-normalised round against JAX's, three rounds."""
    x, y, jcfg, tcfg, jt, tt, gv = _setup()
    jround = jax_round_fn(jt, jcfg, jax_aggregator("fednova", jcfg))
    tround = build_round_fn(tt, tcfg, make_aggregator("fednova", tcfg), device="cpu")
    jgv, tgv = gv, flax_to_torch(gv)
    xs, ys, cs = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(COUNTS)
    for r in range(3):
        jgv, _, _ = jround(jgv, (), jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(COUNTS), jax.random.PRNGKey(r))
        tgv, _, _ = tround(tgv, (), xs, ys, cs, torch.Generator().manual_seed(r))
    _assert_globals_close(tgv, jgv)
    fedavg = build_round_fn(tt, tcfg, make_aggregator("fedavg", tcfg), device="cpu")
    avg, _, _ = fedavg(flax_to_torch(gv), (), xs, ys, cs, torch.Generator())
    nova, _, _ = tround(flax_to_torch(gv), (), xs, ys, cs, torch.Generator())
    # unequal taus: the normalised average is not FedAvg's
    assert max((avg[k] - nova[k]).abs().max().item() for k in avg) > 1e-4


def test_robust_without_noise_matches_jax():
    """Client 1's delta is 1000x the others' and is clipped to norm_bound;
    the others pass unclipped. No noise (stddev 0)."""
    _, _, _, _, _, _, gv = _setup()
    rng = np.random.RandomState(4)
    stacked = jax.tree.map(
        lambda p: np.stack([np.asarray(p) + s * rng.normal(0, 1e-3, p.shape)
                            for s in (1.0, 1000.0, 1.0)]).astype(np.float32), gv)
    jcfg, tcfg = JaxConfig(norm_bound=1.0, stddev=0.0), FedConfig(norm_bound=1.0, stddev=0.0)
    weights = np.array([30.0, 21.0, 8.0], np.float32)
    jgv, _ = JaxRobust(jcfg)(gv, JaxLocalResult(stacked, jnp.ones(3, jnp.int32), {}),
                             jnp.asarray(weights), jax.random.PRNGKey(0), ())
    tgv, _ = make_aggregator("robust", tcfg)(
        flax_to_torch(gv), LocalResult(flax_to_torch(stacked), None, {}),
        torch.from_numpy(weights), torch.Generator(), ())
    # atol: the biases start at 0, so their weighted mean of +-1e-3 deltas
    # cancels to ~1e-4 in places, with float32 rounding of ~1e-10
    _assert_globals_close(tgv, jgv, rtol=1e-6, atol=1e-9)
    # the clipped client moved the mean by at most norm_bound * its weight
    tg = flax_to_torch(gv)
    shift = torch.sqrt(sum(((tgv[k] - tg[k]) ** 2).sum() for k in tg))
    assert float(shift) < 1.0


def test_robust_noise_is_seeded_and_gaussian():
    """With stddev > 0 the noise is drawn from a generator seeded by the
    round generator: the same seed gives the same bits, another seed other
    bits, and over 10**6 elements its mean and standard deviation are
    within 1% of 0 and stddev."""
    sd = 0.5
    agg = make_aggregator("robust", FedConfig(norm_bound=5.0, stddev=sd))
    gv = {"w": torch.zeros(1000, 1000)}
    result = LocalResult({"w": torch.zeros(1, 1000, 1000)}, None, {})

    def noise(seed):
        out, _ = agg(gv, result, torch.ones(1), torch.Generator().manual_seed(seed), ())
        return out["w"]

    a, b, c = noise(7), noise(7), noise(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert abs(float(a.mean())) < 0.01 * sd
    assert abs(float(a.std()) / sd - 1) < 0.01


@pytest.mark.parametrize("name", ["fedopt", "fednova"])
def test_fused_round_with_server_rule_matches_engine(name):
    """The fused round (its plain version on the CPU) with FedOpt (Yogi)
    or FedNova against the port's engine round with the same aggregator,
    three rounds, as test_torch_fused_sgd.py does for FedAvg."""
    cfg, trainer, gv, x, y, counts = _no_drop_setup()
    cfg = cfg.replace(server_optimizer="yogi", server_lr=0.01)
    agg = make_aggregator(name, cfg)
    engine = build_round_fn(trainer, cfg, agg, device="cpu")
    fused = build_round_fn(trainer, cfg.replace(fused_kernel=True), agg, device="cpu")
    gv_e, gv_f = gv, gv
    st_e, st_f = agg.init_state(gv), agg.init_state(gv)
    for r in range(3):
        gv_e, st_e, _ = engine(gv_e, st_e, x, y, counts, torch.Generator().manual_seed(r))
        gv_f, st_f, _ = fused(gv_f, st_f, x, y, counts, torch.Generator().manual_seed(r))
    for k in gv_e:
        np.testing.assert_allclose(gv_f[k].numpy(), gv_e[k].numpy(), rtol=2e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("kw", [dict(momentum=0.9), dict(wd=1e-4),
                                dict(client_optimizer="adam"), dict(fedprox_mu=0.01)],
                         ids=["momentum", "wd", "adam", "fedprox"])
def test_fused_requirement_raises(kw):
    with pytest.raises(ValueError, match="plain SGD with global-norm clip"):
        FedConfig(fused_kernel=True, **kw).validate()
    FedConfig(**kw).validate()  # the engine path runs each of them


def test_unknown_server_optimizer_raises():
    with pytest.raises(ValueError, match="unknown server_optimizer"):
        make_aggregator("fedopt", FedConfig(server_optimizer="lamb"))
