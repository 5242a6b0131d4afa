"""The port's stateful client optimizers (momentum, weight decay,
torch-exact AMSGrad) and FedProx against the JAX package's optax chain:
three FedAvg rounds of ``build_round_fn`` on the small CNN of
``test_torch_engine._setup`` (3 ragged clients, dropout and shuffle off).
Client 2 holds 8 of 30 rows at batch 8, so its last three batches, and
client 1's last, are all padding: no step, and no state change."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.aggregators import make_aggregator as jax_aggregator
from fedml_tpu.algorithms.engine import build_round_fn as jax_round_fn
from fedml_tpu.algorithms.engine import make_local_optimizer as jax_local_optimizer
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import (build_local_update, build_round_fn,
                                               make_local_optimizer)
from fedml_tpu_torch.utils.convert import flax_to_torch, optax_state_to_torch
from test_torch_engine import COUNTS, _assert_globals_close, _setup

# tolerances: the engine's FedAvg contract (test_torch_engine.py), except
# Adam: its first step moves every weight by about lr * g / |g|, so a
# gradient element that float32 sums in another order leave within ~1e-7 of
# zero moves by up to lr with either sign; at lr 1e-3 that stays inside the
# JAX package's FedOpt tolerance (test_reference_parity.py:304).
CASES = {
    "sgd_momentum": (dict(momentum=0.9), (2e-5, 1e-5)),
    "sgd_momentum_wd": (dict(momentum=0.9, wd=1e-3), (2e-5, 1e-5)),
    "adam_wd": (dict(client_optimizer="adam", lr=1e-3, wd=0.01), (1e-3, 1e-4)),
    "fedprox_0.01": (dict(fedprox_mu=0.01), (2e-5, 1e-5)),
    "fedprox_0.1": (dict(fedprox_mu=0.1), (2e-5, 1e-5)),
}


@pytest.mark.parametrize("epochs", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_local_optimizer_rounds_match_jax(case, epochs):
    kw, (rtol, atol) = CASES[case]
    x, y, jcfg, tcfg, jt, tt, gv = _setup()
    jcfg, tcfg = jcfg.replace(epochs=epochs, **kw), tcfg.replace(epochs=epochs, **kw)
    jround = jax_round_fn(jt, jcfg, jax_aggregator("fedavg", jcfg))
    tround = build_round_fn(tt, tcfg, make_aggregator("fedavg", tcfg), device="cpu")
    jgv, tgv = gv, flax_to_torch(gv)
    xs, ys, cs = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(COUNTS)
    for r in range(3):
        jgv, _, jm = jround(jgv, (), jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(COUNTS), jax.random.PRNGKey(r))
        tgv, _, tm = tround(tgv, (), xs, ys, cs, torch.Generator().manual_seed(r))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"round {r} {k}")
    _assert_globals_close(tgv, jgv, rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ["sgd_momentum_wd", "adam_wd"])
def test_optimizer_state_after_steps_matches_optax(case):
    """Three steps of the port's chain against optax's on the same
    gradients: updates and state (momentum trace, AMSGrad moments and
    count), held at float32 rounding."""
    kw, _ = CASES[case]
    _, _, jcfg, tcfg, _, _, gv = _setup()
    jopt = jax_local_optimizer(jcfg.replace(**kw))
    topt = make_local_optimizer(tcfg.replace(**kw))
    rng = np.random.RandomState(5)
    jparams = gv["params"]
    tparams = flax_to_torch(gv)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for _ in range(3):
        # gradients with global norm above and below the clip's bound
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.normal(0, 0.02, p.shape).astype(np.float32)), jparams)
        jupd, jstate = jopt.update(grads, jstate, jparams)
        tupd, tstate = topt.update(flax_to_torch(grads), tstate, tparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jupd)
        tparams = {k: p + tupd[k] for k, p in tparams.items()}
    want = optax_state_to_torch(jstate)
    assert sorted(want) == sorted(tstate)
    for name, value in want.items():
        if name == "count":
            assert int(tstate[name]) == int(value) == 3
            continue
        for k, v in value.items():
            np.testing.assert_allclose(tstate[name][k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-8, err_msg=f"{name} {k}")
    _assert_globals_close(tparams, {"params": jparams}, rtol=1e-6, atol=1e-7)


def test_state_carries_across_epochs():
    """One two-epoch local update equals two one-epoch updates only if the
    optimizer state of the first epoch carries into the second: here it
    does not equal them, and the two-epoch result is JAX's (above)."""
    x, y, _, tcfg, _, tt, gv = _setup()
    cfg = tcfg.replace(momentum=0.9, epochs=2)
    two = build_local_update(tt, cfg)(flax_to_torch(gv), torch.from_numpy(x[0]),
                                      torch.from_numpy(y[0]), int(COUNTS[0]),
                                      torch.Generator())
    one = build_local_update(tt, cfg.replace(epochs=1))
    mid = one(flax_to_torch(gv), torch.from_numpy(x[0]), torch.from_numpy(y[0]),
              int(COUNTS[0]), torch.Generator())
    fresh = one(mid.variables, torch.from_numpy(x[0]), torch.from_numpy(y[0]),
                int(COUNTS[0]), torch.Generator())
    assert two.num_steps == 2 * mid.num_steps == 8
    diff = max((two.variables[k] - fresh.variables[k]).abs().max().item()
               for k in two.variables)
    assert diff > 1e-4


def test_all_padding_batches_take_no_step():
    """Client 2 (8 rows, batch 8, 30 padded) steps once an epoch: its
    momentum state sees one gradient per epoch, as in JAX."""
    x, y, _, tcfg, _, tt, gv = _setup()
    out = build_local_update(tt, tcfg.replace(momentum=0.9))(
        flax_to_torch(gv), torch.from_numpy(x[2]), torch.from_numpy(y[2]),
        int(COUNTS[2]), torch.Generator())
    assert out.num_steps == 2
