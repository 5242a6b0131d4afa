"""FedNAS (``fedml_tpu_torch/algorithms/fednas.py``) against the JAX
package's (``fedml_tpu/algorithms/fednas.py``) on the CPU.

The JAX side of DARTS compiles slowly on the CPU (its own tests are marked
slow), so these tests hold it to the smallest search networks that keep
what each test is about:

  - the search steps run on 3 cells (a normal cell, then two reducing, the
    second after a reduction) of steps 1 and multiplier 1, 4 channels, 8x8
    inputs. JAX's step runs as written, its network's ``apply`` jitted, so
    that its two gradient programs compile once for all the step tests
    (the unrolled and the GDAS forwards compile their own);
  - the round, ``evaluate`` and the resume run on one reducing cell of
    steps 1 (two stride-2 MixedOps): the round's batching, draws, gating
    and averaging do not depend on the network's size, and
    ``tests/test_torch_darts.py`` holds the network itself at steps 2.

Both sides start from the port's initial weights, converted
(``torch_to_flax``), and JAX's alphas; JAX's shuffles, val indices and
gumbel uniforms are re-derived from its keys and injected into the port.
Each step test runs two steps: the second from JAX's state after the
first, converted (``flax_to_torch``, ``optax_state_to_torch``), so its
momentum buffer and Adam moments are live. Tolerances: params, alphas and
both optimizer states rtol 2e-5 / atol 1e-5; the round (two epochs over
three clients, its Adam steps on the alphas included) rtol 1e-4 / atol
1e-5 on the alphas, 2e-5 / 1e-5 on the rest; accuracies exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fednas as jf
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import FederatedDataset as JaxDataset
from fedml_tpu.models import darts as jd
from fedml_tpu_torch.algorithms import fednas as tf
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import flax_default_init
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.models import darts as td
from fedml_tpu_torch.utils.convert import flax_to_torch, optax_state_to_torch, torch_to_flax

RTOL, ATOL = 2e-5, 1e-5
CLASSES, SIDE, BATCH, C = 5, 8, 4, 4
STEP_NET = dict(layers=3, steps=1, multiplier=1)
ROUND_NET = dict(layers=1, steps=1, multiplier=1)
CFG = dict(lr=0.025, momentum=0.9, wd=3e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite's workers share
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _JittedNet:
    """What ``jf.build_search_step`` reads of its network (``apply`` and
    ``layers``), with ``apply`` jitted: the step's gradients of it then
    compile once and are reused across calls and modes."""

    def __init__(self, net):
        self.layers = net.layers
        self._apply = jax.jit(net.apply, static_argnames=("train",))

    def apply(self, *args, **kwargs):
        return self._apply(*args, **kwargs)


def _nets(net):
    tm = td.DARTSNetwork(CLASSES, C, **net)
    jm = jd.DARTSNetwork(output_dim=CLASSES, channels=C, **net)
    return tm, jm


def _port_state(jstate, tm):
    """JAX's NASState as the port's, converted."""
    return tf.NASState(
        flax_to_torch(jstate.params, module=tm),
        dict(zip(tf.ALPHA_KEYS, (torch.tensor(np.asarray(a)) for a in jstate.alphas))),
        optax_state_to_torch(jstate.w_opt),
        optax_state_to_torch(jstate.a_opt, names=tf.ALPHA_KEYS))


def _assert_state(got, want, tm, alpha_rtol=RTOL):
    """The port's NASState ``got`` against JAX's ``want``."""
    w = _port_state(want, tm)
    for k, v in w.params.items():
        np.testing.assert_allclose(got.params[k].numpy(), v.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k in tf.ALPHA_KEYS:
        np.testing.assert_allclose(got.alphas[k].numpy(), w.alphas[k].numpy(),
                                   rtol=alpha_rtol, atol=ATOL, err_msg=k)
    assert set(got.w_opt) == set(w.w_opt) and set(got.a_opt) == set(w.a_opt)
    for k, v in w.w_opt.get("trace", {}).items():
        np.testing.assert_allclose(got.w_opt["trace"][k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"trace {k}")
    assert int(got.a_opt["count"]) == int(w.a_opt["count"])
    for m in ("mu", "nu"):
        for k in tf.ALPHA_KEYS:
            np.testing.assert_allclose(got.a_opt[m][k].numpy(), w.a_opt[m][k].numpy(),
                                       rtol=alpha_rtol, atol=ATOL, err_msg=f"{m} {k}")


def _batches(seed):
    rng = np.random.RandomState(seed)
    tx = rng.normal(size=(BATCH, SIDE, SIDE, 3)).astype(np.float32)
    ty = rng.randint(0, CLASSES, BATCH).astype(np.int32)
    tmask = np.array([1, 1, 1, 0], np.float32)  # a part-padded batch
    vx = rng.normal(size=(BATCH, SIDE, SIDE, 3)).astype(np.float32)
    vy = rng.randint(0, CLASSES, BATCH).astype(np.int32)
    return (tx, ty, tmask), (vx, vy)


def _gdas_uniforms(key, layers, k):
    """The uniforms JAX's GDAS step draws from ``key``, in the port's
    layout [3 (GDAS_STREAMS: a, w, t), 2 (normal, reduce), layers, k, ops]."""
    shape = (layers, k, len(td.PRIMITIVES))
    streams = []
    for stream in jax.random.split(key, 3):
        r1, r2 = jax.random.split(stream)
        streams.append([np.asarray(jax.random.uniform(r, shape, minval=1e-10, maxval=1.0))
                        for r in (r1, r2)])
    return torch.from_numpy(np.array(streams))


@pytest.fixture(scope="module")
def step_case():
    """The step network, its converted weights and alphas, and JAX's
    jitted network."""
    tm, jm = _nets(STEP_NET)
    tv = flax_default_init(tm, torch.Generator().manual_seed(0), "cpu")
    params = jax.tree.map(jnp.asarray, torch_to_flax(tv, tm)["params"])
    rng = np.random.RandomState(1)
    alphas = tuple(jnp.asarray(1e-3 * rng.normal(size=(tm.num_edges, len(td.PRIMITIVES)))
                               .astype(np.float32)) for _ in range(2))
    return dict(tm=tm, jnet=_JittedNet(jm), params=params, alphas=alphas)


MODES = {
    "first_order": dict(),
    "first_order_lambda0": dict(lambda_train=0.0),
    "unrolled": dict(unrolled=True),
    "gdas": dict(gdas=True, tau=5.0),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_search_step_matches_jax(step_case, mode):
    """Two search steps in each mode (first order with lambda_train 1 and
    0, unrolled, GDAS with JAX's noise injected): params, alphas, both
    optimizer states and the step's metric sums."""
    kw = MODES[mode]
    tm = step_case["tm"]
    jstep, jw, ja = jf.build_search_step(step_case["jnet"], JaxConfig(**CFG), **kw)
    tstep, _, _ = tf.build_search_step(tm, FedConfig(**CFG), **kw)
    jstate = jf.NASState(step_case["params"], step_case["alphas"],
                         jw.init(step_case["params"]), ja.init(step_case["alphas"]))
    tstate = _port_state(jstate, tm)
    for i, lr in enumerate((0.025, 0.02)):
        train, val = _batches(seed=10 + i)
        key = jax.random.PRNGKey(20 + i)
        jextra = (key,) if kw.get("gdas") else ()
        uniforms = _gdas_uniforms(key, tm.layers, tm.num_edges) if kw.get("gdas") else None
        jstate, jm = jstep(jstate, tuple(map(jnp.asarray, train)), tuple(map(jnp.asarray, val)),
                           jnp.float32(lr), jnp.bool_(True), *jextra)
        tstate, tmet = tstep(tstate, tuple(map(torch.from_numpy, train)),
                             tuple(map(torch.from_numpy, val)), lr, True, uniforms)
        _assert_state(tstate, jstate, tm)
        np.testing.assert_allclose([float(v) for v in tmet], [float(v) for v in jm],
                                   rtol=RTOL, atol=ATOL)
        # the next step starts from JAX's state, converted mid-run
        tstate = _port_state(jstate, tm)
    assert int(tstate.a_opt["count"]) == 2 and "trace" in tstate.w_opt


def test_step_without_val_half_keeps_the_alphas(step_case):
    """``val_ok`` False: the architecture step is skipped, alphas and their
    Adam state both; the weight step runs, as in JAX's."""
    tm = step_case["tm"]
    jstep, jw, ja = jf.build_search_step(step_case["jnet"], JaxConfig(**CFG))
    tstep, _, _ = tf.build_search_step(tm, FedConfig(**CFG))
    jstate = jf.NASState(step_case["params"], step_case["alphas"],
                         jw.init(step_case["params"]), ja.init(step_case["alphas"]))
    tstate = _port_state(jstate, tm)
    train, val = _batches(seed=30)
    jstate, _ = jstep(jstate, tuple(map(jnp.asarray, train)), tuple(map(jnp.asarray, val)),
                      jnp.float32(0.025), jnp.bool_(False))
    got, _ = tstep(tstate, tuple(map(torch.from_numpy, train)),
                   tuple(map(torch.from_numpy, val)), 0.025, False)
    _assert_state(got, jstate, tm)
    for k in tf.ALPHA_KEYS:
        assert torch.equal(got.alphas[k], tstate.alphas[k])
    assert int(got.a_opt["count"]) == 0


COUNTS = np.array([12, 7, 1], np.int32)
EPOCHS, ROUND_BATCH = 2, 4


def _round_datasets(seed=0):
    """Three ragged clients at batch 4: client 0's second batch is part
    padding, client 1's second batch holds no valid row (no step), client 2
    (one row) has no val half (no architecture step). A test split of 10
    rows: ``evaluate`` at batch 4 pads its last batch with two zero rows."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(3, 12, SIDE, SIDE, 3)).astype(np.float32)
    y = rng.randint(0, CLASSES, size=(3, 12)).astype(np.int32)
    for c, n in enumerate(COUNTS):
        x[c, n:], y[c, n:] = 0, 0
    xte = rng.normal(size=(10, SIDE, SIDE, 3)).astype(np.float32)
    yte = rng.randint(0, CLASSES, 10).astype(np.int32)
    flat = (x[0], y[0])

    def make(dataset_cls, packed_cls):
        return dataset_cls(name="nas", train=packed_cls(x, y, COUNTS.copy()), test=None,
                           train_global=flat, test_global=(xte, yte), class_num=CLASSES)

    return make(JaxDataset, JaxPacked), make(FederatedDataset, PackedClients)


def _jax_draws(rng, counts, n_max, epochs, b):
    """JAX's client_search draws from its round key: each client's epoch
    permutations [E, nb * b] and val indices [E, nb, b]."""
    n_tr_max = max(n_max // 2, 1)
    nb = -(-n_tr_max // b)
    perms, vals = [], []
    for crng, count in zip(jax.random.split(rng, len(counts)), counts):
        count_tr = max(int(count) // 2, 1)
        count_val = max(int(count) - count_tr, 1)
        p_c, v_c = [], []
        for erng in jax.random.split(crng, epochs):
            shuffle_rng, val_rng, _ = jax.random.split(erng, 3)
            u = jax.random.uniform(shuffle_rng, (n_tr_max,))
            perm = jnp.argsort(jnp.where(jnp.arange(n_tr_max) < count_tr, u, jnp.inf))
            p_c.append(np.concatenate([np.asarray(perm), np.zeros(nb * b - n_tr_max, int)]))
            v_c.append(np.asarray(count_tr + jax.random.randint(val_rng, (nb, b), 0,
                                                                count_val)))
        perms.append(np.stack(p_c))
        vals.append(np.stack(v_c))
    return np.stack(perms), np.stack(vals)


def _round_cfg(**kw):
    base = dict(client_num_in_total=3, client_num_per_round=3, batch_size=ROUND_BATCH,
                epochs=EPOCHS, comm_round=2, seed=0, **CFG)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def round_case(monkeypatch_module):
    """One JAX FedNASAPI round on the ragged clients, from the port's
    initial weights (JAX's DARTSNetwork.init answers them: flax's own init
    takes seconds per cell eagerly), and the port's API at JAX's initial
    alphas."""
    jds, tds = _round_datasets()
    tapi = tf.FedNASAPI(tds, FedConfig(**_round_cfg()), channels=C, device="cpu",
                        **_api_net())
    params = jax.tree.map(jnp.asarray,
                          torch_to_flax(tapi.global_state.params, tapi.network)["params"])

    class _Preset(jd.DARTSNetwork):
        def init(self, rngs, *args, **kwargs):
            return {"params": params}

    monkeypatch_module.setattr(jf, "DARTSNetwork", _Preset)
    japi = jf.FedNASAPI(jds, JaxConfig(**_round_cfg()), channels=C, **_api_net())
    start = _port_state(japi.global_state, tapi.network)
    rec = japi.train_one_round(0)
    return dict(japi=japi, tapi=tapi, start=start, rec=rec)


def _api_net():
    return dict(layers=ROUND_NET["layers"], steps=ROUND_NET["steps"],
                multiplier=ROUND_NET["multiplier"])


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_round_matches_jax(round_case):
    """One round on three ragged clients with JAX's shuffles and val
    indices injected: the averaged params and alphas, the metrics and the
    genotype."""
    japi, tapi = round_case["japi"], round_case["tapi"]
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    x, y, counts = tapi.dataset.train.select(np.arange(3))
    perms, vals = _jax_draws(rng, counts, x.shape[1], EPOCHS, ROUND_BATCH)
    state, metrics = tapi.round_fn(round_case["start"], x, y, counts,
                                   torch.Generator().manual_seed(0), perms=perms, val_idx=vals)
    rec = round_case["rec"]
    want = _port_state(japi.global_state, tapi.network)
    for k, v in want.params.items():
        np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k in tf.ALPHA_KEYS:
        np.testing.assert_allclose(state.alphas[k].numpy(), want.alphas[k].numpy(),
                                   rtol=1e-4, atol=ATOL, err_msg=k)
    # every real train-half row once an epoch: (6 + 3 + 1) * 2
    assert metrics["search_samples"] == rec["search_samples"] == 20
    np.testing.assert_allclose([float(metrics["search_loss"]), float(metrics["search_acc"])],
                               [rec["search_loss"], rec["search_acc"]], rtol=RTOL, atol=ATOL)
    geno = td.parse_genotype(state.alphas["normal"], state.alphas["reduce"], 1, 1)
    assert geno == japi.genotype_history[-1]


def test_evaluate_pads_the_last_batch_as_jax(round_case):
    """``evaluate`` at batch 4 over 10 test rows: the last batch carries
    two zero rows into its statistics, on both sides."""
    japi, tapi = round_case["japi"], round_case["tapi"]
    tapi.global_state = _port_state(japi.global_state, tapi.network)
    want = japi.evaluate(batch_size=4)["Test/Acc"]
    assert tapi.evaluate(batch_size=4)["Test/Acc"] == pytest.approx(want, abs=1e-6)
    # the whole set in one batch is another computation (no padding rows)
    assert 0.0 <= tapi.evaluate(batch_size=10)["Test/Acc"] <= 1.0


def test_empty_batches_take_no_step():
    """A client of one row at batch 4 over a padded width of 12 has no val
    half and one valid batch of two: its search is one weight step with
    the alphas kept, whatever the empty batch after it."""
    _, tds = _round_datasets()
    api = tf.FedNASAPI(tds, FedConfig(**_round_cfg(epochs=1)), channels=C, device="cpu",
                       **_api_net())
    g = api.global_state
    x, y = (torch.from_numpy(a[2]) for a in (tds.train.x, tds.train.y))
    perm = torch.tensor([[0, 1, 2, 3, 4, 5, 0, 0]])
    vals = torch.full((1, 2, 4), 1)
    params, alphas, loss_n, correct, n = api.client_search(
        g.params, g.alphas, x, y, 1, torch.Generator(), perm, vals)
    assert n == 1
    want, (ln, _, _) = api.search_step(
        tf.NASState(g.params, g.alphas, api._w_opt.init(g.params), api._a_opt.init(g.alphas)),
        (x[:4], y[:4], torch.tensor([1.0, 0, 0, 0])), (x[[1] * 4], y[[1] * 4]),
        api.epoch_lrs[0], False)
    for k in params:
        assert torch.equal(params[k], want.params[k]), k
    for k in tf.ALPHA_KEYS:
        assert torch.equal(alphas[k], g.alphas[k])
    assert torch.equal(loss_n, ln)


def _resume_api(tds, rounds, **kw):
    return tf.FedNASAPI(tds, FedConfig(**_round_cfg(comm_round=rounds)), channels=C,
                        device="cpu", **_api_net(), **kw)


@pytest.mark.parametrize("gdas", [False, True])
def test_resume_is_bit_for_bit(tmp_path, gdas):
    """A 1 + 1 run resumed from its checkpoint equals the 2-round run: the
    params, alphas, both optimizer states, the history and the genotypes
    (GDAS draws its noise from the round's generators too)."""
    _, tds = _round_datasets()
    straight = _resume_api(tds, 2, gdas=gdas)
    straight.train()
    _resume_api(tds, 1, gdas=gdas).train(ckpt_dir=str(tmp_path))
    resumed = _resume_api(tds, 2, gdas=gdas)
    resumed.train(ckpt_dir=str(tmp_path))
    for a, b in zip(straight.global_state, resumed.global_state):
        for (ka, va), (kb, vb) in zip(_flat(a), _flat(b)):
            assert ka == kb and torch.equal(va, vb), ka
    assert resumed.history == straight.history
    assert resumed.genotype_history == straight.genotype_history
    assert isinstance(resumed.genotype_history[0], td.Genotype)
    assert np.isfinite(straight.history[-1]["search_loss"])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_main_fednas_cpu(tmp_path):
    """``main_fednas`` on the CPU: one round of a one-cell search on two of
    ten CIFAR-10 surrogate clients; the genotype in the wandb summary."""
    from fedml_tpu_torch.experiments import main_fednas

    hist = main_fednas.main([
        "--dataset", "cifar10", "--client_num_in_total", "10", "--client_num_per_round", "2",
        "--comm_round", "1", "--epochs", "1", "--batch_size", "64", "--init_channels", "4",
        "--layers", "1", "--steps", "1", "--multiplier", "1", "--partition_method", "homo",
        "--device", "cpu", "--run_dir", str(tmp_path / "run")])
    summary = json.loads((tmp_path / "run" / "wandb-summary.json").read_text())
    assert 0.0 <= summary["search_acc"] <= 1.0 and np.isfinite(summary["search_loss"])
    assert summary["genotype"].startswith("Genotype(normal=")
    assert len(hist) == 1
