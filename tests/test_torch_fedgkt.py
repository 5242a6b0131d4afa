"""The port's FedGKT (``algorithms/fedgkt.py``), its GKT split ResNets
(``models/resnet_gkt.py``) and the Nesterov trace it needs
(``algorithms/engine.py``) against the JAX package.

The two packages draw their initial weights and shuffles from their own
streams, so the API parity runs at full batch (one batch a client: the
order of rows moves only float rounding) from the JAX package's initial
variables, converted. It runs on tiny twins of the GKT models (a conv,
a BatchNorm and a dense each), which keep every path of the algorithm
(BatchNorm statistics over padded batches, the KD targets, both optimizers)
at a few milliseconds of JAX compile; the ResNets themselves are held
module by module. Tolerances: 2e-5 relative and 1e-5 absolute unless a
test says otherwise."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from fedml_tpu.algorithms import fedgkt as jax_fedgkt
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import FederatedDataset as JaxDataset
from fedml_tpu.models import resnet_gkt as jax_resnet_gkt
from fedml_tpu_torch.algorithms import engine, fedgkt
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ModelTrainer
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.models.cnn import dense
from fedml_tpu_torch.models.resnet import BatchNorm
from fedml_tpu_torch.models.resnet_gkt import GKTClientResNet, GKTServerResNet
from fedml_tpu_torch.utils.checkpoint import save_checkpoint
from fedml_tpu_torch.utils.convert import flax_to_torch, optax_state_to_torch

RTOL, ATOL = 2e-5, 1e-5
C, N, SIDE, K = 3, 20, 8, 4
COUNTS = np.array([20, 13, 16], np.int32)  # ragged: two clients padded


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the tiny twins: (logits, features) edge model and a server over it.
# Their convolutions are bias-free, as the GKT ResNets' are: a bias before a
# BatchNorm has a gradient of rounding noise alone, which Adam's first step
# scales to a full step of either sign.


class JaxTwinClient(fnn.Module):
    output_dim: int = K

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.Conv(8, (3, 3), padding=1, use_bias=False)(x)
        x = fnn.relu(fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                                   epsilon=1e-5)(x))
        return fnn.Dense(self.output_dim)(jnp.mean(x, axis=(1, 2))), x


class JaxTwinServer(fnn.Module):
    output_dim: int = K

    @fnn.compact
    def __call__(self, f, train: bool = False):
        x = fnn.Conv(8, (3, 3), strides=(2, 2), padding=1, use_bias=False)(f)
        x = fnn.relu(fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                                   epsilon=1e-5)(x))
        return fnn.Dense(self.output_dim)(jnp.mean(x, axis=(1, 2)))


class TwinClient(nn.Module):
    def __init__(self, output_dim: int = K):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm(8)
        self.Dense_0 = nn.Linear(8, output_dim)

    def forward(self, x, train: bool = False, generator=None):
        x = F.conv2d(x.permute(0, 3, 1, 2), self.Conv_0.weight, None, 1, 1)
        x = F.relu(self.BatchNorm_0(x, train))
        return dense(self.Dense_0, x.mean((2, 3)), torch.float32), x.permute(0, 2, 3, 1)


class TwinServer(nn.Module):
    def __init__(self, output_dim: int = K):
        super().__init__()
        self.Conv_0 = nn.Conv2d(8, 8, 3, stride=2, padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm(8)
        self.Dense_0 = nn.Linear(8, output_dim)

    def forward(self, f, train: bool = False, generator=None):
        x = F.conv2d(f.permute(0, 3, 1, 2), self.Conv_0.weight, None, 2, 1)
        x = F.relu(self.BatchNorm_0(x, train))
        return dense(self.Dense_0, x.mean((2, 3)), torch.float32)


def _arrays(seed: int = 0):
    rng = np.random.RandomState(seed)
    x = rng.rand(C, N, SIDE, SIDE, 3).astype(np.float32)
    y = rng.randint(0, K, (C, N)).astype(np.int32)
    for c in range(C):  # the packers' zero padding
        x[c, COUNTS[c]:] = 0
        y[c, COUNTS[c]:] = 0
    xte = rng.rand(24, SIDE, SIDE, 3).astype(np.float32)
    yte = rng.randint(0, K, 24).astype(np.int32)
    return x, y, xte, yte


def _datasets():
    x, y, xte, yte = _arrays()
    flat = (x.reshape(-1, SIDE, SIDE, 3), y.reshape(-1))
    return (JaxDataset(name="tiny", train=JaxPacked(x, y, COUNTS), test=None, train_global=flat,
                       test_global=(xte, yte), class_num=K),
            FederatedDataset(name="tiny", train=PackedClients(x, y, COUNTS), test=None,
                             train_global=flat, test_global=(xte, yte), class_num=K))


def _kw(optimizer: str, **over):
    lr = 0.02 if optimizer == "sgd" else 1e-3
    return dict(dict(comm_round=2, epochs=2, batch_size=-1, lr=lr, wd=5e-4,
                     client_optimizer=optimizer, client_num_in_total=C,
                     client_num_per_round=C, seed=0), **over)


GKT_KW = dict(alpha=0.5, temperature=3.0, server_epochs=2)


def _close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module", params=["sgd", "adam"])
def jax_run(request):
    """The JAX package's FedGKTAPI on the twins, 2 rounds, once an
    optimizer: its initial variables (numpy) and its trained state."""
    jds, _ = _datasets()
    api = jax_fedgkt.FedGKTAPI(jds, JaxConfig(**_kw(request.param)), JaxTwinClient(),
                               JaxTwinServer(), **GKT_KW)
    init = jax.tree.map(np.asarray, (api.client_vars, api.server_vars))
    hist = api.train()
    return request.param, init, api, hist


# ---- the losses, the schedule and the optimizers


@pytest.mark.parametrize("T", [1.0, 3.0])
def test_kd_kl_loss_matches_jax(T):
    """kd_kl_loss per sample within float32 rounding (rtol 2e-6: the two
    frameworks' exp and log differ in their last bits)."""
    rng = np.random.RandomState(1)
    s = (3 * rng.randn(64, 10)).astype(np.float32)
    t = (3 * rng.randn(64, 10)).astype(np.float32)
    want = np.asarray(jax_fedgkt.kd_kl_loss(jnp.asarray(s), jnp.asarray(t), T))
    got = fedgkt.kd_kl_loss(torch.from_numpy(s), torch.from_numpy(t), T).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


def test_server_epoch_strategy_matches_jax():
    for r in range(251):
        assert fedgkt.get_server_epoch_strategy(r) == jax_fedgkt.get_server_epoch_strategy(r)


def _params(seed: int):
    """A flat tree of the port's keys; ``_nest`` gives the JAX package's
    tree of it (leaves named ``bias`` convert as they are)."""
    rng = np.random.RandomState(seed)
    return {"a.bias": rng.randn(3, 4).astype(np.float32),
            "b.bias": rng.randn(5).astype(np.float32)}


def _nest(flat: dict) -> dict:
    return {k.split(".")[0]: {"bias": jnp.asarray(v)} for k, v in flat.items()}


def _torch(flat: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


@pytest.mark.parametrize("optimizer,wd", [("sgd", 0.0), ("sgd", 5e-4), ("adam", 5e-4)])
def test_gkt_optimizer_matches_optax(optimizer, wd):
    """``_make_gkt_optimizer``: weight decay then Nesterov SGD (momentum
    0.9), or the fixed 1e-4 decay then AMSGrad, over 5 steps: the
    parameters and the optimizer state against optax (rtol 1e-6)."""
    cfg_kw = dict(lr=0.1 if optimizer == "sgd" else 0.01, wd=wd, client_optimizer=optimizer)
    jopt = jax_fedgkt._make_gkt_optimizer(JaxConfig(**cfg_kw))
    topt = fedgkt._make_gkt_optimizer(FedConfig(**cfg_kw))
    p = _params(0)
    jp, tp = _nest(p), _torch(p)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _params(10 + step)
        ju, js = jopt.update(_nest(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(_torch(g), ts, tp)
        tp = engine.apply_updates(tp, tu)
    _close(tp, flax_to_torch(jp), 1e-6, 1e-7)
    want = optax_state_to_torch(js)
    assert set(ts) == set(want)
    for field, value in want.items():
        if field == "count":
            assert int(ts["count"]) == int(value) == 5
        else:
            _close(ts[field], value, 1e-6, 1e-7)


def test_nesterov_default_off_is_the_old_trace():
    """``nesterov`` defaults to False: sgd with momentum is the plain trace,
    bit for bit."""
    g, p = _torch(_params(3)), _torch(_params(4))
    old, new = engine.scaled(engine.trace(0.9), -0.1), engine.sgd(0.1, 0.9)
    so, sn = old.init(p), new.init(p)
    for _ in range(3):
        uo, so = old.update(g, so, p)
        un, sn = new.update(g, sn, p)
        assert all(torch.equal(uo[k], un[k]) for k in g)


# ---- the GKT ResNets


def _resnet_pair(seed: int = 0):
    rng = np.random.RandomState(seed)
    x = rng.rand(6, 16, 16, 3).astype(np.float32)
    jc = jax_resnet_gkt.GKTClientResNet(output_dim=K, num_blocks=1)
    js = jax_resnet_gkt.GKTServerResNet(output_dim=K, layers=(1, 1, 1))

    @jax.jit
    def init(x):  # one compile: flax's eager init dispatches op by op
        cv = jc.init({"params": jax.random.PRNGKey(0)}, x, train=False)
        _, feat = jc.apply(cv, x, train=False)
        return cv, js.init({"params": jax.random.PRNGKey(1)}, feat, train=False)

    cv, sv = init(jnp.asarray(x))
    return x, jc, js, cv, sv


def test_resnet_gkt_matches_jax():
    """GKTClientResNet (num_blocks 1) and GKTServerResNet (layers (1, 1, 1))
    on 16x16 inputs from the converted JAX variables: eval-mode logits and
    channels-last features, train-mode logits and new BatchNorm
    statistics."""
    x, jc, js, cv, sv = _resnet_pair()
    tc, ts = GKTClientResNet(output_dim=K), GKTServerResNet(output_dim=K, layers=(1, 1, 1))
    cvars, svars = flax_to_torch(cv, module=tc), flax_to_torch(sv, module=ts)
    assert set(cvars) == set(tc.state_dict()) and set(svars) == set(ts.state_dict())
    client, server = ModelTrainer(tc), ModelTrainer(ts)

    @jax.jit
    def jax_both(cv, sv, x):
        """Eval-mode outputs, then train-mode outputs and statistics."""
        jl, jf = jc.apply(cv, x, train=False)
        (tl, tf), cupd = jc.apply(cv, x, train=True, mutable=["batch_stats"])
        so, supd = js.apply(sv, tf, train=True, mutable=["batch_stats"])
        return jl, jf, js.apply(sv, jf, train=False), tl, cupd, so, supd

    jl, jf, jso, jtl, cupd, jto, supd = jax.tree.map(np.asarray,
                                                     jax_both(cv, sv, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    (tl, tf), _ = client.apply(cvars, xt)
    assert tf.shape == (6, 16, 16, 16)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(server.apply(svars, tf)[0].numpy(), jso, rtol=RTOL, atol=ATOL)
    # train mode: the batch's statistics, the running ones blended
    (tl, tf), cstate = client.apply(cvars, xt, None, True)
    np.testing.assert_allclose(tl.numpy(), jtl, rtol=RTOL, atol=ATOL)
    _close(cstate, flax_to_torch({"batch_stats": cupd["batch_stats"]}, module=tc))
    so, sstate = server.apply(svars, tf, None, True)
    np.testing.assert_allclose(so.numpy(), jto, rtol=RTOL, atol=ATOL)
    _close(sstate, flax_to_torch({"batch_stats": supd["batch_stats"]}, module=ts))


def test_full_width_server_shapes_match_jax():
    """The full-width (5, 6, 6) server and the client: every variable's
    name and shape against ``jax.eval_shape`` of the JAX init (no
    compile)."""
    for jmod, tmod, shape in (
            (jax_resnet_gkt.GKTServerResNet(output_dim=10), GKTServerResNet(output_dim=10),
             (1, 32, 32, 16)),
            (jax_resnet_gkt.GKTClientResNet(output_dim=10), GKTClientResNet(output_dim=10),
             (1, 32, 32, 3))):
        abstract = jax.eval_shape(lambda x, m=jmod: m.init({"params": jax.random.PRNGKey(0)},
                                                           x, train=False),
                                  jax.ShapeDtypeStruct(shape, jnp.float32))
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), abstract)
        want = {k: tuple(v.shape) for k, v in flax_to_torch(zeros, module=tmod).items()}
        assert want == {k: tuple(v.shape) for k, v in tmod.state_dict().items()}
    assert tmod is not None and GKTServerResNet().num_blocks == 17


# ---- FedGKTAPI


def _port_api(optimizer: str, init=None, **over):
    _, tds = _datasets()
    api = fedgkt.FedGKTAPI(tds, FedConfig(**_kw(optimizer, **over)), TwinClient(),
                           TwinServer(), device="cpu", **GKT_KW)
    if init is not None:
        cv, sv = init
        api.client_vars = flax_to_torch(cv, module=api.client_module)
        api.server_vars = flax_to_torch(sv, module=api.server_module)
    return api


def test_fedgkt_api_matches_jax(jax_run):
    """2 rounds at full batch on 3 ragged clients, from the JAX package's
    initial variables: every client's variables (BatchNorm statistics
    included), the server's, the server logits, the per-epoch server
    losses, both optimizers' states and Test/Acc."""
    optimizer, init, japi, jhist = jax_run
    tapi = _port_api(optimizer, init)
    thist = tapi.train()
    np.testing.assert_allclose(tapi.server_loss_history, japi.server_loss_history,
                               rtol=RTOL, atol=ATOL)
    _close(tapi.client_vars, flax_to_torch(japi.client_vars, module=tapi.client_module))
    _close(tapi.server_vars, flax_to_torch(japi.server_vars, module=tapi.server_module))
    np.testing.assert_allclose(tapi.server_logits.numpy(), np.asarray(japi.server_logits),
                               rtol=RTOL, atol=ATOL)
    # both optimizers' states, the server's persistent one among them
    for got, want in ((tapi.server_opt_state, japi.server_opt_state),
                      (tapi.client_opt_states, japi.client_opt_states)):
        want = optax_state_to_torch(want)
        assert set(got) == set(want)
        for field, value in want.items():
            if field == "count":
                assert torch.equal(got["count"], value)
            else:
                _close(got[field], value)
    # the same correct count (the float32 mean may differ in its last bit)
    np.testing.assert_allclose([h["Test/Acc"] for h in thist],
                               [h["Test/Acc"] for h in jhist], rtol=1e-6)


def test_epoch_batches_use_every_valid_row_once():
    """At batch 16 over 37 rows of which 29 are valid: every valid row once
    an epoch, in the valid positions; the padding (invalid rows, then row
    0 repeated) only where the mask is off; the extra array permuted with
    the rows."""
    n, count, b = 37, 29, 16
    x = torch.arange(n, dtype=torch.float32)[:, None]
    y = torch.arange(n)
    extra = torch.arange(n, dtype=torch.float32)[:, None] * 10
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        xe, ye, ee, bvalid = fedgkt._epoch_batches(x, y, extra, count, b, gen)
        assert xe.shape == (3, 16, 1) and bvalid.shape == (3, 16)
        rows = ye.reshape(-1)
        valid = bvalid.reshape(-1)
        assert sorted(rows[valid].tolist()) == list(range(count))
        assert all(r >= count or (i >= n and r == 0) for i, r in enumerate(rows.tolist())
                   if not valid[i])
        assert int(valid.sum()) == count and bool(valid[:count].all())
        assert torch.equal(ee.reshape(-1), rows.float() * 10)
        assert torch.equal(xe.reshape(-1), rows.float())


def test_fedgkt_resume_is_bit_for_bit(tmp_path):
    """3 rounds at batch 8 straight, against 2 rounds, a checkpoint and a
    new API resumed from it: client and server variables, both optimizers'
    states, the server logits and the histories bit for bit; a cold
    ``maybe_restore`` before any training takes the structure too."""
    straight = _port_api("sgd", comm_round=3, batch_size=8)
    straight.train()
    first = _port_api("sgd", comm_round=2, batch_size=8)
    first.train(ckpt_dir=str(tmp_path))
    resumed = _port_api("sgd", comm_round=3, batch_size=8)
    resumed.train(ckpt_dir=str(tmp_path))
    for name in ("client_vars", "client_opt_states", "server_vars", "server_opt_state"):
        a, b = getattr(straight, name), getattr(resumed, name)
        leaves_a = jax.tree.leaves(jax.tree.map(np.asarray, _numpy(a)))
        leaves_b = jax.tree.leaves(jax.tree.map(np.asarray, _numpy(b)))
        assert len(leaves_a) == len(leaves_b) > 0
        assert all(np.array_equal(u, v) for u, v in zip(leaves_a, leaves_b)), name
    assert torch.equal(straight.server_logits, resumed.server_logits)
    assert resumed.history == straight.history
    assert resumed.server_loss_history == straight.server_loss_history
    cold = _port_api("sgd", comm_round=3, batch_size=8)
    assert cold.server_logits is None
    assert cold.maybe_restore(str(tmp_path)) == 3
    assert torch.equal(cold.server_logits, straight.server_logits)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def test_pretrained_server_warm_start(tmp_path):
    """``pretrained_server_ckpt`` loads the server's variables from a
    checkpoint of the port's format; a directory without one raises
    FileNotFoundError."""
    base = _port_api("sgd")
    pre = {k: v + 0.123 for k, v in base.server_vars.items()}
    save_checkpoint(str(tmp_path), 0, {"tree": pre})
    _, tds = _datasets()
    warm = fedgkt.FedGKTAPI(tds, FedConfig(**_kw("sgd")), TwinClient(), TwinServer(),
                            pretrained_server_ckpt=str(tmp_path), device="cpu")
    assert all(torch.equal(warm.server_vars[k], pre[k]) for k in pre)
    with pytest.raises(FileNotFoundError):
        fedgkt.FedGKTAPI(tds, FedConfig(**_kw("sgd")), TwinClient(), TwinServer(),
                         pretrained_server_ckpt=str(tmp_path / "missing"), device="cpu")


def test_round_zero_has_no_kd_and_schedule_drives_epochs():
    """Round 0 trains the clients on CE alone (server logits of any value
    change nothing), and ``use_epoch_schedule`` takes the round's epochs
    from ``get_server_epoch_strategy`` (20 in round 0)."""
    a, b = _port_api("sgd", comm_round=1), _port_api("sgd", comm_round=1)
    x, y, counts, mask = a.staged()
    junk = torch.randn(C, N, K, generator=torch.Generator().manual_seed(5))
    a.client_phase(0, x, y, counts, torch.zeros(C, N, K))
    b.client_phase(0, x, y, counts, junk)
    assert all(torch.equal(a.client_vars[k], b.client_vars[k]) for k in a.client_vars)
    sched = fedgkt.FedGKTAPI(_datasets()[1], FedConfig(**_kw("sgd", comm_round=1)),
                             TwinClient(), TwinServer(), use_epoch_schedule=True, device="cpu")
    sched.train()
    assert len(sched.server_loss_history) == 20
