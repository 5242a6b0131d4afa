"""The port's SplitNN (``algorithms/splitnn.py``) against the JAX package:
one split step, the relay over ragged clients and the evaluation.

The two packages draw their initial weights and shuffles from their own
streams, so the relay's parity runs at full batch (one batch a client: the
order of rows moves only float rounding) from the JAX package's initial
parameters, converted. Tolerances: 2e-5 relative and 1e-5 absolute."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fedml_tpu.algorithms import splitnn as jax_splitnn
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import FederatedDataset as JaxDataset
from fedml_tpu_torch.algorithms import splitnn
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.utils.convert import flax_to_torch

RTOL, ATOL = 2e-5, 1e-5
C, N, SIDE, K, WIDTH = 3, 12, 8, 4, 4
COUNTS = np.array([12, 7, 10], np.int32)  # ragged: two clients padded
KW = dict(comm_round=2, epochs=2, batch_size=-1, lr=0.05, client_num_in_total=C,
          client_num_per_round=C, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _datasets():
    rng = np.random.RandomState(0)
    x = rng.rand(C, N, SIDE, SIDE, 3).astype(np.float32)
    y = rng.randint(0, K, (C, N)).astype(np.int32)
    for c in range(C):  # the packers' zero padding
        x[c, COUNTS[c]:] = 0
        y[c, COUNTS[c]:] = 0
    te = (rng.rand(30, SIDE, SIDE, 3).astype(np.float32), rng.randint(0, K, 30).astype(np.int32))
    flat = (x.reshape(-1, SIDE, SIDE, 3), y.reshape(-1))
    return (JaxDataset(name="tiny", train=JaxPacked(x, y, COUNTS), test=None, train_global=flat,
                       test_global=te, class_num=K),
            FederatedDataset(name="tiny", train=PackedClients(x, y, COUNTS), test=None,
                             train_global=flat, test_global=te, class_num=K))


def _modules():
    lower = splitnn.SplitLowerCNN(width=WIDTH)
    upper = splitnn.SplitUpperCNN((SIDE // 4) * (SIDE // 4) * 2 * WIDTH, output_dim=K)
    return lower, upper


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's SplitNNAPI, 2 cycles: its initial parameters
    (numpy), its trained state and history."""
    jds, _ = _datasets()
    api = jax_splitnn.SplitNNAPI(jds, JaxConfig(**KW), jax_splitnn.SplitLowerCNN(width=WIDTH),
                                 jax_splitnn.SplitUpperCNN(output_dim=K))
    init = jax.tree.map(np.asarray, (api.client_params, api.server_params))
    hist = api.train()
    return init, api, hist


def _port_api(init=None, **kw):
    _, tds = _datasets()
    lower, upper = _modules()
    api = splitnn.SplitNNAPI(tds, FedConfig(**KW), lower, upper, device="cpu", **kw)
    if init is not None:
        api.client_params = flax_to_torch(init[0], module=lower)
        api.server_params = flax_to_torch(init[1], module=upper)
    return api


@pytest.mark.parametrize("momentum,wd", [(None, None), (0.0, 0.0)])
def test_split_step_matches_jax(momentum, wd):
    """One ``build_split_step`` on a padded batch from the same converted
    parameters, twice (so momentum acts): both halves' parameters and the
    metrics, under the reference's momentum 0.9 and wd 5e-4 and under an
    explicit 0.0 of each."""
    rng = np.random.RandomState(3)
    x = rng.rand(12, SIDE, SIDE, 3).astype(np.float32)
    y = rng.randint(0, K, 12).astype(np.int32)
    mask = (np.arange(12) < 9).astype(np.float32)
    jl, ju = jax_splitnn.SplitLowerCNN(width=WIDTH), jax_splitnn.SplitUpperCNN(output_dim=K)
    cp = jl.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]
    sp = ju.init({"params": jax.random.PRNGKey(1)}, jl.apply({"params": cp}, jnp.asarray(x)))[
        "params"]
    jcfg, tcfg = JaxConfig(lr=0.1), FedConfig(lr=0.1)
    jstep = jax.jit(jax_splitnn.build_split_step(jl, ju, jcfg, momentum, wd))
    jopt = jax_splitnn.make_splitnn_optimizer(jcfg, momentum, wd)
    jco, jso = jopt.init(cp), jopt.init(sp)
    lower, upper = _modules()
    tcp, tsp = flax_to_torch(cp, module=lower), flax_to_torch(sp, module=upper)
    topt = splitnn.make_splitnn_optimizer(tcfg, momentum, wd)
    tco, tso = topt.init(tcp), topt.init(tsp)
    tstep = splitnn.build_split_step(lower, upper, tcfg, momentum, wd)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y), "mask": jnp.asarray(mask)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "mask": torch.from_numpy(mask)}
    for _ in range(2):
        cp, sp, jco, jso, jm = jstep(cp, sp, jco, jso, jb)
        tcp, tsp, tco, tso, tm = tstep(tcp, tsp, tco, tso, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL)
        assert float(tm["correct"]) == float(jm["correct"])
        assert float(tm["total"]) == float(jm["total"]) == 9.0
    _close(tcp, flax_to_torch(cp, module=lower))
    _close(tsp, flax_to_torch(sp, module=upper))


def test_splitnn_relay_matches_jax(jax_run):
    """2 relay cycles of 2 epochs at full batch over 3 ragged clients from
    the JAX package's initial parameters: every client's lower half, the
    trunk and the history (Train/Acc exact, Train/Loss within 2e-5)."""
    init, japi, jhist = jax_run
    tapi = _port_api(init)
    thist = tapi.train()
    lower, upper = tapi.client_module, tapi.server_module
    _close(tapi.client_params, flax_to_torch(japi.client_params, module=lower))
    _close(tapi.server_params, flax_to_torch(japi.server_params, module=upper))
    assert [h["round"] for h in thist] == [h["round"] for h in jhist] == [0, 1]
    for t, j in zip(thist, jhist):
        assert t["Train/Acc"] == pytest.approx(j["Train/Acc"], abs=1e-12)
        np.testing.assert_allclose(t["Train/Loss"], j["Train/Loss"], rtol=RTOL)


def test_splitnn_evaluate_matches_jax(jax_run):
    """``evaluate`` on the trained state: the test accuracy averaged over
    every client's lower half, from the JAX package's trained parameters."""
    _, japi, _ = jax_run
    tapi = _port_api()
    tapi.client_params = flax_to_torch(japi.client_params, module=tapi.client_module)
    tapi.server_params = flax_to_torch(japi.server_params, module=tapi.server_module)
    assert tapi.evaluate()["Test/Acc"] == pytest.approx(japi.evaluate()["Test/Acc"], abs=1e-12)


def test_all_padding_batch_still_steps():
    """At batch 4, client 1 (7 rows of 12) ends on an all-padding batch: its
    loss and counts are 0, yet momentum and weight decay move both halves,
    as the JAX scan's unconditional step does."""
    tapi = _port_api()
    tapi.cfg = FedConfig(**dict(KW, batch_size=4))
    x, y, counts = tapi.staged()
    cp = {k: v[1] for k, v in tapi.client_params.items()}
    sp, co, so = tapi.server_params, tapi.opt.init(cp), tapi.server_opt
    gen = torch.Generator().manual_seed(0)
    cp, sp, co, so, _ = tapi.client_epoch(cp, sp, co, so, x[1], y[1], 7, gen)
    batch = {"x": x[1][:4], "y": y[1][:4], "mask": torch.zeros(4)}
    cp2, sp2, _, _, m = tapi.step(cp, sp, co, so, batch)
    assert float(m["loss"]) == 0.0 and float(m["total"]) == 0.0
    assert all(not torch.equal(cp2[k], cp[k]) for k in cp)
    assert all(not torch.equal(sp2[k], sp[k]) for k in sp)
