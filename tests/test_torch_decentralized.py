"""The port's topologies (``core/topology.py``) and decentralized gossip
(``algorithms/decentralized.py``) against the JAX package, its oracles
inside the port, and ``main_decentralized`` through ``fed_launch``.

The mixing matrices and neighbor lists equal the JAX package's bit for bit.
DSGD and push-sum run 20 streaming iterations of 2-class logistic
regression (no dropout) from the JAX package's node-stacked init, carried
across by ``utils/convert.py::flax_to_torch`` with the module (the leading
node axis): the node models and the online losses within 1e-5."""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.decentralized import DecentralizedFLAPI as JaxDecentralized
from fedml_tpu.core import topology as jax_topology
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch import ClassificationTrainer, DecentralizedFLAPI, FedConfig, create_model
from fedml_tpu_torch.algorithms.decentralized import build_gossip_step
from fedml_tpu_torch.core import topology
from fedml_tpu_torch.experiments import fed_launch
from fedml_tpu_torch.experiments.main_decentralized import make_stream
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax

DIM = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _streaming_data(n_nodes=8, T=30, dim=DIM, seed=0):
    """tests/test_algorithms.py::_streaming_data's draws."""
    rng = np.random.RandomState(seed)
    w = rng.normal(size=(dim, 2)).astype(np.float32)
    x = rng.normal(size=(n_nodes, T, dim)).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.normal(size=(n_nodes, T, 2)), axis=-1).astype(np.int32)
    return x, y


def _module(dim=DIM):
    return create_model("lr", output_dim=2, input_shape=(dim,))


def _managers(pkg, name, args):
    cls = getattr(pkg, name)
    if name == "AsymmetricTopologyManager":
        *sizes, seed = args
        return cls(*sizes, np.random.RandomState(seed))
    return cls(*args)


@pytest.mark.parametrize("name,args", [
    ("SymmetricTopologyManager", (8, 4)), ("SymmetricTopologyManager", (6, 2)),
    ("SymmetricTopologyManager", (11, 6)), ("AsymmetricTopologyManager", (8, 3, 3, 0)),
    ("AsymmetricTopologyManager", (8, 3, 3, 1)), ("AsymmetricTopologyManager", (12, 4, 4, 5)),
    ("FullyConnectedTopologyManager", (5,))])
def test_topology_is_bitwise_jax(name, args):
    got, want = _managers(topology, name, args), _managers(jax_topology, name, args)
    got.generate_topology()
    want.generate_topology()
    g, w = got.mixing_matrix(), want.mixing_matrix()
    assert g.dtype == w.dtype == np.float32 and g.tobytes() == w.tobytes()
    assert got.topology.tobytes() == want.topology.tobytes()
    np.testing.assert_allclose(g.sum(axis=1), np.ones(got.n), atol=1e-6)
    for i in range(got.n + 1):  # the last index is out of range: []
        for fn in ("get_in_neighbor_idx_list", "get_out_neighbor_idx_list"):
            assert getattr(got, fn)(i) == getattr(want, fn)(i), (fn, i)
    assert got.get_in_neighbor_idx_list(1) == want.get_in_neighbor_idx_list(1)


def test_symmetric_ring_neighbors():
    m = topology.SymmetricTopologyManager(6, 2)
    m.generate_topology()
    assert m.get_in_neighbor_idx_list(1) == [0, 2]  # pure ring neighbors


@pytest.mark.parametrize("model", ["lr", "cnn"])
def test_node_stacked_init_converts_with_the_module(model):
    """A node-stacked flax init [N, ...] converts leaf by leaf: with the
    module each kernel's rank comes from its parameter, the node axis is
    ``_kernel_to_torch``'s lead, and node i's slice is node i's own
    conversion."""
    n = 3
    if model == "lr":
        tmod = _module()
        jt = JaxTrainer(jax_create_model("lr", output_dim=2))
        stacked = jax.vmap(lambda k: jt.init(k, jnp.zeros((1, DIM))))(
            jax.random.split(jax.random.PRNGKey(0), n))
    else:
        # conv kernels [N, h, w, in, out]: flax-layout node trees made from
        # the port's own inits (torch_to_flax is held against JAX elsewhere)
        tmod = create_model("cnn", output_dim=62)
        nodes = [torch_to_flax(ClassificationTrainer(tmod).init(
            torch.Generator().manual_seed(i), "cpu"), module=tmod) for i in range(n)]
        stacked = jax.tree.map(lambda *leaves: np.stack(leaves), *nodes)
    got = flax_to_torch(stacked, module=tmod)
    shapes = {k: tuple(v.shape) for k, v in tmod.state_dict().items()}
    assert {k: tuple(v.shape[1:]) for k, v in got.items()} == shapes
    for i in range(n):
        node = flax_to_torch(jax.tree.map(lambda a, i=i: np.asarray(a)[i], stacked), module=tmod)
        assert all(torch.equal(got[k][i], node[k]) for k in node)


def _pair(x, y, topo_args, push_sum, iterations=20, backend="vmap"):
    """The JAX run and the port's from the same node inits; returns both
    APIs and their final z."""
    name = "AsymmetricTopologyManager" if push_sum else "SymmetricTopologyManager"
    cfg = dict(lr=0.1, seed=0, backend=backend)
    japi = JaxDecentralized(JaxTrainer(jax_create_model("lr", output_dim=2)), JaxConfig(**cfg),
                            _managers(jax_topology, name, topo_args), push_sum=push_sum)
    module = _module(x.shape[-1])
    tapi = DecentralizedFLAPI(ClassificationTrainer(module), FedConfig(**cfg),
                              _managers(topology, name, topo_args), push_sum=push_sum,
                              device="cpu")
    init = flax_to_torch(japi.init_nodes(jnp.asarray(x[0, :1])), module=module)
    jz = japi.run(x, y, iterations)
    tz = tapi.run(x, y, iterations, variables=init)
    return japi, tapi, flax_to_torch(jz, module=module), tz


@pytest.mark.parametrize("push_sum,topo_args", [(False, (8, 4)), (True, (8, 3, 3, 1))])
def test_gossip_matches_jax(push_sum, topo_args):
    """20 iterations of DSGD on the symmetric ring and of push-sum on a
    directed one: every node's model and every online loss within 1e-5."""
    x, y = _streaming_data(seed=int(push_sum))
    japi, tapi, want, got = _pair(x, y, topo_args, push_sum)
    assert torch.equal(tapi.W.cpu(), torch.from_numpy(np.array(japi.W)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert len(tapi.loss_history) == len(japi.loss_history) == 20
    np.testing.assert_allclose(tapi.loss_history, japi.loss_history, rtol=1e-5, atol=1e-5)
    assert tapi.regret() == pytest.approx(japi.regret(), rel=1e-5)


def test_fully_connected_step_is_the_node_average():
    """One gossip step on the fully-connected topology at lr 0: every node
    holds the exact average of the node models (1e-6)."""
    n = 5
    topo = topology.FullyConnectedTopologyManager(n)
    trainer = ClassificationTrainer(_module())
    api = DecentralizedFLAPI(trainer, FedConfig(lr=0.0, seed=0), topo, device="cpu")
    z = api.init_nodes()
    batch = {"x": torch.zeros(n, 1, DIM), "y": torch.zeros(n, 1, dtype=torch.int32),
             "mask": torch.ones(n, 1)}
    x_new, omega, z_new, losses = api.step(dict(z), torch.ones(n), z, batch, api.W,
                                           torch.Generator().manual_seed(0))
    assert losses.shape == (n,) and torch.equal(omega, torch.ones(n))
    assert not torch.allclose(z["linear.weight"], z["linear.weight"].mean(0))  # apart
    for k, v in z.items():
        mean = v.mean(0, keepdim=True).expand_as(v)
        np.testing.assert_allclose(z_new[k].numpy(), mean.numpy(), rtol=0, atol=1e-6)


def test_pushsum_omega_moves_and_its_mass_is_conserved():
    """On a directed (row- but not doubly-stochastic) W, push-sum's omega
    must move (the mix is W^T), and W^T keeps its total mass: sum(omega)
    stays N, step after step."""
    topo = topology.AsymmetricTopologyManager(6, 3, 3, np.random.RandomState(0))
    topo.generate_topology()
    W = torch.from_numpy(topo.mixing_matrix())
    assert float((W - W.T).abs().max()) > 1e-6  # genuinely directed
    trainer = ClassificationTrainer(_module())
    step = build_gossip_step(trainer, FedConfig(lr=0.0), push_sum=True)
    api = DecentralizedFLAPI(trainer, FedConfig(seed=0), topo, device="cpu")
    z = api.init_nodes()
    batch = {"x": torch.zeros(6, 1, DIM), "y": torch.zeros(6, 1, dtype=torch.int32),
             "mask": torch.ones(6, 1)}
    x, omega = dict(z), torch.ones(6)
    for _ in range(5):
        x, omega, z, _ = step(x, omega, z, batch, W, torch.Generator().manual_seed(0))
        np.testing.assert_allclose(float(omega.sum()), 6.0, rtol=1e-6)
    assert float((omega - 1.0).abs().max()) > 1e-3


def test_dsgd_consensus_and_learning():
    """The JAX package's oracle in the port: the online loss falls and
    gossip drives the nodes to consensus (spread under 0.05)."""
    x, y = _streaming_data()
    api = DecentralizedFLAPI(ClassificationTrainer(_module()), FedConfig(lr=0.1, seed=0),
                             topology.SymmetricTopologyManager(8, 4), device="cpu")
    z = api.run(x, y)
    assert np.mean(api.loss_history[-5:]) < np.mean(api.loss_history[:5])
    assert float(z["linear.weight"].std(0, unbiased=False).max()) < 0.05


def test_shard_map_on_one_device_warns_and_mixes_densely(caplog):
    """More gossip nodes than devices: the JAX package warns and uses the
    dense W @ x mix, and so does the port, the same bits as the dense
    backend; a mesh over more ranks than the process group has raises (the
    raise over a real group of 2 ranks is tests/test_torch_multihost.py's)."""
    x, y = _streaming_data(n_nodes=6, T=5)
    runs = []
    for backend in ("vmap", "shard_map"):
        with caplog.at_level(logging.WARNING, logger="fedml_tpu_torch.algorithms.decentralized"):
            api = DecentralizedFLAPI(ClassificationTrainer(_module()),
                                     FedConfig(lr=0.1, seed=0, backend=backend),
                                     topology.SymmetricTopologyManager(6, 2), device="cpu")
        runs.append(api.run(x, y))
    assert "dense single-chip" in caplog.text
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    with pytest.raises(ValueError, match="one process a rank"):
        DecentralizedFLAPI(ClassificationTrainer(_module()),
                           FedConfig(backend="shard_map", mesh_shape=(2,)),
                           topology.SymmetricTopologyManager(6, 2), device="cpu")


def test_main_stream_is_the_jax_mains():
    rng = np.random.RandomState(4)
    w = rng.normal(size=(5, 2)).astype(np.float32)
    xw = rng.normal(size=(3, 7, 5)).astype(np.float32)
    x, y = make_stream(3, 7, 5, 4)
    assert x.tobytes() == xw.tobytes()
    assert y.dtype == np.int32 and np.array_equal(y, np.argmax(xw @ w, axis=-1))


@pytest.mark.parametrize("mode,symmetric", [("dsgd", 1), ("pushsum", 0)])
def test_main_decentralized_through_fed_launch(tmp_path, mode, symmetric):
    run = tmp_path / "run"
    cfg = tmp_path / "decentralized.yaml"
    cfg.write_text(f"algorithm: decentralized\nargs:\n  client_number: 6\n  iterations: 20\n"
                   f"  mode: {mode}\n  b_symmetric: {symmetric}\n  run_dir: {run}\n")
    losses = fed_launch.main(["--config", str(cfg), "--override", "device=cpu"])
    assert len(losses) == 20 and np.isfinite(losses[-1])
    summary = json.loads((run / "wandb-summary.json").read_text())
    assert summary["final_loss"] == losses[-1]
    assert summary["regret"] == pytest.approx(np.mean(losses))
