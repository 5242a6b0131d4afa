"""The port's TurboAggregate (``algorithms/turboaggregate.py``) against the
JAX package: every field function bit for bit, the shares bit for bit from
the same ``RandomState``, ``SecureAggregator`` bit for bit on identical
inputs (its draws too), its guards, and two ``TurboAggregateAPI`` rounds
within 4 * 2^-frac_bits of the JAX package's globals (one quantum a round
may flip under float32 training noise); ``main_turboaggregate`` through
``fed_launch``.

The JAX field vector concatenates flax leaves in ``jax.tree.leaves`` order,
kernels [in, out]; the port's, its own dict in PyTorch's layout. Fixed-point
sums are element-wise, so results are compared after converting the
layout."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import turboaggregate as jax_ta
from fedml_tpu.algorithms.fedavg import client_sampling as jax_client_sampling
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch import (ClassificationTrainer, FedConfig, TurboAggregateAPI,
                             client_sampling, create_model, load_dataset)
from fedml_tpu_torch.algorithms import turboaggregate as ta
from fedml_tpu_torch.experiments import fed_launch
from fedml_tpu_torch.utils.convert import flax_to_torch

P = ta.DEFAULT_PRIME


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_constants_and_modular_inverse_are_bitwise_jax():
    assert ta.DEFAULT_PRIME == jax_ta.DEFAULT_PRIME
    a = np.random.RandomState(0).randint(1, P, size=(7, 5)).astype(np.int64)
    _same(ta.modular_inv(a, P), jax_ta.modular_inv(a, P))
    assert np.all(np.mod(ta.modular_inv(a, P) * a, P) == 1)
    _same(ta.modular_inv(np.int64(12345), 10007), jax_ta.modular_inv(np.int64(12345), 10007))


@pytest.mark.parametrize("alpha,beta", [
    (np.arange(1, 8), np.arange(-2, 3)), (np.zeros(1), np.arange(1, 5)),
    (np.array([-3, 0, 4, 9]), np.array([1, 2, -7]))])
def test_lagrange_coefficients_are_bitwise_jax(alpha, beta):
    _same(ta.gen_lagrange_coeffs(alpha, beta, P), jax_ta.gen_lagrange_coeffs(alpha, beta, P))


@pytest.mark.parametrize("full_range", [False, True])
def test_mod_matmul_and_tensordot_are_bitwise_jax(full_range):
    """Full-range field elements are where a naive int64 product wraps."""
    rng = np.random.RandomState(1)
    hi = P if full_range else 1000
    A = rng.randint(0, hi, size=(6, 9)).astype(np.int64)
    B = rng.randint(0, hi, size=(9, 4, 3)).astype(np.int64)
    _same(ta._mod_matmul(A, B[:, :, 0], P), jax_ta._mod_matmul(A, B[:, :, 0], P))
    _same(ta._mod_tensordot(A, B, P), jax_ta._mod_tensordot(A, B, P))
    exact = (A.astype(object) @ B[:, :, 0].astype(object)) % P
    assert np.array_equal(ta._mod_matmul(A, B[:, :, 0], P), exact.astype(np.int64))
    _same(ta._poly_eval_matrix(np.arange(1, 6), 3, P), jax_ta._poly_eval_matrix(
        np.arange(1, 6), 3, P))


@pytest.mark.parametrize("N,T,seed", [(7, 3, 0), (5, 2, 1), (10, 4, 8)])
def test_bgw_shares_are_bitwise_jax(N, T, seed):
    """The same secrets and RandomState give the same shares and leave the
    generators in the same state; any T+1 shares decode the secrets."""
    X = np.random.RandomState(seed + 100).randint(0, P, size=(4, 6)).astype(np.int64)
    rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
    shares = ta.bgw_encoding(X, N, T, P, rt)
    _same(shares, jax_ta.bgw_encoding(X, N, T, P, rj))
    assert str(rt.get_state()) == str(rj.get_state())
    for idx in (list(range(T + 1)), list(range(N - T - 1, N))):
        dec = ta.bgw_decoding(shares[idx], idx, P)
        _same(dec, jax_ta.bgw_decoding(shares[idx], idx, P))
        _same(dec[0], X)


def test_bgw_shares_add():
    """The sum of shares decodes to the sum of secrets: the property the
    secure aggregation rests on."""
    rng = np.random.RandomState(1)
    A = rng.randint(0, 1000, size=(3, 4)).astype(np.int64)
    B = rng.randint(0, 1000, size=(3, 4)).astype(np.int64)
    s = np.mod(ta.bgw_encoding(A, 5, 2, rng=rng) + ta.bgw_encoding(B, 5, 2, rng=rng), P)
    np.testing.assert_array_equal(ta.bgw_decoding(s[:3], [0, 1, 2])[0], A + B)


@pytest.mark.parametrize("subset", [[0, 1, 2, 3], [1, 3, 5, 6], [3, 4, 5, 6]])
def test_lcc_is_bitwise_jax(subset):
    rng_x = np.random.RandomState(7)
    X = rng_x.randint(0, P, size=(8, 5)).astype(np.int64)
    K, T, N = 2, 1, 7
    enc = ta.lcc_encoding(X, N, K, T, rng=np.random.RandomState(3))
    _same(enc, jax_ta.lcc_encoding(X, N, K, T, rng=np.random.RandomState(3)))
    alpha_s = np.arange(-(N // 2), -(N // 2) + N, dtype=np.int64)
    dec = ta.lcc_decoding(enc[subset], alpha_s[subset], K, T)
    _same(dec, jax_ta.lcc_decoding(enc[subset], alpha_s[subset], K, T))
    np.testing.assert_array_equal(dec.reshape(8, 5), X)


def test_quantization_is_bitwise_jax_after_the_layout():
    """The same flax-initialised model: the port's field vector holds the
    JAX package's elements (as a multiset: the layouts differ), and the
    dequantized trees are the same bits once converted."""
    jt = JaxTrainer(jax_create_model("lr", output_dim=10))
    tree = jt.init(jax.random.PRNGKey(3), jnp.zeros((1, 784)))
    module = create_model("lr", output_dim=10, input_shape=(784,))
    ours = flax_to_torch(tree, module=module)
    for frac_bits in (8, 16):
        jq, tq = jax_ta.quantize_tree(tree, frac_bits), ta.quantize_tree(ours, frac_bits)
        assert tq.dtype == jq.dtype == np.int64 and np.array_equal(np.sort(tq), np.sort(jq))
        back = ta.dequantize_vector(tq, ours, frac_bits)
        want = flax_to_torch(jax_ta.dequantize_vector(jq, tree, frac_bits), module=module)
        assert set(back) == set(want)
        for k in want:
            assert back[k].dtype == torch.float32 and torch.equal(back[k], want[k]), k


def _trees(seed, n, shapes=(("b", (3,)), ("w", (5, 3)))):
    """n client trees with sorted keys (``jax.tree.leaves``' order), as
    JAX arrays and as the port's tensors."""
    rng = np.random.RandomState(seed)
    arrays = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes} for _ in range(n)]
    return ([{k: jnp.asarray(v) for k, v in a.items()} for a in arrays],
            [{k: torch.from_numpy(v) for k, v in a.items()} for a in arrays])


@pytest.mark.parametrize("weights,threshold,groups", [
    ([1.0, 2.0, 3.0, 4.0], 2, 1), ([1.0, 1.0, 1.0, 1.0], None, 2),
    ([1.0, 1.0, 1000.0, 5.0], 1, 3), ([0.0, 3.0, 3.0, 7.0], 2, 2)])
def test_secure_aggregator_is_bitwise_jax(weights, threshold, groups):
    """Identical inputs: the secure average equals the JAX package's bit for
    bit (the last multiply in float32), both generators end in the same
    state, and it is the plain weighted mean within the quantization."""
    jtrees, ttrees = _trees(9, len(weights))
    jagg = jax_ta.SecureAggregator(num_clients=4, threshold=threshold, seed=5)
    tagg = ta.SecureAggregator(num_clients=4, threshold=threshold, seed=5)
    want = jagg.secure_weighted_sum_grouped(jtrees, np.array(weights), groups)
    got = tagg.secure_weighted_sum_grouped(ttrees, np.array(weights), groups)
    assert str(tagg.rng.get_state()) == str(jagg.rng.get_state())
    assert list(got) == sorted(want)
    for k in want:
        _same(got[k].numpy(), np.asarray(want[k]))
    w = np.array(weights) / np.sum(weights)
    for k in want:
        plain = sum(wi * t[k].numpy().astype(np.float64) for wi, t in zip(w, ttrees))
        np.testing.assert_allclose(got[k].numpy(), plain, atol=2e-2)
    assert set(tagg.seconds) == {"quantize", "encode", "decode"}


def test_uniform_weights_do_not_shrink_the_model():
    """Rounded weights that do not sum to 256 (3 x 85 = 255) must not scale
    the average: the division is by the rounded sum."""
    trees = [{"w": torch.full((4,), float(i + 1))} for i in range(3)]
    out = ta.SecureAggregator(num_clients=3, threshold=1).secure_weighted_sum(
        trees, np.ones(3))
    np.testing.assert_allclose(out["w"].numpy(), np.full(4, 2.0), atol=1e-3)


def test_aggregator_guards_raise_as_jax():
    _, ttrees = _trees(2, 3)
    agg = ta.SecureAggregator(num_clients=3, threshold=1)
    with pytest.raises(ValueError, match="num_groups"):
        agg.secure_weighted_sum_grouped(ttrees, np.ones(3), 0)
    with pytest.raises(ValueError, match="underflows"):
        agg.secure_weighted_sum(ttrees, np.array([1.0, 1.0, 1e9]))
    big = [{"w": torch.full((2,), 3000.0)} for _ in range(3)]
    with pytest.raises(ValueError, match="field capacity"):
        agg.secure_weighted_sum(big, np.ones(3))
    with pytest.raises(ValueError, match="field capacity"):
        jax_ta.SecureAggregator(num_clients=3, threshold=1).secure_weighted_sum(
            [{"w": jnp.full((2,), 3000.0)} for _ in range(3)], np.ones(3))


@pytest.fixture(scope="module")
def mnist12():
    return load_dataset("mnist", client_num_in_total=12, partition_method="homo", seed=3)


@pytest.fixture(scope="module")
def jax_mnist12():
    return jax_load_dataset("mnist", client_num_in_total=12, partition_method="homo", seed=3)


def test_turboaggregate_rounds_match_jax(mnist12, jax_mnist12):
    """2 rounds of 6 sampled clients (the same cohorts, bitwise), 2 groups,
    full batch from the same weights: the secure global within 4 * 2^-16 of
    the JAX package's, and one flat copy each way a round."""
    kw = dict(dataset="mnist", model="lr", batch_size=-1, epochs=1, lr=0.1, comm_round=2,
              grad_clip=None, client_num_in_total=12, client_num_per_round=6, shuffle=False,
              seed=0)
    for r in range(2):
        assert np.array_equal(client_sampling(r, 12, 6), jax_client_sampling(r, 12, 6))
    japi = jax_ta.TurboAggregateAPI(jax_mnist12, JaxConfig(**kw),
                                    JaxTrainer(jax_create_model("lr", output_dim=10)))
    module = create_model("lr", output_dim=10, input_shape=mnist12.train.x.shape[2:])
    tapi = TurboAggregateAPI(mnist12, FedConfig(**kw), ClassificationTrainer(module),
                             device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables, module=module)
    jhist, thist = japi.train(), tapi.train()
    for jr, tr in zip(jhist, thist):
        for key in ("Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=1e-4, atol=1e-4, err_msg=key)
    want = flax_to_torch(japi.global_variables, module=module)
    for k in want:
        np.testing.assert_allclose(tapi.global_variables[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=4 * 2.0 ** -16, err_msg=k)
    n_params = sum(v.numel() for v in want.values())
    assert tapi.transfers == {"d2h_bytes": 6 * n_params * 4, "h2d_bytes": n_params * 4}


def test_main_turboaggregate_through_fed_launch(tmp_path):
    run = tmp_path / "run"
    cfg = tmp_path / "turboaggregate.yaml"
    args = {"dataset": "mnist", "model": "lr", "partition_method": "homo",
            "client_num_in_total": 4, "client_num_per_round": 4, "comm_round": 2,
            "epochs": 1, "batch_size": 32, "lr": 0.1, "num_groups": 2, "run_dir": str(run)}
    cfg.write_text("algorithm: turboaggregate\nargs:\n"
                   + "".join(f"  {k}: {v}\n" for k, v in args.items()))
    hist = fed_launch.main(["--config", str(cfg), "--override", "device=cpu"])
    assert [h["round"] for h in hist] == [0, 1]
    # secure group-ring aggregation still trains: accuracy well above chance
    summary = json.loads((run / "wandb-summary.json").read_text())
    assert summary["Test/Acc"] > 0.5
