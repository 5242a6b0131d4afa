"""The port's NWP slice — TransformerLM, NWPTrainer, the StackOverflow NWP
surrogate, the converter on the transformer's tree and a FedAvg drive —
against the JAX package, on the same numpy inputs and flax-initialised
weights. Attention runs the plain versions of the flash kernels here and
the Pallas kernels in interpret mode on the JAX side."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import NWPTrainer as JaxNWPTrainer
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.transformer import TransformerLM as JaxTLM
from fedml_tpu_torch import FedAvgAPI, FedConfig, NWPTrainer, load_dataset
from fedml_tpu_torch.core.trainer import ClassificationTrainer
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax

V, DM, HEADS, LAYERS, MAXLEN, B, T = 50, 32, 2, 2, 24, 3, 20
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _setup(dtype="float32", seed=0, layers=LAYERS):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, V, size=(B, T)).astype(np.int32)
    jm = JaxTLM(vocab_size=V, d_model=DM, heads=HEADS, num_layers=layers, max_len=MAXLEN,
                dtype=DTYPES[dtype])
    gv = jm.init(jax.random.PRNGKey(seed), jnp.asarray(tokens))
    tm = create_model("transformer_nwp", output_dim=V, dtype=dtype, d_model=DM, heads=HEADS,
                      num_layers=layers, max_len=MAXLEN)
    return tokens, jm, gv, tm


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_convert_round_trip_on_the_transformer_tree():
    _, _, gv, tm = _setup()
    state = flax_to_torch(gv)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in tm.state_dict().items()}
    want, got = _flat(gv["params"]), _flat(torch_to_flax(state, tm)["params"])
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)
    # the leaf kinds: an embedding is not transposed, a LayerNorm weight
    # is a scale, a bias-less Dense kernel is transposed
    np.testing.assert_array_equal(state["tok_emb.weight"].numpy(),
                                  np.asarray(gv["params"]["tok_emb"]["embedding"]))
    assert "scale" in torch_to_flax(state, tm)["params"]["block0"]["ln1"]
    np.testing.assert_array_equal(state["block1.qkv.weight"].numpy(),
                                  np.asarray(gv["params"]["block1"]["qkv"]["kernel"]).T)


def test_convert_of_the_cnn_is_unchanged_by_its_module():
    tm = create_model("cnn", output_dim=5, input_hw=12)
    state = ClassificationTrainer(tm).init(torch.Generator().manual_seed(0), "cpu")
    plain, with_module = torch_to_flax(state)["params"], torch_to_flax(state, tm)["params"]
    assert _flat(plain).keys() == _flat(with_module).keys()
    for key, a in _flat(plain).items():
        np.testing.assert_array_equal(_flat(with_module)[key], a)


def test_forward_float32_matches_flax():
    tokens, jm, gv, tm = _setup()
    want = np.asarray(jm.apply(gv, jnp.asarray(tokens)))
    got = torch.func.functional_call(tm, flax_to_torch(gv), (torch.from_numpy(tokens),))
    assert got.shape == (B, T, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5, atol=2e-5)


def test_forward_bfloat16_compute():
    """bf16 compute with f32 params: both sides round the embeddings, Dense
    inputs, weights and outputs, LayerNorm outputs and residual sums to bf16
    (2**-9 relative per rounding), with float32 attention inside; XLA and
    PyTorch's CPU kernels accumulate in different orders, so single bf16
    roundings differ and compound over two blocks. 5e-2 absolute on logits
    of magnitude ~1."""
    tokens, jm, gv, tm = _setup("bfloat16", seed=1)
    want = np.asarray(jm.apply(gv, jnp.asarray(tokens))).astype(np.float32)
    got = torch.func.functional_call(tm, flax_to_torch(gv), (torch.from_numpy(tokens),))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=0, atol=5e-2)


def test_sequence_longer_than_max_len_raises():
    _, _, gv, tm = _setup()
    with pytest.raises(ValueError, match="exceeds max_len"):
        torch.func.functional_call(tm, flax_to_torch(gv),
                                   (torch.zeros(1, MAXLEN + 1, dtype=torch.long),))


def _batch(seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, V, size=(B + 1, T)).astype(np.int32)
    y = rng.randint(0, V, size=(B + 1, T)).astype(np.int32)
    y[:, -3:] = 0  # pad tokens
    mask = np.array([1, 1, 0, 1], np.float32)
    return x, y, mask


def test_nwp_loss_and_gradients_match_jax():
    _, jm, gv, tm = _setup(seed=2)
    x, y, mask = _batch(2)
    jt, tt = JaxNWPTrainer(jm), NWPTrainer(tm)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y), "mask": jnp.asarray(mask)}

    def jloss(params):
        return jt.loss_fn({"params": params}, jbatch, None, True)

    (jl, (_, jaux)), jgrads = jax.value_and_grad(jloss, has_aux=True)(gv["params"])
    leaves = {k: v.requires_grad_(True) for k, v in flax_to_torch(gv).items()}
    tl, (_, taux) = tt.loss_fn(leaves, {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                                        "mask": torch.from_numpy(mask)}, None, True)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=2e-5, err_msg=k)
    want = _flat(jgrads)
    got = _flat(torch_to_flax({k: v.grad for k, v in leaves.items()}, tm)["params"])
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=2e-6, err_msg=key)


def test_nwp_eval_matches_jax_per_client():
    """One batch of two clients' rows gives the sum of the JAX trainer's
    evaluations of each client: the reported loss is per client."""
    _, jm, gv, tm = _setup(seed=3)
    x, y, mask = _batch(3)
    jt, tt = JaxNWPTrainer(jm), NWPTrainer(tm)
    want = {}
    for rows in (slice(0, 2), slice(2, 4)):
        m = jt.eval_fn(gv, {"x": jnp.asarray(x[rows]), "y": jnp.asarray(y[rows]),
                            "mask": jnp.asarray(mask[rows])})
        want = {k: want.get(k, 0.0) + float(v) for k, v in m.items()}
    got = tt.eval_fn(flax_to_torch(gv), {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                                         "mask": torch.from_numpy(mask), "clients": 2})
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), w, rtol=2e-5, err_msg=k)


def test_nwp_argmax_ties_go_to_the_first_index():
    tt = NWPTrainer(create_model("transformer_nwp", output_dim=4, d_model=8, heads=2,
                                 num_layers=1, max_len=4))
    logits = torch.tensor([[[1.0, 3.0, 3.0, 0.0]]])
    tt.apply = lambda variables, x, generator=None, train=False: (logits, {})
    m = tt.eval_fn({}, {"x": None, "y": torch.tensor([[1]]), "mask": torch.ones(1)})
    assert float(m["test_correct"]) == 1.0


def test_init_follows_flax_defaults_by_kind():
    tm = create_model("transformer_nwp", output_dim=V, d_model=DM, heads=HEADS,
                      num_layers=1, max_len=MAXLEN)
    p = NWPTrainer(tm).init(torch.Generator().manual_seed(0), "cpu")
    assert set(p) == set(tm.state_dict())
    assert torch.equal(p["block0.ln1.weight"], torch.ones(DM))
    assert torch.equal(p["ln_f.bias"], torch.zeros(DM))
    assert torch.equal(p["block0.mlp_up.bias"], torch.zeros(4 * DM))
    # Embed: normal, std 1/sqrt(features); Dense: truncated at 2 std of
    # 1/sqrt(fan_in) after rescaling
    assert abs(float(p["tok_emb.weight"].std()) * np.sqrt(DM) - 1.0) < 0.1
    w = p["lm_head.weight"]
    assert float(w.abs().max()) <= 2 / 0.87962566103423978 / np.sqrt(DM) + 1e-6
    assert abs(float(w.std()) * np.sqrt(DM) - 1.0) < 0.1


@pytest.fixture(scope="module")
def nwp_datasets():
    """Both packages' StackOverflow NWP surrogate, 4 clients, built once (the
    transition table draws a permutation of the vocab per token)."""
    return (jax_load_dataset("stackoverflow_nwp", client_num_in_total=4, seed=0),
            load_dataset("stackoverflow_nwp", client_num_in_total=4, seed=0))


def test_surrogate_byte_identical(nwp_datasets):
    jds, tds = nwp_datasets
    assert tds.meta == jds.meta == {"task": "nwp"} and tds.class_num == jds.class_num == 10004
    for split in ("train", "test"):
        for leaf in ("x", "y", "counts"):
            g, w = getattr(getattr(tds, split), leaf), getattr(getattr(jds, split), leaf)
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert tds.train.x.shape[2:] == (20,) and tds.train.y.shape[2:] == (20,)


def _capped(ds, packed_cls, cap, test_cap):
    return dataclasses.replace(
        ds,
        train=packed_cls(np.ascontiguousarray(ds.train.x[:, :cap]),
                         np.ascontiguousarray(ds.train.y[:, :cap]),
                         np.minimum(ds.train.counts, cap)),
        test_global=(ds.test_global[0][:test_cap], ds.test_global[1][:test_cap]))


def test_fedavg_api_two_rounds_match_jax_drive(nwp_datasets):
    """A 2-round eager drive on the NWP surrogate at a small width (d_model
    32, 2 heads, 1 layer), shuffle off, the same flax-initialised weights:
    per-round train/test metrics and the final globals match the JAX drive
    at tests/test_torch_fedavg.py's tolerances."""
    kw = dict(dataset="stackoverflow_nwp", model="transformer_nwp", client_num_in_total=4,
              client_num_per_round=2, batch_size=8, lr=0.3, grad_clip=1.0, epochs=1,
              comm_round=2, shuffle=False, seed=0)
    jds = _capped(nwp_datasets[0], JaxPacked, 16, 32)
    tds = _capped(nwp_datasets[1], PackedClients, 16, 32)
    model = dict(d_model=32, heads=2, num_layers=1)
    japi = JaxFedAvgAPI(jds, JaxConfig(**kw), JaxNWPTrainer(JaxTLM(vocab_size=10004, **model)))
    tm = create_model("transformer_nwp", output_dim=10004, **model)
    tapi = FedAvgAPI(tds, FedConfig(**kw), NWPTrainer(tm), device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables)
    jhist, thist = japi.train(), tapi.train()
    assert len(jhist) == len(thist) == 2
    for jr, tr in zip(jhist, thist):
        for key in ("Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=1e-4, atol=1e-5,
                                       err_msg=f"round {jr['round']} {key}")
    want = _flat(japi.global_variables["params"])
    got = _flat(torch_to_flax(tapi.global_variables, tm)["params"])
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=2e-5, atol=1e-5, err_msg=key)


def test_cli_setup_picks_the_nwp_trainer_and_trains(monkeypatch):
    """The CLI's setup picks NWPTrainer for the nwp task; a round runs."""
    small = main_fedavg.create_model

    def narrow(name, output_dim, dtype="float32", **kw):
        return small(name, output_dim, dtype, d_model=16, heads=2, num_layers=1, max_len=20)

    monkeypatch.setattr(main_fedavg, "create_model", narrow)
    monkeypatch.setattr(main_fedavg, "load_dataset", lambda name, **kw: _capped(
        load_dataset(name, **kw), PackedClients, 8, 16))
    args = main_fedavg.add_args(__import__("argparse").ArgumentParser()).parse_args([
        "--dataset", "stackoverflow_nwp", "--model", "transformer_nwp",
        "--client_num_in_total", "2", "--client_num_per_round", "2", "--comm_round", "1",
        "--batch_size", "8", "--lr", "0.3", "--device", "cpu"])
    cfg, ds, trainer = main_fedavg.setup_run(args)
    assert isinstance(trainer, NWPTrainer)
    hist = FedAvgAPI(ds, cfg, trainer, device="cpu").train()
    assert len(hist) == 1 and np.isfinite(hist[0]["Test/Loss"]) and hist[0]["total"] > 0
