"""The port's federated LoRA (``fedml_tpu_torch/models/lora.py``) against the
JAX package's ``fedml_tpu/models/lora.py``: the adapter tree's paths, shapes
and leaf order (the lm_head excluded), the merged forward and the adapters'
gradients, and one engine round, all with the JAX package's adapters
injected through the converter (the adapters' initial values are drawn
from torch generators, not JAX's stream); rank 0 structurally off; the
frozen base bit for bit across a drive; the adapters-only checkpoint and
its bitwise resume; the guard's rollback; LoRA x top-k on the buffered
drive; and every ``fedml_tpu/core/spec.py`` row on the LoRA and
personalization axes raised with its reason verbatim.

Small shapes: the transformer at vocab 64, d_model 32, 2 heads, T 20;
MNIST logistic regression on 8 homo clients capped at 48 rows, shuffle off
(no dropout in either model), so both packages train on the same streams.
Tolerances: rtol 2e-5, atol 1e-5 (``tests/test_sequence.py:33``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.aggregators import make_aggregator as jax_aggregator
from fedml_tpu.algorithms.engine import build_round_fn as jax_round_fn
from fedml_tpu.core import spec as jax_spec
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxClassifier
from fedml_tpu.core.trainer import NWPTrainer as JaxNWPTrainer
from fedml_tpu.models.cnn import CNN_DropOut as JaxCNN
from fedml_tpu.models.lora import LoRATrainer as JaxLoRA
from fedml_tpu.models.lora import merge_lora_params as jax_merge_lora
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.models.rnn import RNN_OriginalFedAvg as JaxRNN
from fedml_tpu.models.rnn import RNN_StackOverFlow as JaxRNNSO
from fedml_tpu.models.transformer import TransformerLM as JaxTLM
from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, NWPTrainer
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import build_round_fn
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.models.cnn import CNN_DropOut
from fedml_tpu_torch.models.lora import (BASE_PREFIX, LoRATrainer, adapter_order,
                                         is_adapter, lora_base, maybe_wrap_lora,
                                         strip_lora_base)
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.models.rnn import RNN_OriginalFedAvg, RNN_StackOverFlow
from fedml_tpu_torch.robustness.chaos import FaultPlan
from fedml_tpu_torch.robustness.guard import GuardVerdict
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.utils.pytree import tree_leaves
from test_torch_fedavg import _capped

V, DM, HEADS, MAXLEN, T = 64, 32, 2, 24, 20
RANK = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _paths(tree, prefix=""):
    """{"a/b/c": array} of a nested tree."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _tlm(layers=2):
    jm = JaxTLM(vocab_size=V, d_model=DM, heads=HEADS, num_layers=layers, max_len=MAXLEN)
    tm = create_model("transformer_nwp", output_dim=V, d_model=DM, heads=HEADS,
                      num_layers=layers, max_len=MAXLEN)
    return jm, tm


def _models():
    jm, tm = _tlm(1)
    return {
        "transformer": (JaxNWPTrainer(jm), NWPTrainer(tm), np.zeros((1, T), np.int32)),
        "lr": (JaxClassifier(jax_create_model("lr", output_dim=10)),
               ClassificationTrainer(create_model("lr", output_dim=10, input_shape=(784,))),
               np.zeros((1, 784), np.float32)),
        "cnn": (JaxClassifier(JaxCNN(output_dim=10)),
                ClassificationTrainer(CNN_DropOut(output_dim=10)),
                np.zeros((1, 28, 28, 1), np.float32)),
    }


@pytest.mark.parametrize("name", ["transformer", "lr", "cnn"])
def test_adapter_tree_matches_jax(name):
    """The adapter entries' flax paths and shapes are the JAX package's (the
    lm_head, embeddings, norms and conv kernels get none), and
    ``adapter_order`` is ``jax.tree.flatten``'s order, the bank row's."""
    jt, tt, example = _models()[name]
    jgv = JaxLoRA(jt, rank=RANK).init(jax.random.PRNGKey(0), jnp.asarray(example))
    tgv = LoRATrainer(tt, rank=RANK).init(torch.Generator().manual_seed(0), "cpu")
    want = {p: a.shape for p, a in _paths(jgv["params"]).items()}
    adapters = {k: v for k, v in strip_lora_base(tgv).items() if k.endswith(("lora_A",
                                                                            "lora_B"))}
    got = {p: a.shape for p, a in _paths(torch_to_flax(adapters, tt.module)["params"]).items()}
    assert got == want
    assert not any("lm_head" in p for p in got)
    flat = jax.tree_util.tree_flatten_with_path(jgv["params"])[0]
    order = ["/".join(k.key for k in path) for path, _ in flat]
    assert [p.replace("/kernel/", "/weight/").replace("/", ".") for p in order] == \
        adapter_order(adapters)
    # the base: every parameter of the unwrapped model, bit for bit its init
    plain = tt.init(torch.Generator().manual_seed(0), "cpu")
    base = {k[len(BASE_PREFIX):]: v for k, v in lora_base(tgv).items()}
    assert base.keys() == plain.keys()
    assert all(torch.equal(base[k], plain[k]) for k in plain)
    # B starts at zero: the wrapped model is the unwrapped one
    assert all(torch.equal(v, torch.zeros_like(v)) for k, v in adapters.items()
               if k.endswith("lora_B"))


def test_rank_32768_at_the_registry_widths():
    """The registry's transformer_nwp (vocab 10,004, d_model 128, 4 heads, 2
    layers) at rank 8: 32,768 adapter parameters, a 131,072-byte bank row."""
    tm = create_model("transformer_nwp", output_dim=10004)
    gv = LoRATrainer(NWPTrainer(tm), rank=8).init(torch.Generator().manual_seed(0), "cpu")
    adapters = strip_lora_base(gv)
    assert sum(v.numel() for v in adapters.values()) == 32768
    assert sum(v.numel() for v in lora_base(gv).values()) == 3022336


def _jax_lora_variables(seed=0, layers=2):
    """JAX LoRA variables of the small transformer with lora_B drawn
    nonzero (so every adapter leaf has a gradient)."""
    jm, tm = _tlm(layers)
    jt = JaxLoRA(JaxNWPTrainer(jm), rank=RANK)
    jgv = jt.init(jax.random.PRNGKey(seed), jnp.zeros((1, T), jnp.int32))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.asarray(0.1 * rng.randn(*a.shape), a.dtype)
                      if p[-1].key == "lora_B" else a), jgv["params"])
    return jt, {**jgv, "params": params}, tm


def test_merged_forward_and_adapter_gradients_match_jax():
    jt, jgv, tm = _jax_lora_variables(layers=1)
    rng = np.random.RandomState(1)
    x = rng.randint(0, V, size=(4, T)).astype(np.int32)
    y = rng.randint(0, V, size=(4, T)).astype(np.int32)
    mask = np.array([1, 1, 0, 1], np.float32)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y), "mask": jnp.asarray(mask)}
    frozen = {k: v for k, v in jgv.items() if k != "params"}

    def jloss(params):
        return jt.loss_fn({**frozen, "params": params}, jbatch, None, True)

    (jl, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(jgv["params"])
    tt = LoRATrainer(NWPTrainer(tm), rank=RANK)
    tgv = flax_to_torch(jgv, module=tm)
    logits = tt.apply(tgv, torch.from_numpy(x))[0]
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jt.apply(jgv, jnp.asarray(x))[0]),
                               rtol=2e-5, atol=1e-5)
    leaves = {k: (v.requires_grad_(True) if k.endswith(("lora_A", "lora_B")) else v)
              for k, v in tgv.items()}
    tl, _ = tt.loss_fn(leaves, {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                                "mask": torch.from_numpy(mask)}, None, True)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    assert not any(v.requires_grad for k, v in leaves.items() if k.startswith(BASE_PREFIX))
    got = _paths(torch_to_flax({k: v.grad for k, v in leaves.items()
                                if v.grad is not None}, tm)["params"])
    want = _paths(jgrads)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=2e-5, atol=1e-5, err_msg=key)


def test_engine_lora_round_matches_jax():
    """One engine round of 3 ragged clients (batch 4, shuffle off, no
    dropout in the model): the aggregated adapters match the JAX round's,
    the base comes back bit for bit."""
    jt, jgv, tm = _jax_lora_variables(seed=2, layers=1)
    rng = np.random.RandomState(2)
    x = rng.randint(0, V, size=(3, 8, T)).astype(np.int32)
    y = rng.randint(0, V, size=(3, 8, T)).astype(np.int32)
    counts = np.array([8, 5, 3], np.int32)
    kw = dict(batch_size=4, lr=0.3, client_num_per_round=3, shuffle=False, grad_clip=1.0,
              lora_rank=RANK)
    jcfg, tcfg = JaxConfig(**kw), FedConfig(**kw)
    jround = jax_round_fn(jt, jcfg, jax_aggregator("fedavg", jcfg))
    jnew, _, jm = jround(jgv, (), jnp.asarray(x), jnp.asarray(y), jnp.asarray(counts),
                         jax.random.PRNGKey(0))
    tt = LoRATrainer(NWPTrainer(tm), rank=RANK)
    tround = build_round_fn(tt, tcfg, make_aggregator("fedavg", tcfg), device="cpu")
    tgv = flax_to_torch(jgv, module=tm)
    tnew, _, tmet = tround(tgv, (), torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(counts), torch.Generator().manual_seed(0))
    for k in jm:
        np.testing.assert_allclose(float(tmet[k]), float(jm[k]), rtol=2e-5, err_msg=k)
    got = torch_to_flax(tnew, tm)
    for key, w in _paths(jnew["params"]).items():
        np.testing.assert_allclose(_paths(got["params"])[key], w, rtol=2e-5, atol=1e-5,
                                   err_msg=key)
    assert all(torch.equal(tnew[k], v) for k, v in lora_base(tgv).items())


# ------------------------------------------------------------- the drive


@pytest.fixture(scope="module")
def ds8():
    return _capped(load_dataset("mnist", client_num_in_total=8, partition_method="homo",
                                seed=0, flatten=True), PackedClients, 48, 256)


def _api(ds, rule="fedavg", **kw):
    base = dict(dataset="mnist", model="lr", client_num_in_total=8, client_num_per_round=8,
                batch_size=16, lr=0.1, comm_round=4, shuffle=False, seed=0,
                pipeline_depth=0, lora_rank=RANK)
    extra = dict(server_optimizer="adam", server_lr=0.01) if rule == "fedopt" else {}
    model = create_model("lr", output_dim=10, input_shape=ds.train.x.shape[2:])
    return FedAvgAPI(ds, FedConfig(**{**base, **extra, **kw}), ClassificationTrainer(model),
                     aggregator_name=rule, device="cpu")


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def test_rank_zero_is_structurally_off(ds8):
    """rank 0 returns the very trainer; its API holds no base and no
    adapter; a LoRA trainer is never wrapped twice."""
    trainer = ClassificationTrainer(create_model("lr", output_dim=10, input_shape=(784,)))
    assert maybe_wrap_lora(trainer, FedConfig()) is trainer
    wrapped = maybe_wrap_lora(trainer, FedConfig(lora_rank=4))
    assert isinstance(wrapped, LoRATrainer)
    assert maybe_wrap_lora(wrapped, FedConfig(lora_rank=4)) is wrapped
    api = _api(ds8, lora_rank=0)
    assert api.trainer is not wrapped and not isinstance(api.trainer, LoRATrainer)
    assert set(api.global_variables) == {"linear.weight", "linear.bias"}


@pytest.mark.parametrize("depth", [0, 2])
def test_base_is_bit_invariant_and_only_adapters_train(ds8, depth):
    """A FedAdam drive with chaos (drops and NaN): the base comes back bit
    for bit, the adapters moved, the server optimizer's moments and the
    record of the round hold adapters only, and no base tensor requires
    grad."""
    api = _api(ds8, "fedopt", pipeline_depth=depth)
    base0 = {k: v.clone() for k, v in lora_base(api.global_variables).items()}
    adapters0 = {k: v.clone() for k, v in strip_lora_base(api.global_variables).items()}
    hist = api.train(chaos=FaultPlan(seed=3, drop_rate=0.25, nan_rate=0.2))
    assert any(h.get("quarantined_count", 0) > 0 for h in hist)
    assert _bitwise(lora_base(api.global_variables), base0)
    assert not _bitwise(strip_lora_base(api.global_variables), adapters0)
    assert set(api.agg_state["mu"]) == {"linear.weight.lora_A", "linear.weight.lora_B"}
    assert not any(v.requires_grad for v in api.global_variables.values())
    assert all(torch.isfinite(v).all() for v in api.global_variables.values())


def test_adapters_only_checkpoint_resumes_bitwise(ds8, tmp_path):
    """3 rounds into a checkpoint, then a new API resumed to 5: the 5-round
    run's globals and FedAdam state bit for bit; the checkpoint's tree
    holds no base."""
    full = _api(ds8, "fedopt", comm_round=5)
    full.train()
    _api(ds8, "fedopt", comm_round=3).train(ckpt_dir=str(tmp_path))
    saved = torch.load(tmp_path / "ckpt_3" / "tree.pt", weights_only=True)
    assert not any(k.startswith(BASE_PREFIX) for k in saved["variables"])
    resumed = _api(ds8, "fedopt", comm_round=5)
    hist = resumed.train(ckpt_dir=str(tmp_path))
    assert [h["round"] for h in hist] == [0, 1, 2, 3, 4]
    assert _bitwise(resumed.global_variables, full.global_variables)
    assert _bitwise(resumed.agg_state, full.agg_state)


class _RejectOnce:
    max_retries = 2

    def __init__(self, bad_round):
        self.bad_round, self.fired = bad_round, False

    def inspect(self, round_idx, loss, global_variables=None):
        if round_idx == self.bad_round and not self.fired:
            self.fired = True
            return GuardVerdict(False, "forced test rejection")
        return GuardVerdict(True, "")


@pytest.mark.parametrize("depth", [0, 2])
def test_guard_rollback_restores_the_adapters(ds8, depth):
    """A rejected round 2 whose attempt wrote the adapters in place: the
    rollback restores them (the base re-attached from the live API), and
    the salted retry draws nothing here (shuffle off, no dropout), so the
    run equals an unguarded one bit for bit."""
    clean = _api(ds8, pipeline_depth=depth)
    clean.train()
    api = _api(ds8, pipeline_depth=depth)
    inner, calls = api.round_fn, []

    def writing(gv, *args):
        calls.append(1)
        if len(calls) == 3:
            for k, v in gv.items():
                if not k.startswith(BASE_PREFIX):
                    v.add_(1.0)
        return inner(gv, *args)

    api.round_fn = writing
    hist = api.train(guard=_RejectOnce(2))
    assert hist[2]["guard_retries"] == 1 and len(calls) == 5
    assert _bitwise(api.global_variables, clean.global_variables)


def test_lora_topk_on_the_buffered_drive(ds8):
    """LoRA x top-k runs on the buffered drive (spec.py's adapter-aware
    path): the admit encodes adapter deltas only, the base stays, the
    adapters move and stay finite; the synchronous round refuses the pair
    with spec.py's reason."""
    api = _api(ds8, buffer_size=4, staleness_alpha=0.5, update_codec="topk", codec_k=16,
               comm_round=3)
    base0 = {k: v.clone() for k, v in lora_base(api.global_variables).items()}
    adapters0 = {k: v.clone() for k, v in strip_lora_base(api.global_variables).items()}
    hist = api.train(chaos=FaultPlan(seed=5, straggler_rate=0.3, straggler_rounds=2))
    assert sum(h["buffer_commits"] for h in hist) >= 3
    assert _bitwise(lora_base(api.global_variables), base0)
    assert not _bitwise(strip_lora_base(api.global_variables), adapters0)
    assert all(torch.isfinite(v).all() for v in api.global_variables.values())
    assert set(api._buffer["vars"]) == {"linear.weight.lora_A", "linear.weight.lora_B"}
    with pytest.raises(ValueError, match="update codecs reach LoRA runs only"):
        _api(ds8, update_codec="topk")


def _spec_rows():
    """Every spec.py exclusion and constraint with the lora or
    personalization axis, as axis-level assignments (the first listed
    level of each clause)."""
    rows = []
    for exc in jax_spec.EXCLUSIONS:
        if {exc.axis_a, exc.axis_b} & {"lora", "personalization"}:
            rows.append({exc.axis_a: exc.levels_a[0], exc.axis_b: exc.levels_b[0]})
    for con in jax_spec.CONSTRAINTS:
        if {a for a, _ in con.clauses} & {"lora", "personalization"}:
            rows.append({a: lv[0] for a, lv in con.clauses})
    return rows


@pytest.mark.parametrize("levels", _spec_rows(), ids=lambda lv: ",".join(
    f"{a}={v}" for a, v in lv.items()))
def test_config_raises_every_spec_lora_reason_verbatim(levels):
    """The JAX package's point config of each row: the port's validate
    raises ValueError with the message the JAX validate raises."""
    jcfg = jax_spec.point_config(levels)
    with pytest.raises(ValueError) as want:
        jcfg.validate(**{a: v for a, v in levels.items()
                         if jax_spec.AXES[a].overrides is None})
    d = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__ if f != "extra"}
    tcfg = FedConfig.from_dict({k: v for k, v in d.items()
                                if k in FedConfig.__dataclass_fields__})
    with pytest.raises(ValueError) as got:
        tcfg.validate(chaos=levels.get("chaos") == "on")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------ LoRA over an LSTM

LV, LE, LH, LT = 12, 8, 16, 10  # vocab, embedding, hidden, sequence


def _lstms():
    """(JAX model, port model, task) of the two LSTM families, narrow."""
    return {
        "rnn": (JaxRNN(vocab_size=LV, embedding_dim=LE, hidden_size=LH),
                RNN_OriginalFedAvg(vocab_size=LV, embedding_dim=LE, hidden_size=LH),
                "classification"),
        "rnn_stackoverflow": (JaxRNNSO(vocab_size=LV, embedding_size=LE, latent_size=LH),
                              RNN_StackOverFlow(vocab_size=LV, embedding_size=LE,
                                                latent_size=LH),
                              "nwp"),
    }


def _lstm_trainers(name):
    jm, tm, task = _lstms()[name]
    if task == "nwp":
        return JaxNWPTrainer(jm), NWPTrainer(tm), tm
    return JaxClassifier(jm), ClassificationTrainer(tm), tm


@pytest.mark.parametrize("name", ["rnn", "rnn_stackoverflow"])
def test_lstm_adapter_tree_matches_jax(name):
    """Each LSTM cell's eight gate kernels get an adapter under flax's path
    (``OptimizedLSTMCell_0/ii/kernel``, ...) with flax's shapes, in
    ``jax.tree.flatten``'s order, beside the Dense layers'; the wrapped
    model starts as the unwrapped one."""
    jt, tt, _ = _lstm_trainers(name)
    jgv = JaxLoRA(jt, rank=RANK).init(jax.random.PRNGKey(0), jnp.zeros((1, LT), jnp.int32))
    tgv = LoRATrainer(tt, rank=RANK).init(torch.Generator().manual_seed(0), "cpu")
    adapters = strip_lora_base(tgv)
    want = {p: a.shape for p, a in _paths(jgv["params"]).items()}
    got = {p: a.shape for p, a in _paths(torch_to_flax(adapters, tt.module)["params"]).items()}
    assert got == want
    assert sum(p.endswith("/ii/kernel/lora_A") for p in got) == (
        2 if name == "rnn" else 1)
    flat = jax.tree_util.tree_flatten_with_path(jgv["params"])[0]
    order = ["/".join(k.key for k in path) for path, _ in flat]
    assert [p.replace("/kernel/", "/weight/").replace("/", ".") for p in order] == \
        adapter_order(adapters)
    x = torch.from_numpy(np.random.RandomState(0).randint(0, LV, (3, LT)).astype(np.int32))
    wrapped = LoRATrainer(tt, rank=RANK).apply(tgv, x)[0]
    plain = tt.apply({k[len(BASE_PREFIX):]: v for k, v in lora_base(tgv).items()}, x)[0]
    assert torch.equal(wrapped, plain)


@pytest.mark.parametrize("name,wire", [("rnn", 60368), ("rnn_stackoverflow", 154320)])
def test_lstm_wire_count_matches_jax(name, wire):
    """At the registry's widths and rank 8 the wire (the adapters) holds
    the JAX package's parameter count: Shakespeare's two 256-wide cells
    and fc; StackOverflow's 670-wide cell, fc1 and fc2 (no head is
    excluded: the LSTMs have no ``lm_head``)."""
    if name == "rnn":
        jm, tm = jax_create_model("rnn", output_dim=90), create_model("rnn", output_dim=90)
    else:
        jm = jax_create_model("rnn_stackoverflow", output_dim=10004)
        tm = create_model("rnn_stackoverflow", output_dim=10004)
    jgv = JaxLoRA(JaxNWPTrainer(jm), rank=8).init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, LT), jnp.int32))
    tgv = LoRATrainer(NWPTrainer(tm), rank=8).init(torch.Generator().manual_seed(0), "cpu")
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jgv["params"]))
    assert sum(v.numel() for v in strip_lora_base(tgv).values()) == want == wire


def _jax_lstm_lora(name, seed=0):
    """JAX LoRA variables of a narrow LSTM with lora_B drawn nonzero."""
    jt, tt, tm = _lstm_trainers(name)
    jl = JaxLoRA(jt, rank=RANK)
    jgv = jl.init(jax.random.PRNGKey(seed), jnp.zeros((1, LT), jnp.int32))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.asarray(0.1 * rng.randn(*a.shape), a.dtype)
                      if p[-1].key == "lora_B" else a), jgv["params"])
    return jl, {**jgv, "params": params}, LoRATrainer(tt, rank=RANK), tm


def test_lstm_merged_gate_weights_forward_and_gradients_match_jax():
    """The merged stacked weights are the JAX package's merged gate kernels
    (``merge_lora_params``, converted; the rank-r products summed in
    another order); the forward pass
    through ``torch._VF.lstm`` and every adapter's gradient match JAX's;
    the base gets no gradient."""
    jl, jgv, tl_, tm = _jax_lstm_lora("rnn", seed=4)
    tgv = flax_to_torch(jgv, module=tm)
    merged = flax_to_torch({"params": jax_merge_lora(jgv["lora_base"], jgv["params"],
                                                     jl.scale)}, module=tm)
    got = tl_.merged_variables(tgv)
    assert got.keys() == merged.keys()
    for k, w in merged.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=2e-5, atol=1e-5,
                                   err_msg=k)
    rng = np.random.RandomState(5)
    x = rng.randint(0, LV, size=(4, LT)).astype(np.int32)
    y = rng.randint(0, LV, size=(4,)).astype(np.int32)
    mask = np.array([1, 1, 0, 1], np.float32)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y), "mask": jnp.asarray(mask)}
    frozen = {k: v for k, v in jgv.items() if k != "params"}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jl.loss_fn({**frozen, "params": p}, jbatch, None, True),
        has_aux=True)(jgv["params"])
    leaves = {k: (v.requires_grad_(True) if is_adapter(k) else v) for k, v in tgv.items()}
    tloss, _ = tl_.loss_fn(leaves, {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                                    "mask": torch.from_numpy(mask)}, None, True)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=2e-5)
    assert all(v.grad is None for k, v in leaves.items() if k.startswith(BASE_PREFIX))
    grads = _paths(torch_to_flax({k: v.grad for k, v in leaves.items()
                                  if v.grad is not None}, tm)["params"])
    want = _paths(jgrads)
    assert sorted(grads) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(grads[key], w, rtol=2e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", ["rnn", "rnn_stackoverflow"])
def test_lstm_engine_lora_round_matches_jax(name):
    """One engine round of 3 ragged clients (batch 4, shuffle off, no
    dropout in the LSTMs): the aggregated adapters and the round's sums
    match the JAX round's, the base comes back bit for bit."""
    jl, jgv, tl_, tm = _jax_lstm_lora(name, seed=6)
    rng = np.random.RandomState(7)
    x = rng.randint(0, LV, size=(3, 8, LT)).astype(np.int32)
    y = (rng.randint(0, LV, size=(3, 8, LT)) if name == "rnn_stackoverflow"
         else rng.randint(0, LV, size=(3, 8))).astype(np.int32)
    counts = np.array([8, 5, 3], np.int32)
    kw = dict(batch_size=4, lr=0.5, client_num_per_round=3, shuffle=False, grad_clip=1.0,
              lora_rank=RANK)
    jcfg, tcfg = JaxConfig(**kw), FedConfig(**kw)
    jnew, _, jm = jax_round_fn(jl, jcfg, jax_aggregator("fedavg", jcfg))(
        jgv, (), jnp.asarray(x), jnp.asarray(y), jnp.asarray(counts), jax.random.PRNGKey(0))
    tround = build_round_fn(tl_, tcfg, make_aggregator("fedavg", tcfg), device="cpu")
    tgv = flax_to_torch(jgv, module=tm)
    tnew, _, tmet = tround(tgv, (), torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(counts), torch.Generator().manual_seed(0))
    for k in jm:
        np.testing.assert_allclose(float(tmet[k]), float(jm[k]), rtol=2e-5, err_msg=k)
    got = _paths(torch_to_flax(tnew, tm)["params"])
    for key, w in _paths(jnew["params"]).items():
        np.testing.assert_allclose(got[key], w, rtol=2e-5, atol=1e-5, err_msg=key)
    assert all(torch.equal(tnew[k], v) for k, v in lora_base(tgv).items())


def test_cli_lora_run(tmp_path):
    """``main_fedavg`` with --lora_rank on the NWP surrogate at full width:
    one round on the CPU, the history finite."""
    from fedml_tpu_torch.experiments import main_fedavg

    hist = main_fedavg.main([
        "--dataset", "stackoverflow_nwp", "--model", "transformer_nwp",
        "--client_num_in_total", "4", "--client_num_per_round", "2", "--comm_round", "1",
        "--batch_size", "16", "--lr", "0.3", "--lora_rank", "8", "--device", "cpu",
        "--run_dir", str(tmp_path)])
    assert len(hist) == 1 and np.isfinite(hist[0]["Test/Loss"])
    assert os.path.exists(tmp_path / "history.jsonl")
