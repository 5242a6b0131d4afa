"""The port's CNN_DropOut, weight converter and ClassificationTrainer
against the JAX package's, on the same numpy inputs and flax-initialised
weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.models.cnn import CNN_DropOut as JaxCNN
from fedml_tpu_torch.core.trainer import ClassificationTrainer
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax

B, H, C = 8, 12, 5


def _setup(seed=0, dtype=jnp.float32):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(B, H, H, 1)).astype(np.float32)
    y = rng.randint(0, C, size=B).astype(np.int32)
    jm = JaxCNN(output_dim=C, dtype=dtype)
    gv = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))
    tdtype = "float32" if dtype == jnp.float32 else "bfloat16"
    tm = create_model("cnn", output_dim=C, dtype=tdtype, input_hw=H)
    return x, y, jm, gv, tm


def test_convert_round_trip_and_layouts():
    _, _, _, gv, tm = _setup()
    state = flax_to_torch(gv)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in tm.state_dict().items()}
    back = torch_to_flax(state)["params"]
    for layer, leaves in gv["params"].items():
        for kind, want in leaves.items():
            np.testing.assert_array_equal(back[layer][kind], np.asarray(want))


def test_cnn_forward_float32_matches_flax():
    x, _, jm, gv, tm = _setup()
    want = np.asarray(jm.apply(gv, jnp.asarray(x)))
    got = torch.func.functional_call(tm, flax_to_torch(gv), (torch.from_numpy(x),))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_cnn_forward_bfloat16_compute():
    """bf16 compute with f32 params. Tolerance 5e-2 absolute on logits of
    magnitude ~1: both sides round inputs, weights, conv/matmul outputs and
    bias sums to bf16 (8 mantissa bits, 2**-9 relative per rounding), but
    XLA and PyTorch's CPU kernels accumulate in different orders and may
    round their partial sums differently, so single bf16 steps differ and
    compound over four layers."""
    x, _, jm, gv, tm = _setup(1, jnp.bfloat16)
    want = np.asarray(jm.apply(gv, jnp.asarray(x)))
    got = torch.func.functional_call(tm, flax_to_torch(gv), (torch.from_numpy(x),))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=5e-2)


def test_flatten_is_channels_last():
    """A linear_1 row permutation would not show in the forward of a
    symmetric input; check the flatten order on a one-hot feature map."""
    _, _, _, gv, tm = _setup()
    state = flax_to_torch(gv)
    pooled = (H - 4) // 2
    # the flax kernel row (h, w, c) = (1, 2, 3) must multiply feature (1, 2, 3)
    row = (1 * pooled + 2) * 64 + 3
    w = np.asarray(gv["params"]["linear_1"]["kernel"])[row]
    np.testing.assert_array_equal(state["linear_1.weight"][:, row].numpy(), w)


def test_trainer_loss_and_eval_match_jax_with_padding_mask():
    x, y, jm, gv, tm = _setup(2)
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 1], np.float32)
    jt, tt = JaxTrainer(jm), ClassificationTrainer(tm)
    batch_j = {"x": jnp.asarray(x), "y": jnp.asarray(y), "mask": jnp.asarray(mask)}
    batch_t = {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
               "mask": torch.from_numpy(mask)}
    jloss, (_, jaux) = jt.loss_fn(gv, batch_j, None, False)
    tloss, (_, taux) = tt.loss_fn(flax_to_torch(gv), batch_t, None, False)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    je = jt.eval_fn(gv, batch_j)
    te = tt.eval_fn(flax_to_torch(gv), batch_t)
    for k in je:
        np.testing.assert_allclose(float(te[k]), float(je[k]), rtol=1e-5,
                                   err_msg=k)


def test_argmax_ties_go_to_the_first_index():
    tt = ClassificationTrainer(create_model("cnn", output_dim=C, input_hw=H))
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0, 0.0]])
    tt.apply = lambda variables, x, generator=None, train=False: (logits, {})
    m = tt.eval_fn({}, {"x": None, "y": torch.tensor([1]),
                        "mask": torch.ones(1)})
    assert float(m["test_correct"]) == 1.0


def test_unported_model_raises():
    """A name the registry does not know raises; FedSeg's ``deeplab``, the
    last of the JAX zoo's names to be ported, builds."""
    with pytest.raises(NotImplementedError):
        create_model("no_such_model", output_dim=10)
    assert type(create_model("deeplab", output_dim=10)).__name__ == "DeepLabV3Plus"
