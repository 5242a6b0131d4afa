"""Train-time augmentation in the port (``fedml_tpu_torch/data/augment.py``)
against ``fedml_tpu/data/augment.py``: each function with the JAX
package's draws injected gives the JAX output bit for bit; draws from a
``torch.Generator`` repeat with its seed; ``ClassificationTrainer``'s
``augment_fn`` runs only when training with a generator, and its loss
matches the JAX trainer's at 2e-5 with the JAX draws injected; an engine
round with the hook repeats bit for bit.

Small shapes: CIFAR-sized batches of 8 (32 x 32 x 3) and logistic
regression to 10 classes. JAX's draws are re-derived from its keys as
its functions derive them (``jax.random.bernoulli``/``randint``,
``fold_in(rng, 1)`` for the second offset, ``split(rng, 3)`` in
``cifar_train_augment``, ``fold_in(rng, 17)`` in the trainer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.trainer import ClassificationTrainer as JaxClassifier
from fedml_tpu.data import augment as jax_augment
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch import ClassificationTrainer, FedConfig, create_model
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import build_round_fn
from fedml_tpu_torch.data import augment
from fedml_tpu_torch.utils.convert import flax_to_torch

SHAPE = (8, 32, 32, 3)


def _x(seed=0):
    return np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)


def _offsets(rng, high):
    """The two offsets JAX's crop and cutout draw from ``rng``."""
    return (int(jax.random.randint(rng, (), 0, high[0])),
            int(jax.random.randint(jax.random.fold_in(rng, 1), (), 0, high[1])))


def _jax_draws(rng, pad=4):
    """``cifar_train_augment``'s draws from ``rng``, as its parts take them."""
    r1, r2, r3 = jax.random.split(rng, 3)
    return {"offsets": _offsets(r1, (2 * pad + 1, 2 * pad + 1)),
            "flip": np.array(jax.random.bernoulli(r2, 0.5, (SHAPE[0],))),
            "center": _offsets(r3, SHAPE[1:3])}


@pytest.mark.parametrize("seed", range(4))
def test_each_function_with_jax_draws_is_bit_for_bit(seed):
    x = _x(seed)
    rng = jax.random.PRNGKey(seed)
    tx = torch.from_numpy(x)
    flip = np.array(jax.random.bernoulli(rng, 0.5, (SHAPE[0],)))
    cases = [
        (jax_augment.random_flip(rng, jnp.asarray(x)), augment.random_flip(None, tx, flip)),
        (jax_augment.random_crop(rng, jnp.asarray(x)),
         augment.random_crop(None, tx, offsets=_offsets(rng, (9, 9)))),
        (jax_augment.cutout(rng, jnp.asarray(x)),
         augment.cutout(None, tx, center=_offsets(rng, SHAPE[1:3]))),
        (jax_augment.cifar_train_augment(rng, jnp.asarray(x)),
         augment.cifar_train_augment(None, tx, draws=_jax_draws(rng))),
    ]
    for want, got in cases:
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(cases[-1][1].numpy(), x)


def test_edge_draws_are_bit_for_bit():
    """A crop at either corner, a cutout centred on a corner, no flip and
    every flip: the padding and the clipped hole match JAX's."""
    x = _x(7)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for oy, ox in ((0, 0), (8, 8), (0, 8)):
        want = jax.lax.dynamic_slice(jnp.pad(jx, ((0, 0), (4, 4), (4, 4), (0, 0))),
                                     (0, oy, ox, 0), SHAPE)
        assert np.array_equal(augment.random_crop(None, tx, offsets=(oy, ox)).numpy(),
                              np.asarray(want))
    for flip in (np.zeros(8, bool), np.ones(8, bool)):
        want = np.where(flip[:, None, None, None], x[:, :, ::-1, :], x)
        assert np.array_equal(augment.random_flip(None, tx, flip).numpy(), want)
    for cy, cx in ((0, 0), (31, 31)):
        ys, xs = np.arange(32), np.arange(32)
        hole = (((ys >= cy - 8) & (ys < cy + 8))[:, None]
                & ((xs >= cx - 8) & (xs < cx + 8))[None, :])
        want = x * (1.0 - hole[None, :, :, None].astype(np.float32))
        assert np.array_equal(augment.cutout(None, tx, center=(cy, cx)).numpy(), want)


def test_generator_draws_repeat_with_the_seed():
    tx = torch.from_numpy(_x(1))
    runs = [augment.cifar_train_augment(torch.Generator().manual_seed(s), tx)
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], tx) and not torch.equal(runs[0], runs[2])


def _trainers(draws=None):
    jt = JaxClassifier(jax_create_model("lr", output_dim=10),
                       augment_fn=jax_augment.cifar_train_augment)
    jv = jt.init(jax.random.PRNGKey(0), jnp.zeros((1,) + SHAPE[1:], jnp.float32))

    def fn(generator, x):
        return augment.cifar_train_augment(generator, x, draws=draws)

    tt = ClassificationTrainer(create_model("lr", output_dim=10, input_shape=SHAPE[1:]),
                               augment_fn=fn)
    return jt, jv, tt, flax_to_torch(jv)


def test_trainer_hook_matches_jax_and_runs_only_in_training():
    """With the draws of the JAX trainer's ``fold_in(rng, 17)`` injected,
    the training loss and its aux match the JAX trainer's; without a
    generator, or not training, the batch is not augmented."""
    rng = jax.random.PRNGKey(3)
    x, y = _x(3), np.random.RandomState(3).randint(0, 10, SHAPE[0]).astype(np.int32)
    mask = np.ones(SHAPE[0], np.float32)
    jt, jv, tt, tv = _trainers(_jax_draws(jax.random.fold_in(rng, 17)))
    jloss, (_, jaux) = jt.loss_fn(jv, {"x": jnp.asarray(x), "y": jnp.asarray(y),
                                       "mask": jnp.asarray(mask)}, rng, True)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
             "mask": torch.from_numpy(mask)}
    tloss, (_, taux) = tt.loss_fn(tv, batch, torch.Generator().manual_seed(0), True)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-5)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=2e-5, err_msg=k)
    plain = ClassificationTrainer(tt.module)
    want = plain.loss_fn(tv, batch, None, True)[0]
    assert torch.equal(tt.loss_fn(tv, batch, None, True)[0], want)
    assert torch.equal(tt.loss_fn(tv, batch, torch.Generator().manual_seed(0), False)[0],
                       plain.loss_fn(tv, batch, None, False)[0])
    assert not torch.equal(tloss, want)


def test_engine_round_with_augmentation_repeats_bit_for_bit():
    """An engine round draws its augmentations from the clients'
    generators: the same round generator gives the same globals, and the
    augmented round differs from the plain one."""
    cfg = FedConfig(batch_size=4, lr=0.1, client_num_per_round=2, shuffle=False)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 8, *SHAPE[1:]).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (2, 8)).astype(np.int32))
    counts = torch.tensor([8, 6], dtype=torch.int32)
    model = create_model("lr", output_dim=10, input_shape=SHAPE[1:])
    outs = []
    for fn in (augment.cifar_train_augment, augment.cifar_train_augment, None):
        trainer = ClassificationTrainer(model, augment_fn=fn)
        rnd = build_round_fn(trainer, cfg, make_aggregator("fedavg", cfg), device="cpu")
        gv = trainer.init(torch.Generator().manual_seed(0), "cpu")
        outs.append(rnd(gv, (), x, y, counts, torch.Generator().manual_seed(1))[0])
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    assert not all(torch.equal(outs[0][k], outs[2][k]) for k in outs[0])
