"""The port's attacks against the JAX package's on the CPU: the
membership-inference attacks (``privacy/mi_attack.py``), FGSM and PGD
(``privacy/adv_attack.py``) and ``main_privacy.run_mi_attacks``.

The target is an AdaptiveCNN at 12x12 (10 classes) with the JAX package's
weights converted; 20 member and 20 non-member rows. The attack
classifiers train for 3 epochs in batches of 16 (a partial last batch)
from the JAX package's initial weights, converted and given to the port's
``fit``, with dropout the identity on both sides inside the test. The
tolerance is the engine's float32 contract, rtol 2e-5 / atol 1e-5, unless
noted."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.experiments import main_privacy as jax_main
from fedml_tpu.models.ensemble import AdaptiveCNN as JaxCNN
from fedml_tpu.privacy import adv_attack as jax_adv
from fedml_tpu.privacy import mi_attack as jax_mi
from fedml_tpu_torch.core.trainer import ClassificationTrainer, flax_default_init
from fedml_tpu_torch.experiments import main_privacy
from fedml_tpu_torch.models.ensemble import AdaptiveCNN
from fedml_tpu_torch.privacy import adv_attack, mi_attack
from fedml_tpu_torch.utils.convert import flax_to_torch

HW, CLASSES, ROWS = 12, 10, 20
RTOL, ATOL = 2e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(mi_attack, "_dropout", lambda x, rate, generator: x)


@pytest.fixture(scope="module")
def target():
    """(jax trainer, jax variables, port trainer, port variables, member,
    non-member): members and non-members as numpy (x, y) pairs."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(2 * ROWS, HW, HW, 1)).astype(np.float32)
    y = rng.randint(0, CLASSES, size=2 * ROWS).astype(np.int32)
    jt = JaxTrainer(JaxCNN(output_dim=CLASSES))
    jv = jt.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    tt = ClassificationTrainer(AdaptiveCNN(output_dim=CLASSES, input_hw=HW))
    tv = flax_to_torch(jv, module=tt.module)
    return jt, jv, tt, tv, (x[:ROWS], y[:ROWS]), (x[ROWS:], y[ROWS:])


def _pair(data):
    """((jax x, jax y), (torch x, torch y))."""
    x, y = data
    return (jnp.asarray(x), jnp.asarray(y)), (torch.from_numpy(x), torch.from_numpy(y))


def _predictors(target):
    jt, jv, tt, tv, _, _ = target
    return (lambda x: jt.apply(jv, x, train=False)[0]), (lambda x: tt.apply(tv, x)[0])


def _same_scores(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-5, abs=1e-6), k


def _close(got: dict, want_params, module):
    want = flax_to_torch(jax.device_get(want_params), module=module)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# ------------------------------------------------------------- NN attack


def test_attack_dataset_matches_jax(target):
    jpred, tpred = _predictors(target)
    (jm, _), (tm, _) = _pair(target[4])
    (jn, _), (tn, _) = _pair(target[5])
    for k in (None, 3):
        jx, jy = jax_mi.attack_dataset(jpred, jm, jn, k)
        tx, ty = mi_attack.attack_dataset(tpred, tm, tn, k)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)
        assert np.array_equal(ty.numpy(), np.asarray(jy))
        assert (tx[:, :-1] >= tx[:, 1:]).all()  # descending


@pytest.mark.parametrize("top_k", [None, 3])
def test_nn_attack_fit_and_score_match_jax(target, top_k):
    jpred, tpred = _predictors(target)
    (jm, _), (tm, _) = _pair(target[4])
    (jn, _), (tn, _) = _pair(target[5])
    kw = dict(top_k=top_k, epochs=3, batch_size=16, seed=4)
    jatk = jax_mi.NNAttack(**kw).fit(jpred, jm, jn)
    jx, _ = jax_mi.attack_dataset(jpred, jm, jn, top_k)
    start = jax_mi.NNAttackModel().init({"params": jax.random.PRNGKey(4)}, jx[:1])
    model = mi_attack.NNAttackModel(jx.shape[1])
    tatk = mi_attack.NNAttack(**kw).fit(tpred, tm, tn,
                                        init_variables=flax_to_torch(start, module=model))
    _close(tatk.variables, jatk.variables, model)
    _same_scores(tatk.score(tpred, tm, tn), jatk.score(jpred, jm, jn))


@pytest.mark.parametrize("cls", ["GradientVectorAttack", "MixGradientAttack"])
def test_gradient_vector_attacks_match_jax(target, no_dropout, cls):
    """Features (sorted softmax + penultimate gradient), fit from the same
    start, score; the feature cache holds from fit to score and is dropped
    after it."""
    jt, jv, tt, tv, member, nonmember = target
    jpred, tpred = _predictors(target)
    jpg = jax_mi.make_penultimate_grad_fn(jt, jv)
    tpg = mi_attack.make_penultimate_grad_fn(tt, tv)
    jm, tm = _pair(member)
    jn, tn = _pair(nonmember)
    kw = dict(epochs=3, batch_size=16, seed=2)
    jatk = getattr(jax_mi, cls)(**kw)
    jx, _ = jatk._dataset(jpred, jpg, jm, jn)
    start = jax_mi.TwoBranchAttackModel(pred_dim=CLASSES).init(
        {"params": jax.random.PRNGKey(2)}, jx[:1])
    jatk.fit(jpred, jpg, jm, jn)
    tatk = getattr(mi_attack, cls)(**kw)
    model = mi_attack.TwoBranchAttackModel(CLASSES, jx.shape[1] - CLASSES)
    tatk.fit(tpred, tpg, tm, tn, init_variables=flax_to_torch(start, module=model))
    tx, _ = tatk._feat_cache
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)
    _close(tatk.variables, jatk.variables, model)
    _same_scores(tatk.score(tpred, tpg, tm, tn), jatk.score(jpred, jpg, jm, jn))
    assert tatk._feat_inputs is None and tatk._feat_cache is None


def test_gradient_vector_attack_trains_with_dropout(target):
    """With dropout on, the fit draws its masks from its own generator:
    two fits agree bit for bit and differ from a dropout-free fit."""
    _, _, tt, tv, member, nonmember = target
    _, tpred = _predictors(target)
    tpg = mi_attack.make_penultimate_grad_fn(tt, tv)
    _, tm = _pair(member)
    _, tn = _pair(nonmember)
    a = mi_attack.GradientVectorAttack(epochs=2).fit(tpred, tpg, tm, tn)
    b = mi_attack.GradientVectorAttack(epochs=2).fit(tpred, tpg, tm, tn)
    assert all(torch.equal(a.variables[k], b.variables[k]) for k in a.variables)
    model = b.model
    plain = mi_attack._fit_classifier(model, flax_default_init(
        model, torch.Generator().manual_seed(0), "cpu"), *b._feat_cache, 0.1, 2, 64, 0)
    assert not torch.equal(plain["Dense_0.weight"], b.variables["Dense_0.weight"])


# -------------------------------------------------- threshold attacks


def test_per_sample_loss_and_gradient_norm_attacks_match_jax(target):
    jt, jv, tt, tv, member, nonmember = target
    jm, tm = _pair(member)
    jn, tn = _pair(nonmember)
    jl, tl = jax_mi.make_per_sample_loss(jt, jv), mi_attack.make_per_sample_loss(tt, tv)
    np.testing.assert_allclose(tl(*tm).numpy(), np.asarray(jl(*jm)), rtol=RTOL, atol=ATOL)
    jg = jax_mi.make_per_sample_grad_norm(jt, jv)
    tg = mi_attack.make_per_sample_grad_norm(tt, tv)
    np.testing.assert_allclose(tg(*tm).numpy(), np.asarray(jg(*jm)), rtol=RTOL, atol=ATOL)
    _same_scores(mi_attack.loss_attack(tl, tm, tn), jax_mi.loss_attack(jl, jm, jn))
    _same_scores(mi_attack.gradient_norm_attack(tg, tm, tn),
                 jax_mi.gradient_norm_attack(jg, jm, jn))


def test_attacks_read_advantage_zero_when_members_are_nonmembers(target):
    """The control: member and non-member sets are the same tensors, so no
    attack can tell them apart: advantage exactly 0."""
    _, _, tt, tv, member, _ = target
    _, tpred = _predictors(target)
    _, (x, y) = _pair(member)
    nn_score = mi_attack.NNAttack(epochs=2).fit(tpred, x, x).score(tpred, x, x)
    loss_score = mi_attack.loss_attack(mi_attack.make_per_sample_loss(tt, tv), (x, y), (x, y))
    assert nn_score["advantage"] == 0.0 and nn_score["tpr"] == nn_score["fpr"]
    assert loss_score["advantage"] == 0.0 and loss_score["attack_acc"] == 0.5


# --------------------------------------------------- penultimate gradient


class _JaxTwoHeads(fnn.Module):
    """Two Dense layers of output width CLASSES: 'b_head', the head, sorts
    after 'a_proj' in flax's path order."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        h = fnn.relu(fnn.Dense(CLASSES, name="a_proj")(x))
        return fnn.Dense(CLASSES, name="b_head")(h)


class _TorchTwoHeads(nn.Module):
    """The same network with the head registered first, so registration
    order disagrees with flax's sorted order."""

    def __init__(self, d):
        super().__init__()
        self.b_head = nn.Linear(CLASSES, CLASSES)
        self.a_proj = nn.Linear(d, CLASSES)

    def forward(self, x, train: bool = False, generator=None):
        return self.b_head(torch.relu(self.a_proj(x)))


def test_penultimate_gradient_matches_jax_and_picks_flax_head(target):
    jt, jv, tt, tv, member, _ = target
    jm, tm = _pair(member)
    want = jax_mi.make_penultimate_grad_fn(jt, jv)(*jm)
    got = mi_attack.make_penultimate_grad_fn(tt, tv)(*tm)
    assert got.shape == (ROWS, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    named = mi_attack.make_penultimate_grad_fn(tt, tv, head_path=("linear2_out",))(*tm)
    assert torch.equal(named, got)
    # a model whose registration order is not flax's sorted order
    rng = np.random.RandomState(3)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    y = rng.randint(0, CLASSES, size=8).astype(np.int32)
    jtwo = JaxTrainer(_JaxTwoHeads())
    jv2 = jtwo.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]))
    ttwo = ClassificationTrainer(_TorchTwoHeads(6))
    assert [n for n, _ in ttwo.module.named_parameters()][0] == "b_head.weight"
    tv2 = flax_to_torch(jv2, module=ttwo.module)
    want = jax_mi.make_penultimate_grad_fn(jtwo, jv2)(jnp.asarray(x), jnp.asarray(y))
    got = mi_attack.make_penultimate_grad_fn(ttwo, tv2)(torch.from_numpy(x),
                                                        torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the closed form is the loss's gradient with respect to b_head's input
    h = torch.relu(torch.from_numpy(x) @ tv2["a_proj.weight"].T + tv2["a_proj.bias"])
    h.requires_grad_(True)
    loss = torch.nn.functional.cross_entropy(
        h @ tv2["b_head.weight"].T + tv2["b_head.bias"], torch.from_numpy(y).long(),
        reduction="sum")
    (want,) = torch.autograd.grad(loss, [h])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="head_path"):
        mi_attack._head_weight(ttwo, tv2, CLASSES + 1, None)


# ------------------------------------------------------------ FGSM and PGD


def test_fgsm_pgd_and_robust_accuracy_match_jax(target):
    """No random start: FGSM (clipped to the batch's own range) and 4 PGD
    steps give the JAX package's inputs; robust_accuracy's dict equal, and
    at eps 0 it is the plain accuracy."""
    jpred, tpred = _predictors(target)
    jm, tm = _pair(target[4])
    for eps in (0.05, 0.3):
        want = jax_adv.fgsm(jpred, *jm, eps)
        got = adv_attack.fgsm(tpred, *tm, eps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        assert got.min() >= tm[0].min() and got.max() <= tm[0].max()
        want = jax_adv.pgd(jpred, *jm, eps, steps=4)
        got = adv_attack.pgd(tpred, *tm, eps, steps=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        assert (got - tm[0]).abs().max() <= eps + 1e-6
    for attack in ("fgsm", "pgd"):
        want = jax_adv.robust_accuracy(jpred, *jm, [0.0, 0.1, 0.5], attack=attack, steps=3)
        got = adv_attack.robust_accuracy(tpred, *tm, [0.0, 0.1, 0.5], attack=attack, steps=3)
        assert got == pytest.approx(want, abs=1e-6)
    plain = float((tpred(tm[0]).argmax(-1) == tm[1]).float().mean())
    assert adv_attack.robust_accuracy(tpred, *tm, [0.0])[0.0] == plain


def test_pgd_random_start_stays_in_the_ball(target):
    _, tpred = _predictors(target)
    _, (x, y) = _pair(target[4])
    a = adv_attack.pgd(tpred, x, y, 0.2, steps=2, rng=torch.Generator().manual_seed(1))
    b = adv_attack.pgd(tpred, x, y, 0.2, steps=2, rng=torch.Generator().manual_seed(1))
    c = adv_attack.pgd(tpred, x, y, 0.2, steps=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert (a - x).abs().max() <= 0.2 + 1e-6


# ------------------------------------------------------------ the MI report


def test_run_mi_attacks_matches_jax(target, no_dropout):
    """The five attacks with the JAX main's key prefixes. The threshold
    attacks read the same numbers; the trained classifiers start from each
    package's own initialisation, so their numbers are only in range."""
    jt, jv, tt, tv, member, nonmember = target
    jpred, tpred = _predictors(target)
    jm, tm = _pair(member)
    jn, tn = _pair(nonmember)
    want = jax_main.run_mi_attacks(jpred, jt, jv, jm, jn)
    got = main_privacy.run_mi_attacks(tpred, tt, tv, tm, tn)
    assert got.keys() == want.keys()
    assert {k.split("_")[0] for k in got} == {"MI/NN", "MI/Loss", "MI/GradNorm",
                                              "MI/GradVec", "MI/MixGrad"}
    for k in want:
        if k.startswith(("MI/Loss", "MI/GradNorm")):
            assert got[k] == pytest.approx(float(want[k]), rel=1e-5, abs=1e-6), k
        elif k.endswith(("acc", "tpr", "fpr")):
            assert 0.0 <= got[k] <= 1.0, k
    assert set(main_privacy.run_mi_attacks(tpred, None, None, tm, tn)) == {
        k for k in want if k.startswith("MI/NN")}
