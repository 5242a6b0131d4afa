"""The privacy package's own checks, with no JAX: per-sample gradient
norms from ``torch.func.vmap`` against a loop of ``torch.autograd.grad``,
the penultimate gradient's closed form against autograd, and robust
accuracy at eps 0 against the plain accuracy. Each runs on the CPU and,
marked ``cuda``, on the card (``python -m pytest --noconftest
tests/test_torch_privacy_device.py`` there: the suite's conftest imports
JAX, which the card's machine lacks)."""

import pytest
import torch
import torch.nn.functional as F

from fedml_tpu_torch.core.trainer import ClassificationTrainer
from fedml_tpu_torch.models.ensemble import AdaptiveCNN, build_hetero_archs
from fedml_tpu_torch.privacy import adv_attack, mi_attack

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
HW, CLASSES, ROWS = 12, 10, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _target(device, arch=None, seed=0):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    trainer = ClassificationTrainer(AdaptiveCNN(output_dim=CLASSES, arch=arch, input_hw=HW))
    variables = trainer.init(gen, device)
    x = torch.randn((ROWS, HW, HW, 1), generator=gen).to(device)
    y = torch.randint(0, CLASSES, (ROWS,), generator=gen).to(device)
    return trainer, variables, x, y


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("arch", [0, 3])
def test_per_sample_grad_norms_equal_a_loop_of_autograd(device, arch):
    """vmap(grad) at 16 samples against one autograd.grad a sample, float32
    rtol 1e-5."""
    trainer, variables, x, y = _target(device, build_hetero_archs(4)[arch])
    got = mi_attack.make_per_sample_grad_norm(trainer, variables)(x, y)
    want = []
    for i in range(ROWS):
        leaves = {k: v.detach().requires_grad_(True) for k, v in variables.items()}
        logits, _ = trainer.apply(leaves, x[i:i + 1])
        grads = torch.autograd.grad(F.cross_entropy(logits, y[i:i + 1].long()),
                                    list(leaves.values()))
        want.append(torch.sqrt(sum((g ** 2).sum() for g in grads)))
    torch.testing.assert_close(got, torch.stack(want), rtol=1e-5, atol=0)


@pytest.mark.parametrize("device", DEVICES)
def test_penultimate_closed_form_equals_autograd(device):
    """(softmax - onehot) @ W equals the gradient of the summed CE with
    respect to linear2_out's input (eval mode: no dropout before it)."""
    trainer, v, x, y = _target(device)
    got = mi_attack.make_penultimate_grad_fn(trainer, v)(x, y)
    with torch.no_grad():  # the head's input: linear1_out's output after its ReLU
        _, feats = torch.func.functional_call(trainer.module, v, (x,), {"features": True})
    h = F.relu(feats[-1]).requires_grad_(True)
    logits = F.linear(h, v["linear2_out.weight"], v["linear2_out.bias"])
    (want,) = torch.autograd.grad(F.cross_entropy(logits, y.long(), reduction="sum"), [h])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("device", DEVICES)
def test_robust_accuracy_at_eps_zero_is_the_plain_accuracy(device):
    trainer, v, x, y = _target(device)

    def predict(inp):
        return trainer.apply(v, inp)[0]

    with torch.no_grad():
        plain = float((predict(x).argmax(-1) == y).float().mean())
    accs = adv_attack.robust_accuracy(predict, x, y, [0.0, 0.5], attack="fgsm")
    assert accs[0.0] == plain and accs[0.5] <= plain
