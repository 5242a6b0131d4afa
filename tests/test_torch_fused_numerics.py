"""The rounding points of the fused epoch's tensor-core conv2 products,
emulated on the CPU.

``csrc/fused_sgd.cu`` takes conv2's forward, weight gradient and input
gradient on the tensor cores: in float32 as 3xTF32 (each operand split into
``big = tf32(x)`` and ``small = tf32(x - big)``, rounded to nearest with ties
away from zero as ``cvt.rna`` does, and ``small.big + big.small +
big.big``), in bf16 as one bf16 product with float32 accumulation on
operands that are bf16 values already. This file puts that arithmetic into
the plain version's ``_conv2_product`` and holds the epoch
  - against the exact plain version at chip_smoke.py's small shape (3
    clients x 40 samples, 12x12, 5 classes), numpy seeds 0-2, both types:
    every element within chip_smoke.TOL's (rtol, atol), the check the kernel
    itself must pass on the card;
  - against the JAX kernel in interpret mode on the inputs of the port's
    parity test (tests/test_torch_fused_sgd.py), within its tolerances, in
    float32 the reference's own 2e-5 / 1e-5 (tests/test_fused_sgd.py:76).
The control, one TF32 product, misses the float32 contract: the split is
needed. The TF32 rounding is tests/test_torch_flash_numerics.py's, loaded by
path.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops import fused_sgd
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax

TESTS = pathlib.Path(__file__).resolve().parent


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_fused_numerics_{name}", TESTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FN = _load("test_torch_flash_numerics")   # tf32 rounding; FN.CS is chip_smoke.py
PARITY = _load("test_torch_fused_sgd")    # the parity test's inputs and specs
CS = FN.CS
SEEDS = (0, 1, 2)


def product_3xtf32(equation, a, b):
    """``torch.einsum(equation, a, b)`` as the kernel's 3xTF32 MMAs take it."""
    a_big, b_big = FN.tf32(a), FN.tf32(b)
    a_small, b_small = FN.tf32(a - a_big), FN.tf32(b - b_big)
    return (torch.einsum(equation, a_small, b_big) + torch.einsum(equation, a_big, b_small)
            + torch.einsum(equation, a_big, b_big))


def product_tf32(equation, a, b):
    """The control: one TF32 product."""
    return torch.einsum(equation, FN.tf32(a), FN.tf32(b))


def product_bf16(equation, a, b):
    """One bf16 MMA with float32 accumulation: exact products of operands
    that must be bf16 values already (no split)."""
    for t in (a, b):
        assert torch.equal(t, t.to(torch.bfloat16).float()), "operand is no bf16 value"
    return torch.einsum(equation, a, b)


KERNEL_PRODUCT = {"float32": product_3xtf32, "bfloat16": product_bf16}


def small_epoch(dtype, seed, product=None, monkeypatch=None):
    """fused_epoch_reference at chip_smoke.py's small shape, with conv2's
    products taken by ``product`` from here on (None: the plain version)."""
    cdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    spec = fused_sgd.FusedEpochSpec(height=12, width=12, n_classes=5, samples=40,
                                    batch=CS.BATCH, lr=0.1, grad_clip=1.0, drop1=0.25,
                                    drop2=0.5, compute_dtype=cdtype)
    inputs = CS.make_inputs("cpu", 3, 40, 12, 5, seed)
    if product is not None:
        monkeypatch.setattr(fused_sgd, "_conv2_product", product)
    return fused_sgd.fused_epoch_reference(spec, *inputs)


def outside(got, want, rtol, atol):
    """Elements of ``got`` outside (rtol, atol) of ``want``, over all leaves."""
    return sum(int(((got[k] - w).abs() > atol + rtol * w.abs()).sum()) for k, w in want.items())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_core_products_meet_chip_tolerance_at_small_shape(dtype, seed, monkeypatch):
    tol = CS.TOL[dtype]
    exact, exact_m = small_epoch(dtype, seed)
    got, got_m = small_epoch(dtype, seed, KERNEL_PRODUCT[dtype], monkeypatch)
    assert outside(got, exact, tol["rtol"], tol["atol"]) == 0
    rel = ((got_m["loss_sum"] - exact_m["loss_sum"]).abs() / exact_m["loss_sum"].abs()).max()
    assert rel <= tol["loss"], rel


@pytest.mark.parametrize("seed", SEEDS)
def test_one_tf32_product_misses_the_float32_contract(seed, monkeypatch):
    tol = CS.TOL["float32"]
    exact, _ = small_epoch("float32", seed)
    got, _ = small_epoch("float32", seed, product_tf32, monkeypatch)
    assert outside(got, exact, tol["rtol"], tol["atol"]) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_core_products_meet_the_jax_kernel_contract(dtype, monkeypatch):
    x, y, seeds = PARITY._data()
    gv = PARITY._flax_params(x)
    jspec, tspec = PARITY._specs(dtype)
    jp, _ = PARITY.jax_fused.fused_epoch(jspec, gv, jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(seeds), interpret=True)
    monkeypatch.setattr(fused_sgd, "_conv2_product", KERNEL_PRODUCT[dtype])
    tp, _ = fused_sgd.fused_epoch(tspec, flax_to_torch(gv), torch.from_numpy(x),
                                  torch.from_numpy(y), torch.from_numpy(seeds))
    rtol, atol, _ = PARITY.TOL[dtype]
    got = torch_to_flax(tp)["params"]
    for layer, leaves in jp["params"].items():
        for kind, want in leaves.items():
            np.testing.assert_allclose(got[layer][kind], np.asarray(want), rtol=rtol, atol=atol,
                                       err_msg=f"{dtype} {layer}.{kind}")
