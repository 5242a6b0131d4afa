"""The rounding points of the tensor-core flash forward, emulated on the CPU.

``csrc/flash_attention.cu``'s forward computes its products on the tensor
cores: in bf16 the scores exactly (bf16 products are exact in float32) and
P.V with P split into ``hi = bf16(p)`` and ``lo = bf16(p - hi)``; in float32
with 3xTF32 (each operand split into ``big = tf32(x)`` and
``small = tf32(x - big)``, rounded to nearest with ties away from zero as
``cvt.rna`` does, and ``big.big + big.small + small.big``). The online
softmax runs over 64-key tiles in float32. This file emulates those
rounding points in torch and holds the result against the port's plain
version (``flash_fwd_reference``) within chip_smoke.py's ``ATTN_TOL``, the
check the kernel itself must pass on the card, at the check shapes (a),
(b), (d) and (e), causal and not, numpy seeds 0-2. The controls show why
the splits are there: one bf16 P, or one TF32 product, misses the
tolerance. Exponentials are exact here; the kernel's ex2.approx is not
emulated, and the card's own check holds it.
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops import attention

TILE = 64  # keys per tile, as the kernel stages them


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


def tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b as the kernel's 3xTF32 MMAs compute it."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_tf32(a, b):
    """a @ b as one TF32 MMA computes it (the control)."""
    return tf32(a) @ tf32(b)


def pv_bf16_split(p, v):
    """p @ v with p as two bf16 terms (v is bf16 already)."""
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    return lo @ v + hi @ v


def pv_bf16_once(p, v):
    """p @ v with p rounded once to bf16 (the control)."""
    return p.to(torch.bfloat16).float() @ v


def emulate_forward(q, k, v, causal, split=True):
    """The kernel's forward at its rounding points: (O [B, T, H, D] in q's
    dtype, lse [B*H, T] float32). ``split=False`` is the control: one bf16
    P, or one TF32 product."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qr, kr, vr = (attention._heads_first(t).float() for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        s = (qr @ kr.transpose(-1, -2)) * scale
        pv = pv_bf16_split if split else pv_bf16_once
    else:
        mm = mm_3xtf32 if split else mm_tf32
        s = mm(qr * scale, kr.transpose(-1, -2))
        pv = mm
    if causal:
        s = s.masked_fill(~attention._causal_live(s), float("-inf"))
    m = torch.full((b * h, tq), float("-inf"))
    l = torch.zeros(b * h, tq)
    acc = torch.zeros(b * h, tq, d)
    for k0 in range(0, tk, TILE):
        st = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.where(m == float("-inf"), torch.ones_like(m), torch.exp(m - m_new))
        p = torch.where(st == float("-inf"), torch.zeros_like(st), torch.exp(st - m_new[..., None]))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + pv(p, vr[:, k0:k0 + TILE])
        m = m_new
    lsafe = l.clamp_min(1e-30)
    o = (acc / lsafe[..., None]).to(q.dtype)
    return attention._heads_last(o, b, h), m + torch.log(lsafe)


def _inputs(key, dtype, seed):
    rng = np.random.RandomState(seed)
    shape = CS.ATTN_SHAPES[key]
    return [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dtype)
            for _ in range(3)]


def _shares(dtype_name, key, causal, seed, split):
    """The emulation against the plain version: {"o", "lse"} readings of
    chip_smoke.close, or Disagreement."""
    q, k, v = _inputs(key, getattr(torch, dtype_name), seed)
    o, lse = emulate_forward(q, k, v, causal, split)
    po, plse = attention.flash_fwd_reference(q, k, v, causal)
    tol = CS.ATTN_TOL[dtype_name]
    tag = f"{dtype_name} {key} causal={causal} seed {seed}"
    return {"o": CS.close(f"{tag} O", o, po, *tol["o"]),
            "lse": CS.close(f"{tag} lse", lse, plse, *tol["lse"])}


SHAPES = ("a", "b", "d", "e")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("key", SHAPES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_kernel_rounding_points_meet_the_contract(dtype_name, key, causal, seed):
    r = _shares(dtype_name, key, causal, seed, split=True)
    assert r["o"]["share"] <= 1.0 and r["lse"]["share"] <= 1.0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("key", SHAPES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_one_bf16_p_or_one_tf32_product_misses_the_contract(dtype_name, key, causal):
    with pytest.raises(CS.Disagreement, match="O: .* elements outside"):
        _shares(dtype_name, key, causal, 0, split=False)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's step at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 2, 3.0e-3], dtype=torch.float32)
    got = tf32(x)
    assert got[0] == one + ulp and got[1] == -(one + ulp)  # ties away from zero
    assert got[2] == one and got[3] == one + 2 * ulp
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    big = tf32(x)
    small = tf32(x - big)
    assert ((big + small - x).abs() <= x.abs() * 2.0 ** -21).all()


def test_split_p_is_exact_to_sixteen_bits():
    p = torch.rand(1000, dtype=torch.float32)
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    assert ((hi + lo - p).abs() <= p * 2.0 ** -16).all()
    assert ((hi - p).abs() > p * 2.0 ** -12).any()  # one bf16 term alone is coarser
