"""The rounding points of the tensor-core flash kernels, emulated on the CPU.

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

The backward kernels compose the same two products with roles swapped
(``emulate_backward``): in bf16 the score and dP = dO.V^T products are
exact and the second-level products take P and dS as A operands, each
split hi/lo; in float32 every product is 3xTF32. The dQ kernel computes
S = (q * scale).k^T; the dK/dV kernel S^T = (k * scale).q^T, and
dP^T = V.dO^T. The controls show why both splits are kept: one bf16 term
of P misses in dV, one of dS in dQ and dK, one TF32 product everywhere.
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


def emulate_backward(q, k, v, do, lse, delta, causal, split=True):
    """The backward kernels at their rounding points: (dQ, dK, dV) [B, T, H,
    D] in q's dtype. ``split`` is True (every split the kernels make),
    False (the controls: one bf16 term of P and of dS, or one TF32
    product), or, for bf16, the names ("p", "ds") of the A operands that
    are split hi/lo."""
    b, _, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qr, kr, vr, dor = (attention._heads_first(t).float() for t in (q, k, v, do))
    t_ = lambda x: x.transpose(-1, -2)  # noqa: E731
    if q.dtype == torch.bfloat16:
        terms = {"p", "ds"} if split is True else set(split or ())
        s_q, s_k = (qr @ t_(kr)) * scale, t_((kr @ t_(qr)) * scale)
        dp_q, dp_k = dor @ t_(vr), t_(vr @ t_(dor))
        mm_p = pv_bf16_split if "p" in terms else pv_bf16_once
        mm_ds = pv_bf16_split if "ds" in terms else pv_bf16_once
    else:
        mm = mm_3xtf32 if split else mm_tf32
        s_q, s_k = mm(qr * scale, t_(kr)), t_(mm(kr * scale, t_(qr)))
        dp_q, dp_k = mm(dor, t_(vr)), t_(mm(vr, t_(dor)))
        mm_p = mm_ds = mm
    live = attention._causal_live(s_q) if causal else torch.ones_like(s_q, dtype=torch.bool)

    def p_ds(s, dp):
        p = torch.where(live, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
        return p, p * (dp - delta.float()[..., None])

    _, ds_q = p_ds(s_q, dp_q)  # the dQ kernel's, sweeping key tiles
    p_k, ds_k = p_ds(s_k, dp_k)  # the dK/dV kernel's, sweeping query tiles
    grads = (mm_ds(ds_q, kr) * scale, mm_ds(t_(ds_k), qr) * scale, mm_p(t_(p_k), dor))
    return tuple(attention._heads_last(x.to(q.dtype), b, h) for x in grads)


def _inputs(key, dtype, seed, n=3):
    rng = np.random.RandomState(seed)
    shape = CS.ATTN_SHAPES[key]
    return [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dtype)
            for _ in range(n)]


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


GRADS = {"dq": "dQ", "dk": "dK", "dv": "dV"}


def _grad_shares(dtype_name, key, causal, seed, split, grads=tuple(GRADS)):
    """The emulated backward against the plain versions: {name: reading of
    chip_smoke.close} for the gradients named in ``grads``, or
    Disagreement."""
    q, k, v, do = _inputs(key, getattr(torch, dtype_name), seed, n=4)
    o, lse = attention.flash_fwd_reference(q, k, v, causal)
    delta = attention.attention_delta(o, do)
    got = emulate_backward(q, k, v, do, lse, delta, causal, split)
    want = (attention.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal),
            *attention.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal))
    tol = CS.ATTN_TOL[dtype_name]["grad"]
    tag = f"{dtype_name} {key} causal={causal} seed {seed}"
    return {name: CS.close(f"{tag} {GRADS[name]}", g, w, *tol)
            for name, g, w in zip(GRADS, got, want) if name in grads}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("key", SHAPES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_backward_rounding_points_meet_the_contract(dtype_name, key, causal, seed):
    r = _grad_shares(dtype_name, key, causal, seed, split=True)
    assert all(x["share"] <= 1.0 for x in r.values())


# (dtype, split, the gradients that miss, those that still meet the
# contract): one TF32 product misses in all three; one bf16 term of P (only
# dS split) in dV, which P alone feeds; one bf16 term of dS (only P split)
# in dQ and dK
BACKWARD_CONTROLS = [("float32", False, ("dq", "dk", "dv"), ()),
                     ("bfloat16", ("ds",), ("dv",), ("dq", "dk")),
                     ("bfloat16", ("p",), ("dq", "dk"), ("dv",))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("key", SHAPES)
@pytest.mark.parametrize("dtype_name,split,misses,meets", BACKWARD_CONTROLS)
def test_one_bf16_term_of_p_or_ds_or_one_tf32_product_misses(dtype_name, split, misses, meets,
                                                             key, causal):
    for name in misses:
        with pytest.raises(CS.Disagreement, match=f"{GRADS[name]}: .* elements outside"):
            _grad_shares(dtype_name, key, causal, 0, split, grads=(name,))
    _grad_shares(dtype_name, key, causal, 0, split, grads=meets)


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
