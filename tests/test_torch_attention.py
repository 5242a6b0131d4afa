"""The port's flash attention (fedml_tpu_torch/ops/attention.py) against the
JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_sequence.py
does, with the block size models/transformer.py picks (the largest power
of two up to 128 that divides T). Inputs come from numpy seeds. The CUDA
kernels themselves are held against the plain versions by the
``cuda``-marked test here and by chip_smoke.py.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import attention as jax_attention
from fedml_tpu_torch.ops import attention

# the JAX package's contract for f32 flash attention (tests/test_sequence.py:51)
RTOL = ATOL = 2e-5


def _qkv(b, t, h, d, seed=0, n=3):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, (b, t, h, d)).astype(np.float32) for _ in range(n)]


def _block(t):
    return next(bb for bb in (128, 64, 32, 16, 8, 4, 2, 1) if t % bb == 0)


CASES = [(c, t) for c in (False, True) for t in (20, 64, 80)]


@pytest.mark.parametrize("causal,t", CASES)
def test_plain_forward_matches_jax_kernel(causal, t):
    q, k, v = _qkv(2, t, 2, 16, seed=t)
    blk = _block(t)
    want_o, want_lse = jax_attention._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, blk, blk,
        interpret=True, return_lse=True)
    o, lse = attention.flash_fwd(*map(torch.from_numpy, (q, k, v)), causal)
    assert o.shape == (2, t, 2, 16) and lse.shape == (4, t)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal,t", CASES)
def test_plain_backward_matches_jax_grad(causal, t):
    q, k, v, cot = _qkv(2, t, 2, 16, seed=100 + t, n=4)
    blk = _block(t)

    def loss(q_, k_, v_):
        return jnp.sum(jax_attention.flash_attention(q_, k_, v_, causal, blk, blk, True)
                       * jnp.asarray(cot))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (attention.flash_attention(*leaves, causal) * torch.from_numpy(cot)).sum().backward()
    for name, leaf, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    q, k, v = _qkv(2, 24, 3, 8, seed=5)
    want = jax_attention.attention_reference(*map(jnp.asarray, (q, k, v)), causal)
    got = attention.attention_reference(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_gradcheck_float64(causal):
    rng = np.random.RandomState(7)
    leaves = [torch.from_numpy(rng.normal(size=(1, 5, 2, 3))).requires_grad_(True)
              for _ in range(3)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: attention.flash_attention(q, k, v, causal), leaves)


def test_split_backward_pieces_make_the_whole():
    """flash_bwd = delta, then the dQ and dK/dV wrappers; each matches the
    plain whole backward."""
    q, k, v, do = map(torch.from_numpy, _qkv(1, 33, 2, 8, seed=9, n=4))
    o, lse = attention.flash_fwd(q, k, v, True)
    want = attention.flash_bwd_reference(q, k, v, o, lse, do, True)
    delta = attention.attention_delta(o, do)
    assert delta.shape == (2, 33)
    got = (attention.flash_bwd_dq(q, k, v, do, lse, delta, True),
           *attention.flash_bwd_dkv(q, k, v, do, lse, delta, True))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_causal_mask_and_lse_definition():
    """The first query sees only the first key: its output is v[0] and its
    lse is its one score."""
    q, k, v = map(torch.from_numpy, _qkv(1, 6, 1, 4, seed=3))
    o, lse = attention.flash_fwd_reference(q, k, v, True)
    torch.testing.assert_close(o[0, 0, 0], v[0, 0, 0])
    s00 = (q[0, 0, 0] * 0.5 * k[0, 0, 0]).sum()
    torch.testing.assert_close(lse[0, 0], s00)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 1, 4))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        attention.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="differ in B, H or D"):
        attention.flash_fwd(q, k[..., :2], v[..., :2])
    with pytest.raises(ValueError, match="at least 1"):
        attention.flash_fwd(q[:, :0], k, v)
    o, lse = attention.flash_fwd(q, k, v)
    delta = attention.attention_delta(o, o)
    with pytest.raises(ValueError, match="shaped as q"):
        attention.flash_bwd_dq(q, k, v, o[:, :2], lse, delta)
    with pytest.raises(ValueError, match="lse/delta must be"):
        attention.flash_bwd_dkv(q, k, v, o, lse[:, :2], delta)


def test_forward_reads_split_views_in_place_and_copies_a_strided_head_dim():
    """The forward kernel takes the q, k, v views the model cuts from one
    [B, T, 3H, D] projection as they are (their pointers and batch, token and
    head strides go to the kernel); a view whose D stride is not 1 is copied
    once."""
    b, t, h, d = 2, 5, 3, 4
    qkv = torch.from_numpy(np.random.RandomState(0).normal(size=(b, t, 3 * h, d)))
    views = qkv.split(h, dim=2)
    for i, view in enumerate(views):
        got = attention.fwd_operand(view)
        assert got is view
        assert got.data_ptr() == qkv.data_ptr() + i * h * d * qkv.element_size()
    assert attention.fwd_strides(*views) == [t * 3 * h * d, 3 * h * d, d] * 3
    heads_outer = qkv[:, :, :h].transpose(1, 2).contiguous().transpose(1, 2)
    assert attention.fwd_operand(heads_outer) is heads_outer  # D stride 1: any order
    assert attention.fwd_strides(heads_outer) == [h * t * d, d, t * d]
    strided = torch.zeros(b, t, h, 2 * d, dtype=torch.float64)[..., ::2]
    assert strided.stride(3) == 2
    copied = attention.fwd_operand(strided)
    assert copied.is_contiguous() and copied.data_ptr() != strided.data_ptr()
    assert torch.equal(copied, strided)
    one = torch.zeros(b, t, h, 2)[..., :1]  # D = 1: its stride is never used
    assert attention.fwd_operand(one) is one


def test_forward_on_split_views_matches_contiguous_inputs():
    q, k, v = map(torch.from_numpy, _qkv(2, 33, 3, 8, seed=11))
    views = torch.cat((q, k, v), dim=2).split(3, dim=2)
    for causal in (False, True):
        o, lse = attention.flash_fwd(*views, causal)
        want_o, want_lse = attention.flash_fwd(q, k, v, causal)
        torch.testing.assert_close(o, want_o, rtol=0, atol=0)
        torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)


def test_attention_delta_sums_before_moving_heads_first():
    """delta is rowsum(dO * O), [B*H, T] contiguous, with the same bits as
    the sums taken on heads-first copies."""
    for dtype, h in ((torch.float32, 3), (torch.bfloat16, 3), (torch.float32, 1)):
        o, do = (torch.from_numpy(a).to(dtype) for a in _qkv(2, 9, h, 8, seed=4, n=2))
        got = attention.attention_delta(o, do)
        acc = torch.float32
        want = (attention._heads_first(do).to(acc) * attention._heads_first(o).to(acc)).sum(-1)
        assert got.shape == (2 * h, 9) and got.dtype == acc and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_backward_reads_views_in_place():
    """The backward wrappers hand the kernels q, k, v and dO as they come
    when their D stride is 1, dO in q's dtype, and copy only a view whose D
    stride is not 1."""
    b, t, h, d = 2, 5, 3, 4
    qkv = torch.from_numpy(np.random.RandomState(1).normal(size=(b, t, 3 * h, d)))
    q, k, v = qkv.split(h, dim=2)
    do = torch.zeros(b, t, h, 2 * d, dtype=torch.float32)[..., ::2]
    got = attention._bwd_views(q, k, v, do)
    assert all(g is w for g, w in zip(got[:3], (q, k, v)))
    assert got[3].dtype == q.dtype and got[3].is_contiguous()
    assert attention.fwd_strides(*got) == [t * 3 * h * d, 3 * h * d, d] * 3 + [t * h * d, h * d, d]


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("causal", [False, True])
def test_chip_smoke_attention_check_and_its_controls(monkeypatch, causal):
    """chip_smoke.py's flash check, run on the CPU (the wrappers run the
    plain versions, so every reading is 0): the faulted results it builds
    (O without the causal mask, dQ with one key tile dropped, dK and dV
    swapped) must each fail its elementwise check."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setitem(cs.ATTN_SHAPES, "t", (2, 70, 2, 16))
    _, errs = cs.check_attention_case("float32", torch.device("cpu"), "t", causal)
    assert errs == {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    q = torch.ones(3, 2)
    with pytest.raises(cs.Disagreement, match="1 elements outside"):
        cs.close("one off", q + torch.tensor([[0.0, 0.0]] * 2 + [[0.0, 1e-3]]), q, 2e-5, 2e-5)


PTXAS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PS2_PfNS_4GeomE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PS2_PfNS_4GeomE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 140 registers, used 1 barriers, 472 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_PfNS_4GeomE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_PfNS_4GeomE
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 472 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi32EEEvPKT_S3_S3_S3_PKfS5_PS1_NS_4GeomE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi32EEEvPKT_S3_S3_S3_PKfS5_PS1_NS_4GeomE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 62 registers, used 1 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110fused_stepEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110fused_stepEv
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 420 bytes cmem[0]
"""
DKV64 = "_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_NS_4GeomE"


def test_chip_smoke_reads_registers_and_spills_per_kernel():
    """Every flash instantiation is labelled, the forward's and both
    backward kernels'; a spill fails at D <= 64 and is only marked at
    D = 128."""
    cs = _chip_smoke()
    kernels = cs.ptxas_kernels(PTXAS)
    assert len(kernels) == 4
    got = {cs.flash_label(name): x for name, x in kernels.items()}
    assert got == {("flash_fwd_kernel<bfloat16, 64>", 64): {"registers": 140, "spill_bytes": 0},
                   ("flash_fwd_kernel<float32, 128>", 128): {"registers": 255,
                                                             "spill_bytes": 28},
                   ("flash_bwd_dq_kernel<float32, 32>", 32): {"registers": 62,
                                                              "spill_bytes": 0},
                   None: {"registers": 40, "spill_bytes": 8}}
    assert cs.flash_label(DKV64) == ("flash_bwd_dkv_kernel<bfloat16, 64>", 64)
    lines = cs.check_spills(kernels)
    assert len(lines) == 3
    assert "flash_fwd_kernel<float32, 128>: 255 registers, 28 bytes of spill (SPILL)" in lines
    assert "flash_bwd_dq_kernel<float32, 32>: 62 registers, 0 bytes of spill" in lines
    with pytest.raises(RuntimeError, match="flash_bwd_dkv_kernel<bfloat16, 64> spills 12 bytes"):
        cs.check_spills({**kernels, DKV64: {"registers": 255, "spill_bytes": 12}})


def test_chip_smoke_backward_kernel_list_check():
    """chip_smoke's profiler check of a backward on split views: the delta
    op's kernels, one dQ and one dK/dV kernel, in any order, and nothing
    more (a layout copy) or less."""
    cs = _chip_smoke()
    delta = ["vectorized_elementwise_kernel<mul>", "reduce_kernel<sum>", "elementwise_copy"]
    dq = "void (anonymous namespace)::flash_bwd_dq_kernel<float, 32>(...)"
    dkv = "void (anonymous namespace)::flash_bwd_dkv_kernel<float, 32>(...)"
    assert cs.backward_kernels_ok([*delta, dkv, dq], delta)
    assert cs.backward_kernels_ok([delta[1], dq, delta[0], dkv, delta[2]], delta)
    assert not cs.backward_kernels_ok([*delta, "elementwise_copy", dq, dkv], delta)
    assert not cs.backward_kernels_ok([*delta, dq], delta)
    assert not cs.backward_kernels_ok([*delta, dq, dq, dkv], delta)
    assert not cs.backward_kernels_ok([*delta[:2], dq, dkv], delta)


def test_chip_smoke_split_view_check_and_its_control():
    """chip_smoke's views are cut from one [B, T, 3H, D] tensor, hold the
    same values, and its bitwise check rejects one flipped bit."""
    cs = _chip_smoke()
    q, k, v = map(torch.from_numpy, _qkv(2, 7, 3, 4, seed=2))
    views = cs.qkv_views(q, k, v)
    assert all(t.data_ptr() == views[0].data_ptr() + i * 3 * 4 * 4
               for i, t in enumerate(views))
    for got, want in zip(views, (q, k, v)):
        cs.bitwise("view", got, want)
    flipped = q.clone()
    flipped.view(torch.int32).view(-1)[5] ^= 1
    with pytest.raises(cs.Disagreement, match="not bitwise equal"):
        cs.bitwise("flipped", flipped, q)
    with pytest.raises(cs.Disagreement, match="not bitwise equal"):
        cs.bitwise("dtype", q.to(torch.bfloat16), q.to(torch.bfloat16).half())


def test_chip_smoke_attention_work_counts_live_pairs():
    cs = _chip_smoke()
    flops, nbytes = cs.attention_work((8, 2048, 4, 32), True, 4)
    pairs = 8 * 4 * 2048 * 2049 // 2
    assert flops == {"flash_fwd": 2 * pairs * 64, "flash_bwd_dq": 3 * pairs * 64,
                     "flash_bwd_dkv": 4 * pairs * 64}
    x = 8 * 2048 * 4 * 32 * 4
    assert nbytes["flash_fwd"] == 4 * x + 8 * 4 * 2048 * 4
    assert cs.attention_work((1, 3, 1, 2), False, 2)[0]["flash_fwd"] == 2 * 9 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_kernels_match_plain_versions(dtype, causal):
    """The three CUDA kernels against their plain versions on the card, at a
    ragged multi-tile shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(dev, dt) for a in _qkv(2, 333, 2, 64, n=4))
    tol = {"float32": (2e-5, 2e-5, 2e-4), "bfloat16": (1e-2, 1e-2, 1e-2)}[dtype]
    before = dict(attention.launches)
    o, lse = attention.flash_fwd(q, k, v, causal)
    po, plse = attention.flash_fwd_reference(q, k, v, causal)
    torch.testing.assert_close(o.float(), po.float(), rtol=tol[0], atol=tol[1])
    torch.testing.assert_close(lse, plse, rtol=2e-5, atol=2e-5)
    assert o.is_contiguous()
    # the model's split views go to the kernel uncopied and give the same bits
    so, slse = attention.flash_fwd(*torch.cat((q, k, v), dim=2).split(2, dim=2), causal)
    torch.testing.assert_close(so, o, rtol=0, atol=0)
    torch.testing.assert_close(slse, lse, rtol=0, atol=0)
    # a view with a D stride of 2 (the same values, every other element of
    # a wider tensor) is copied once, then runs the same
    strided = [torch.stack((t, torch.zeros_like(t)), dim=-1).flatten(-2)[..., ::2]
               for t in (q, k, v)]
    assert all(t.stride(3) == 2 and torch.equal(t, w) for t, w in zip(strided, (q, k, v)))
    copied, _ = attention.flash_fwd(*strided, causal)
    torch.testing.assert_close(copied, o, rtol=0, atol=0)
    got = attention.flash_bwd(q, k, v, o, lse, do, causal)
    want = attention.flash_bwd_reference(q, k, v, o, lse, do, causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol[2], atol=tol[2])
    # the backward reads the split views in place too, and gives the same bits
    split = attention.flash_bwd(*torch.cat((q, k, v), dim=2).split(2, dim=2), o, lse, do, causal)
    for g, w in zip(split, got):
        assert g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert {n: attention.launches[n] - before[n] for n in before} == {
        "flash_fwd": 3, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
