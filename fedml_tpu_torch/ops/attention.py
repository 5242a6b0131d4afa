"""Flash attention — the port of ``fedml_tpu/ops/attention.py``.

Three kernels, as in the JAX package: the online-softmax forward, which
also emits the per-row logsumexp, and the two blocked backward kernels,
dQ sweeping key tiles and dK/dV sweeping query tiles, both recomputing
``p = exp(s - lse)`` tile by tile (``csrc/flash_attention.cu``).
``flash_attention`` wraps them in a ``torch.autograd.Function`` whose
backward computes ``delta = rowsum(dO * O)`` in float32 with one PyTorch op
and launches the two backward kernels, as the ``jax.custom_vjp`` does.

Each kernel has a wrapper and a plain PyTorch version of the same function
(dense, not blocked): ``flash_fwd`` / ``flash_fwd_reference``,
``flash_bwd_dq`` / ``flash_bwd_dq_reference``, ``flash_bwd_dkv`` /
``flash_bwd_dkv_reference``. A wrapper runs the plain version for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises.

Layouts are the JAX package's: q, k, v, O and their gradients are
[B, T, H, D]; lse and delta are [B*H, T] float32 (float64 for float64
inputs, which only the plain versions take). Scores are
``(q * scale) . k^T`` with ``scale = 1 / sqrt(D)``; ``causal`` masks keys
after the query. The kernels take float32 or bfloat16 and run on the
tensor cores: bf16 MMAs with P (and, in the backward, dS) split into two
bf16 terms, and 3xTF32 for float32, which keeps the float32 contract. All
three read q, k, v (and dO) through their own strides, so the views a qkv
projection is cut into go to the kernels uncopied, and write O, dQ, dK and
dV contiguous.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from fedml_tpu_torch.ops import _build

#: launches of each CUDA kernel (one per wrapper call that reaches the
#: card); a run sets them to 0 and reads them to show that the main path
#: went through the kernels
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

#: the largest head dim the kernels take
MAX_HEAD_DIM = 128


def _acc(t: torch.Tensor) -> torch.dtype:
    """The accumulation type: float64 for float64 inputs, else float32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> [B*H, T, D]."""
    b, n, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, n, d)


def _heads_last(t: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, T, D] -> [B, T, H, D]."""
    return t.reshape(b, h, t.shape[1], t.shape[2]).permute(0, 2, 1, 3)


def attention_reference(q, k, v, causal: bool = False):
    """Plain scaled dot-product attention. q/k/v: [B, T, H, D]."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(_acc(q)) / math.sqrt(d)
    if causal:
        s = s.masked_fill(~_causal_live(s), float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _causal_live(s: torch.Tensor) -> torch.Tensor:
    """[Tq, Tk] mask of the live (key index <= query index) scores."""
    tq, tk = s.shape[-2:]
    return (torch.arange(tq, device=s.device)[:, None]
            >= torch.arange(tk, device=s.device)[None, :])


def _scores(qr, kr, causal: bool):
    """s = (q * scale) . k^T over [B*H, T, D] operands, in the accumulation
    type, with dead scores at -inf."""
    scale = 1.0 / math.sqrt(qr.shape[-1])
    acc = _acc(qr)
    s = torch.matmul(qr.to(acc) * scale, kr.to(acc).transpose(-1, -2))
    if causal:
        s = s.masked_fill(~_causal_live(s), float("-inf"))
    return s


def attention_delta(o, do):
    """delta = rowsum(dO * O) in the accumulation type: [B*H, T]. The sums
    are taken on the [B, T, H, D] tensors, so only the [B, T, H] result is
    moved heads first."""
    b, t, h, _ = o.shape
    acc = _acc(o)
    return (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2).reshape(b * h, t)


# ---------------------------------------------------------- plain versions


def flash_fwd_reference(q, k, v, causal: bool = False):
    """Plain version of the forward kernel: (O [B, T, H, D] in q's dtype,
    lse [B*H, T])."""
    b, _, h, _ = q.shape
    s = _scores(_heads_first(q), _heads_first(k), causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, _heads_first(v).to(p.dtype)) / l
    return _heads_last(o.to(q.dtype), b, h), (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, causal):
    """p = exp(s - lse) and ds = p * (dO . V^T - delta), [B*H, Tq, Tk]."""
    s = _scores(_heads_first(q), _heads_first(k), causal)
    acc = s.dtype
    p = torch.exp(s - lse.to(acc)[..., None])
    dp = torch.matmul(_heads_first(do).to(acc), _heads_first(v).to(acc).transpose(-1, -2))
    return p, p * (dp - delta.to(acc)[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool = False):
    """Plain version of the dQ kernel: dQ [B, T, H, D] in q's dtype."""
    b, _, h, d = q.shape
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    dq = torch.matmul(ds, _heads_first(k).to(ds.dtype)) / math.sqrt(d)
    return _heads_last(dq.to(q.dtype), b, h)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = False):
    """Plain version of the dK/dV kernel: (dK, dV), [B, T, H, D] in k's and
    v's dtypes."""
    b, _, h, d = q.shape
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    acc = p.dtype
    dv = torch.matmul(p.transpose(-1, -2), _heads_first(do).to(acc))
    dk = torch.matmul(ds.transpose(-1, -2), _heads_first(q).to(acc)) / math.sqrt(d)
    return _heads_last(dk.to(k.dtype), b, h), _heads_last(dv.to(v.dtype), b, h)


def flash_bwd_reference(q, k, v, o, lse, do, causal: bool = False):
    """Plain version of the whole backward: (dQ, dK, dV)."""
    delta = attention_delta(o, do)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    return (dq, *flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal))


# --------------------------------------------------------------- wrappers


def _check(q, k, v, do=None, lse=None, delta=None):
    """Shapes, dtypes and devices the kernels (and their plain versions)
    take; raises on anything else."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q, k, v must be [B, T, H, D] with k and v alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in B, H or D")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("sequence lengths must be at least 1")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} must be shaped as q {tuple(q.shape)}")
    rows = (q.shape[0] * q.shape[2], q.shape[1])
    for t in (lse, delta):
        if t is not None and tuple(t.shape) != rows:
            raise ValueError(f"lse/delta must be {rows}, got {tuple(t.shape)}")
    for t in (k, v, do, lse, delta):
        if t is not None and t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernels take float32 or bfloat16 q, k, v of one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[3]} exceeds {MAX_HEAD_DIM}")


def signatures(lib):
    """Declare the C interface of a loaded flash_attention library."""
    vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    # the tensors; b, h, tq, tk, d; (batch, token, head) strides of q, k, v
    # (and dO); scale, causal, bf16, stream
    tail = [f, i, i, vp]
    lib.flash_fwd.argtypes = [vp] * 5 + [i] * 5 + [ll] * 9 + tail  # q, k, v, o, lse
    # q, k, v, dO, lse, delta, then dq, or dk and dv
    lib.flash_bwd_dq.argtypes = [vp] * 7 + [i] * 5 + [ll] * 12 + tail
    lib.flash_bwd_dkv.argtypes = [vp] * 8 + [i] * 5 + [ll] * 12 + tail
    for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
        fn.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library():
    """The loaded, declared library, built at first use."""
    return signatures(_build.load("flash_attention"))


def _call(name: str, device, *args):
    """Call the C entry point ``name`` with ``args`` and the current stream
    of ``device``; count the launch; raise on a non-zero return code."""
    lib = _library()
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: " + lib.flash_error_string(rc).decode())
    launches[name] += 1


def _launch(name: str, views, outputs, causal: bool):
    """The kernel ``name`` on the [B, T, H, D] ``views`` (q, k, v, and dO
    for the backward) and ``outputs``, with the views' strides."""
    q, k = views[:2]
    b, tq, h, d = q.shape
    _call(name, q.device, *(t.data_ptr() for t in (*views, *outputs)), b, h, tq, k.shape[1], d,
          *fwd_strides(*views), 1.0 / math.sqrt(d), int(causal), int(q.dtype == torch.bfloat16))


def _rows(t):
    """lse or delta as the kernels read it: contiguous float32."""
    return t.to(torch.float32).contiguous()


def fwd_operand(t):
    """A [B, T, H, D] operand as the kernels read it: the view itself when
    its D stride is 1 (any batch, token and head strides), else one
    contiguous copy."""
    return t if t.stride(3) == 1 or t.shape[3] == 1 else t.contiguous()


def fwd_strides(*operands):
    """The (batch, token, head) strides, in elements, of each operand."""
    return [s for t in operands for s in t.stride()[:3]]


def flash_fwd(q, k, v, causal: bool = False):
    """Forward: (O [B, T, H, D] in q's dtype, lse [B*H, T] float32). On the
    card O is contiguous and q, k, v are read in place (``fwd_operand``)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal)
    b, tq, h, d = q.shape
    views = [fwd_operand(t) for t in (q, k, v)]
    o = torch.empty(b, tq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b * h, tq, dtype=torch.float32, device=q.device)
    _launch("flash_fwd", views, (o, lse), causal)
    return o, lse


def _bwd_views(q, k, v, do):
    """q, k, v and dO as the backward kernels read them (``fwd_operand``),
    dO in q's dtype."""
    return [fwd_operand(t) for t in (q, k, v, do.to(q.dtype))]


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False):
    """dQ [B, T, H, D] in q's dtype, given lse and delta [B*H, T]. On the
    card dQ is contiguous and q, k, v, dO are read in place."""
    _check(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("flash_bwd_dq", _bwd_views(q, k, v, do), (_rows(lse), _rows(delta), dq), causal)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False):
    """(dK, dV) [B, T, H, D] in k's and v's dtype, given lse and delta. On
    the card dK and dV are contiguous and q, k, v, dO are read in place."""
    _check(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("flash_bwd_dkv", _bwd_views(q, k, v, do), (_rows(lse), _rows(delta), dk, dv),
            causal)
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal: bool = False):
    """Backward: delta = rowsum(dO * O), then the dQ and dK/dV kernels."""
    delta = attention_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_bwd(q, k, v, o, lse, do, ctx.causal), None)


def flash_attention(q, k, v, causal: bool = False):
    """Flash attention with the blocked backward. q/k/v: [B, T, H, D]."""
    return _FlashAttention.apply(q, k, v, causal)
