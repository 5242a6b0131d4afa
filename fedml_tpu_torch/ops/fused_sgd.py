"""Fused local-SGD epoch of CNN_DropOut — the port of
``fedml_tpu/ops/fused_sgd.py`` (``fused_epoch`` -> ``_epoch_kernel``).

One call runs every client's whole local epoch: for each minibatch step the
forward pass (conv 3x3 32, conv 3x3 64, ReLU, 2x2 max-pool, dropout .25,
dense 128, dropout .5, dense C), float32 softmax cross-entropy, the
backward pass, a global-norm clip over all eight gradients and the SGD
update. On a CUDA tensor ``fused_epoch`` launches the hand-written kernels of
``csrc/fused_sgd.cu``; on a CPU tensor it runs ``fused_epoch_reference``, the
plain PyTorch version of the same arithmetic. There is no fallback from one
to the other: a CUDA tensor launches the kernel or raises.

Semantics kept from the JAX kernel, bit for bit where they are integer:
  - dropout bits are ``lowbias32(flat index + offset)`` over the geometry of
    a (chunk, Hp, Wp, 64) or (chunk, 128) tensor, with ``chunk =
    gcd(batch, 5)`` and the offset built from the client seed and the global
    chunk index ``s * nchunks + ci``; keep is ``bits >= uint32(p * 2**32)``
    and kept values are scaled by 1 / (1 - p) in the compute dtype;
  - max-pool backward routes to the first maximal element in row-major
    window order; ReLU' is ``x > 0`` on the post-activation;
  - conv/matmul outputs accumulate in float32 and are cast to the compute
    dtype before a bias added in the compute dtype; logits are cast to
    float32; the input gradient of conv2 is summed over the nine filter
    offsets in the compute dtype, offset by offset; weight gradients
    accumulate in float32;
  - the gradient is the full-batch mean; the clip is
    ``g / max(1, ||g|| / clip)``; ``total`` is ``spec.n``;
  - every row given is trained, padding rows included (counts only weight
    the aggregation), and ``samples % batch != 0`` raises.

Parameters travel in PyTorch's layout (``fedml_tpu_torch.models.cnn``). The
kernel works on one packed float32 row per client, each layer as a
[K + 1, N] block whose last row is the bias: conv1 [9 + 1, 32] (rows
(di, dj)), conv2 [288 + 1, 64] (rows (di, dj, ci)), dense1 [F + 1, 128] (rows
(h, w, c)), dense2 [128 + 1, C].
"""

from __future__ import annotations

import ctypes
import math

import torch

from fedml_tpu_torch.algorithms.engine import (LocalResult, cohort_stats,
                                               draw_client_randomness)
from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.utils.device import to_device

M32 = 0xFFFFFFFF

#: launches of the CUDA kernel sequence made by ``fused_epoch`` (one per call
#: that reaches the card); a run sets it to 0 and reads it to show that the
#: main path went through the kernel
launches = 0


class FusedEpochSpec:
    """Static geometry of the fused epoch (flagship: H = W = 28, C = 62)."""

    def __init__(self, height=28, width=28, n_classes=62, samples=200,
                 batch=20, lr=0.1, grad_clip=1.0, drop1=0.25, drop2=0.5,
                 compute_dtype=torch.bfloat16, chunk=5):
        if samples % batch != 0:
            raise ValueError("fused path requires samples % batch == 0")
        # the dropout bits follow the JAX kernel's sub-batch chunks
        self.chunk = math.gcd(batch, chunk) if chunk else batch
        self.nchunks = batch // self.chunk
        self.H, self.W, self.C = height, width, n_classes
        self.n, self.b = samples, batch
        self.steps = samples // batch
        self.H1, self.W1 = height - 2, width - 2
        self.H2, self.W2 = self.H1 - 2, self.W1 - 2
        if self.H2 % 2 or self.W2 % 2:
            raise ValueError("pool input must be even")
        self.Hp, self.Wp = self.H2 // 2, self.W2 // 2
        self.P = self.Hp * self.Wp
        self.F = self.P * 64
        self.lr, self.clip = lr, grad_clip
        self.drop1, self.drop2 = drop1, drop2
        self.cdtype = compute_dtype
        # packed row: [w1; b1] [w2; b2] [w3; b3] [w4; b4]
        self.blocks = ((10, 32), (289, 64), (self.F + 1, 128), (129, self.C))
        self.offsets = []
        off = 0
        for rows, cols in self.blocks:
            self.offsets.append(off)
            off += rows * cols
        self.NP = off

    def flops_per_round(self, clients: int) -> int:
        """Multiply-adds x 2 that one epoch of ``clients`` needs: every
        layer's forward, weight-gradient and input-gradient products, except
        conv1's input gradient, which nothing needs (its input is the image)."""
        conv1 = self.H1 * self.W1 * 9 * 32
        rest = self.H2 * self.W2 * 288 * 64 + self.F * 128 + 128 * self.C
        step = 2 * self.b * (2 * conv1 + 3 * rest)
        return step * self.steps * clients


# ------------------------------------------------------------ param packing


def pack_params(spec: FusedEpochSpec, params: dict) -> torch.Tensor:
    """PyTorch-layout CNN_DropOut params -> one packed float32 row [NP]."""
    w1 = params["conv2d_1.weight"].permute(2, 3, 1, 0).reshape(9, 32)
    w2 = params["conv2d_2.weight"].permute(2, 3, 1, 0).reshape(288, 64)
    w3 = params["linear_1.weight"].t()
    w4 = params["linear_2.weight"].t()
    if w3.shape[0] != spec.F or w4.shape[1] != spec.C:
        raise ValueError(f"params do not fit the spec: linear_1 "
                         f"{tuple(w3.shape)}, linear_2 {tuple(w4.shape)}")
    parts = []
    for w, b in ((w1, "conv2d_1.bias"), (w2, "conv2d_2.bias"),
                 (w3, "linear_1.bias"), (w4, "linear_2.bias")):
        parts += [w.reshape(-1), params[b].reshape(-1)]
    return torch.cat(parts).float().contiguous()


def unpack_params(spec: FusedEpochSpec, rows: torch.Tensor) -> dict:
    """[clients, NP] packed rows -> client-stacked PyTorch-layout params."""
    cl = rows.shape[0]
    layers = []
    for (r, c), off in zip(spec.blocks, spec.offsets):
        blk = rows[:, off:off + r * c].reshape(cl, r, c)
        layers.append((blk[:, :-1], blk[:, -1]))
    (w1, b1), (w2, b2), (w3, b3), (w4, b4) = layers
    return {
        "conv2d_1.weight": w1.reshape(cl, 3, 3, 1, 32).permute(0, 4, 3, 1, 2).contiguous(),
        "conv2d_1.bias": b1.contiguous(),
        "conv2d_2.weight": w2.reshape(cl, 3, 3, 32, 64).permute(0, 4, 3, 1, 2).contiguous(),
        "conv2d_2.bias": b2.contiguous(),
        "linear_1.weight": w3.transpose(1, 2).contiguous(),
        "linear_1.bias": b3.contiguous(),
        "linear_2.weight": w4.transpose(1, 2).contiguous(),
        "linear_2.bias": b4.contiguous(),
    }


# ------------------------------------------------------------- dropout bits


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer on int64 tensors holding uint32 values. The
    products wrap in int64; their low 32 bits, all that is kept, are exact."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def hash_bits(shape, offset) -> torch.Tensor:
    """lowbias32 of (row-major flat index + offset) as int64 tensors holding
    uint32 values — bitwise ``fedml_tpu/ops/fused_sgd.py::_hash_bits``.
    ``offset`` is an int or an integer tensor broadcastable to ``shape``."""
    device = offset.device if torch.is_tensor(offset) else None
    flat = torch.arange(math.prod(shape), dtype=torch.int64,
                        device=device).reshape(shape)
    return _lowbias32((flat + offset) & M32)


def threshold(rate: float) -> int:
    """Keep threshold of a dropout rate: uint32(int(rate * 2**32))."""
    return int(rate * (1 << 32)) & M32


# the JAX kernel's offset constants (fused_sgd.py:235-256): seed, chunk, add
_DROP1_MIX = (0x9E3779B9, 0x85EBCA77, 0)
_DROP2_MIX = (0xC2B2AE35, 0x27D4EB2F, 0x165667B1)


def _step_bits(spec: FusedEpochSpec, seeds, s, width, mix):
    """[clients, b, width] dropout bits of step ``s``: sample ``bi`` is row
    ``bi % chunk`` of the (chunk, width) tensor of global chunk
    ``s * nchunks + bi // chunk``."""
    c_seed, c_chunk, c_add = mix
    bi = torch.arange(spec.b, device=seeds.device)
    g_idx = s * spec.nchunks + bi // spec.chunk
    off = (seeds[:, None] * c_seed + g_idx[None] * c_chunk + c_add) & M32
    flat = ((bi % spec.chunk) * width)[:, None] + torch.arange(
        width, device=seeds.device)
    return _lowbias32((flat[None] + off[:, :, None]) & M32)


def keep_scale(spec: FusedEpochSpec, rate: float) -> float:
    """1 / (1 - rate) rounded to the compute dtype, as the JAX kernel's
    ``cd(inv_keep)``."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=spec.cdtype).item()


def _keep(spec, seeds, s, width, rate, mix):
    """Dropout multiplier in {0, keep_scale} as float32 [clients, b, width]."""
    bits = _step_bits(spec, seeds, s, width, mix)
    return (bits >= threshold(rate)).float() * keep_scale(spec, rate)


# ---------------------------------------------------------- plain version


def _rounder(cdtype):
    if cdtype == torch.float32:
        return lambda t: t
    return lambda t: t.to(cdtype).float()


def _pool_route(dd, candidates, pooled):
    """Max-pool backward: each window's gradient ``dd`` goes to its first
    candidate equal to the window's max ``pooled``, in row-major window
    order (s00, s01, s10, s11). Returns the four routed gradients."""
    taken = torch.zeros_like(pooled, dtype=torch.bool)
    routed = []
    for sv in candidates:
        eq = sv == pooled
        routed.append(dd * (eq & ~taken))
        taken = taken | eq
    return routed


def _conv2_product(equation, a, b):
    """One of conv2's three products in the plain version (the forward, the
    weight gradient, one offset of the input gradient): ``torch.einsum`` in
    float32 on operands that hold compute-dtype values. The kernel takes the
    same products on the tensor cores (3xTF32 in float32); the numerics test
    puts that arithmetic here."""
    return torch.einsum(equation, a, b)


def fused_epoch_reference(spec: FusedEpochSpec, params: dict, x, y, seeds):
    """Plain PyTorch version of the fused epoch, batched over clients.

    Every tensor is float32 holding values of the compute dtype; ``R``
    rounds to the compute dtype where the JAX kernel casts, so bfloat16 runs
    see the same rounding points with float32 accumulation.

    params: PyTorch-layout global CNN_DropOut params; x: [clients, n, H, W, 1]
    float32; y: [clients, n] int; seeds: [clients] int. Returns (stacked
    per-client params, metrics {loss_sum, correct, total} of [clients]).
    """
    R = _rounder(spec.cdtype)
    cl, b, C = x.shape[0], spec.b, spec.C
    H1, W1, H2, W2, Hp, Wp, F = (spec.H1, spec.W1, spec.H2, spec.W2, spec.Hp,
                                 spec.Wp, spec.F)
    dev = x.device
    xs_all = x.reshape(cl, spec.n, spec.H, spec.W).float()
    ys_all = y.long()
    seeds = seeds.to(dev).long() & M32
    rows = pack_params(spec, params).to(dev).unsqueeze(0).repeat(cl, 1)
    loss_sum = torch.zeros(cl, device=dev)
    correct = torch.zeros(cl, device=dev)
    taps = [(di, dj) for di in range(3) for dj in range(3)]

    for s in range(spec.steps):
        blocks = []
        for (r, c), off in zip(spec.blocks, spec.offsets):
            blk = rows[:, off:off + r * c].reshape(cl, r, c)
            blocks.append((R(blk[:, :-1]), R(blk[:, -1])))
        (w1, b1), (w2, b2), (w3, b3), (w4, b4) = blocks
        xs = R(xs_all[:, s * b:(s + 1) * b])
        ys = ys_all[:, s * b:(s + 1) * b]

        # ---- forward
        p1 = torch.stack([xs[:, :, di:di + H1, dj:dj + W1] for di, dj in taps], -1)
        a1 = torch.relu(R(R(torch.einsum("zbhwk,zkc->zbhwc", p1, w1))
                          + b1[:, None, None, None]))
        p2 = torch.cat([a1[:, :, di:di + H2, dj:dj + W2] for di, dj in taps], -1)
        a2 = torch.relu(R(R(_conv2_product("zbhwk,zkn->zbhwn", p2, w2))
                          + b2[:, None, None, None]))
        win = a2.reshape(cl, b, Hp, 2, Wp, 2, 64)
        s00, s01 = win[:, :, :, 0, :, 0], win[:, :, :, 0, :, 1]
        s10, s11 = win[:, :, :, 1, :, 0], win[:, :, :, 1, :, 1]
        pooled = torch.maximum(torch.maximum(s00, s01), torch.maximum(s10, s11))
        d = pooled.reshape(cl, b, F)
        keep1 = keep2 = None
        if spec.drop1:
            keep1 = _keep(spec, seeds, s, F, spec.drop1, _DROP1_MIX)
            d = R(d * keep1)
        h = torch.relu(R(R(torch.einsum("zbf,zfn->zbn", d, w3)) + b3[:, None]))
        hd = h
        if spec.drop2:
            keep2 = _keep(spec, seeds, s, 128, spec.drop2, _DROP2_MIX)
            hd = R(h * keep2)
        logits = R(R(torch.einsum("zbn,znc->zbc", hd, w4)) + b4[:, None])

        # ---- float32 softmax cross-entropy
        lmax = logits.max(-1, keepdim=True).values
        ex = torch.exp(logits - lmax)
        sumex = ex.sum(-1, keepdim=True)
        oh = torch.nn.functional.one_hot(ys, C).float()
        ll = (logits * oh).sum(-1, keepdim=True)
        loss_sum = loss_sum + (torch.log(sumex) + lmax - ll).sum((1, 2))
        correct = correct + (logits.argmax(-1) == ys).float().sum(1)

        # ---- backward (full-batch mean)
        dlog = R((ex / sumex - oh) * (1.0 / b))
        gw4 = torch.einsum("zbn,zbc->znc", hd, dlog)
        gb4 = dlog.sum(1)
        dh = R(torch.einsum("zbc,znc->zbn", dlog, w4))
        if keep2 is not None:
            dh = R(dh * keep2)
        dh = dh * (h > 0).float()
        gw3 = torch.einsum("zbf,zbn->zfn", d, dh)
        gb3 = dh.sum(1)
        dd = R(torch.einsum("zbn,zfn->zbf", dh, w3))
        if keep1 is not None:
            dd = R(dd * keep1)
        dd = dd.reshape(cl, b, Hp, Wp, 64)
        routed = _pool_route(dd, (s00, s01, s10, s11), pooled)
        da2 = torch.zeros_like(win)
        for (u, v), r in zip(((0, 0), (0, 1), (1, 0), (1, 1)), routed):
            da2[:, :, :, u, :, v] = r
        dz2 = da2.reshape(cl, b, H2, W2, 64) * (a2 > 0).float()
        gw2 = _conv2_product("zbhwk,zbhwn->zkn", p2, dz2)
        gb2 = dz2.sum((1, 2, 3))
        da1 = torch.zeros_like(a1)
        for k, (di, dj) in enumerate(taps):
            t = R(_conv2_product("zbhwn,zcn->zbhwc", dz2, w2[:, 32 * k:32 * (k + 1)]))
            padded = torch.zeros_like(a1)
            padded[:, :, di:di + H2, dj:dj + W2] = t
            da1 = R(da1 + padded)
        dz1 = da1 * (a1 > 0).float()
        gw1 = torch.einsum("zbhwk,zbhwc->zkc", p1, dz1)
        gb1 = dz1.sum((1, 2, 3))

        # ---- global-norm clip + SGD
        g = torch.cat([t.reshape(cl, -1) for t in
                       (gw1, gb1, gw2, gb2, gw3, gb3, gw4, gb4)], 1)
        if spec.clip is not None:
            normsq = (g * g).sum(1)
            scale = 1.0 / torch.clamp(torch.sqrt(normsq) / spec.clip, min=1.0)
        else:
            scale = torch.ones(cl, device=dev)
        rows = rows - (spec.lr * scale)[:, None] * g

    metrics = {"loss_sum": loss_sum, "correct": correct,
               "total": torch.full((cl,), float(spec.n), device=dev)}
    return unpack_params(spec, rows), metrics


# ------------------------------------------------------------ the wrapper


def _check_inputs(spec: FusedEpochSpec, params, x, y, seeds):
    cl = x.shape[0]
    expect = (cl, spec.n, spec.H, spec.W, 1)
    if tuple(x.shape) != expect:
        raise ValueError(f"x must be {expect}, got {tuple(x.shape)}")
    if tuple(y.shape) != (cl, spec.n) or tuple(seeds.shape) != (cl,):
        raise ValueError(f"y must be {(cl, spec.n)} and seeds {(cl,)}, got "
                         f"{tuple(y.shape)} and {tuple(seeds.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    for name, t in (("x", x), ("y", y), ("seeds", seeds),
                    *params.items()):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if spec.cdtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype {spec.cdtype} is not supported")


def signatures(lib):
    """Declare the C interface of a loaded fused_sgd library."""
    vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.fused_sgd_epoch.argtypes = [vp, vp, vp, vp, vp, vp,
                                    i, i, i, i, i, i, i,
                                    f, f, i, i, u, f, i, u, f, i, vp]
    lib.fused_sgd_epoch.restype = ctypes.c_int
    lib.fused_sgd_workspace_bytes.argtypes = [i, i, i, i, i, i, i]
    lib.fused_sgd_workspace_bytes.restype = ctypes.c_longlong
    lib.fused_sgd_error_string.argtypes = [ctypes.c_int]
    lib.fused_sgd_error_string.restype = ctypes.c_char_p
    return lib


def fused_epoch(spec: FusedEpochSpec, params: dict, x, y, seeds):
    """Run one local epoch for every client.

    params: PyTorch-layout global CNN_DropOut params (float32); x:
    [clients, n, H, W, 1] float32; y: [clients, n] int; seeds: [clients] int
    (dropout streams). Returns (stacked per-client params, metrics dict of
    [clients] float32). CPU tensors run ``fused_epoch_reference``; CUDA
    tensors launch ``csrc/fused_sgd.cu`` or raise.
    """
    global launches
    _check_inputs(spec, params, x, y, seeds)
    if x.device.type == "cpu":
        return fused_epoch_reference(spec, params, x, y, seeds)
    if x.device.type != "cuda":
        raise ValueError(f"fused_epoch runs on cuda or cpu, not {x.device}")
    lib = signatures(_build.load("fused_sgd"))
    with torch.cuda.device(x.device):
        rows, met = _run_library(lib, spec, params, x, y, seeds,
                                 torch.cuda.current_stream(x.device).cuda_stream)
        launches += 1
    metrics = {"loss_sum": met[:, 0], "correct": met[:, 1], "total": met[:, 2]}
    return unpack_params(spec, rows), metrics


def _run_library(lib, spec: FusedEpochSpec, params: dict, x, y, seeds, stream):
    """Call ``fused_sgd_epoch`` of the loaded library on CUDA tensors of one
    device on its ``stream``. Returns the packed rows [clients, NP] and the
    metrics [clients, 3]; raises on a non-zero return code."""
    cl = x.shape[0]
    bf16 = int(spec.cdtype == torch.bfloat16)
    y32 = y.to(torch.int32).contiguous()
    seeds32 = (seeds.long() & M32).to(torch.int32).contiguous()
    rows = pack_params(spec, params).unsqueeze(0).repeat(cl, 1).contiguous()
    met = torch.zeros(cl, 3, dtype=torch.float32, device=x.device)
    met[:, 2] = float(spec.n)
    nbytes = lib.fused_sgd_workspace_bytes(cl, spec.n, spec.H, spec.W,
                                           spec.C, spec.b, bf16)
    if nbytes <= 0:
        raise ValueError(f"fused_sgd rejects this geometry (code {nbytes})")
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    clip = spec.clip if spec.clip is not None else 0.0
    rc = lib.fused_sgd_epoch(
        x.data_ptr(), y32.data_ptr(), seeds32.data_ptr(), rows.data_ptr(),
        met.data_ptr(), ws.data_ptr(),
        cl, spec.n, spec.H, spec.W, spec.C, spec.b, spec.chunk,
        spec.lr, clip, int(spec.clip is not None),
        int(bool(spec.drop1)), threshold(spec.drop1),
        keep_scale(spec, spec.drop1),
        int(bool(spec.drop2)), threshold(spec.drop2),
        keep_scale(spec, spec.drop2),
        bf16, stream)
    if rc != 0:
        raise RuntimeError("fused_sgd_epoch failed: "
                           + lib.fused_sgd_error_string(rc).decode())
    return rows, met


def build_fused_round_fn(spec: FusedEpochSpec, aggregator, shuffle=True,
                         collect_stats: bool = False):
    """Engine-signature round over the fused epoch:
    round_fn(gv, agg_state, x, y, counts, rng, participation=None,
    seeds=None, perms=None, host_counts=None) -> (gv, agg_state, metrics).

    Shuffling gathers each client's rows outside the kernel (one gather per
    round over all n rows); dropout streams are per-client seeds. Both come
    from ``rng`` (a CPU ``torch.Generator``) unless injected, and reach the
    card through pinned memory without a host sync. The kernel has no
    participation/quarantine stage: a participation mask raises.
    ``host_counts`` is the engine round's argument; the fused round reads
    no count on the host. ``collect_stats`` adds the client ledger's rows
    as a fourth output (``engine.cohort_stats`` of the kernel's results;
    None for a call's ``stats=False``)."""

    def round_fn(gv, agg_state, x, y, counts, rng, participation=None,
                 seeds=None, perms=None, host_counts=None, stats=collect_stats):
        if participation is not None:
            raise ValueError(
                "the fused kernel round has no participation/quarantine "
                "stage — run without chaos faults or cohort padding, or "
                "drop --fused_kernel")
        cl, n = x.shape[0], x.shape[1]
        # every row is trained, so a shuffle permutes all n rows
        drawn_perms, drawn_seeds = draw_client_randomness(
            rng, [n] * cl, n, 1, shuffle)
        if seeds is None:
            seeds = drawn_seeds
        if shuffle and perms is None:
            perms = drawn_perms[:, 0]
        if shuffle:
            perms = to_device(perms, x.device)
            x = torch.gather(x, 1, perms.reshape(cl, n, 1, 1, 1).expand_as(x))
            y = torch.gather(y, 1, perms)
        new_vars, metrics = fused_epoch(spec, gv, x.contiguous(), y,
                                        to_device(seeds, x.device))
        result = LocalResult(
            variables=new_vars,
            num_steps=torch.full((cl,), spec.steps, dtype=torch.int32,
                                 device=x.device),
            metrics=metrics)
        rows = cohort_stats(gv, result) if stats else None
        gv, agg_state = aggregator(gv, result, counts.float(), rng, agg_state)
        metrics = {k: v.sum() for k, v in metrics.items()}
        return (gv, agg_state, metrics, rows) if collect_stats else (gv, agg_state, metrics)

    return round_fn
