"""Feistel cohort sampling on the device (PyTorch form of
``fedml_tpu/algorithms/sampling.py``), bitwise the host's
``fast_client_sampling``.

``fast_client_sampling`` is a pure function of the round: a keyed 4-round
Feistel permutation over the enclosing power-of-four domain of [0, N), with
a splitmix64-style round function, whose first ``num`` in-range values are
the cohort. ``feistel_cohort_in_graph`` computes it on the device from the
per-round key schedule (``feistel_keys_block``), for one round or a block
of rounds at once. The drive does not call it: its superstep draws each
round's cohort on the host, which it needs there for the round's counts,
and sends the ids with the dispatch's other inputs.

The round function mixes in full uint64, and torch's int64 is signed: a
product past 2**63 is an overflow. So each 64-bit value is a pair of
32-bit halves (hi, lo), each held in an int64 lane, and every product is
taken over 16-bit limbs, so that no intermediate exceeds 2**49; sums are
masked back to 32 bits. Feistel halves are at most 16 bits for N < 2**31.

Cycle-walking (values that land >= N go through the network again) is a
data-dependent loop, whose trip count on the card would need a host read
per pass. The caller passes it instead: ``feistel_host`` counts its own
passes, and the device runs exactly that many.
"""

from __future__ import annotations

import numpy as np
import torch

_GOLDEN = 0x9E3779B97F4A7C15
_MIX = 0xBF58476D1CE4E5B9
_M32 = 0xFFFFFFFF
_U16 = 0xFFFF


# ------------------------------------------------------------ host schedule

def feistel_geometry(client_num_in_total: int) -> tuple[int, int]:
    """(half_bits, mask) of the enclosing power-of-four Feistel domain."""
    n = int(client_num_in_total)
    half_bits = max(1, (max(n - 1, 1).bit_length() + 1) // 2)
    return half_bits, (1 << half_bits) - 1


def feistel_round_keys(round_idx: int) -> np.ndarray:
    """[4] uint64: the key schedule of round ``round_idx``."""
    return np.random.RandomState(round_idx).randint(
        0, 2 ** 63, size=4, dtype=np.int64).astype(np.uint64)


def split_keys(keys: np.ndarray) -> np.ndarray:
    """uint64 [..., 4] -> [..., 4, 2] uint32 (hi, lo) pairs."""
    keys = np.asarray(keys, np.uint64)
    return np.stack([(keys >> np.uint64(32)).astype(np.uint32),
                     (keys & np.uint64(_M32)).astype(np.uint32)], axis=-1)


def feistel_keys_block(round_start: int, num_rounds: int) -> np.ndarray:
    """[K, 4, 2] uint32 key schedule of rounds [round_start, +num_rounds)."""
    return split_keys(np.stack([feistel_round_keys(round_start + j)
                                for j in range(num_rounds)]))


def _permute_host(v: np.ndarray, keys: np.ndarray, half_bits: int) -> np.ndarray:
    """The Feistel network in numpy uint64 (products wrap modulo 2**64)."""
    hb = np.uint64(half_bits)
    mask = np.uint64((1 << half_bits) - 1)
    left = (v >> hb) & mask
    right = v & mask
    for k in keys:  # a splitmix64-style round function, cut to a half
        mixed = right * np.uint64(_GOLDEN) + k
        mixed ^= mixed >> np.uint64(29)
        mixed = mixed * np.uint64(_MIX)
        mixed ^= mixed >> np.uint64(32)
        left, right = right, left ^ (mixed & mask)
    return (left << hb) | right


def feistel_host(round_idx: int, client_num_in_total: int,
                 client_num_per_round: int) -> tuple[np.ndarray, int]:
    """(cohort int64 [num], cycle-walk passes): ``fast_client_sampling``'s
    cohort for N > num, and how many passes its walk took (0 when every
    first value landed in range)."""
    n = int(client_num_in_total)
    num = min(int(client_num_per_round), n)
    half_bits, _ = feistel_geometry(n)
    keys = feistel_round_keys(round_idx)
    vals = _permute_host(np.arange(num, dtype=np.uint64), keys, half_bits)
    walks = 0
    oob = vals >= n
    while oob.any():
        vals = np.where(oob, _permute_host(vals, keys, half_bits), vals)
        oob = vals >= n
        walks += 1
    return vals.astype(np.int64), walks


# ----------------------------------------- uint64 as two 32-bit int64 lanes

def _mulmod32(a, b):
    """a * b mod 2**32 of 32-bit values, over a's 16-bit limbs."""
    return ((a & _U16) * b + (((a >> 16) * b) & _U16) * 65536) & _M32


def _mul64(ah, al, bh: int, bl: int):
    """(hi, lo) of (ah, al) * (bh, bl) mod 2**64 (b a constant)."""
    a0, a1 = al & _U16, al >> 16
    b0, b1 = bl & _U16, bl >> 16
    p00, p01, p10 = a0 * b0, a0 * b1, a1 * b0
    t = (p00 >> 16) + (p01 & _U16) + (p10 & _U16)
    lo = (p00 & _U16) | ((t & _U16) << 16)
    hi = a1 * b1 + (p01 >> 16) + (p10 >> 16) + (t >> 16)
    hi = (hi + _mulmod32(al, bh) + _mulmod32(ah, bl)) & _M32
    return hi, lo


def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & _M32, lo & _M32


def _shr64(ah, al, s: int):
    if s == 32:
        return torch.zeros_like(ah), ah
    return ah >> s, ((al >> s) | (ah << (32 - s))) & _M32


def _permute(v, keys, half_bits: int, mask: int):
    """The Feistel network on int64 lanes: ``v`` [..., num] in [0, 2**32),
    ``keys`` [..., 4, 2] int64 (hi, lo), one schedule a row of ``v``."""
    left = (v >> half_bits) & mask
    right = v & mask
    zero = torch.zeros_like(right)
    for i in range(4):
        mh, ml = _mul64(zero, right, _GOLDEN >> 32, _GOLDEN & _M32)
        mh, ml = _add64(mh, ml, keys[..., i, 0, None], keys[..., i, 1, None])
        sh, sl = _shr64(mh, ml, 29)
        mh, ml = mh ^ sh, ml ^ sl
        mh, ml = _mul64(mh, ml, _MIX >> 32, _MIX & _M32)
        ml = ml ^ mh  # mixed ^= mixed >> 32 touches only the low word
        left, right = right, left ^ (ml & mask)
    return (left << half_bits) | right


def feistel_cohort_in_graph(keys_hi_lo, client_num_in_total: int,
                            client_num_per_round: int, walks: int):
    """The first ``num`` in-range values of the round's keyed Feistel
    permutation, computed where ``keys_hi_lo`` lies: the device twin of
    ``fast_client_sampling(round_idx, N, num)`` given that round's split
    key schedule ([4, 2], uint32 values in any integer dtype), or of K
    rounds' at once given [K, 4, 2]. ``walks`` is the number of cycle-walk
    passes (``feistel_host``'s count; for K rounds the largest of theirs:
    a pass leaves a value in range as it is). Returns int64 ids
    [min(num, N)], or [K, min(num, N)]."""
    n = int(client_num_in_total)
    num = min(int(client_num_per_round), n)
    half_bits, mask = feistel_geometry(n)
    if n > np.iinfo(np.int32).max or half_bits > 16:
        raise ValueError(
            f"in-graph Feistel sampling takes N < 2**31 (<= 16 half bits); "
            f"got N={n}")
    keys = torch.as_tensor(keys_hi_lo).to(torch.int64)
    ids = torch.arange(num, dtype=torch.int64, device=keys.device)
    vals = _permute(ids.expand(keys.shape[:-2] + (num,)), keys, half_bits, mask)
    for _ in range(int(walks)):
        vals = torch.where(vals >= n, _permute(vals, keys, half_bits, mask), vals)
    return vals
