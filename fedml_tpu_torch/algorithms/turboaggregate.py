"""TurboAggregate: secure aggregation via Lagrange-coded MPC, PyTorch form
of ``fedml_tpu/algorithms/turboaggregate.py``.

Reference fedml_api/distributed/turboaggregate/mpc_function.py:4-150
(modular inverse, Lagrange coefficients, BGW/Shamir secret sharing, LCC
encoding) and the standalone TA_trainer.py:11 round structure (fixed-point
quantized model updates, multi-group circular aggregation topology).

The field arithmetic is a copy of the JAX package's, numpy int64 on the
host, as it runs there: encoding and decoding are overflow-safe U @ X (mod
p) products (``_mod_matmul``, 16-bit limbs), the modular inverse is Fermat's
by square-and-multiply, and a client's update is one flat field vector. It
stays on the host because the card has no int64 matrix product. Given the
same vectors and ``RandomState``, every function and every share equals the
JAX package's bit for bit (``tests/test_torch_turboaggregate.py``).

The security property preserved: any T or fewer shares reveal nothing about
a client's update (Shamir threshold); the server only ever reconstructs the
*sum* of updates.

A round (``TurboAggregateAPI``) trains the cohort on the device through the
engine's client step, copies the cohort-stacked parameters to the host
once (one flat [C, P] float32 matrix, the port's leaf order; fixed-point
sums are element-wise, so the average does not depend on the layout), runs
the secure sum there, and copies the new global to the device once.
"""

from __future__ import annotations

import time

import numpy as np
import torch

DEFAULT_PRIME = 2_147_483_647  # 2^31 - 1 (Mersenne), products fit in int64


def modular_inv(a: np.ndarray, p: int) -> np.ndarray:
    """Fermat inverse a^(p-2) mod p, vectorized square-and-multiply."""
    a = np.mod(np.asarray(a, np.int64), p)
    result = np.ones_like(a)
    e = p - 2
    base = a.copy()
    while e > 0:
        if e & 1:
            result = np.mod(result * base, p)
        base = np.mod(base * base, p)
        e >>= 1
    return result


def gen_lagrange_coeffs(alpha_s: np.ndarray, beta_s: np.ndarray, p: int) -> np.ndarray:
    """U[i, j] = prod_{o != beta_j} (alpha_i - o) / (beta_j - o) mod p
    (reference gen_Lagrange_coeffs, mpc_function.py:38-58)."""
    alpha_s = np.mod(np.asarray(alpha_s, np.int64), p)
    beta_s = np.mod(np.asarray(beta_s, np.int64), p)
    na, nb = len(alpha_s), len(beta_s)
    U = np.zeros((na, nb), np.int64)
    for j in range(nb):
        others = np.delete(beta_s, j)
        den = 1
        for o in others:
            den = int(np.mod(den * np.mod(beta_s[j] - o, p), p))
        den_inv = int(modular_inv(np.int64(den), p))
        for i in range(na):
            num = 1
            for o in others:
                num = int(np.mod(num * np.mod(alpha_s[i] - o, p), p))
            U[i, j] = np.mod(num * den_inv, p)
    return U


def _mod_matmul(A: np.ndarray, B: np.ndarray, p: int) -> np.ndarray:
    """(A @ B) mod p without int64 overflow.

    Both operands are reduced mod p (< 2^31), then A is split into 16-bit
    limbs: every partial product stays below 2^47, so sums over up to ~2^16
    terms fit in int64. A naive int64 A @ B with full-range field elements
    wraps mod 2^64 once two ~2^62 products are summed, which is NOT
    congruent mod p."""
    A = np.mod(np.asarray(A, np.int64), p)
    B = np.mod(np.asarray(B, np.int64), p)
    hi = np.mod((A >> 16) @ B, p)
    lo = np.mod((A & 0xFFFF) @ B, p)
    return np.mod((hi << 16) + lo, p)


def _mod_tensordot(A: np.ndarray, B: np.ndarray, p: int) -> np.ndarray:
    """tensordot(A, B, axes=(1, 0)) mod p via the overflow-safe
    ``_mod_matmul``. A: [n, k], B: [k, ...] -> [n, ...]."""
    B = np.asarray(B, np.int64)
    flat = B.reshape(B.shape[0], -1)
    out = _mod_matmul(A, flat, p)
    return out.reshape((A.shape[0],) + B.shape[1:])


def _poly_eval_matrix(alpha_s: np.ndarray, degree: int, p: int) -> np.ndarray:
    """Vandermonde [len(alpha), degree+1] with powers mod p."""
    V = np.ones((len(alpha_s), degree + 1), np.int64)
    for t in range(1, degree + 1):
        V[:, t] = np.mod(V[:, t - 1] * alpha_s, p)
    return V


def bgw_encoding(X: np.ndarray, N: int, T: int, p: int = DEFAULT_PRIME,
                 rng: np.random.RandomState | None = None) -> np.ndarray:
    """Shamir-share each row of X into N shares with threshold T (reference
    BGW_encoding, mpc_function.py:61-75). X: [m, d] int64. Returns [N, m, d]."""
    rng = rng or np.random.RandomState()
    X = np.mod(np.asarray(X, np.int64), p)
    m, d = X.shape
    R = rng.randint(0, p, size=(T + 1, m, d)).astype(np.int64)
    R[0] = X
    alpha_s = np.mod(np.arange(1, N + 1, dtype=np.int64), p)
    V = _poly_eval_matrix(alpha_s, T, p)  # [N, T+1]
    # share_i = sum_t V[i,t] * R[t]  (mod p): one overflow-safe matmul
    return _mod_tensordot(V, R, p)


def bgw_decoding(f_eval: np.ndarray, worker_idx: list[int], p: int = DEFAULT_PRIME) -> np.ndarray:
    """Reconstruct the secret (the polynomial at 0) from T+1 shares
    (reference BGW_decoding, mpc_function.py:91-109)."""
    alpha_s = np.mod(np.asarray(worker_idx, np.int64) + 1, p)
    lam = gen_lagrange_coeffs(np.zeros(1, np.int64), alpha_s, p)  # [1, RT]
    flat = f_eval.reshape(len(worker_idx), -1)
    out = np.zeros(flat.shape[1], np.int64)
    for i in range(len(worker_idx)):
        out = np.mod(out + lam[0, i] * flat[i], p)
    return out.reshape((1,) + f_eval.shape[1:])


def lcc_encoding(X: np.ndarray, N: int, K: int, T: int, p: int = DEFAULT_PRIME,
                 rng: np.random.RandomState | None = None) -> np.ndarray:
    """Lagrange-coded encoding (reference LCC_encoding, mpc_function.py:112-135):
    split X into K chunks + T random masks, interpolate through K+T points,
    evaluate at N points. X: [m, d] with K | m. Returns [N, m//K, d]."""
    rng = rng or np.random.RandomState()
    X = np.mod(np.asarray(X, np.int64), p)
    m, d = X.shape
    sub = np.zeros((K + T, m // K, d), np.int64)
    for i in range(K):
        sub[i] = X[i * m // K:(i + 1) * m // K]
    for i in range(K, K + T):
        sub[i] = rng.randint(0, p, size=(m // K, d))
    n_beta = K + T
    beta_s = np.mod(np.arange(-(n_beta // 2), -(n_beta // 2) + n_beta, dtype=np.int64), p)
    alpha_s = np.mod(np.arange(-(N // 2), -(N // 2) + N, dtype=np.int64), p)
    U = gen_lagrange_coeffs(alpha_s, beta_s, p)  # [N, K+T]
    return _mod_tensordot(U, sub, p)


def lcc_decoding(f_eval: np.ndarray, eval_points: np.ndarray, K: int, T: int,
                 p: int = DEFAULT_PRIME) -> np.ndarray:
    """Interpolate back to the K data chunks from >= K+T evaluations."""
    n_beta = K + T
    beta_s = np.mod(np.arange(-(n_beta // 2), -(n_beta // 2) + n_beta, dtype=np.int64), p)
    U = gen_lagrange_coeffs(beta_s[:K], np.mod(eval_points, p), p)  # [K, n_eval]
    flat = f_eval.reshape(len(eval_points), -1)
    out = _mod_matmul(U, flat, p)
    return out.reshape((K,) + f_eval.shape[1:])


# --------------------------------------------------------------------------
# fixed-point quantization of model trees (reference TA_trainer quantizer)


def quantize_vector(flat: np.ndarray, frac_bits: int = 16, p: int = DEFAULT_PRIME) -> np.ndarray:
    """float vector -> int64 field vector (two's-complement into [0, p)),
    rounded in float64."""
    q = np.round(np.asarray(flat, np.float64) * (1 << frac_bits)).astype(np.int64)
    return np.mod(q, p)


def flatten_tree(tree: dict) -> np.ndarray:
    """A dict of tensors (or arrays) -> one flat host vector, the leaves in
    the dict's order."""
    return np.concatenate([np.asarray(torch.as_tensor(v).detach().cpu()).ravel()
                           for v in tree.values()])


def quantize_tree(tree: dict, frac_bits: int = 16, p: int = DEFAULT_PRIME) -> np.ndarray:
    """A dict of tensors (or arrays) -> one flat int64 field vector."""
    return quantize_vector(flatten_tree(tree), frac_bits, p)


def dequantize_flat(vec: np.ndarray, frac_bits: int = 16, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Inverse of ``quantize_vector`` after summing quantized vectors: the
    signed fixed-point values as float32 (divided in float64, then cast, as
    the JAX package's leaves are made)."""
    vec = np.mod(np.asarray(vec, np.int64), p)
    # map back to signed: values > p/2 are negatives
    signed = np.where(vec > p // 2, vec - p, vec).astype(np.float64)
    return (signed / (1 << frac_bits)).astype(np.float32)


def unflatten_like(flat, tree: dict) -> dict:
    """Cut a flat tensor (or array) into ``tree``'s leaves' shapes, in the
    dict's order (views of ``flat``)."""
    flat = torch.as_tensor(flat)
    out, i = {}, 0
    for k, v in tree.items():
        n = v.numel() if isinstance(v, torch.Tensor) else int(np.prod(np.shape(v)))
        out[k] = flat[i:i + n].reshape(tuple(v.shape))
        i += n
    return out


def dequantize_vector(vec: np.ndarray, tree: dict, frac_bits: int = 16,
                      p: int = DEFAULT_PRIME, count: int = 1) -> dict:
    """Inverse of ``quantize_tree`` after summing ``count`` quantized
    vectors: float32 CPU tensors in ``tree``'s shapes."""
    return unflatten_like(torch.from_numpy(dequantize_flat(vec, frac_bits, p)), tree)


class SecureAggregator:
    """Drop-in secure-sum aggregator: clients Shamir-share quantized updates,
    the server sums *shares* and reconstructs only the sum (reference
    TurboAggregate round over groups, TA_trainer.py / TA_Aggregator.py:13).
    ``seconds`` holds the host seconds of the last call's quantize, encode
    and decode."""

    def __init__(self, num_clients: int, threshold: int | None = None,
                 frac_bits: int = 16, p: int = DEFAULT_PRIME, seed: int = 0):
        self.n = num_clients
        self.t = threshold if threshold is not None else max(1, num_clients // 2 - 1)
        self.frac_bits = frac_bits
        self.p = p
        self.rng = np.random.RandomState(seed)
        self.seconds: dict[str, float] = {}

    def secure_weighted_sum(self, client_trees: list, weights: np.ndarray) -> dict:
        """The weighted average tree, computed only from shares: the
        single-group case of the circular aggregation below."""
        return self.secure_weighted_sum_grouped(client_trees, weights, 1)

    def secure_weighted_sum_grouped(self, client_trees: list, weights: np.ndarray,
                                    num_groups: int) -> dict:
        """Multi-group circular aggregation of dicts of tensors (see
        ``secure_weighted_rows``); returns float32 CPU tensors in the first
        tree's shapes."""
        rows = [flatten_tree(tree) for tree in client_trees]
        flat = self.secure_weighted_rows(rows, weights, num_groups)
        return unflatten_like(torch.from_numpy(flat), client_trees[0])

    def weight_quanta(self, weights: np.ndarray) -> tuple:
        """(wq, res_bits): the clients' normalized weights in fixed point.
        Starts at 8-bit resolution; if any client's weight would round to 0
        (and be silently dropped from the secure sum), raises the resolution
        until it does not, up to 20 bits."""
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
        nonzero = w > 0  # exactly-zero weights contribute nothing; that's fine
        for res_bits in range(8, 22, 2):
            wq = np.round(w * (1 << res_bits)).astype(np.int64)
            if not nonzero.any() or wq[nonzero].min() > 0:
                return wq, res_bits
        raise ValueError(
            f"client weight {w[nonzero].min():.3g} underflows fixed-point "
            f"resolution 2^-{res_bits}; weights this skewed cannot be "
            "represented — drop the client or rescale weights")

    def secure_weighted_rows(self, rows, weights: np.ndarray, num_groups: int) -> np.ndarray:
        """The weighted average of the clients' flat float vectors ``rows``
        ([C, P], or C vectors), computed from shares only: float32 [P].

        Multi-group circular aggregation (reference TurboAggregate topology,
        TA_decentralized_worker_manager.py:8: workers forward partial
        aggregates to ring neighbors). Clients are split into
        ``num_groups`` ring-ordered groups; each group adds its members'
        Shamir shares onto the share-space partial aggregate received from
        the previous group, so plaintext updates never leave a client and
        intermediate aggregates exist only as shares. The final group's
        accumulated shares are reconstructed once. num_groups=1 is the flat
        secure sum."""
        if num_groups < 1:
            raise ValueError("num_groups must be >= 1")
        wq, res_bits = self.weight_quanta(weights)
        # quantize once up front; the signed magnitudes double as the
        # overflow budget: the reconstructed signed sum must stay in
        # (-p/2, p/2) or the dequantization aliases. Each client knows its
        # own max |q|.
        t0 = time.perf_counter()
        qvecs = [quantize_vector(r, self.frac_bits, self.p) for r in rows]
        t1 = time.perf_counter()
        bound = 0
        for vec, wi in zip(qvecs, wq):
            signed_max = int(np.max(np.where(vec > self.p // 2, self.p - vec, vec),
                                    initial=0))
            bound += int(wi) * signed_max
        if bound >= self.p // 2:
            raise ValueError(
                f"weighted fixed-point sum bound {bound} exceeds field capacity "
                f"{self.p // 2}; reduce frac_bits ({self.frac_bits}) or weight "
                f"resolution (2^{res_bits})")
        # ring traversal: group g adds its members' shares onto the running
        # share-space aggregate received from group g-1; only the last hop's
        # accumulated shares are ever reconstructed. The clients draw their
        # masks from self.rng in order.
        groups = np.array_split(np.arange(len(qvecs)), num_groups)
        share_total = None
        for members in groups:
            group_shares = None
            for i in members:
                masked = np.mod(qvecs[i] * wq[i], self.p)[None, :]  # [1, n]
                s = bgw_encoding(masked.T, self.n, self.t, self.p, self.rng)  # [N, n, 1]
                group_shares = s if group_shares is None else np.mod(group_shares + s, self.p)
            if group_shares is not None:
                share_total = (group_shares if share_total is None
                               else np.mod(share_total + group_shares, self.p))
        t2 = time.perf_counter()
        # reconstruct from T+1 of the summed shares: individual updates
        # never leave the field
        idx = list(range(self.t + 1))
        dec = bgw_decoding(share_total[: self.t + 1], idx, self.p)[0]  # [n, 1]
        total = np.mod(dec[:, 0], self.p)
        # normalize by the ACTUAL rounded-weight sum (sum(round(w*256)) is
        # generally != 256, which would otherwise scale the model each
        # round); the multiply in float32, as the JAX package's float32
        # leaves times a Python float
        out = dequantize_flat(total, self.frac_bits, self.p) * np.float32(1.0 / float(wq.sum()))
        self.seconds = {"quantize": t1 - t0, "encode": t2 - t1,
                        "decode": time.perf_counter() - t2}
        return out


class TurboAggregateAPI:
    """Runnable TurboAggregate federated training (reference TA_API.py +
    TA_trainer.py) on ``device`` (``cuda`` unless the caller asks for the
    CPU): FedAvg local training through the engine's client step, server
    aggregation through the secure multi-group circular sum on the host.
    The server only ever sees Shamir shares and the reconstructed
    average. ``transfers`` holds the last round's bytes copied each way."""

    def __init__(self, dataset, cfg, model_trainer, num_groups: int = 2,
                 threshold: int | None = None, frac_bits: int = 16, device="cuda"):
        from fedml_tpu_torch.algorithms.engine import (_batched_update, build_eval_fn,
                                                       pack_test_batches)
        from fedml_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = cfg.validate(device=self.device)
        self.trainer = model_trainer
        self.num_groups = num_groups
        k = min(cfg.client_num_per_round, dataset.client_num)
        self.agg = SecureAggregator(num_clients=k, threshold=threshold,
                                    frac_bits=frac_bits, seed=cfg.seed)
        self._local = _batched_update(model_trainer, cfg)
        self._eval = build_eval_fn(model_trainer)
        self.global_variables = model_trainer.init(torch.Generator().manual_seed(cfg.seed),
                                                   self.device)
        self._test_batches = pack_test_batches(dataset.test_global, cfg.batch_size,
                                               self.device)
        self.history: list[dict] = []
        self.transfers: dict[str, int] = {}

    def train_one_round(self, round_idx: int) -> dict:
        from fedml_tpu_torch.algorithms.fedavg import client_sampling, round_generator
        from fedml_tpu_torch.models.lora import attach_lora_base
        from fedml_tpu_torch.telemetry.records import fetch_scalars

        cfg = self.cfg
        idx = client_sampling(round_idx, self.dataset.client_num, cfg.client_num_per_round)
        x, y, counts = self.dataset.train.select(idx)
        dev = self.device
        result = self._local(self.global_variables, torch.from_numpy(x).to(dev),
                             torch.from_numpy(y).to(dev), torch.from_numpy(counts).to(dev),
                             round_generator(cfg.seed, round_idx), host_counts=counts)
        # one copy of the whole cohort-stacked tree to the host, as one flat
        # [C, P] matrix: per-client or per-leaf copies would each wait
        stacked = result.variables
        rows = torch.cat([v.reshape(len(idx), -1) for v in stacked.values()], 1).cpu()
        flat = self.agg.secure_weighted_rows(rows.numpy(), counts.astype(np.float64),
                                             self.num_groups)
        # one copy of the new global to the device (under LoRA the server's
        # frozen base rides beside the aggregated adapters, as in FedAvg)
        new = torch.from_numpy(flat).to(dev)
        self.global_variables = attach_lora_base(
            unflatten_like(new, {k: v[0] for k, v in stacked.items()}), self.global_variables)
        self.transfers = {"d2h_bytes": rows.numel() * rows.element_size(),
                          "h2d_bytes": new.numel() * new.element_size()}
        m = dict(zip(result.metrics, fetch_scalars([v.sum() for v in result.metrics.values()])))
        total = max(m.get("total", 1.0), 1.0)
        return {"Train/Acc": m.get("correct", 0.0) / total,
                "Train/Loss": m.get("loss_sum", 0.0) / total}

    def train(self, metrics_logger=None) -> list[dict]:
        from fedml_tpu_torch.algorithms.engine import test_metrics

        for r in range(self.cfg.comm_round):
            rec = {"round": r, **self.train_one_round(r)}
            rec.update(test_metrics(self._eval, self.global_variables, self._test_batches))
            self.history.append(rec)
            if metrics_logger is not None:
                metrics_logger.log({k: v for k, v in rec.items() if k != "round"}, step=r)
        return self.history
