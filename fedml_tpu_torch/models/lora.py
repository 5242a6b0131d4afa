"""Federated LoRA (Hu et al. 2021): a frozen base and small trainable
low-rank adapters, so that only the adapters are federated (PyTorch form of
``fedml_tpu/models/lora.py``).

``LoRATrainer`` wraps a task trainer. Its variables dict keeps the wrapped
model's parameters frozen under keys prefixed ``lora_base/`` (the JAX
package's ``"lora_base"`` collection) and puts ONLY the adapters where the
parameters were:

    {"<layer>.weight.lora_A": [d_in, r], "<layer>.weight.lora_B": [r, d_out],
     ...the model state (BatchNorm statistics), unchanged,
     "lora_base/<layer>.weight": the base weight, ...}

An LSTM cell's stacked ``weight_ih``/``weight_hh`` take one adapter per
gate kernel, as flax holds them (``<cell>.ii.weight.lora_A``, ... for the
eight kernels ``ii, if, ig, io, hi, hf, hg, ho``), merged into the stacked
rows each step.

The adapters keep flax's layout (A is [d_in, r], B is [r, d_out], their
product a flax kernel), so an adapter leaf has the same shape and bytes in
both packages and the adapter bank's rows are interchangeable. At apply
time a layer's effective weight is ``base + ((A @ B) * (alpha / r))ᵀ``;
``B`` starts at zero, so the wrapped model starts bit for bit the unwrapped
one. The engine differentiates the parameters of the stripped variables
(``utils/pytree.py::split_variables`` of ``strip_lora_base(variables)``),
which are the adapters alone: the base is frozen by construction. It never
requires grad, no optimizer state is kept for it, and it is never in an
update tree.

Federation-facing consequences, threaded through the drive:

  - the engine's local update strips the base from every client's
    ``LocalResult``, so the cohort-stacked update tree never holds C copies
    of it: aggregation, codecs, the FedBuff buffer and checkpoints see
    adapters only;
  - the round aggregates the stripped tree and the server re-attaches its
    own base afterwards (``core/builder.py``, the buffered commit);
  - checkpoints store adapters only (``FedAvgAPI._ckpt_tree``); resume and
    the guard's rollback re-attach the live base, a pure function of
    ``cfg.seed``.

The adapters' initial values are drawn from seeded ``torch.Generator``s:
JAX's threefry stream cannot be reproduced, so the values differ from the
JAX package's, but the per-leaf seeds fold the same crc32 path salts, so
the same seed gives the same adapters in every process. Parity tests inject
the JAX package's adapters through ``utils/convert.py``.
"""

from __future__ import annotations

import re
import zlib
from typing import Any, Optional

import numpy as np
import torch

from fedml_tpu_torch.utils.pytree import split_variables

# the frozen-base collection's name; the port's variables dicts hold the
# base under keys with this prefix and a "/"
LORA_COLLECTION = "lora_base"
BASE_PREFIX = LORA_COLLECTION + "/"
ADAPTER_LEAVES = ("lora_A", "lora_B")

# which parameters get adapters, matched against a weight's flax path
# ("block0/qkv/kernel"): 2-D matmul kernels (Dense layers) except the LM
# head. Embeddings and norm scales stay base-only, and the head is excluded
# as peft's "all-linear" convention excludes the output embedding: at a
# realistic NWP vocabulary a [d_model, vocab] head adapter would dwarf every
# block adapter together.
DEFAULT_TARGETS = r"(?<!lm_head/)kernel$"


def strip_lora_base(variables: dict) -> dict:
    """The variables without the frozen base (unchanged when there is
    none): what crosses the wire, what aggregators average, what
    checkpoints store."""
    return {k: v for k, v in variables.items() if not k.startswith(BASE_PREFIX)}


def attach_lora_base(variables: dict, source: dict) -> dict:
    """``variables`` with ``source``'s frozen base re-attached (unchanged
    when ``source`` carries none)."""
    base = {k: v for k, v in source.items() if k.startswith(BASE_PREFIX)}
    if not base:
        return variables
    return {**variables, **base}


def lora_base(variables: dict) -> dict:
    """The frozen base entries of ``variables``, prefix kept."""
    return {k: v for k, v in variables.items() if k.startswith(BASE_PREFIX)}


def is_adapter(key: str) -> bool:
    return key.rpartition(".")[2] in ADAPTER_LEAVES


def flax_path(key: str) -> str:
    """The flax path of a port weight key: ``block0.qkv.weight`` ->
    ``block0/qkv/kernel``."""
    return key[:-len("weight")].replace(".", "/") + "kernel"


# an LSTM cell's stacked gate weights (models/rnn.py::OptimizedLSTMCell)
# and the flax gate kernels whose transposes they stack, in row order
LSTM_GATES = {"weight_ih": ("ii", "if", "ig", "io"),
              "weight_hh": ("hi", "hf", "hg", "ho")}


def gate_key(stacked_key: str, gate: str) -> str:
    """The adapter target of one gate kernel of a stacked LSTM weight:
    ``cell.weight_ih``, ``if`` -> ``cell.if.weight`` (flax path
    ``cell/if/kernel``)."""
    return f"{stacked_key.rpartition('.')[0]}.{gate}.weight"


def adapter_targets(module, targets: str = DEFAULT_TARGETS) -> list:
    """The weight keys of ``module`` that get adapters: its 2-D flax
    kernels (Linear weights and an LSTM cell's eight gate kernels; not an
    embedding's table nor a norm's scale) whose flax path matches
    ``targets``. A gate kernel's key names the gate under its cell
    (``gate_key``): flax holds the gates as eight kernels, each adapted on
    its own, which the port's stacked weights hold as row blocks."""
    from fedml_tpu_torch.utils.convert import leaf_kinds

    kinds = leaf_kinds(module)
    out = []
    for name, p in module.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf in LSTM_GATES:
            out += [k for k in (gate_key(name, g) for g in LSTM_GATES[leaf])
                    if re.search(targets, flax_path(k))]
            continue
        if (leaf != "weight" or name in kinds or p.dim() != 2
                or not re.search(targets, flax_path(name))):
            continue
        out.append(name)
    return out


def _target_weight(base_params: dict, key: str) -> tuple:
    """(the base weight that holds target ``key``, its [d_out, d_in]):
    the weight itself, or a gate's stacked LSTM weight and one gate's
    block of it."""
    if key in base_params:
        w = base_params[key]
        return w, tuple(w.shape)
    owner, _, gate = key[:-len(".weight")].rpartition(".")
    leaf = next(leaf for leaf, gates in LSTM_GATES.items() if gate in gates)
    w = base_params[f"{owner}.{leaf}"]
    return w, (w.shape[0] // 4, w.shape[1])


def adapter_order(keys) -> list:
    """``keys`` in the JAX package's ``jax.tree.flatten`` order of the
    nested adapter tree (sorted keys at every level): the order of a bank
    row's leaves."""
    return sorted(keys, key=lambda k: tuple(k.split(".")))


def _path_salt(part: str) -> int:
    # crc32, not hash(): str hashing is randomised per process
    return zlib.crc32(part.encode()) & 0x7FFFFFFF


def init_lora_adapters(base_params: dict, rank: int, seed: int, targets: list) -> dict:
    """The adapter entries for ``targets`` (weight keys of ``base_params``):
    each weight [d_out, d_in] gets ``lora_A`` [d_in, r], a normal draw over
    sqrt(d_in), and ``lora_B`` [r, d_out] of zeros, so A @ B == 0. Each A
    is drawn from its own generator, seeded by ``seed`` and the crc32 salts
    of its flax path, so an adapter's values do not depend on the others."""
    out = {}
    for key in adapter_order(targets):
        w, (d_out, d_in) = _target_weight(base_params, key)
        salts = [_path_salt(part) for part in flax_path(key).split("/")]
        state = np.random.SeedSequence([seed, 0x10A, *salts]).generate_state(1, np.uint64)
        gen = torch.Generator().manual_seed(int(state[0]) & (2 ** 63 - 1))
        a = torch.randn((d_in, rank), generator=gen, dtype=w.dtype) / float(d_in) ** 0.5
        out[f"{key}.lora_A"] = a.to(w.device)
        out[f"{key}.lora_B"] = torch.zeros((rank, d_out), dtype=w.dtype, device=w.device)
    if not out:
        raise ValueError("no base parameter matched the LoRA targets: nothing to "
                         "fine-tune (adapters need at least one 2-D kernel)")
    return out


def _delta(adapters: dict, key: str, dtype, scale: float):
    """``((A @ B) * scale)ᵀ`` of target ``key``, or None without adapters."""
    a = adapters.get(f"{key}.lora_A")
    if a is None:
        return None
    return ((a @ adapters[f"{key}.lora_B"]).to(dtype) * scale).T


def merge_lora_params(base_params: dict, adapters: dict, scale: float) -> dict:
    """The effective parameters: ``base + ((A @ B) * scale)ᵀ`` on adapted
    weights, the base elsewhere. A stacked LSTM weight adds its gates'
    products as its row blocks, in the cell's gate order (zeros for a gate
    without adapters), so ``torch._VF.lstm`` takes the merged weights and
    the gradient reaches A and B, never the base. The rank-r products are
    small beside the layer's own matmuls and run on the device inside the
    step."""
    out = {}
    for k, w in base_params.items():
        gates = LSTM_GATES.get(k.rpartition(".")[2])
        if gates is None:
            delta = _delta(adapters, k, w.dtype, scale)
        else:
            blocks = [_delta(adapters, gate_key(k, g), w.dtype, scale) for g in gates]
            delta = None if all(b is None for b in blocks) else torch.cat([
                w.new_zeros(w.shape[0] // 4, w.shape[1]) if b is None else b
                for b in blocks])
        out[k] = w if delta is None else w + delta
    return out


class LoRATrainer:
    """A task trainer behind adapters: the same surface (``init``,
    ``apply``, ``loss_fn``, ``eval_fn``), adapters where the parameters
    were and the frozen base under ``lora_base/``. Wrap after the task
    trainer is built:

        trainer = LoRATrainer(NWPTrainer(create_model(...)), rank=8)
    """

    def __init__(self, inner, rank: int, alpha: Optional[float] = None,
                 targets: str = DEFAULT_TARGETS):
        if rank <= 0:
            raise ValueError(f"LoRA rank must be positive, got {rank} "
                             f"(rank 0 means: don't wrap the trainer)")
        self.inner = inner
        self.module = inner.module
        self.rank = int(rank)
        self.scale = float(alpha if alpha is not None else rank) / float(rank)
        self.targets = adapter_targets(self.module, targets)

    @property
    def aux_keys(self) -> tuple:
        return getattr(self.inner, "aux_keys", ("loss_sum", "correct", "total"))

    def init(self, generator: torch.Generator, device) -> dict:
        """The inner model's variables from ``generator`` (as unwrapped),
        then a seed for the adapters drawn from it: the adapters, the
        state, and the parameters as the frozen base."""
        params, state = split_variables(self.inner.init(generator, device))
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        adapters = init_lora_adapters(params, self.rank, seed, self.targets)
        return {**adapters, **state, **{BASE_PREFIX + k: v for k, v in params.items()}}

    def merged_variables(self, variables: dict) -> dict:
        """The wrapped model's view: the adapters folded into the base, no
        adapter or base key left."""
        base, adapters, inner = {}, {}, {}
        for k, v in variables.items():
            if k.startswith(BASE_PREFIX):
                base[k[len(BASE_PREFIX):]] = v
            elif is_adapter(k):
                adapters[k] = v
            else:
                inner[k] = v
        return {**inner, **merge_lora_params(base, adapters, self.scale)}

    def apply(self, variables, x, generator=None, train: bool = False):
        return self.inner.apply(self.merged_variables(variables), x, generator, train)

    def loss_fn(self, variables, batch, generator, train: bool = True):
        return self.inner.loss_fn(self.merged_variables(variables), batch, generator,
                                  train)

    def eval_fn(self, variables, batch):
        return self.inner.eval_fn(self.merged_variables(variables), batch)


def maybe_wrap_lora(trainer, cfg) -> Any:
    """The seam every entry point shares: wrap when ``cfg.lora_rank`` > 0;
    otherwise the trainer itself comes back, so ``lora_rank`` 0 runs the
    unwrapped programs. ``lora_alpha`` comes from ``cfg.extra``."""
    rank = int(getattr(cfg, "lora_rank", 0) or 0)
    if rank <= 0 or isinstance(trainer, LoRATrainer):
        return trainer
    alpha = cfg.extra.get("lora_alpha") if hasattr(cfg, "extra") else None
    return LoRATrainer(trainer, rank=rank, alpha=alpha)
