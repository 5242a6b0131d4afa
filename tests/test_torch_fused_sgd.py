"""The port's fused local-SGD epoch (fedml_tpu_torch/ops/fused_sgd.py)
against the JAX kernel and against the port's own engine.

On the CPU ``fused_epoch`` runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode, as tests/test_fused_sgd.py does. Inputs
come from numpy seeds and the weights from flax ``init``, carried across by
fedml_tpu_torch.utils.convert. The CUDA kernel itself is held against the
plain version by the ``cuda``-marked test here and by chip_smoke.py.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.cnn import CNN_DropOut as JaxCNN
from fedml_tpu.ops import fused_sgd as jax_fused
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import build_round_fn
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ClassificationTrainer
from fedml_tpu_torch.models.cnn import CNN_DropOut
from fedml_tpu_torch.ops import fused_sgd
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax

CLIENTS, N, BS, H, C = 3, 40, 20, 12, 5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _data(seed=0):
    """Inputs and dropout seeds. With these seeds no max-pool route of the
    epoch is a knife edge (its two largest candidates within float32
    rounding of each other), so every element meets the float32 contract;
    KNIFE_SEEDS below have one, and the test of them forces it."""
    rng = np.random.RandomState(seed)
    x = rng.rand(CLIENTS, N, H, H, 1).astype(np.float32)
    y = rng.randint(0, C, size=(CLIENTS, N)).astype(np.int32)
    seeds = np.array([11, 12345, 2 ** 31 - 2], np.int32)
    return x, y, seeds


# Dropout seeds under which the plain version and the JAX kernel part on one
# decision: in step 1, client 0's pool window (hp 2, wp 0) of channel 39 for
# sample 17 has candidates s01 and s11 a few float32 ulps apart, and the two
# float32 summation orders pick different maxima.
KNIFE_SEEDS = np.array([7, 123456789, 2 ** 31 - 2], np.int32)
KNIFE_STEP, KNIFE_WINDOW = 1, (0, 17, 2, 0, 39)


def _flax_params(x):
    return JaxCNN(output_dim=C).init(jax.random.PRNGKey(0), jnp.asarray(x[0, :1]))


def _specs(dtype, drop=(0.25, 0.5)):
    jd, td = DTYPES[dtype]
    kw = dict(height=H, width=H, n_classes=C, samples=N, batch=BS, lr=0.1,
              grad_clip=1.0, drop1=drop[0], drop2=drop[1])
    return (jax_fused.FusedEpochSpec(compute_dtype=jd, **kw),
            fused_sgd.FusedEpochSpec(compute_dtype=td, **kw))


@pytest.mark.parametrize("shape,offset", [
    ((4, 3, 3, 64), 0), ((5, 128), 0x9E3779B9), ((2, 7), 0xFFFFFFF0),
    ((3, 4, 4, 64), 12345)])
def test_hash_bits_bitwise(shape, offset):
    want = np.asarray(jax_fused._hash_bits(shape, jnp.uint32(offset)))
    got = fused_sgd.hash_bits(shape, offset).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


# float32: the JAX kernel's own contract (tests/test_fused_sgd.py:76-81).
# bfloat16: both sides round at the same points; float32 sums taken in
# another order may land on the other side of a bf16 rounding step.
TOL = {"float32": (2e-5, 1e-5, 1e-4), "bfloat16": (1e-3, 2e-4, 1e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_epoch_reference_matches_jax_kernel_with_dropout(dtype):
    x, y, seeds = _data()
    gv = _flax_params(x)
    jspec, tspec = _specs(dtype)
    jp, jm = jax_fused.fused_epoch(jspec, gv, jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(seeds), interpret=True)
    tp, tm = fused_sgd.fused_epoch(tspec, flax_to_torch(gv), torch.from_numpy(x),
                                   torch.from_numpy(y), torch.from_numpy(seeds))
    rtol, atol, mtol = TOL[dtype]
    got = torch_to_flax(tp)["params"]
    for layer, leaves in jp["params"].items():
        for kind, want in leaves.items():
            np.testing.assert_allclose(got[layer][kind], np.asarray(want),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{dtype} {layer}.{kind}")
    for key in ("loss_sum", "correct", "total"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]),
                                   rtol=mtol, atol=mtol, err_msg=key)


def test_knife_edge_seeds_agree_once_their_pool_route_is_forced(monkeypatch):
    """KNIFE_SEEDS: as is, the plain version misses the float32 contract
    against the JAX kernel, in client 0 only. With the one knife-edge route
    sent to s01 (the JAX kernel's choice), every element meets it."""
    x, y, _ = _data()
    gv = _flax_params(x)
    jspec, tspec = _specs("float32")
    jp, _ = jax_fused.fused_epoch(jspec, gv, jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(KNIFE_SEEDS), interpret=True)
    rtol, atol, _ = TOL["float32"]

    def clients_outside():
        tp, _ = fused_sgd.fused_epoch(tspec, flax_to_torch(gv), torch.from_numpy(x),
                                      torch.from_numpy(y), torch.from_numpy(KNIFE_SEEDS))
        got = torch_to_flax(tp)["params"]
        bad = np.zeros(CLIENTS, np.int64)
        for layer, leaves in jp["params"].items():
            for kind, want in leaves.items():
                want = np.asarray(want)
                out = np.abs(got[layer][kind] - want) > atol + rtol * np.abs(want)
                bad += out.reshape(CLIENTS, -1).sum(1)
        return bad

    as_is = clients_outside()
    assert as_is[0] > 0 and not as_is[1:].any(), as_is

    route, calls = fused_sgd._pool_route, []

    def forced(dd, candidates, pooled):
        calls.append(None)
        if len(calls) - 1 == KNIFE_STEP:
            s00, s01, s10, s11 = candidates
            top = pooled[KNIFE_WINDOW].item()
            assert s11[KNIFE_WINDOW].item() == top
            gap = top - s01[KNIFE_WINDOW].item()
            assert 0 < gap <= 8 * np.spacing(np.float32(top)), gap
            s01 = s01.clone()
            s01[KNIFE_WINDOW] = top
            candidates = (s00, s01, s10, s11)
        return route(dd, candidates, pooled)

    monkeypatch.setattr(fused_sgd, "_pool_route", forced)
    np.testing.assert_array_equal(clients_outside(), 0)


def test_dropout_masks_follow_the_chunk_geometry():
    """The keep bits of sample bi of step s are those of row bi % chunk of
    the JAX kernel's global chunk s * nchunks + bi // chunk."""
    _, spec = _specs("float32")
    seeds = torch.tensor([5, 77, 2 ** 31 - 2])
    s, width = 1, spec.F
    got = fused_sgd._step_bits(spec, seeds, s, width, fused_sgd._DROP1_MIX)
    for z, seed in enumerate(seeds.tolist()):
        for ci in range(spec.nchunks):
            g_idx = s * spec.nchunks + ci
            off = (seed * 0x9E3779B9 + g_idx * 0x85EBCA77) & 0xFFFFFFFF
            want = np.asarray(jax_fused._hash_bits(
                (spec.chunk, spec.Hp, spec.Wp, 64), jnp.uint32(off)))
            rows = got[z, ci * spec.chunk:(ci + 1) * spec.chunk]
            np.testing.assert_array_equal(rows.numpy(),
                                          want.reshape(spec.chunk, width))


def _no_drop_setup(seed=0):
    x, y, _ = _data(seed)
    counts = torch.full((CLIENTS,), N, dtype=torch.int32)
    cfg = FedConfig(batch_size=BS, epochs=1, lr=0.1, client_optimizer="sgd",
                    client_num_per_round=CLIENTS, shuffle=False)
    trainer = ClassificationTrainer(CNN_DropOut(output_dim=C, drop1=0.0,
                                                drop2=0.0, input_hw=H))
    gv = flax_to_torch(_flax_params(x))
    return cfg, trainer, gv, torch.from_numpy(x), torch.from_numpy(y), counts


def test_fused_round_matches_engine_round():
    """Mirror of tests/test_fused_sgd.py:62 inside the port: dropout and
    shuffle off, three rounds of the fused round against the engine."""
    cfg, trainer, gv, x, y, counts = _no_drop_setup()
    agg = make_aggregator("fedavg", cfg)
    engine = build_round_fn(trainer, cfg, agg, device="cpu")
    fused = build_round_fn(trainer, cfg.replace(fused_kernel=True), agg,
                           device="cpu")
    gv_e, gv_f, st_e, st_f = gv, gv, (), ()
    for r in range(3):
        gen_e = torch.Generator().manual_seed(r)
        gen_f = torch.Generator().manual_seed(r)
        gv_e, st_e, m_e = engine(gv_e, st_e, x, y, counts, gen_e)
        gv_f, st_f, m_f = fused(gv_f, st_f, x, y, counts, gen_f)
    for k in gv_e:
        np.testing.assert_allclose(gv_f[k].numpy(), gv_e[k].numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=k)
    assert m_e.keys() == m_f.keys()
    for k in m_e:
        np.testing.assert_allclose(float(m_f[k]), float(m_e[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_fused_round_injected_shuffle_matches_pre_permuted_data():
    """Injected permutations gather each client's rows outside the kernel:
    a shuffled round equals an unshuffled round on pre-permuted data."""
    cfg, trainer, gv, x, y, counts = _no_drop_setup(1)
    agg = make_aggregator("fedavg", cfg)
    on = build_round_fn(trainer, cfg.replace(fused_kernel=True, shuffle=True),
                        agg, device="cpu")
    off = build_round_fn(trainer, cfg.replace(fused_kernel=True), agg,
                         device="cpu")
    perms = torch.stack([torch.randperm(N, generator=torch.Generator().manual_seed(c))
                         for c in range(CLIENTS)])
    seeds = torch.tensor([1, 2, 3])
    gv_a, _, m_a = on(gv, (), x, y, counts, torch.Generator(), seeds=seeds,
                      perms=perms)
    xp = torch.stack([x[c, perms[c]] for c in range(CLIENTS)])
    yp = torch.stack([y[c, perms[c]] for c in range(CLIENTS)])
    gv_b, _, m_b = off(gv, (), xp, yp, counts, torch.Generator(), seeds=seeds)
    for k in gv_a:
        torch.testing.assert_close(gv_a[k], gv_b[k], rtol=0, atol=0)
    assert float(m_a["loss_sum"]) == float(m_b["loss_sum"])


def test_fused_guards():
    cfg, trainer, gv, x, y, counts = _no_drop_setup()
    agg = make_aggregator("fedavg", cfg)
    fused = build_round_fn(trainer, cfg.replace(fused_kernel=True), agg,
                           device="cpu")
    with pytest.raises(ValueError, match="participation"):
        fused(gv, (), x, y, counts, torch.Generator(),
              participation=torch.ones(CLIENTS, dtype=torch.bool))
    with pytest.raises(ValueError, match="samples % batch"):
        fused(gv, (), x[:, :30], y[:, :30], counts, torch.Generator())
    with pytest.raises(ValueError, match="codec"):
        build_round_fn(trainer, cfg.replace(fused_kernel=True), agg,
                       codec=object(), device="cpu")
    with pytest.raises(ValueError, match="epoch"):
        build_round_fn(trainer, cfg.replace(fused_kernel=True, epochs=2), agg,
                       device="cpu")


def test_pack_unpack_round_trip():
    cfg, trainer, gv, *_ = _no_drop_setup()
    _, spec = _specs("float32")
    rows = fused_sgd.pack_params(spec, gv).unsqueeze(0).repeat(2, 1)
    back = fused_sgd.unpack_params(spec, rows)
    for k, v in gv.items():
        torch.testing.assert_close(back[k][1], v, rtol=0, atol=0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_agreement_check_passes_sound_and_rejects_faulted_results(dtype):
    """chip_smoke.py's check of the kernel against its plain version, on
    plain-version results: a copy off by float32 rounding passes; a copy
    with a skipped update, a skipped leaf, or a few elements off by more
    than max_abs (a fault at one tile's edge) does not."""
    cs = _chip_smoke()
    tol = cs.TOL[dtype]
    x, y, seeds = _data()
    gv = flax_to_torch(_flax_params(x))
    _, spec = _specs(dtype)
    plain, _ = fused_sgd.fused_epoch_reference(spec, gv, torch.from_numpy(x),
                                               torch.from_numpy(y), torch.from_numpy(seeds))
    gen = torch.Generator().manual_seed(0)
    sound = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
             for k, v in plain.items()}
    cs.check_agreement("sound", sound, plain, gv, tol, tol["outliers"])
    assert cs.check_controls("controls", plain, gv, tol, tol["outliers"]) == 17
    edge = dict(plain)
    edge["conv2d_2.weight"] = plain["conv2d_2.weight"].clone()
    edge["conv2d_2.weight"][:, :2, 0, 0, 0] += 2 * tol["max_abs"]
    with pytest.raises(cs.Disagreement, match="differs by"):
        cs.check_agreement("edge", edge, plain, gv, tol, tol["outliers"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """The CUDA kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, y, seeds = _data()
    _, spec = _specs(dtype)
    dev = torch.device("cuda")
    gv = flax_to_torch(_flax_params(x), device=dev)
    args = (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
            torch.from_numpy(seeds).to(dev))
    before = fused_sgd.launches
    kp, km = fused_sgd.fused_epoch(spec, gv, *args)
    assert fused_sgd.launches == before + 1
    pp, pm = fused_sgd.fused_epoch_reference(spec, gv, *args)
    rtol, atol, mtol = TOL[dtype]
    for k in kp:
        torch.testing.assert_close(kp[k], pp[k], rtol=rtol, atol=atol)
    for k in km:
        torch.testing.assert_close(km[k], pm[k], rtol=mtol, atol=mtol)


def test_chip_smoke_fails_on_any_spill_in_a_conv2_kernel():
    """chip_smoke.py labels each conv2 tensor-core instantiation of
    csrc/fused_sgd.cu and fails on a spill in any of them."""
    cs = _chip_smoke()
    prefix = "_ZN45_GLOBAL__N__b2a06293_12_fused_sgd_cu_ef83f7e9"
    kernels = {
        prefix + "16conv2_fwd_kernelIfEEvNS_3GeoENS_4BufsIT_EE": {"registers": 81,
                                                                   "spill_bytes": 0},
        prefix + "18conv2_wgrad_kernelI13__nv_bfloat16EEvNS_3GeoENS_4BufsIT_EEi":
            {"registers": 117, "spill_bytes": 0},
        prefix + "12sumsq_kernelEPKfiPf": {"registers": 32, "spill_bytes": 8}}
    assert [cs.conv2_label(k) for k in sorted(kernels)] == [
        None, "conv2_fwd_kernel<float32>", "conv2_wgrad_kernel<bfloat16>"]
    assert cs.check_spills(kernels) == [
        "conv2_fwd_kernel<float32>: 81 registers, 0 bytes of spill",
        "conv2_wgrad_kernel<bfloat16>: 117 registers, 0 bytes of spill"]
    dgrad = prefix + "18conv2_dgrad_kernelIfEEvNS_3GeoENS_4BufsIT_EE"
    with pytest.raises(RuntimeError, match=r"conv2_dgrad_kernel<float32> spills 4 bytes"):
        cs.check_spills({**kernels, dgrad: {"registers": 255, "spill_bytes": 4}})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_determinism_check_passes_equal_runs_and_rejects_others(dtype, monkeypatch):
    """chip_smoke.py's two-run check: the plain version run twice passes;
    a second run one ulp off in one leaf fails."""
    cs = _chip_smoke()
    x, y, seeds = _data()
    _, spec = _specs(dtype)
    inputs = (flax_to_torch(_flax_params(x)), torch.from_numpy(x), torch.from_numpy(y),
              torch.from_numpy(seeds))
    cs.check_determinism(dtype, spec, inputs)
    plain, calls = fused_sgd.fused_epoch, []

    def second_run_off(*args):
        params, metrics = plain(*args)
        calls.append(None)
        if len(calls) == 2:
            w = params["linear_2.bias"]
            params["linear_2.bias"] = torch.nextafter(w, w + 1)
        return params, metrics

    monkeypatch.setattr(fused_sgd, "fused_epoch", second_run_off)
    with pytest.raises(cs.Disagreement, match="linear_2.bias"):
        cs.check_determinism(dtype, spec, inputs)
