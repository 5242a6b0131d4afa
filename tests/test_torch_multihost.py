"""The port's multi-process control plane (``fedml_tpu_torch/parallel/
multihost.py``) and ``fed_launch``'s ``multihost:`` block, on the CPU:

- ``sample_sharded_cohort`` and ``stage_local_cohort`` equal the JAX
  package's bit for bit over several (N, n, P, multiple) and both samplers;
- ``init_multihost``'s default timeout (300 s), its rendezvous arguments
  and its error wrapping; a peer that never comes up raises a RuntimeError
  naming the coordinator and the rank;
- one spawned group of two ranks started by ``fed_launch``'s ``multihost:``
  block (rank 1 taking its id from ``FEDML_PROCESS_ID``) trains the
  ``shard_map`` FedAvg config: both ranks' histories and globals agree, and
  equal a single-process launch of the same config; then the control plane
  (broadcast, the metric all-gather, the agreement check and its failure,
  a barrier); then rank 1 dies and rank 0's next collective raises a
  RuntimeError naming the coordinator and the rank instead of hanging."""

import datetime
import os

import numpy as np
import pytest
import torch

import torch_dist_worker as dw
from fedml_tpu.algorithms.fedavg import fast_client_sampling as jax_fast_sampling
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.parallel import multihost as jax_multihost
from fedml_tpu_torch.algorithms.fedavg import fast_client_sampling
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.experiments import fed_launch
from fedml_tpu_torch.parallel import multihost
from fedml_tpu_torch.utils.checkpoint import all_checkpoint_steps

ROUNDS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n_total,per_round,procs,multiple", [
    (100, 10, 2, 1), (100, 10, 3, 1), (37, 11, 4, 2), (50, 50, 2, 4), (5, 3, 4, 1),
    (1000, 64, 8, 8)])
@pytest.mark.parametrize("fast", [False, True])
def test_sharded_cohort_is_the_jax_packages_bit_for_bit(n_total, per_round, procs,
                                                        multiple, fast):
    rng = np.random.RandomState(n_total)
    x = rng.rand(n_total, 3, 2).astype(np.float32)
    y = rng.randint(0, 9, size=(n_total, 3)).astype(np.int32)
    counts = rng.randint(1, 4, size=n_total).astype(np.int64)
    for r in (0, 5):
        for pi in range(procs):
            kw = dict(multiple=multiple, process_index=pi, process_count=procs)
            got = multihost.sample_sharded_cohort(
                r, n_total, per_round, sampler=fast_client_sampling if fast else None, **kw)
            want = jax_multihost.sample_sharded_cohort(
                r, n_total, per_round, sampler=jax_fast_sampling if fast else None, **kw)
            assert got.block == want.block and got.local_slice == want.local_slice
            for a, b in ((got.full_idx, want.full_idx), (got.padded_idx, want.padded_idx),
                         (got.local_idx, want.local_idx)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            staged = multihost.stage_local_cohort(PackedClients(x, y, counts), got)
            jstaged = jax_multihost.stage_local_cohort(JaxPacked(x, y, counts), want)
            for a, b in zip(staged, jstaged):
                assert a.dtype == b.dtype and a.tobytes() == np.asarray(b).tobytes()
    with pytest.raises(ValueError, match="out of range"):
        multihost.sample_sharded_cohort(0, 10, 2, process_index=2, process_count=2)


def test_single_process_control_plane_is_a_no_op():
    assert multihost.init_multihost() == {"process_index": 0, "process_count": 1,
                                          "backend": None,
                                          "local_device_count": torch.cuda.device_count()}
    assert multihost.broadcast_from_server({"a": 1}) == {"a": 1}
    assert multihost.allgather_metrics({"a": 2.0}) == {"a": 2.0}
    multihost.assert_same_across_processes(np.arange(3))
    multihost.round_barrier("r", 0)


def test_init_timeout_default_and_error_wrapping(monkeypatch):
    """init_multihost hands the rendezvous its tcp:// address, world size,
    rank, backend and a timeout defaulting to DEFAULT_INIT_TIMEOUT (300 s),
    and rewraps a failure as a RuntimeError naming the coordinator and the
    slot; a real rendezvous whose peer never comes up fails so within its
    timeout."""
    seen = {}

    def fake_init(backend, **kw):
        seen.update(backend=backend, **kw)
        raise TimeoutError("no peers")

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    with pytest.raises(RuntimeError, match=r"coordinator=10\.1\.2\.3:4.*process_id=1.*"
                                           r"num_processes=3") as err:
        multihost.init_multihost("10.1.2.3:4", 3, 1)
    assert isinstance(err.value.__cause__, TimeoutError)
    assert multihost.DEFAULT_INIT_TIMEOUT == 300
    assert seen == {"backend": "gloo", "init_method": "tcp://10.1.2.3:4", "world_size": 3,
                    "rank": 1, "timeout": datetime.timedelta(seconds=300)}
    monkeypatch.undo()
    port = dw.free_port()
    with pytest.raises(RuntimeError, match=f"after 1.0s.*coordinator=localhost:{port}.*"
                                           f"process_id=0"):
        multihost.init_multihost(f"localhost:{port}", 2, 0, initialization_timeout=1.0)
    assert not torch.distributed.is_initialized()


def _config(path, port=None, **extra):
    args = dict(dataset="mnist", model="lr", partition_method="homo", client_num_in_total=16,
                client_num_per_round=9, comm_round=ROUNDS, batch_size=8, lr=0.05, epochs=2,
                seed=3, backend="shard_map", device="cpu", **extra)
    text = "algorithm: fedavg\nargs:\n" + "".join(f"  {k}: {v}\n" for k, v in args.items())
    if port is not None:
        text += (f"multihost:\n  coordinator: \"localhost:{port}\"\n  num_processes: 2\n"
                 "  backend: gloo\n  timeout: 30\n")
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    port = dw.free_port()
    job = {"fn": "launch_job", "outdir": str(tmp), "run_dir": str(tmp / "runs"),
           "ckpt_dir": str(tmp / "ckpt"),
           "config": _config(tmp / "mh.yaml", port, ckpt_dir=tmp / "ckpt")}
    results, logs = dw.spawn({"mode": "launch", "port": port, "jobs": {"launch": job}},
                             str(tmp))
    for r, out in enumerate(results["launch"]):
        assert out is not None, f"rank {r} wrote nothing:\n{logs[r][-3000:]}"
        assert "error" not in out, f"rank {r}:\n{out['error']}"
    return tmp, results["launch"]


def test_multihost_block_starts_a_two_rank_run(launched, tmp_path):
    tmp, (rank0, rank1) = launched
    assert (rank0["world"], rank0["rank"], rank1["world"], rank1["rank"]) == (2, 0, 2, 1)
    assert len(rank0["hist"]) == ROUNDS and rank0["hist"] == rank1["hist"]
    for k, v in rank0["gv"].items():
        assert np.array_equal(v, rank1["gv"][k]), k
    # the same config launched in one process (backend shard_map over one
    # rank: the vmap round)
    ckpt = tmp_path / "single"
    hist = fed_launch.main(["--config", _config(tmp_path / "one.yaml", ckpt_dir=ckpt),
                            "--override", f"run_dir={tmp_path / 'run'}"])
    step = all_checkpoint_steps(str(ckpt))[-1]
    want = torch.load(ckpt / f"ckpt_{step}" / "tree.pt", weights_only=True)["variables"]
    gap = max(float(np.abs(rank0["gv"][k] - v.numpy()).max()) for k, v in want.items())
    assert gap < 1e-6, gap
    for got, rec in zip(rank0["hist"], hist):
        for k, v in rec.items():
            if k != "round_time":
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_control_plane_over_two_ranks(launched):
    _, (rank0, rank1) = launched
    assert rank0["broadcast"] == rank1["broadcast"] == {"from": 0}
    assert rank0["summed"] == rank1["summed"] == {"a": 3.0, "b": 1.0}
    assert "rank-dependent differs across processes" in rank0["differs"]
    assert "rank-dependent differs across processes" in rank1["differs"]


def test_a_dead_rank_raises_and_does_not_hang(launched):
    _, (rank0, _) = launched
    message, seconds = rank0["dead"]
    assert "rank 0 of 2" in message and "coordinator=localhost:" in message
    assert seconds < 30.0
