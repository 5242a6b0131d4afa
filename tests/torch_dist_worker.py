"""One rank of the port's multi-process CPU tests (tests/test_torch_parallel.py,
tests/test_torch_multihost.py), run as a script:

    python tests/torch_dist_worker.py RANK WORLD PORT SPEC OUTDIR

SPEC is a ``torch.save``d dict: ``mode`` and the jobs. Every job's result
(or its traceback) is saved to ``OUTDIR/<job>.rank<RANK>.pt``. The worker
imports torch and the port only, never JAX, and pins PyTorch to one
thread."""

import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _save(outdir, name, rank, value):
    import torch

    torch.save(value, os.path.join(outdir, f"{name}.rank{rank}.pt"))


def _numpy(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree


def _trainer(job):
    from fedml_tpu_torch import ClassificationTrainer, create_model

    return ClassificationTrainer(create_model(job.get("model", "lr"), output_dim=job["classes"]))


def _aggregator(job, cfg, slots):
    from fedml_tpu_torch.algorithms.aggregators import make_aggregator
    from fedml_tpu_torch.codecs import make_codec
    from fedml_tpu_torch.core.builder import wrap_codec

    agg = make_aggregator(job["aggregator"], cfg)
    return wrap_codec(agg, make_codec(cfg.update_codec, cfg), slots)


def round_job(job, rank, world):
    """One sharded round over this rank's block of the job's padded
    cohort: (globals, state, metrics)."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import round_generator
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.parallel import build_sharded_round_fn, make_mesh

    cfg = FedConfig(**job["cfg"])
    x, y, counts = job["x"], job["y"], job["counts"]
    n = len(counts)
    block = -(-n // world)
    pad = block * world - n
    padded = [torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]) for a in (x, y, counts)]
    lo = rank * block
    local = [a[lo:lo + block] for a in padded]
    agg = _aggregator(job, cfg, block)
    state = agg.init_state(job["gv"])
    if "state" in job:
        state = job["state"]
        if "codec" in state:
            state = {"agg": state["agg"], "codec": {k: v[lo:lo + block]
                                                    for k, v in state["codec"].items()}}
    participation = None
    if job.get("participation") is not None:
        participation = torch.cat([job["participation"],
                                   torch.zeros(pad, dtype=torch.bool)])[lo:lo + block]
    round_fn = build_sharded_round_fn(_trainer(job), cfg, agg, make_mesh(device="cpu"))
    out = round_fn(job["gv"], state, *local, round_generator(cfg.seed, job.get("round", 0)),
                   participation, host_counts=counts.numpy())
    return _numpy(out)


def buffer_job(job, rank, world):
    """The sharded admits and commit: (local buffer rows, commit outputs)."""
    import torch

    from fedml_tpu_torch.algorithms.aggregators import (init_buffer, make_aggregator,
                                                        make_staleness_discount)
    from fedml_tpu_torch.algorithms.engine import LocalResult
    from fedml_tpu_torch.algorithms.fedavg import round_generator
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.parallel import build_sharded_buffer_fns, make_mesh

    cfg = FedConfig(**job["cfg"])
    stacked = job["stacked"]
    c_local = stacked["steps"].shape[0] // world
    k_local = job["k"] // world

    def block(v, size):
        return v[rank * size:(rank + 1) * size]

    local = LocalResult({n: block(v, c_local) for n, v in stacked["vars"].items()},
                        block(stacked["steps"], c_local),
                        {n: block(v, c_local) for n, v in stacked["metrics"].items()})
    agg = make_aggregator(job["aggregator"], cfg)
    admit, commit = build_sharded_buffer_fns(agg, make_staleness_discount(job["alpha"]),
                                             make_mesh(device="cpu"))
    buf = init_buffer(local, k_local)
    counts = block(stacked["counts"], c_local)
    for fill, src in enumerate(job["srcs"]):
        buf = admit(buf, local.variables, local.num_steps, local.metrics, counts, src, fill)
    out = commit(job["gv"], agg.init_state(job["gv"]), buf, len(job["srcs"]), job["births"],
                 job["commit_round"], round_generator(cfg.seed, job["commit_round"]))
    return _numpy({"buf": buf, "commit": out})


def api_job(job, rank, world):
    """FedAvgAPI with backend='shard_map' over the group: its history and
    final globals."""
    from fedml_tpu_torch import FedAvgAPI, FedConfig, load_dataset
    from fedml_tpu_torch.parallel.multihost import assert_same_across_processes
    from fedml_tpu_torch.robustness.chaos import FaultPlan

    ds = load_dataset(**job["dataset"])
    api = FedAvgAPI(ds, FedConfig(**job["cfg"]), _trainer(job),
                    aggregator_name=job["aggregator"], device="cpu")
    if "gv" in job:
        api.global_variables = job["gv"]
    chaos = FaultPlan(**job["chaos"]) if job.get("chaos") else None
    hist = api.train(chaos=chaos)
    assert_same_across_processes(api.global_variables, "globals")
    assert_same_across_processes(
        [[r[k] for k in sorted(r) if k != "round_time"] for r in hist], "history")
    return {"mesh": (api.mesh.world_size, api.mesh.rank, api.mesh.backend),
            "round": api.round_fn.__qualname__,
            "gv": _numpy(api.global_variables),
            "hist": [{k: v for k, v in r.items() if k != "round_time"} for r in hist]}


def raises_job(job, rank, world):
    """The APIs that must refuse a group of more than one rank, and the
    config rules of the sharded round: {case: error message}."""
    import numpy as np

    from fedml_tpu_torch import (ClassificationTrainer, DecentralizedFLAPI, FedAvgAPI,
                                 FedConfig, HierarchicalFLAPI, create_model, load_dataset)
    from fedml_tpu_torch.core import topology

    ds = load_dataset("mnist", client_num_in_total=6, partition_method="homo", seed=1)

    def trainer():
        return ClassificationTrainer(create_model("lr", output_dim=ds.class_num))

    cases = {
        "hierarchical": lambda: HierarchicalFLAPI(ds, FedConfig(backend="shard_map"),
                                                  trainer(), device="cpu"),
        "decentralized": lambda: DecentralizedFLAPI(
            trainer(), FedConfig(), topology.SymmetricTopologyManager(4, 2), device="cpu"),
        "mesh_shape": lambda: FedConfig(backend="shard_map", mesh_shape=(4,)).validate(),
        "fused": lambda: FedAvgAPI(ds, FedConfig(backend="shard_map", fused_kernel=True,
                                                 model="cnn"), trainer(), device="cpu"),
        "silo": lambda: FedConfig(backend="shard_map", silo_threshold=2).validate(),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — the test reads the type and text
            out[name] = (type(e).__name__, str(e))
        else:
            out[name] = None
    out["valid"] = FedConfig(backend="shard_map", mesh_shape=(1, 2)).validate().mesh_size()
    out["shape"] = np.asarray([world])
    return out


def launch_job(job, rank, world):
    """A fed_launch run whose multihost: block starts the group (rank 1
    takes its id from FEDML_PROCESS_ID), then the control plane; rank 1
    then exits without a word and rank 0's next collective must raise."""
    import numpy as np
    import torch

    from fedml_tpu_torch.experiments import fed_launch
    from fedml_tpu_torch.parallel import mesh, multihost
    from fedml_tpu_torch.utils.checkpoint import all_checkpoint_steps

    os.environ["FEDML_PROCESS_ID"] = str(rank)
    t0 = time.perf_counter()
    hist = fed_launch.main(["--config", job["config"], "--override",
                            f"run_dir={job['run_dir']}/rank{rank}"])
    out = {"hist": [{k: v for k, v in r.items() if k != "round_time"} for r in hist],
           "world": mesh.world_size(), "rank": mesh.rank(), "launch_s": time.perf_counter() - t0,
           "gv": _numpy(_final_globals(os.path.join(job["ckpt_dir"], f"rank{rank}"),
                                       all_checkpoint_steps)),
           "broadcast": multihost.broadcast_from_server({"from": rank}),
           "summed": multihost.allgather_metrics({"a": rank + 1.0, "b": 0.5})}
    multihost.assert_same_across_processes(np.arange(4), "same")
    try:
        multihost.assert_same_across_processes(np.arange(4) + rank, "rank-dependent")
    except AssertionError as e:
        out["differs"] = str(e)
    multihost.round_barrier("test", 0)
    if rank == 1:
        _save(job["outdir"], "launch", rank, out)
        os._exit(0)  # a dead rank: no goodbye to the group
    time.sleep(1.0)
    t0 = time.perf_counter()
    try:
        mesh.all_reduce_tree({"x": torch.ones(3)})
    except RuntimeError as e:
        out["dead"] = (str(e), time.perf_counter() - t0)
    return out


def _final_globals(ckpt_dir, steps):
    import torch

    path = os.path.join(ckpt_dir, f"ckpt_{steps(ckpt_dir)[-1]}", "tree.pt")
    return torch.load(path, weights_only=True)["variables"]


def main(rank, world, port, spec_path, outdir):
    import torch

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    if spec["mode"] == "jobs":
        from fedml_tpu_torch.parallel.multihost import init_multihost

        init_multihost(f"localhost:{port}", world, rank, initialization_timeout=120)
    for name, job in spec["jobs"].items():
        try:
            result = globals()[job["fn"]](job, rank, world)
        except Exception:  # noqa: BLE001 — handed to the test
            result = {"error": traceback.format_exc()}
        _save(outdir, name, rank, result)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn(spec: dict, tmp_dir: str, world: int = 2, timeout: float = 300.0):
    """Run ``spec`` on ``world`` worker processes (rendezvous on localhost at
    ``spec["port"]``, or a free port); returns ({job: [rank 0's result,
    ...]}, the ranks' logs). A missing result file reads as None."""
    import subprocess

    import torch

    port = spec.get("port") or free_port()
    spec_path = os.path.join(tmp_dir, "spec.pt")
    torch.save(spec, spec_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               str(port), spec_path, tmp_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = {}
    for name in spec["jobs"]:
        paths = [os.path.join(tmp_dir, f"{name}.rank{r}.pt") for r in range(world)]
        results[name] = [torch.load(p, weights_only=False) if os.path.exists(p) else None
                         for p in paths]
    return results, logs
