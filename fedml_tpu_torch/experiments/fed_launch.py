"""YAML-driven experiment launcher of the PyTorch port (mirror of
``fedml_tpu/experiments/fed_launch.py``; reference fedml_experiments/
distributed/fed_launch/). The YAML describes the experiment: the algorithm,
and under ``args`` the CLI flags of that algorithm's main (dataset, model,
hyperparameters, the backend and mesh shape). The repo's configs are under
``fedml_tpu/experiments/configs/`` and its ``baseline/``.

    algorithm: fedavg            # fedavg, fedopt, fednova, fedavg_robust, privacy,
                                 # hierarchical, decentralized, base, turboaggregate,
                                 # fedgkt, split_nn, vfl, fednas or fedseg
    args:
      dataset: femnist
      model: cnn
      client_num_in_total: 3400
      client_num_per_round: 10
      comm_round: 100
      batch_size: 20
      lr: 0.1
      backend: shard_map         # one device: the vmap round

Usage:
  python -m fedml_tpu_torch.experiments.fed_launch --config exp.yaml
  python -m fedml_tpu_torch.experiments.fed_launch --config exp.yaml \
      --override comm_round=2 --override fused_kernel=1

``privacy`` runs ``main_privacy`` (the branch and block ensembles with the
MI report), so all 26 of the repo's configs run, and every one of the JAX
launcher's 14 algorithm names.

A ``multihost:`` block starts this process as one rank of a
``torch.distributed`` process group before the main runs
(``parallel/multihost.py::init_multihost``), as the JAX launcher starts
``jax.distributed``; with ``backend: shard_map`` FedAvg then shards each
round's cohort over the ranks (``parallel/sharded.py``). One process a rank:

    multihost:
      coordinator: "localhost:29500"   # host:port of rank 0's rendezvous
      num_processes: 2
      process_id: 0                    # or the FEDML_PROCESS_ID variable
      backend: gloo                    # gloo (CPU, or ranks sharing a card)
                                       # or nccl (one card a rank)
      timeout: 300                     # seconds to wait for the peers and
                                       # for any collective

The config is read with PyYAML, or as JSON where PyYAML does not import,
as the JAX launcher reads it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os

ALGORITHMS = {
    # algorithm name -> the port's experiments module with a main(argv)
    name: f"fedml_tpu_torch.experiments.main_{name}"
    for name in ("fedavg", "fedopt", "fednova", "fedavg_robust", "privacy", "hierarchical",
                 "decentralized", "base", "turboaggregate", "fedgkt", "split_nn", "vfl",
                 "fednas", "fedseg")
}


def _load_yaml(path: str) -> dict:
    """The config at ``path``, by the JAX package's rule: PyYAML's
    ``safe_load``, or JSON (a subset of YAML) where PyYAML does not import."""
    with open(path) as f:
        try:
            import yaml
        except ImportError:
            return json.load(f)
        return yaml.safe_load(f)


def config_to_argv(args_map: dict) -> list[str]:
    """The CLI argv of a config's ``args``: ``--key value``; a list gives
    its items after the flag; True gives the bare flag and False nothing."""
    argv: list[str] = []
    for k, v in args_map.items():
        if isinstance(v, bool):
            if v:
                argv.append(f"--{k}")
        elif isinstance(v, (list, tuple)):
            argv += [f"--{k}"] + [str(x) for x in v]
        else:
            argv += [f"--{k}", str(v)]
    return argv


def resolve(argv=None) -> tuple[str, list[str]]:
    """(the main's module name, its argv) for the launcher's ``argv``:
    ``--config`` and any number of ``--override key=value``. A
    ``multihost:`` block initializes the process group here."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--override", type=str, nargs="*", default=[], action="extend",
                        help="key=value overrides applied on top of the YAML; "
                             "repeatable (occurrences accumulate)")
    args = parser.parse_args(argv)
    cfg = _load_yaml(args.config)
    algo = cfg.get("algorithm", "fedavg")
    if algo not in ALGORITHMS:
        raise SystemExit(f"unknown algorithm {algo!r}; one of {sorted(ALGORITHMS)}")
    mh = cfg.get("multihost")
    if mh:
        from fedml_tpu_torch.parallel.multihost import init_multihost

        pid = mh.get("process_id")
        if pid is None:
            pid = int(os.environ.get("FEDML_PROCESS_ID", "0"))
        info = init_multihost(mh["coordinator"], int(mh["num_processes"]), int(pid),
                              initialization_timeout=mh.get("timeout"),
                              backend=mh.get("backend", "gloo"))
        print(f"multihost topology: {info}")
    exp_args = dict(cfg.get("args") or {})
    for ov in args.override:
        k, _, v = ov.partition("=")
        exp_args[k] = v
    return ALGORITHMS[algo], config_to_argv(exp_args)


def main(argv=None):
    """Run the config's algorithm main; returns its history."""
    module, main_argv = resolve(argv)
    return importlib.import_module(module).main(main_argv)


if __name__ == "__main__":
    main()
