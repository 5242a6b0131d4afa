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
launcher's 14 algorithm names. A ``multihost:`` block raises
``NotImplementedError`` naming ROADMAP.md.
The config is read with PyYAML, or as JSON where PyYAML does not import,
as the JAX launcher reads it.
"""

from __future__ import annotations

import argparse
import importlib
import json

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
    ``--config`` and any number of ``--override key=value``."""
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
    if cfg.get("multihost"):
        raise NotImplementedError(
            f"the multihost: block of {args.config} is not ported to fedml_tpu_torch "
            f"yet (ROADMAP.md Queue 1 item 5, multi-device)")
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
