"""Privacy experiment main of the PyTorch port (mirror of
``fedml_tpu/experiments/main_privacy.py``; reference privacy_fedml/
main_fedavg.py:1-552, the fork's branch / ensemble FedAvg with
membership-inference evaluation). Flags: ``main_fedavg``'s and the
reference's (:100-135) ``--branch_num``, ``--ensemble_method``,
``--server_data_ratio``, ``--feat_lmda``, ``--num_paths``,
``--no_mi_attack`` and ``--shared_blocks``.

Ensemble methods: predavg, predvote, predweight, blockavg and hetero
through ``privacy/branch_fedavg.py::BranchFedAvgAPI``; blockensemble
through ``privacy/blockensemble.py::BlockEnsembleAPI``, whose clients train
``--num_paths`` (2 or 3) mixed paths jointly. The run ends with the MI
report (``MI/*``) unless ``--no_mi_attack``, and writes the metrics
logger's files into ``--run_dir``.

Usage (``fedml_tpu/experiments/configs/privacy_blockensemble.yaml``):
  python -m fedml_tpu_torch.experiments.main_privacy --dataset mnist \\
      --partition_method homo --client_num_in_total 10 \\
      --client_num_per_round 10 --comm_round 50 --batch_size 32 --lr 0.1 \\
      --branch_num 4 --ensemble_method blockensemble --num_paths 2
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from fedml_tpu_torch.core.trainer import ClassificationTrainer
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.experiments.main_fedavg import add_args, start_run
from fedml_tpu_torch.models.ensemble import AdaptiveCNN, ArchSpec, build_hetero_archs
from fedml_tpu_torch.privacy.blockensemble import BlockEnsembleAPI
from fedml_tpu_torch.privacy.branch_fedavg import BranchFedAvgAPI
from fedml_tpu_torch.privacy.mi_attack import (GradientVectorAttack, MixGradientAttack,
                                               NNAttack, gradient_norm_attack, loss_attack,
                                               make_penultimate_grad_fn,
                                               make_per_sample_grad_norm,
                                               make_per_sample_loss)
from fedml_tpu_torch.utils.logging import MetricsLogger

log = logging.getLogger(__name__)

#: most member (and as many non-member) rows of the MI report
MI_ROWS = 512


def run_mi_attacks(predict_fn, trainer, variables, member, nonmember) -> dict:
    """The shadow-NN attack on ``predict_fn``; with a local model
    (``trainer`` and ``variables``) also the loss, gradient-norm,
    gradient-vector and mix-gradient attacks (reference
    privacy_fedml/MI_attack/*)."""
    (mx, my), (nx, ny) = member, nonmember
    out = {}
    nn_attack = NNAttack(top_k=3)
    nn_attack.fit(predict_fn, mx, nx)
    out.update({f"MI/NN_{k}": v for k, v in nn_attack.score(predict_fn, mx, nx).items()})
    if trainer is not None and variables is not None:
        loss_fn = make_per_sample_loss(trainer, variables)
        out.update({f"MI/Loss_{k}": v for k, v in
                    loss_attack(loss_fn, (mx, my), (nx, ny)).items()})
        gn_fn = make_per_sample_grad_norm(trainer, variables)
        out.update({f"MI/GradNorm_{k}": v for k, v in
                    gradient_norm_attack(gn_fn, (mx, my), (nx, ny)).items()})
        pg_fn = make_penultimate_grad_fn(trainer, variables)

        @torch.no_grad()
        def local_predict(x):
            return trainer.apply(variables, x)[0]

        # gradient-vector attack: the LOCAL model's own predictions and
        # gradients
        gv = GradientVectorAttack().fit(local_predict, pg_fn, (mx, my), (nx, ny))
        out.update({f"MI/GradVec_{k}": v for k, v in
                    gv.score(local_predict, pg_fn, (mx, my), (nx, ny)).items()})
        # mix-gradient attack: the TARGET (ensemble) predictions with the
        # LOCAL gradients, the reference's feature mix
        # (MixGradient_attack.py:104-114)
        mg = MixGradientAttack(seed=1).fit(predict_fn, pg_fn, (mx, my), (nx, ny))
        out.update({f"MI/MixGrad_{k}": v for k, v in
                    mg.score(predict_fn, pg_fn, (mx, my), (nx, ny)).items()})
    return out


def add_privacy_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The reference's privacy flags (privacy_fedml/main_fedavg.py:122-134)."""
    parser.add_argument("--branch_num", type=int, default=4)
    parser.add_argument("--ensemble_method", type=str, default="predavg",
                        choices=["predavg", "predvote", "predweight",
                                 "blockavg", "hetero", "blockensemble"])
    parser.add_argument("--server_data_ratio", type=float, default=0.1)
    parser.add_argument("--feat_lmda", type=float, default=0.0)
    parser.add_argument("--num_paths", type=int, default=2,
                        help="2 = TwoModelTrainer, 3 = ThreeModelTrainer "
                             "(blockensemble client joint training)")
    parser.add_argument("--no_mi_attack", action="store_true")
    parser.add_argument("--shared_blocks", type=str, nargs="*", default=None)
    return parser


def main(argv=None):
    """Parse ``argv``, train the ensemble, run the MI report; returns
    (history, final metrics)."""
    args = add_privacy_args(add_args(argparse.ArgumentParser())).parse_args(argv)
    cfg = start_run(args)
    # AdaptiveCNN branches take images: mnist and fmnist stay unflattened
    ds = load_dataset(args.dataset, data_dir=args.data_dir,
                      client_num_in_total=args.client_num_in_total,
                      partition_method=args.partition_method,
                      partition_alpha=args.partition_alpha, seed=args.seed,
                      flatten=False)
    logger = MetricsLogger(run_dir=args.run_dir, config=vars(args))

    trainer_for_mi = vars_for_mi = None
    if args.ensemble_method == "blockensemble":
        api = BlockEnsembleAPI(ds, cfg, branch_num=args.branch_num,
                               num_paths=args.num_paths, feat_lmda=args.feat_lmda,
                               device=args.device)
        api.train(metrics_logger=logger)
    else:
        archs = (build_hetero_archs(args.branch_num) if args.ensemble_method == "hetero"
                 else [ArchSpec()] * args.branch_num)
        shape = ds.train.x.shape[2:]
        trainers = [ClassificationTrainer(AdaptiveCNN(
            output_dim=ds.class_num, arch=a, dtype=cfg.dtype, input_hw=int(shape[0]),
            in_channels=int(shape[-1]))) for a in archs]
        shared = (tuple(args.shared_blocks) if args.shared_blocks
                  else (("conv1_out", "conv2_out")
                        if args.ensemble_method == "blockavg" else ()))
        api = BranchFedAvgAPI(ds, cfg, trainers, ensemble_method=args.ensemble_method,
                              shared_blocks=shared,
                              server_data_ratio=args.server_data_ratio,
                              device=args.device)
        for rec in api.train():
            logger.log({k: v for k, v in rec.items() if k != "round"}, step=rec["round"])
        trainer_for_mi, vars_for_mi = trainers[0], api.branches[0]

    def predict_fn(x):
        return torch.log(api.branch_probs(x).mean(0) + 1e-9)

    final = api.evaluate()
    logger.log(final, step=cfg.comm_round)
    if not args.no_mi_attack:
        # members: training rows the federation saw; non-members: held-out
        # test rows (the reference's MI split)
        xtr, ytr = ds.train_global
        xte, yte = ds.test_global
        k = min(len(ytr), len(yte), MI_ROWS)
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a[:k])).to(api.device)
        mi = run_mi_attacks(predict_fn, trainer_for_mi, vars_for_mi,
                            (to(xtr), to(ytr)), (to(xte), to(yte)))
        logger.log(mi, step=cfg.comm_round)
        final.update(mi)
    logger.finish()
    log.info("final: %s", final)
    return api.history, final


if __name__ == "__main__":
    main()
