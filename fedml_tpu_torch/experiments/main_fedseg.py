"""FedSeg experiment main (mirror of ``fedml_tpu/experiments/main_fedseg.py``:
the FedAvg main's flags plus the segmentation extras of reference
fedml_api/distributed/fedseg/utils.py). The history records (train sums
and, on test rounds, ``Test/accuracy``, ``Test/accuracy_class``,
``Test/mIoU``, ``Test/FWIoU``, ``Test/loss``) go to ``--run_dir``;
``--ckpt_dir`` resumes. ``--dtype bfloat16`` runs the model in bf16 (the
JAX main builds it in float32 whatever the flag).

Usage:
  python -m fedml_tpu_torch.experiments.main_fedseg --dataset pascal_voc \
      --model deeplab --client_num_in_total 4 --comm_round 3 --loss_type ce \
      [--image_size 64 --model_width 32] [--device cpu]
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.algorithms.fedseg import FedSegAPI, SegmentationTrainer
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.experiments.main_fedavg import add_args, start_run
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.utils.logging import MetricsLogger


def main(argv=None):
    parser = add_args(argparse.ArgumentParser())
    parser.add_argument("--loss_type", type=str, default="ce", choices=["ce", "focal"])
    parser.add_argument("--image_size", type=int, default=32)
    parser.add_argument("--model_width", type=int, default=16)
    parser.set_defaults(dataset="pascal_voc", model="deeplab", partition_method="homo",
                        client_num_in_total=4, client_num_per_round=4)
    args = parser.parse_args(argv)
    cfg = start_run(args)
    ds = load_dataset(args.dataset, data_dir=args.data_dir,
                      client_num_in_total=args.client_num_in_total,
                      partition_method=args.partition_method,
                      partition_alpha=args.partition_alpha, image_size=args.image_size,
                      seed=args.seed)
    module = create_model(args.model, output_dim=ds.class_num, dtype=cfg.dtype,
                          input_shape=ds.train.x.shape[2:], width=args.model_width)
    trainer = SegmentationTrainer(module, loss_type=args.loss_type)
    logger = MetricsLogger(run_dir=args.run_dir, config=vars(args))
    api = FedSegAPI(ds, cfg, trainer, device=args.device)
    history = api.train(ckpt_dir=args.ckpt_dir, metrics_logger=logger)
    logger.finish()
    return history


if __name__ == "__main__":
    main()
