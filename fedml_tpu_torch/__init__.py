"""fedml_tpu_torch — the PyTorch/CUDA port of fedml_tpu.

The JAX package ``fedml_tpu`` stays as the reference; this package imports
neither it nor JAX. Ported so far: the FedAvg FEMNIST flagship — surrogate
data, CNN_DropOut, the eager round engine, FedAvg aggregation, the drive
loop and the fused local-SGD epoch as a hand-written CUDA kernel
(ops/fused_sgd.py, csrc/fused_sgd.cu) — and StackOverflow next-word
prediction with the transformer LM and NWPTrainer, its attention the
flash-attention forward and backward as hand-written CUDA kernels
(ops/attention.py, csrc/flash_attention.cu) — and FedML's algorithm zoo
on both: FedOpt, FedNova and robust aggregation, FedProx, the momentum,
weight-decay and AMSGrad clients, and their CLIs — and FedML's benchmark
rows beyond FEMNIST: the MNIST, CIFAR, fed_CIFAR-100, synthetic and
Shakespeare data, the linear models, CNNs, ResNets (BatchNorm running
statistics carried as model state) and LSTMs — and the JAX CLI's drive:
the pipelined round loop, the tracer and metrics logger, checkpoints and
resume, the chaos harness and the round guard — and the out-of-core mmap
shard store (data/packed_store.py) with the O(cohort) Feistel sampler, so
the flagship runs at its configured 3400 clients — and FedML's
hierarchical, centralized, base-framework, decentralized gossip and
TurboAggregate secure-aggregation algorithms — and its split-learning
family: FedGKT with the GKT split ResNets, SplitNN's relay, and vertical
FL with the NUS-WIDE and lending club readers — and FedNAS (federated
DARTS) and FedSeg (DeepLabV3+ and the FCN on Pascal VOC). Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from fedml_tpu_torch.algorithms.base_framework import FedML_Base_simulated
from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
from fedml_tpu_torch.algorithms.decentralized import DecentralizedFLAPI
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, client_sampling
from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
from fedml_tpu_torch.algorithms.fednas import FedNASAPI
from fedml_tpu_torch.algorithms.fedseg import FedSegAPI
from fedml_tpu_torch.algorithms.hierarchical import HierarchicalFLAPI
from fedml_tpu_torch.algorithms.splitnn import SplitNNAPI
from fedml_tpu_torch.algorithms.turboaggregate import SecureAggregator, TurboAggregateAPI
from fedml_tpu_torch.algorithms.vfl import NeuralVFLAPI, VerticalFederatedLearningAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ClassificationTrainer, NWPTrainer
from fedml_tpu_torch.data.registry import FederatedDataset, load_dataset
from fedml_tpu_torch.models.registry import create_model

__all__ = ["FedAvgAPI", "FedConfig", "ClassificationTrainer", "NWPTrainer",
           "FederatedDataset", "client_sampling", "create_model",
           "load_dataset", "CentralizedTrainer", "DecentralizedFLAPI",
           "FedML_Base_simulated", "HierarchicalFLAPI", "SecureAggregator",
           "TurboAggregateAPI", "FedGKTAPI", "SplitNNAPI", "VerticalFederatedLearningAPI",
           "NeuralVFLAPI", "FedNASAPI", "FedSegAPI"]
