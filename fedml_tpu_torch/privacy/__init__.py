"""The privacy research package, PyTorch form of ``fedml_tpu/privacy/``:
branch / ensemble FL and membership-inference and adversarial-robustness
evaluation.

Rebuild of the fork's privacy_fedml/: branch-wise FedAvg with server-side
ensembles (pred-avg / pred-vote / pred-weight / block-avg /
hetero-ensemble) and the block ensemble with joint multi-model client
training, MI attacks (shadow NN, loss, top-k, gradient norm, gradient
vector, mix gradient), and FGSM / PGD adversarial evaluation.
"""

from fedml_tpu_torch.privacy.branch_fedavg import BranchFedAvgAPI  # noqa: F401
