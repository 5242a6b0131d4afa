"""Model registry (mirror of ``fedml_tpu/models/registry.py::create_model``
and the factories of ``fedml_tpu/models/zoo.py``, with their defaults).

Ported: ``lr``, ``mlp``, ``purchasemlp``, ``texasmlp``, ``cnn`` (CNN_DropOut),
``cnn_fedavg``, ``cnn_cifar``, ``har_cnn``, the ResNets (``resnet20/32/44/
56/56_s2d/110``, ``resnet18/34/50``, ``resnet18_gn``), ``vgg11``, ``vgg16``,
``mobilenet``, ``mobilenet_v3``, ``efficientnet``, ``rnn``,
``rnn_stackoverflow``, ``transformer_nwp``, and FedSeg's ``deeplab``
(DeepLabV3+, width 32) and ``fcn`` (SimpleFCN, width 16).

``input_shape`` is one sample's shape (flax infers it at init; a PyTorch
layer needs it when it is built). Where it is not given, each factory
assumes its reference dataset's: MNIST 784 for ``lr``/``mlp``, 28x28 for
the FEMNIST CNNs, 32x32x3 for ``cnn_cifar``, VGG and the convolutional
nets, 128 steps of 9 channels for ``har_cnn``, 600 and 6169 for the
Purchase and Texas MLPs.
"""

from __future__ import annotations

import math

from fedml_tpu_torch.models import resnet
from fedml_tpu_torch.models.cnn import CNN_DropOut, CNN_OriginalFedAvg, CNNCifar, HAR_CNN
from fedml_tpu_torch.models.efficientnet import EfficientNet
from fedml_tpu_torch.models.linear import DenseMLP, LogisticRegression, ReferenceMLP
from fedml_tpu_torch.models.mobilenet import MobileNet
from fedml_tpu_torch.models.mobilenet_v3 import MobileNetV3
from fedml_tpu_torch.models.rnn import RNN_OriginalFedAvg, RNN_StackOverFlow
from fedml_tpu_torch.models.segmentation import DeepLabV3Plus, SimpleFCN
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.models.vgg import VGG

_RESNETS = ("resnet20", "resnet32", "resnet44", "resnet56", "resnet56_s2d",
            "resnet110", "resnet18", "resnet34", "resnet50")


def _width(input_shape, default: int) -> int:
    return default if input_shape is None else int(math.prod(input_shape))


def _side(input_shape, default: int) -> int:
    return default if input_shape is None else int(input_shape[0])


def create_model(model_name: str, output_dim: int, dtype="float32", input_shape=None,
                 **kwargs):
    """Build a module by reference model name. ``dtype`` is the compute
    dtype ("float32" or "bfloat16"); parameters stay float32."""
    shape = None if input_shape is None else tuple(input_shape)
    if model_name == "lr":
        return LogisticRegression(_width(shape, 784), output_dim,
                                  flatten=kwargs.get("flatten", True), dtype=dtype)
    if model_name == "mlp":
        return DenseMLP(_width(shape, 784), output_dim,
                        hidden=tuple(kwargs.get("hidden", (1024, 512, 256, 128))), dtype=dtype)
    if model_name == "purchasemlp":
        return ReferenceMLP(_width(shape, 600), output_dim, hidden=(256,), dtype=dtype)
    if model_name == "texasmlp":
        return ReferenceMLP(_width(shape, 6169), output_dim, hidden=(1024, 512), dtype=dtype)
    if model_name == "cnn":
        if shape is not None:
            kwargs.setdefault("input_hw", _side(shape, 28))
        return CNN_DropOut(output_dim=output_dim, dtype=dtype, **kwargs)
    if model_name == "cnn_fedavg":
        return CNN_OriginalFedAvg(output_dim, dtype, input_hw=_side(shape, 28))
    if model_name == "cnn_cifar":
        return CNNCifar(output_dim, dtype, input_hw=_side(shape, 32))
    if model_name == "har_cnn":
        seq, channels = (128, 9) if shape is None else shape
        return HAR_CNN(output_dim, dtype, seq_len=seq, channels=channels)
    # the convolutional nets take their input channels from the sample
    # (chmnist's images are grey, CIFAR's RGB)
    channels = 3 if shape is None else int(shape[-1])
    if model_name in _RESNETS:
        return getattr(resnet, model_name)(output_dim=output_dim,
                                           group_norm=kwargs.get("group_norm", 0), dtype=dtype,
                                           in_channels=channels)
    if model_name == "resnet18_gn":
        # the fed_cifar100 model: GroupNorm of 2 channels per group
        return resnet.resnet18(output_dim=output_dim, group_norm=kwargs.get("group_norm", 2),
                               dtype=dtype, in_channels=channels)
    if model_name in ("vgg11", "vgg16"):
        return VGG(model_name, output_dim, dtype, input_hw=_side(shape, 32),
                   in_channels=channels)
    if model_name == "mobilenet":
        return MobileNet(output_dim, alpha=kwargs.get("alpha", 1.0), dtype=dtype,
                         in_channels=channels)
    if model_name == "mobilenet_v3":
        # the reference's main_fedavg.py "mobilenet_v3" -> MobileNetV3(model_mode=...)
        return MobileNetV3(output_dim, mode=kwargs.get("mode", "LARGE"),
                           multiplier=kwargs.get("multiplier", 1.0),
                           dropout_rate=kwargs.get("dropout_rate", 0.0), dtype=dtype,
                           in_channels=channels)
    if model_name == "efficientnet":
        return EfficientNet.from_name(kwargs.get("variant", "efficientnet-b0"), output_dim,
                                      dtype=dtype, in_channels=channels)
    if model_name == "deeplab":
        # the FedSeg encoder-decoder (models/zoo.py::_deeplab's width 32)
        return DeepLabV3Plus(output_dim, width=kwargs.get("width", 32), dtype=dtype,
                             in_channels=channels)
    if model_name == "fcn":
        return SimpleFCN(output_dim, width=kwargs.get("width", 16), dtype=dtype,
                         in_channels=channels)
    if model_name == "rnn":
        # the shakespeare next-char model
        return RNN_OriginalFedAvg(vocab_size=kwargs.get("vocab_size", output_dim),
                                  per_position=kwargs.get("per_position", False), dtype=dtype)
    if model_name == "rnn_stackoverflow":
        return RNN_StackOverFlow(vocab_size=kwargs.get("vocab_size", 10000), dtype=dtype)
    if model_name == "transformer_nwp":
        # models/zoo.py::_transformer_nwp's defaults
        return TransformerLM(vocab_size=kwargs.get("vocab_size", output_dim),
                             d_model=kwargs.get("d_model", 128),
                             heads=kwargs.get("heads", 4),
                             num_layers=kwargs.get("num_layers", 2),
                             max_len=kwargs.get("max_len", 512), dtype=dtype)
    raise NotImplementedError(
        f"model {model_name!r} is not ported to fedml_tpu_torch yet "
        f"(see ROADMAP.md Queue 1)")
