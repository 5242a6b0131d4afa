"""Model registry (mirror of ``fedml_tpu/models/registry.py``'s
``register_model``, ``create_model`` and ``available_models``, and the
factories of ``fedml_tpu/models/zoo.py``, with their defaults).

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
from typing import Callable

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


_MODELS: dict[str, Callable] = {}


def register_model(name: str):
    """Register ``fn(output_dim, dtype, shape, **kwargs) -> module`` under
    ``name`` (``shape`` is one sample's shape as a tuple, or None)."""
    def deco(fn):
        _MODELS[name] = fn
        return fn

    return deco


def create_model(model_name: str, output_dim: int, dtype="float32", input_shape=None,
                 **kwargs):
    """Build a module by reference model name. ``dtype`` is the compute
    dtype ("float32" or "bfloat16"); parameters stay float32."""
    if model_name not in _MODELS:
        raise NotImplementedError(
            f"model {model_name!r} is not ported to fedml_tpu_torch yet "
            f"(see ROADMAP.md Queue 1)")
    shape = None if input_shape is None else tuple(input_shape)
    return _MODELS[model_name](output_dim, dtype, shape, **kwargs)


def available_models() -> list[str]:
    return sorted(_MODELS)


@register_model("lr")
def _lr(output_dim, dtype, shape, **kwargs):
    return LogisticRegression(_width(shape, 784), output_dim,
                              flatten=kwargs.get("flatten", True), dtype=dtype)


@register_model("mlp")
def _mlp(output_dim, dtype, shape, **kwargs):
    return DenseMLP(_width(shape, 784), output_dim,
                    hidden=tuple(kwargs.get("hidden", (1024, 512, 256, 128))), dtype=dtype)


@register_model("purchasemlp")
def _purchasemlp(output_dim, dtype, shape, **kwargs):
    return ReferenceMLP(_width(shape, 600), output_dim, hidden=(256,), dtype=dtype)


@register_model("texasmlp")
def _texasmlp(output_dim, dtype, shape, **kwargs):
    return ReferenceMLP(_width(shape, 6169), output_dim, hidden=(1024, 512), dtype=dtype)


@register_model("cnn")
def _cnn(output_dim, dtype, shape, **kwargs):
    if shape is not None:
        kwargs.setdefault("input_hw", _side(shape, 28))
    return CNN_DropOut(output_dim=output_dim, dtype=dtype, **kwargs)


@register_model("cnn_fedavg")
def _cnn_fedavg(output_dim, dtype, shape, **kwargs):
    return CNN_OriginalFedAvg(output_dim, dtype, input_hw=_side(shape, 28))


@register_model("cnn_cifar")
def _cnn_cifar(output_dim, dtype, shape, **kwargs):
    return CNNCifar(output_dim, dtype, input_hw=_side(shape, 32))


@register_model("har_cnn")
def _har_cnn(output_dim, dtype, shape, **kwargs):
    seq, channels = (128, 9) if shape is None else shape
    return HAR_CNN(output_dim, dtype, seq_len=seq, channels=channels)


def _channels(shape) -> int:
    """The convolutional nets' input channels, from the sample (chmnist's
    images are grey, CIFAR's RGB)."""
    return 3 if shape is None else int(shape[-1])


def _resnet_factory(name: str):
    def make(output_dim, dtype, shape, **kwargs):
        return getattr(resnet, name)(output_dim=output_dim,
                                     group_norm=kwargs.get("group_norm", 0), dtype=dtype,
                                     in_channels=_channels(shape))

    return make


for _name in _RESNETS:
    register_model(_name)(_resnet_factory(_name))


@register_model("resnet18_gn")
def _resnet18_gn(output_dim, dtype, shape, **kwargs):
    # the fed_cifar100 model: GroupNorm of 2 channels per group
    return resnet.resnet18(output_dim=output_dim, group_norm=kwargs.get("group_norm", 2),
                           dtype=dtype, in_channels=_channels(shape))


def _vgg_factory(name: str):
    def make(output_dim, dtype, shape, **kwargs):
        return VGG(name, output_dim, dtype, input_hw=_side(shape, 32),
                   in_channels=_channels(shape))

    return make


for _name in ("vgg11", "vgg16"):
    register_model(_name)(_vgg_factory(_name))


@register_model("mobilenet")
def _mobilenet(output_dim, dtype, shape, **kwargs):
    return MobileNet(output_dim, alpha=kwargs.get("alpha", 1.0), dtype=dtype,
                     in_channels=_channels(shape))


@register_model("mobilenet_v3")
def _mobilenet_v3(output_dim, dtype, shape, **kwargs):
    # the reference's main_fedavg.py "mobilenet_v3" -> MobileNetV3(model_mode=...)
    return MobileNetV3(output_dim, mode=kwargs.get("mode", "LARGE"),
                       multiplier=kwargs.get("multiplier", 1.0),
                       dropout_rate=kwargs.get("dropout_rate", 0.0), dtype=dtype,
                       in_channels=_channels(shape))


@register_model("efficientnet")
def _efficientnet(output_dim, dtype, shape, **kwargs):
    return EfficientNet.from_name(kwargs.get("variant", "efficientnet-b0"), output_dim,
                                  dtype=dtype, in_channels=_channels(shape))


@register_model("deeplab")
def _deeplab(output_dim, dtype, shape, **kwargs):
    # the FedSeg encoder-decoder (models/zoo.py::_deeplab's width 32)
    return DeepLabV3Plus(output_dim, width=kwargs.get("width", 32), dtype=dtype,
                         in_channels=_channels(shape))


@register_model("fcn")
def _fcn(output_dim, dtype, shape, **kwargs):
    return SimpleFCN(output_dim, width=kwargs.get("width", 16), dtype=dtype,
                     in_channels=_channels(shape))


@register_model("rnn")
def _rnn(output_dim, dtype, shape, **kwargs):
    # the shakespeare next-char model
    return RNN_OriginalFedAvg(vocab_size=kwargs.get("vocab_size", output_dim),
                              per_position=kwargs.get("per_position", False), dtype=dtype)


@register_model("rnn_stackoverflow")
def _rnn_stackoverflow(output_dim, dtype, shape, **kwargs):
    return RNN_StackOverFlow(vocab_size=kwargs.get("vocab_size", 10000), dtype=dtype)


@register_model("transformer_nwp")
def _transformer_nwp(output_dim, dtype, shape, **kwargs):
    # models/zoo.py::_transformer_nwp's defaults
    return TransformerLM(vocab_size=kwargs.get("vocab_size", output_dim),
                         d_model=kwargs.get("d_model", 128),
                         heads=kwargs.get("heads", 4),
                         num_layers=kwargs.get("num_layers", 2),
                         max_len=kwargs.get("max_len", 512), dtype=dtype)
