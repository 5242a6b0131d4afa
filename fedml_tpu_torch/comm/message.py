"""Typed message envelope for the mobile transport, PyTorch form of
``fedml_tpu/comm/message.py``.

The wire contract is the reference's (fedml_core/distributed/communication/
message.py:5-74): a msg_type + sender + receiver header with arbitrary
JSON-serializable params. Model parameters travel as a flat {name: nested
lists} dict, the reference's ``transform_tensor_to_list`` (fedavg/utils.py:
11-14) on a state_dict: here the port's own variables, whose keys ARE
state_dict names in PyTorch's layout (``conv2d_1.weight`` [O, I, kh, kw]).
A JAX peer names and lays out the same model flax's way
(``params.conv2d_1.kernel`` [kh, kw, I, O]); ``utils/convert.py`` maps one
onto the other.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

MSG_ARG_KEY_TYPE = "msg_type"
MSG_ARG_KEY_SENDER = "sender"
MSG_ARG_KEY_RECEIVER = "receiver"


def _to_list(leaf) -> list:
    """A tensor (any device) or array as nested Python lists."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().tolist()
    return np.asarray(leaf).tolist()


def _wire_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy type that holds a wire value of ``dtype`` exactly (bf16 and
    fp16 values are float32 values)."""
    if dtype.is_floating_point:
        return np.dtype(np.float64 if dtype == torch.float64 else np.float32)
    return np.dtype(np.bool_ if dtype == torch.bool else np.int64)


class Message:
    def __init__(self, msg_type: int | str = 0, sender_id: int = 0,
                 receiver_id: int = 0):
        self.msg_params: dict[str, Any] = {
            MSG_ARG_KEY_TYPE: msg_type,
            MSG_ARG_KEY_SENDER: sender_id,
            MSG_ARG_KEY_RECEIVER: receiver_id,
        }

    # reference surface (message.py:23-58)
    def add_params(self, key: str, value: Any):
        self.msg_params[key] = value

    def get_params(self) -> dict[str, Any]:
        return self.msg_params

    def add(self, key: str, value: Any):
        self.msg_params[key] = value

    def get(self, key: str) -> Any:
        return self.msg_params[key]

    def get_type(self):
        return self.msg_params[MSG_ARG_KEY_TYPE]

    def get_sender_id(self):
        return self.msg_params[MSG_ARG_KEY_SENDER]

    def get_receiver_id(self):
        return self.msg_params[MSG_ARG_KEY_RECEIVER]

    def add_model_params(self, key: str, variables: dict):
        """A flat variables dict (tensors on any device, or arrays) -> the
        mobile wire format, {name: nested lists}: the reference's
        ``transform_tensor_to_list``. A CUDA tensor is copied to the host
        first."""
        self.msg_params[key] = {name: _to_list(leaf) for name, leaf in variables.items()}

    @staticmethod
    def decode_model_params(payload: dict, example: dict) -> dict:
        """The wire format -> a variables dict with ``example``'s names,
        dtypes and devices (the reference's ``transform_list_to_tensor``).
        Every float32 value a peer encoded comes back to the same bits."""
        out = {}
        for name, e in example.items():
            a = np.asarray(payload[name], dtype=_wire_dtype(e.dtype))
            out[name] = torch.from_numpy(a).to(device=e.device, dtype=e.dtype)
        return out

    def to_json(self) -> str:
        return json.dumps(self.msg_params)

    @classmethod
    def from_json(cls, s: str | bytes) -> "Message":
        m = cls()
        m.msg_params = json.loads(s)
        return m
