"""Mobile/IoT control-plane transport (the reference's MQTT path), PyTorch
form of ``fedml_tpu/comm``."""

from fedml_tpu_torch.comm.message import Message  # noqa: F401
from fedml_tpu_torch.comm.mqtt import MiniBroker, MqttClient, MqttCommManager  # noqa: F401
from fedml_tpu_torch.comm.mqtt_fedavg import (  # noqa: F401
    MqttFedAvgClientManager,
    MqttFedAvgServerManager,
    MyMessage,
    run_mqtt_fedavg,
)
