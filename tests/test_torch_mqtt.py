"""The port's mobile transport (``comm/``) after ``tests/test_mqtt.py``: the
MQTT 3.1.1 codec and the in-process broker, the reference topic scheme
carrying the port's variables as JSON lists, FedAvg over real MQTT frames
(a broker kill and restart among them), a resent sync retraining to the
same bits, and the wire format against the JAX package's through
``utils/convert.py`` both ways. Every wait has its own timeout."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.comm.message import Message as JaxMessage
from fedml_tpu.comm.message import _named_leaves
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.models.resnet import Bottleneck as JaxBottleneck
from fedml_tpu.models.resnet import ResNetCifar as JaxResNetCifar
from fedml_tpu_torch.algorithms.engine import build_local_update, draw_client_randomness
from fedml_tpu_torch.algorithms.fedavg import round_generator
from fedml_tpu_torch.comm import (Message, MiniBroker, MqttClient, MqttCommManager,
                                  MqttFedAvgClientManager, MqttFedAvgServerManager,
                                  MyMessage, run_mqtt_fedavg)
from fedml_tpu_torch.comm.mqtt_fedavg import _client_sampling
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ClassificationTrainer
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.models.resnet import Bottleneck, ResNetCifar
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax

WAIT = 10.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mnist():
    return load_dataset("mnist", client_num_in_total=2, partition_method="homo", seed=0,
                        flatten=True)


def _cfg(**kw):
    base = dict(dataset="mnist", model="lr", client_num_in_total=2, client_num_per_round=2,
                comm_round=3, batch_size=32, lr=0.1)
    return FedConfig(**{**base, **kw})


def _lr_trainer(ds):
    return ClassificationTrainer(create_model("lr", output_dim=ds.class_num))


@pytest.fixture
def broker():
    b = MiniBroker()
    yield b
    b.close()


# ------------------------------------------------------------- the transport

def test_mqtt_pubsub_roundtrip(broker):
    got, done = [], threading.Event()
    sub = MqttClient(broker.host, broker.port, "sub")
    sub.subscribe("t/1", lambda t, p: (got.append((t, p)), done.set()), timeout=WAIT)
    pub = MqttClient(broker.host, broker.port, "pub")
    pub.publish("t/1", b"hello mqtt")
    assert done.wait(WAIT)
    assert got == [("t/1", b"hello mqtt")]
    sub.disconnect()
    pub.disconnect()


def test_mqtt_multiple_subscribers_fanout(broker):
    hits, evs, subs = [], [threading.Event() for _ in range(2)], []
    for i in range(2):
        c = MqttClient(broker.host, broker.port, f"s{i}")
        c.subscribe("fan", lambda t, p, i=i: (hits.append(i), evs[i].set()), timeout=WAIT)
        subs.append(c)
    pub = MqttClient(broker.host, broker.port, "p")
    pub.publish("fan", b"x")
    assert all(e.wait(WAIT) for e in evs)
    assert sorted(hits) == [0, 1]
    for c in subs + [pub]:
        c.disconnect()


def test_mqtt_survives_client_killed_mid_exchange(broker):
    """A subscriber whose socket dies without a DISCONNECT takes down
    neither the broker nor the other subscribers."""
    got, ev = [], threading.Event()
    survivor = MqttClient(broker.host, broker.port, "alive")
    survivor.subscribe("st", lambda t, p: (got.append(p), ev.set()), timeout=WAIT)
    victim = MqttClient(broker.host, broker.port, "dead")
    victim.subscribe("st", lambda t, p: None, timeout=WAIT)
    victim._stop.set()
    victim._sock.close()
    pub = MqttClient(broker.host, broker.port, "p")
    for i in range(3):
        pub.publish("st", b"payload-%d" % i)
    assert ev.wait(WAIT), "the survivor never received a publish"
    ev2 = threading.Event()
    survivor.subscribe("st2", lambda t, p: ev2.set(), timeout=WAIT)
    pub.publish("st2", b"again")
    assert ev2.wait(WAIT)
    for c in (survivor, pub):
        c.disconnect()


def test_mqtt_client_reconnects_and_resubscribes(broker):
    """A client whose connection drops reconnects under the retry policy,
    resubscribes and keeps receiving; the reconnect is a schema-checked
    ``mqtt_reconnect`` event of the installed tracer."""
    from fedml_tpu_torch import telemetry
    from fedml_tpu_torch.telemetry.tracer import Tracer

    tracer = Tracer()
    telemetry.install(tracer)
    try:
        got, ev1, ev2 = [], threading.Event(), threading.Event()
        sub = MqttClient(broker.host, broker.port, "r", reconnect_backoff=0.05)
        sub.subscribe("rt", lambda t, p: (got.append(p),
                                          (ev1 if len(got) == 1 else ev2).set()),
                      timeout=WAIT)
        pub = MqttClient(broker.host, broker.port, "p")
        pub.publish("rt", b"before")
        assert ev1.wait(WAIT)
        sub._sock.shutdown(2)
        deadline = time.time() + WAIT
        while time.time() < deadline:
            pub.publish("rt", b"after")
            if ev2.wait(0.25):
                break
        assert ev2.wait(1), "the client never recovered after the drop"
        assert got[-1] == b"after"
        for c in (sub, pub):
            c.disconnect()
    finally:
        telemetry.uninstall(tracer)
    events = tracer.find_events("mqtt_reconnect")
    assert events and events[0]["ok"] is True and events[0]["client_id"] == "r"


# ------------------------------------------------------------- the wire format

def test_comm_manager_exchanges_variables_bit_for_bit(broker):
    """The server sends a variables dict to a client over the reference
    topic scheme and the client replies: every leaf decodes to its bits,
    dtypes and all."""
    server = MqttCommManager(broker.host, broker.port, client_id=0, client_num=2)
    client1 = MqttCommManager(broker.host, broker.port, client_id=1)
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(2, 3, generator=g), "b": torch.rand(3, generator=g),
            "n": torch.arange(4), "h": torch.randn(5, generator=g).to(torch.bfloat16)}
    received, c_done, s_done = {}, threading.Event(), threading.Event()

    def on_client(msg_type, msg):
        received["client"] = Message.decode_model_params(msg.get("model"), tree)
        c_done.set()

    def on_server(msg_type, msg):
        received["server_sender"] = msg.get_sender_id()
        s_done.set()

    client1.add_observer(on_client)
    server.add_observer(on_server)
    m = Message(msg_type=2, sender_id=0, receiver_id=1)
    m.add_model_params("model", tree)
    server.send_message(m)
    assert c_done.wait(WAIT)
    for k, v in tree.items():
        got = received["client"][k]
        assert got.dtype == v.dtype and torch.equal(got, v), k
    reply = Message(msg_type=3, sender_id=1, receiver_id=0)
    reply.add("train_acc", 0.9)
    client1.send_message(reply)
    assert s_done.wait(WAIT)
    assert received["server_sender"] == 1
    server.stop()
    client1.stop()


def _unflatten(flat: dict) -> dict:
    """A JAX wire payload (dotted flax paths) -> the nested numpy tree."""
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value, np.float32)
    return tree


def _tiny_resnets():
    kw = dict(layers=(1, 1, 1), widths=(4, 8, 16), output_dim=10)
    jm, tm = JaxResNetCifar(block=JaxBottleneck, **kw), ResNetCifar(Bottleneck, **kw)
    x = np.random.RandomState(0).rand(2, 8, 8, 3).astype(np.float32)
    # jitted: XLA compiles a ResNet faster than it runs one op by op
    jgv = jax.device_get(jax.jit(lambda k, x: JaxTrainer(jm).init(k, x))(
        jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    return jm, tm, jgv, x


def test_jax_payload_decodes_to_the_ports_model():
    """A JAX peer's message (flax names and layout, params and batch_stats)
    crosses through ``utils/convert.py`` into the port's variables: the
    port's own message of them decodes bit for bit to the converted JAX
    init, and the port's model gives the JAX model's logits."""
    jm, tm, jgv, x = _tiny_resnets()
    jmsg = JaxMessage(2, 0, 1)
    jmsg.add_model_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, jgv)
    wire = JaxMessage.from_json(jmsg.to_json()).get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
    variables = flax_to_torch(_unflatten(wire), module=tm)
    want = flax_to_torch(jgv, module=tm)
    mine = Message(2, 0, 1)
    mine.add_model_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, variables)
    payload = Message.from_json(mine.to_json()).get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
    example = ClassificationTrainer(tm).init(torch.Generator().manual_seed(1), "cpu")
    assert set(payload) == set(example)  # the port's state_dict names
    got = Message.decode_model_params(payload, example)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    logits, _ = ClassificationTrainer(tm).apply(got, torch.tensor(x), None, False)
    jlogits = jax.jit(lambda v, x: JaxTrainer(jm).apply(v, x, None, False)[0])(
        jgv, jnp.asarray(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-5, atol=1e-5)


def test_port_payload_decodes_to_the_jax_model():
    """The reverse: the port's message of its variables, converted to
    flax's tree, is a payload the JAX package's decoder reads bit for bit
    into the JAX model's variables."""
    jm, tm, jgv, x = _tiny_resnets()
    variables = ClassificationTrainer(tm).init(torch.Generator().manual_seed(3), "cpu")
    mine = Message(3, 1, 0)
    mine.add_model_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, variables)
    payload = Message.from_json(mine.to_json()).get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
    tree = torch_to_flax(Message.decode_model_params(payload, variables), module=tm)
    jwire = {name: np.asarray(leaf).tolist() for name, leaf in _named_leaves(tree)}
    got = JaxMessage.decode_model_params(jwire, jgv)
    want = torch_to_flax(variables, module=tm)
    for (name, g), (_, w) in zip(_named_leaves(got), _named_leaves(want)):
        assert np.asarray(g).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def test_server_aggregate_is_the_jax_packages_bits():
    """The server's sample-weighted mean (float64, cast back) is the JAX
    server's numpy arithmetic bit for bit."""
    rng = np.random.RandomState(0)
    models = [{"w": rng.randn(7, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
              for _ in range(3)]
    nums = np.array([10.0, 3.0, 7.0])
    w = nums / nums.sum()
    want = {k: sum(wi * m[k] for wi, m in zip(w, models)).astype(np.float32)
            for k in models[0]}
    got = MqttFedAvgServerManager._aggregate(
        None, [{k: torch.from_numpy(v) for k, v in m.items()} for m in models], nums)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_client_sampling_is_the_references():
    from fedml_tpu.comm.mqtt_fedavg import _client_sampling as jax_sampling

    for r in range(5):
        assert _client_sampling(r, 10, 3) == jax_sampling(r, 10, 3)
    assert _client_sampling(0, 4, 4) == [0, 1, 2, 3]


# ------------------------------------------------------------ FedAvg over MQTT

def test_fedavg_over_mqtt_end_to_end(mnist):
    """FedAvg, 2 workers x 3 rounds, over real MQTT frames through the
    in-process broker: the test loss falls and the accuracy passes 0.3."""
    final, history = run_mqtt_fedavg(mnist, _lr_trainer(mnist), _cfg(), timeout=120.0,
                                     device="cpu")
    assert [r["round"] for r in history] == [0, 1, 2]
    assert history[-1]["test_loss"] < history[0]["test_loss"]
    assert history[-1]["test_acc"] > 0.3
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in final.values())


def test_resent_sync_retrains_to_the_same_bits(mnist, broker):
    """A resent sync for the same round gives the same reply on the wire
    (the rng derives from the stamped round), counts the round once, and
    the reply is the engine's local update under the worker's draws."""
    cfg = _cfg(client_num_per_round=1, comm_round=5)
    trainer = _lr_trainer(mnist)
    gv = trainer.init(torch.Generator().manual_seed(cfg.seed), "cpu")
    client = MqttFedAvgClientManager(broker.host, broker.port, 1, mnist, trainer, cfg, gv,
                                     device="cpu")
    sent = []
    client.comm.send_message = sent.append
    sync = Message(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, 1)
    sync.add_model_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, gv)
    sync.add(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, "0")
    sync.add(MyMessage.MSG_ARG_KEY_ROUND_IDX, "2")
    client._train_and_reply(sync)
    client._train_and_reply(sync)  # the resend
    assert len(sent) == 2 and sent[0].to_json() == sent[1].to_json()
    assert sent[0].get(MyMessage.MSG_ARG_KEY_ROUND_IDX) == "2"
    assert sent[0].get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES) == int(mnist.train.counts[0])
    assert client.rounds_trained == 3  # ridx + 1, not one a message
    count = int(mnist.train.counts[0])
    perms, seeds = draw_client_randomness(round_generator(cfg.seed, 2, 1), [count],
                                          mnist.train.n_max, cfg.epochs, cfg.shuffle)
    want = build_local_update(trainer, cfg)(
        gv, torch.from_numpy(mnist.train.x[0]), torch.from_numpy(mnist.train.y[0]), count,
        torch.Generator().manual_seed(int(seeds[0])), perms[0])
    got = Message.decode_model_params(sent[0].get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS), gv)
    for k, v in want.variables.items():
        assert torch.equal(got[k], v), k
    client.stop()


def test_cudnn_determinism_is_held_while_any_worker_trains():
    """A worker's local update runs on cuDNN's deterministic algorithms; the
    worker threads share the flag, so it stays set until the last of them
    ends and then the process's own setting comes back."""
    from fedml_tpu_torch.comm.mqtt_fedavg import _deterministic_cudnn

    before = torch.backends.cudnn.deterministic
    inside, release, seen = threading.Event(), threading.Event(), []

    def worker():
        with _deterministic_cudnn():
            inside.set()
            release.wait(10)
            seen.append(torch.backends.cudnn.deterministic)

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert inside.wait(10)
        with _deterministic_cudnn():
            assert torch.backends.cudnn.deterministic
        assert torch.backends.cudnn.deterministic  # the other worker still trains
    finally:
        release.set()
        t.join(10)
    assert seen == [True]
    assert torch.backends.cudnn.deterministic == before


def test_fedavg_survives_broker_kill_and_restart_mid_exchange(mnist):
    """Kill the broker after round 0 and restart it on the same port: the
    clients reconnect and resubscribe, the server's round-stamped resends
    recover the lost frames, and every round completes."""
    cfg = _cfg()
    trainer = _lr_trainer(mnist)
    gv = trainer.init(torch.Generator().manual_seed(cfg.seed), "cpu")
    broker = MiniBroker()
    host, port = broker.host, broker.port
    server, clients = None, []
    try:
        server = MqttFedAvgServerManager(host, port, 2, gv, cfg, trainer=trainer,
                                         test_global=mnist.test_global,
                                         resend_interval=0.5, device="cpu")
        clients = [MqttFedAvgClientManager(host, port, k, mnist, trainer, cfg, gv,
                                           device="cpu") for k in (1, 2)]
        server.send_init_msg()
        deadline = time.time() + 60
        while not server.history and time.time() < deadline:
            time.sleep(0.05)
        assert server.history, "round 0 never finished"
        # kill: close the listener and shut every established connection
        # (shutdown, not close: a serve thread blocked in recv would keep
        # the port), then rebind the same port
        old = broker
        old.close()
        for s in list(old._outboxes):
            try:
                s.shutdown(2)
            except OSError:
                pass
        for _ in range(200):
            try:
                broker = MiniBroker(host, port)
                break
            except OSError:
                time.sleep(0.05)
        else:
            pytest.fail("could not rebind the broker's port")
        assert server.done.wait(60), f"the run wedged after the restart: {server.history}"
        assert [r["round"] for r in server.history] == [0, 1, 2]
        assert all(np.isfinite(r["test_loss"]) for r in server.history)
        assert server.history[-1]["test_acc"] > 0.3
    finally:
        for c in clients:
            c.stop()
        if server is not None:
            server.stop()
        broker.close()


def test_main_mqtt_fedavg_cli(tmp_path):
    """The CLI: the JAX main's flags on the port's ``add_args`` plus
    ``--device``; the history carries each round's test metrics."""
    import json

    from fedml_tpu_torch.experiments import main_mqtt_fedavg

    history = main_mqtt_fedavg.main([
        "--dataset", "mnist", "--model", "lr", "--client_num_in_total", "2",
        "--client_num_per_round", "2", "--comm_round", "2", "--batch_size", "64",
        "--partition_method", "homo", "--device", "cpu", "--run_dir", str(tmp_path),
        "--data_dir", str(tmp_path / "data")])
    assert [r["round"] for r in history] == [0, 1]
    assert all(np.isfinite(r["test_loss"]) for r in history)
    summary = json.loads((tmp_path / "wandb-summary.json").read_text())
    assert "Test/Acc" in summary
