"""FedAvg riding the MQTT mobile transport, end to end: PyTorch form of
``fedml_tpu/comm/mqtt_fedavg.py``.

The reference's mobile deployment runs the whole algorithm through the
broker: FedAvgServerManager broadcasts init/sync messages,
FedAvgClientManager trains on each sync and publishes its model back, with
tensors list-encoded in JSON when is_mobile (reference
FedAvgServerManager.py:63-127, FedAvgClientManager.py:127-167,
mqtt_comm_manager.py:14-125). Here the actors are message-driven shells
around the port's engine: each worker's local SGD is
``engine.build_local_update`` on the run's device (``cuda`` unless the
caller passes ``device="cpu"``), the server's aggregate the sample-weighted
mean of the decoded variables.

Worker-pool semantics are the reference's: ``worker_num`` actors
impersonate logical clients; each round the server samples logical indices
with np.random.seed(round_idx) + choice (FedAVGAggregator.client_sampling:
89-97) and tells worker i which client to be (MSG_ARG_KEY_CLIENT_INDEX,
string-encoded like the reference).

Fault tolerance, as the JAX package: messages carry the round index, the
server re-sends the round's syncs to the workers it still waits on (after
a broker restart, say), a worker's rng derives from (seed, round, worker)
so a resent sync retrains to the same bits, and a stale reply is dropped.
Unlike the JAX package's fixed 2 s resend period, a worker's resend timer
follows its measured round trip and backs off (``_sync_round``): at a
full-width payload a round outlasts 2 s, and fixed resends piled up
retrainings of stale syncs at the workers.
On the card a worker's local update runs on cuDNN's deterministic
algorithms for that reason (its convolutions would otherwise pick
algorithms that add in a varying order); the process's own setting is
restored when no worker trains (``_deterministic_cudnn``).

With a tracer installed (``telemetry.install``) the actors record spans a
round: ``mqtt_encode`` and ``mqtt_decode`` (variables to and from the wire
format), ``mqtt_train`` (a worker's local update, the device synchronised
at its end); the comm layer adds the JSON half and the publish
(``comm/mqtt.py``).
"""

from __future__ import annotations

import contextlib
import copy
import logging
import math
import threading
import time

import numpy as np
import torch

from fedml_tpu_torch import telemetry
from fedml_tpu_torch.algorithms.engine import (build_eval_fn, build_local_update,
                                               draw_client_randomness, pack_test_batches,
                                               test_metrics)
from fedml_tpu_torch.algorithms.fedavg import round_generator
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.mqtt import MiniBroker, MqttCommManager
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.utils.device import resolve_device, synchronize, to_device

log = logging.getLogger(__name__)


_cudnn_lock = threading.Lock()
_cudnn_trainers = 0  # workers inside a local update
_cudnn_saved = False  # the flag before the first of them set it


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms while any worker trains: the worker
    threads share the process's flag, so the first sets it and the last
    restores it."""
    global _cudnn_trainers, _cudnn_saved
    with _cudnn_lock:
        if _cudnn_trainers == 0:
            _cudnn_saved = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
        _cudnn_trainers += 1
    try:
        yield
    finally:
        with _cudnn_lock:
            _cudnn_trainers -= 1
            if _cudnn_trainers == 0:
                torch.backends.cudnn.deterministic = _cudnn_saved


class MyMessage:
    """Reference message_define.py values, verbatim."""

    MSG_TYPE_S2C_INIT_CONFIG = 1
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 2
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = 3
    MSG_TYPE_C2S_SEND_STATS_TO_SERVER = 4

    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    # fault-tolerance extension (absent from the reference's message_define;
    # messages without it are handled with the legacy counters, so the
    # reference wire-format interop is unchanged): stamping the round makes
    # sync/reply handling idempotent under resends
    MSG_ARG_KEY_ROUND_IDX = "round_idx"


def _tracer():
    return telemetry.get_tracer() or telemetry.NULL_TRACER


def _client_sampling(round_idx: int, total: int, per_round: int) -> list[int]:
    """Reference client_sampling (FedAVGAggregator.py:89-97) exactly."""
    if total == per_round:
        return list(range(total))
    np.random.seed(round_idx)
    return list(np.random.choice(range(total), min(per_round, total), replace=False))


class MqttFedAvgServerManager:
    """Rank-0 actor: receive models -> aggregate -> eval -> resample -> sync
    (FedAvgServerManager.handle_message_receive_model_from_client,
    FedAvgServerManager.py:74-112). The aggregate is FedAVGAggregator.
    aggregate:58-87's sample-weighted mean, taken in float64 on the device
    and cast back to each leaf's dtype, as the JAX package takes it in
    numpy."""

    def __init__(self, host: str, port: int, worker_num: int, global_variables: dict,
                 cfg: FedConfig, trainer=None, test_global=None, topic: str = "fedml",
                 resend_interval: float | None = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.worker_num = worker_num
        self.global_variables = global_variables
        self.round_idx = 0
        self.history: list[dict] = []
        self.done = threading.Event()
        self._lock = threading.Lock()
        self._model_dict: dict[int, dict] = {}
        self._sample_num_dict: dict[int, float] = {}
        # the current round's worker->client assignment, so the resend loop
        # can re-sync stragglers whose sync or reply was lost; per worker
        # the round's first send (its reply's round trip starts there), its
        # last send and how long to wait before the next resend
        self._assignment: dict[int, int] = {}
        self._resend_type: int | None = None
        self._resend_interval = resend_interval
        self._first_sent: dict[int, float] = {}
        self._last_sent: dict[int, float] = {}
        self._wait: dict[int, float] = {}
        self._rtt: dict[int, float] = {}
        if trainer is not None and test_global is not None:
            self._eval = build_eval_fn(trainer)
            self._test = pack_test_batches(test_global, cfg.batch_size, self.device)
        else:
            self._eval = None
        self.comm = MqttCommManager(host, port, topic=topic, client_id=0,
                                    client_num=worker_num)
        self.comm.add_observer(self._dispatch)
        if resend_interval is not None:
            threading.Thread(target=self._resend_loop, daemon=True).start()

    def _dispatch(self, msg_type, msg: Message):
        if msg_type == MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER:
            self._handle_model(msg)

    def _sync_round(self, round_idx: int, msg_type: int):
        """Sample the round's clients, send every worker its sync, and arm
        the resend timers. A worker is re-sent its sync when its reply is
        more than twice its last round trip late (before one is measured:
        four times the time these sends took, a bound below a worker's
        decode, train and encode of the same payload), never sooner than
        ``resend_interval``, the wait doubling after each resend. A fixed
        interval shorter than the round (a 25 MB payload takes seconds to
        encode and decode) would queue a retraining of every sync at the
        workers, round after round."""
        idx = _client_sampling(round_idx, self.cfg.client_num_in_total, self.worker_num)
        workers = range(1, self.worker_num + 1)
        t0 = time.monotonic()
        with self._lock:
            self._assignment = {w: idx[w - 1] for w in workers}
            self._resend_type = msg_type
            self._first_sent = {w: t0 for w in workers}
            self._last_sent = dict(self._first_sent)
            self._wait = {w: math.inf for w in workers}  # armed after the sends
        for worker in workers:
            self._send_model(msg_type, worker, idx[worker - 1], round_idx=round_idx)
        send_s = time.monotonic() - t0
        floor = self._resend_interval or 0.0
        with self._lock:
            if self.round_idx == round_idx:
                self._wait = {w: max(floor, 2 * self._rtt.get(w, 2 * send_s))
                              for w in workers}

    def send_init_msg(self):
        with self._lock:
            ridx = self.round_idx
        self._sync_round(ridx, MyMessage.MSG_TYPE_S2C_INIT_CONFIG)

    def _send_model(self, msg_type: int, worker: int, client_index: int,
                    round_idx: int | None = None):
        if round_idx is None:
            with self._lock:
                round_idx = self.round_idx
        m = Message(msg_type, 0, worker)
        with _tracer().span("mqtt_encode", round_idx):
            m.add_model_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, self.global_variables)
        m.add(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, str(client_index))
        m.add(MyMessage.MSG_ARG_KEY_ROUND_IDX, str(round_idx))
        self.comm.send_message(m)

    def _resend_loop(self):
        """Re-sync each worker the round still waits on once its resend
        timer runs out (``_sync_round``). A broker kill loses the frames in
        flight; the comm layer reconnects, and these resends recover the
        exchange. Duplicates are harmless: a worker retrains to the same
        bits from the stamped round, and the server keys replies by
        sender."""
        while not self.done.wait(min(self._resend_interval, 0.25)):
            now = time.monotonic()
            with self._lock:
                if self._resend_type is None:
                    continue
                pending = [(w, c) for w, c in self._assignment.items()
                           if w not in self._model_dict
                           and now - self._last_sent[w] >= self._wait[w]]
                for w, _ in pending:
                    self._last_sent[w] = now
                    self._wait[w] *= 2
                msg_type = self._resend_type
                # the round under the lock: frames of a round that advances
                # after release carry the old stamp and their replies drop
                ridx = self.round_idx
            for worker, client_index in pending:
                try:
                    self._send_model(msg_type, worker, client_index, round_idx=ridx)
                except OSError:  # broker mid-restart; the next tick retries
                    break

    def _aggregate(self, models: list[dict], nums: np.ndarray) -> dict:
        w = nums / nums.sum()
        return {k: sum(float(wi) * m[k].double() for wi, m in zip(w, models)).to(v.dtype)
                for k, v in models[0].items()}

    def _handle_model(self, msg: Message):
        sender = msg.get_sender_id()
        raw_ridx = msg.get_params().get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        # this dispatch thread is the only round_idx writer, so the locked
        # snapshot stays current for the whole handler
        with self._lock:
            current_round = self.round_idx
        if raw_ridx is not None and int(raw_ridx) != current_round:
            log.info("dropping stale round-%s reply from worker %d (current round %d)",
                     raw_ridx, sender, current_round)
            return
        with _tracer().span("mqtt_decode", current_round):
            variables = Message.decode_model_params(
                msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS), self.global_variables)
        with self._lock:
            now = time.monotonic()
            self._rtt[sender] = now - self._first_sent.get(sender, now)
            self._model_dict[sender] = variables
            self._sample_num_dict[sender] = float(msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES))
            if len(self._model_dict) < self.worker_num:
                return
            order = sorted(self._model_dict)
            models = [self._model_dict[i] for i in order]
            nums = np.array([self._sample_num_dict[i] for i in order])
            self._model_dict.clear()
            self._sample_num_dict.clear()
            self._resend_type = None  # round complete; pause resends
        self.global_variables = self._aggregate(models, nums)
        record = {"round": current_round}
        if self._eval is not None:
            m = test_metrics(self._eval, self.global_variables, self._test)
            record["test_loss"] = m["Test/Loss"]
            record["test_acc"] = m["Test/Acc"]
        self.history.append(record)
        log.info("mqtt round %d done: %s", current_round, record)

        # advance under the lock: the resend loop snapshots round_idx there
        with self._lock:
            self.round_idx += 1
            current_round = self.round_idx
        if current_round == self.cfg.comm_round:
            self.done.set()
            return
        self._sync_round(current_round, MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)

    def stop(self):
        self.done.set()
        self.comm.stop()


class MqttFedAvgClientManager:
    """Worker actor: on init/sync decode the global model, impersonate the
    assigned logical client, run the engine's local update on the device,
    publish the trained variables and the sample count
    (FedAvgClientManager.py:127-167; the is_mobile list encoding is
    ``Message.add_model_params``)."""

    def __init__(self, host: str, port: int, worker_id: int, dataset: FederatedDataset,
                 trainer, cfg: FedConfig, example_variables: dict, topic: str = "fedml",
                 local_update=None, device="cuda"):
        self.worker_id = worker_id
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataset = dataset
        self.example_variables = example_variables
        self.rounds_trained = 0
        self.finished = threading.Event()
        # a worker's own copy of the trainer: a local update swaps the
        # variables into the module (functional_call), so two workers must
        # not train through one module from their two receive threads
        self._local_update = (build_local_update(copy.deepcopy(trainer), cfg)
                              if local_update is None else local_update)
        self.comm = MqttCommManager(host, port, topic=topic, client_id=worker_id)
        self.comm.add_observer(self._dispatch)

    def _dispatch(self, msg_type, msg: Message):
        if msg_type in (MyMessage.MSG_TYPE_S2C_INIT_CONFIG,
                        MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT):
            self._train_and_reply(msg)

    def _train_and_reply(self, msg: Message):
        client_index = int(msg.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX))
        # the round stamp (absent from reference-format messages: then the
        # local counter, which equals it when no frame was lost); the rng of
        # a round derives from it, so a resent sync retrains to the same bits
        raw_ridx = msg.get_params().get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        ridx = self.rounds_trained if raw_ridx is None else int(raw_ridx)
        tracer = _tracer()
        with tracer.span("mqtt_decode", ridx):
            variables = Message.decode_model_params(
                msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS), self.example_variables)
        train = self.dataset.train
        count = int(train.counts[client_index])
        with tracer.span("mqtt_train", ridx):
            x = to_device(torch.from_numpy(np.asarray(train.x[client_index])), self.device)
            y = to_device(torch.from_numpy(np.asarray(train.y[client_index])), self.device)
            perms, seeds = draw_client_randomness(
                round_generator(self.cfg.seed, ridx, self.worker_id), [count],
                x.shape[0], self.cfg.epochs, self.cfg.shuffle)
            generator = torch.Generator(device=self.device).manual_seed(int(seeds[0]))
            # a reply must be a pure function of (global, round) for the
            # resend protocol to be idempotent
            with _deterministic_cudnn():
                result = self._local_update(variables, x, y, count, generator,
                                            None if perms is None else perms[0])
                synchronize(self.device)
        reply = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.worker_id, 0)
        with tracer.span("mqtt_encode", ridx):
            reply.add_model_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, result.variables)
        reply.add(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, count)
        reply.add(MyMessage.MSG_ARG_KEY_ROUND_IDX, str(ridx))
        self.comm.send_message(reply)
        self.rounds_trained = max(self.rounds_trained, ridx + 1)
        if self.rounds_trained >= self.cfg.comm_round:
            self.finished.set()

    def stop(self):
        self.comm.stop()


def run_mqtt_fedavg(dataset: FederatedDataset, trainer, cfg: FedConfig,
                    host: str | None = None, port: int | None = None,
                    timeout: float = 300.0, device="cuda"):
    """Single-host mobile simulation: broker + server + worker actors in one
    process (the analog of the reference CI's mpirun-on-localhost), FedAvg
    over real MQTT frames, on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``). With ``host`` None an in-process broker listens on
    loopback. Returns (final_variables, history)."""
    device = resolve_device(device)
    worker_num = min(cfg.client_num_per_round, cfg.client_num_in_total)
    broker = MiniBroker() if host is None else None
    if broker is not None:
        host, port = broker.host, broker.port
    server = None
    clients: list[MqttFedAvgClientManager] = []
    try:
        gv = trainer.init(torch.Generator().manual_seed(cfg.seed), device)
        server = MqttFedAvgServerManager(host, port, worker_num, gv, cfg, trainer=trainer,
                                         test_global=dataset.test_global,
                                         resend_interval=2.0, device=device)
        for k in range(1, worker_num + 1):
            clients.append(MqttFedAvgClientManager(host, port, k, dataset, trainer, cfg, gv,
                                                   device=device))
        server.send_init_msg()
        if not server.done.wait(timeout):
            raise TimeoutError("mqtt fedavg did not finish in time")
        for c in clients:
            c.finished.wait(10.0)
    finally:
        for c in clients:
            c.stop()
        if server is not None:
            server.stop()
        if broker is not None:
            broker.close()
    return server.global_variables, server.history
