"""Dependency-free MQTT 3.1.1 transport for the mobile/IoT deployment
mode, the port's copy of ``fedml_tpu/comm/mqtt.py`` (plain sockets and
threads; the port imports nothing of the JAX package).

Behavior parity with the reference's paho-based
fedml_core/distributed/communication/mqtt/mqtt_comm_manager.py:14-125: the
server subscribes to one topic per client and publishes to
``<topic><server>_<client>``; each client subscribes to its
``<topic><server>_<client>`` inbox and publishes to ``<topic><client>``;
payloads are JSON Message envelopes. No hard-coded broker address, and a
clean disconnect instead of a thread kill.

paho-mqtt is not needed: the codec is written here, MQTT 3.1.1
CONNECT/CONNACK/PUBLISH/SUBSCRIBE/SUBACK/PINGREQ/PINGRESP/DISCONNECT at QoS
0 over a TCP socket. ``MiniBroker`` is an in-process broker (a thread per
connection, topic -> subscriber routing), so the whole path runs with no
external service. A client reconnects and resubscribes under
``robustness/retry.py``'s policy and reports each reconnect as an
``mqtt_reconnect`` event to the installed tracer; with a tracer installed
the comm manager also records ``mqtt_encode``, ``mqtt_publish`` and
``mqtt_decode`` spans (the JSON half of a message's codec, and its send).
"""

from __future__ import annotations

import logging
import queue
import socket
import struct
import threading
from typing import Callable

from fedml_tpu_torch import telemetry
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.robustness.retry import RetryError, RetryPolicy, call_with_retry

log = logging.getLogger(__name__)

# MQTT 3.1.1 control packet types
CONNECT, CONNACK = 0x10, 0x20
PUBLISH = 0x30
SUBSCRIBE, SUBACK = 0x82, 0x90
PINGREQ, PINGRESP = 0xC0, 0xD0
DISCONNECT = 0xE0


def _encode_len(n: int) -> bytes:
    out = b""
    while True:
        d, n = n % 128, n // 128
        out += bytes([d | (0x80 if n else 0)])
        if not n:
            return out


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return buf


def _read_packet(sock: socket.socket) -> tuple[int, bytes]:
    head = _read_exact(sock, 1)[0]
    mult, length = 1, 0
    while True:
        b = _read_exact(sock, 1)[0]
        length += (b & 0x7F) * mult
        if not (b & 0x80):
            break
        mult *= 128
    return head, _read_exact(sock, length) if length else b""


def _mqtt_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _connect_packet(client_id: str) -> bytes:
    var = _mqtt_str("MQTT") + bytes([4, 0x02]) + struct.pack(">H", 60)
    payload = _mqtt_str(client_id)
    body = var + payload
    return bytes([CONNECT]) + _encode_len(len(body)) + body


def _publish_packet(topic: str, payload: bytes) -> bytes:
    body = _mqtt_str(topic) + payload
    return bytes([PUBLISH]) + _encode_len(len(body)) + body


def _subscribe_packet(pid: int, topic: str) -> bytes:
    body = struct.pack(">H", pid) + _mqtt_str(topic) + bytes([0])
    return bytes([SUBSCRIBE]) + _encode_len(len(body)) + body


class MiniBroker:
    """In-process MQTT broker (QoS 0, exact-topic routing) for tests and
    single-host mobile simulations.

    Each connection has a reader thread and a writer thread with its own
    outbound queue: a reader relays a PUBLISH by queueing it for each
    subscriber, so a subscriber that is not reading (a worker busy training)
    never stalls the publisher's connection. A relay that wrote into the
    subscriber's socket directly would block on a payload larger than the
    socket buffers (a 1.2M-parameter model is about 25 MB of JSON), and
    blocked relays can chain into a cycle of connections that all wait."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(32)
        self.host, self.port = self._srv.getsockname()
        self._subs: dict[str, list[socket.socket]] = {}
        self._outboxes: dict[socket.socket, queue.SimpleQueue] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            if self._stop.is_set():
                # accepted while closing: a client must not attach to a
                # broker that routes nothing to the one that replaces it
                conn.close()
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    @staticmethod
    def _write_loop(conn: socket.socket, outbox: queue.SimpleQueue):
        """Write the connection's queued packets in order until the None
        that ends it (or the peer goes)."""
        while True:
            data = outbox.get()
            if data is None:
                return
            try:
                conn.sendall(data)
            except OSError:
                return

    def _send(self, sock: socket.socket, data: bytes):
        with self._lock:
            outbox = self._outboxes.get(sock)
        if outbox is None:
            raise OSError("peer gone")
        outbox.put(data)

    def _serve(self, conn: socket.socket):
        outbox = queue.SimpleQueue()
        with self._lock:
            self._outboxes[conn] = outbox
        threading.Thread(target=self._write_loop, args=(conn, outbox), daemon=True).start()
        send = self._send
        try:
            head, _body = _read_packet(conn)
            if head & 0xF0 != CONNECT:
                return
            send(conn, bytes([CONNACK, 2, 0, 0]))
            while True:
                head, body = _read_packet(conn)
                ptype = head & 0xF0
                if ptype == SUBSCRIBE & 0xF0:
                    pid = struct.unpack(">H", body[:2])[0]
                    tlen = struct.unpack(">H", body[2:4])[0]
                    topic = body[4:4 + tlen].decode()
                    with self._lock:
                        self._subs.setdefault(topic, []).append(conn)
                    send(conn, bytes([SUBACK, 3]) + struct.pack(">H", pid) + b"\x00")
                elif ptype == PUBLISH:
                    tlen = struct.unpack(">H", body[:2])[0]
                    topic = body[2:2 + tlen].decode()
                    payload = body[2 + tlen:]
                    pkt = _publish_packet(topic, payload)
                    with self._lock:
                        targets = list(self._subs.get(topic, ()))
                    for t in targets:
                        try:
                            send(t, pkt)
                        except OSError:
                            pass
                elif ptype == PINGREQ:
                    send(conn, bytes([PINGRESP, 0]))
                elif ptype == DISCONNECT:
                    break
        except (ConnectionError, OSError):
            pass
        finally:
            with self._lock:
                for subs in self._subs.values():
                    if conn in subs:
                        subs.remove(conn)
                self._outboxes.pop(conn, None)
            outbox.put(None)
            # wakes a writer blocked on a peer that stopped reading
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()

    def close(self):
        """Stop accepting. The listening socket is shut down before it is
        closed, which wakes the accept loop at once: closing alone leaves a
        blocked ``accept`` holding the listener, and a reconnecting client
        could still attach to this broker after a new one took the port.
        Established connections stay served until their peers leave."""
        self._stop.set()
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._srv.close()
        self._thread.join(timeout=5.0)


class MqttClient:
    """Minimal MQTT 3.1.1 client: connect, subscribe(topic, cb), publish.

    paho-parity semantics the reference gets from its client library:
    a keepalive PINGREQ loop, and automatic reconnect + re-subscribe after
    a dropped connection (QoS-0: messages published while disconnected are
    lost, exactly as with paho at QoS 0)."""

    def __init__(self, host: str, port: int, client_id: str,
                 keepalive: float = 60.0, reconnect: bool = True,
                 reconnect_backoff: float = 0.2, reconnect_tries: int = 12,
                 reconnect_policy: RetryPolicy | None = None):
        self._addr = (host, port)
        self._client_id = client_id
        self._keepalive = keepalive
        self._reconnect = reconnect
        # robustness.retry owns the backoff; the legacy knobs map onto it.
        # No jitter here: with jitter every sleep can land near zero, so all
        # attempts may burn in under a second while the broker is still
        # restarting — and an exhausted reconnect kills the receive loop for
        # good. Deterministic backoff makes the give-up horizon a guarantee
        # (~2 min of patience at these defaults), and a per-process handful
        # of clients has no retry herd worth spreading.
        self._reconnect_policy = reconnect_policy or RetryPolicy(
            max_attempts=reconnect_tries, base_delay=reconnect_backoff,
            max_delay=30.0, jitter=False, retryable=(OSError,))
        self._cbs: dict[str, Callable[[str, bytes], None]] = {}
        self._pid = 0
        self._send_lock = threading.Lock()  # publish/subscribe from any thread
        # SUBACKs are matched to their SUBSCRIBE by packet id so concurrent
        # subscribers never return on each other's ack
        self._pending_subacks: dict[int, threading.Event] = {}
        self._stop = threading.Event()
        self._sock = self._connect()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self._ping_thread = threading.Thread(target=self._ping_loop, daemon=True)
        self._ping_thread.start()

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._addr, timeout=30)
        sock.sendall(_connect_packet(self._client_id))
        head, body = _read_packet(sock)
        if head & 0xF0 != CONNACK or body[1] != 0:
            raise ConnectionError(f"MQTT CONNACK refused: {body!r}")
        # the timeout bounds the handshake only: a send that timed out part
        # way through a packet would leave the stream mid-packet, and the
        # next packet on it would arrive corrupt
        sock.settimeout(None)
        return sock

    def _sendall(self, data: bytes):
        """Write one packet on the live connection (the caller holds the send
        lock). A failed write may have left part of the packet on the
        stream, so the connection is shut down: the receive loop then
        reconnects on a clean one."""
        sock = self._sock
        try:
            sock.sendall(data)
        except OSError:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            raise

    def _try_reconnect(self) -> bool:
        """Rebuild the connection and re-subscribe every topic (paho's
        on_connect-resubscribe pattern), with capped-exponential-backoff +
        full-jitter retries (robustness.retry — the shared policy also used
        by data downloads). Returns False when shut down or out of retries."""

        attempts = [1]  # first try + one per on_retry callback

        def reconnect_once():
            sock = self._connect()
            with self._send_lock:
                self._sock = sock
                for topic in list(self._cbs):
                    self._pid = (self._pid % 0xFFFF) + 1
                    sock.sendall(_subscribe_packet(self._pid, topic))

        def on_retry(attempt, exc, delay):
            attempts[0] = attempt + 2
            log.info("mqtt %s: reconnect attempt %d failed (%s), next in "
                     "%.2fs", self._client_id, attempt + 1, exc, delay)

        try:
            call_with_retry(
                reconnect_once,
                policy=self._reconnect_policy,
                abort=self._stop.is_set,
                on_retry=on_retry,
            )
        except (RetryError, OSError):
            telemetry.emit("mqtt_reconnect", client_id=self._client_id,
                           ok=False, attempts=attempts[0])
            return False
        with self._send_lock:
            n_topics = len(self._cbs)
        log.info("mqtt %s: reconnected and resubscribed %d topic(s)",
                 self._client_id, n_topics)
        telemetry.emit("mqtt_reconnect", client_id=self._client_id,
                       ok=True, attempts=attempts[0])
        return True

    def _loop(self):
        while not self._stop.is_set():
            try:
                # snapshot the socket ref under the lock (reconnect rebinds
                # it there) but read packets with the lock RELEASED — a
                # blocking read under the send lock would starve publishers
                with self._send_lock:
                    sock = self._sock
                head, body = _read_packet(sock)
            except (ConnectionError, OSError):
                if self._stop.is_set() or not self._reconnect:
                    return
                if not self._try_reconnect():
                    return
                continue
            ptype = head & 0xF0
            if ptype == PUBLISH:
                tlen = struct.unpack(">H", body[:2])[0]
                topic = body[2:2 + tlen].decode()
                with self._send_lock:
                    cb = self._cbs.get(topic)
                if cb is not None:
                    try:
                        cb(topic, body[2 + tlen:])
                    except Exception:
                        # a handler that publishes onto a just-severed socket
                        # raises OSError here; letting it kill the receive
                        # loop would permanently deafen the client — log and
                        # keep receiving (reconnect + the server's resend
                        # loop recover the lost exchange)
                        log.exception("mqtt %s: subscriber callback failed "
                                      "for topic %s", self._client_id, topic)
            elif ptype == SUBACK & 0xF0:
                pid = struct.unpack(">H", body[:2])[0]
                with self._send_lock:
                    ev = self._pending_subacks.pop(pid, None)
                if ev is not None:
                    ev.set()

    def _ping_loop(self):
        """PINGREQ every keepalive/2 so the broker (and any NAT between)
        keeps the connection alive — paho's keepalive loop."""
        while not self._stop.wait(self._keepalive / 2):
            try:
                with self._send_lock:
                    self._sendall(bytes([PINGREQ, 0]))
            except OSError:
                pass  # the receive loop owns reconnection

    def subscribe(self, topic: str, callback: Callable[[str, bytes], None],
                  timeout: float = 10.0):
        ev = threading.Event()
        with self._send_lock:
            self._cbs[topic] = callback
            self._pid = (self._pid % 0xFFFF) + 1
            pid = self._pid
            self._pending_subacks[pid] = ev
            self._sendall(_subscribe_packet(pid, topic))
        if not ev.wait(timeout):
            with self._send_lock:
                self._pending_subacks.pop(pid, None)
            raise TimeoutError(f"no SUBACK for {topic!r}")

    def publish(self, topic: str, payload: bytes):
        with self._send_lock:
            self._sendall(_publish_packet(topic, payload))

    def disconnect(self):
        self._stop.set()
        with self._send_lock:
            try:
                self._sock.sendall(bytes([DISCONNECT, 0]))
            except OSError:
                pass
            # shut down before close: close alone does not wake the receive
            # thread blocked reading this socket
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()


class MqttCommManager:
    """Reference MqttCommManager surface (mqtt_comm_manager.py:14-125):
    server (client_id 0) subscribes to every client's topic and sends to
    `<topic><server>_<client>`; clients subscribe to their inbox and send
    to `<topic><client>`. Observers receive decoded Message envelopes."""

    def __init__(self, host: str, port: int, topic: str = "fedml",
                 client_id: int = 0, client_num: int = 0):
        self._topic = topic
        self.client_id = client_id
        self.client_num = client_num
        self._observers: list[Callable[[int, Message], None]] = []
        self._client = MqttClient(host, port, f"{topic}_{client_id}")
        if client_id == 0:  # server: one inbox per client
            for cid in range(1, client_num + 1):
                self._client.subscribe(f"{topic}{cid}", self._on_payload)
        else:
            self._client.subscribe(f"{topic}0_{client_id}", self._on_payload)

    def add_observer(self, fn: Callable[[int, Message], None]):
        self._observers.append(fn)

    def _on_payload(self, _topic: str, payload: bytes):
        tracer = telemetry.get_tracer() or telemetry.NULL_TRACER
        with tracer.span("mqtt_decode", bytes=len(payload)):
            msg = Message.from_json(payload)
        for fn in self._observers:
            fn(msg.get_type(), msg)

    def send_message(self, msg: Message):
        receiver = msg.get_receiver_id()
        if self.client_id == 0:
            topic = f"{self._topic}0_{receiver}"
        else:
            topic = f"{self._topic}{self.client_id}"
        tracer = telemetry.get_tracer() or telemetry.NULL_TRACER
        with tracer.span("mqtt_encode"):
            payload = msg.to_json().encode()
        with tracer.span("mqtt_publish", bytes=len(payload)):
            self._client.publish(topic, payload)

    def stop(self):
        self._client.disconnect()
