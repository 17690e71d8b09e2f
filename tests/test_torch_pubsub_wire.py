"""The port's pub/sub wire clients against the JAX package's, on the CPU
and over the JAX tests' in-process brokers: the trace envelope, the
Kafka codec and client (produce, fetch, commit, resume from a commit,
topic admin, health, pause and resume, a broker restart, an offset out
of range, the coordinator's error codes), the MQTT client (a round
trip, packet bytes, a reconnect that subscribes again) and the Google
client (without its driver, and over the stub driver). Each case drives
both packages through the same inputs and compares bytes, messages,
broker state and metric series."""

import asyncio
import importlib
import random
import socket
import struct
import sys
import time

import pytest

from tests.test_gated_drivers import (_FakePublisher, _FakeReceived,
                                      _FakeSubscriber, _module)
from tests.test_pubsub_wire import FakeKafkaBroker, FakeMQTTBroker

PKGS = {"jax": "gofr_tpu", "port": "gofr_tpu_torch"}
SIDES = ("jax", "port")


def mod(side, name):
    return importlib.import_module(f"{PKGS[side]}.{name}")


def mock(side, config=None):
    new = mod(side, "container").new_mock_container
    return new(config) if side == "jax" else new(config, device="cpu")


def kafka_client(side, broker, extra=None, tracer=None):
    values = {"PUBSUB_BROKER": f"127.0.0.1:{broker.port}",
              "CONSUMER_ID": "workers", "KAFKA_FETCH_MAX_WAIT_MS": "20",
              "KAFKA_HEARTBEAT_INTERVAL_MS": "100"}
    values.update(extra or {})
    container = mock(side)
    client = mod(side, "datasource.pubsub.kafka").KafkaClient(
        mod(side, "config").MapConfig(values), container.logger,
        container.metrics, tracer=tracer)
    return client, container


class FixedClock:
    """``time`` for the codec modules: a fixed wall clock (message-set
    timestamps, the partition pick) and the real monotonic clock."""

    def __init__(self, now=1_700_000_000.0):
        self.now = now

    def time(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def fix_clock(monkeypatch, name):
    for side in SIDES:
        monkeypatch.setattr(mod(side, name), "time", FixedClock())


def seeded_ids(monkeypatch, seed):
    """Span ids from one seeded stream a package, so both packages' spans
    carry the same ids."""
    for side in SIDES:
        rng = random.Random(seed)
        monkeypatch.setattr(
            mod(side, "trace.tracer"), "_rand_hex",
            lambda nbits, rng=rng: f"{rng.getrandbits(nbits):0{nbits // 4}x}")


# -- the trace envelope ------------------------------------------------------------

def test_trace_envelope_bytes_as_jax():
    rng = random.Random(3)
    cases = [(f"00-{rng.getrandbits(128):032x}-{rng.getrandbits(64):016x}-01",
              bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 40))))
             for _ in range(50)]
    noise = [bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 12)))
             for _ in range(50)]
    noise += [b"\x00GTR1", b"\x00GTR1\x00", b"\x00GTR1\x00\x09ab"]
    got = {}
    for side in SIDES:
        base = mod(side, "datasource.pubsub.base")
        wrapped = [base.encode_trace_envelope(tp, p) for tp, p in cases]
        got[side] = (wrapped, [base.decode_trace_envelope(w) for w in wrapped],
                     [base.decode_trace_envelope(n) for n in noise])
    assert got["port"] == got["jax"]
    assert got["port"][1] == cases


# -- the Kafka codec ---------------------------------------------------------------

def test_kafka_codec_bytes_as_jax(monkeypatch):
    fix_clock(monkeypatch, "datasource.pubsub.kafka")
    rng = random.Random(11)
    sets = [[(bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 8))),
              bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 64))))
             for _ in range(rng.randint(0, 6))] for _ in range(20)]
    topics = [f"t{i}" for i in range(4)]
    assignments = [{t: sorted(rng.sample(range(8), rng.randint(0, 8)))
                    for t in rng.sample(topics, rng.randint(0, 4))}
                   for _ in range(20)]
    groups = [({f"m{j}": rng.sample(topics, rng.randint(1, 4))
                for j in range(rng.randint(1, 5))},
               {t: sorted(rng.sample(range(12), rng.randint(0, 12)))
                for t in topics}) for _ in range(20)]
    subscriptions = [list(members.values())[0] for members, _ in groups]
    got = {}
    for side in SIDES:
        kafka = mod(side, "datasource.pubsub.kafka")
        blobs = [kafka.encode_message_set(items) for items in sets]
        got[side] = (
            blobs, [kafka.decode_message_set(b, 0) for b in blobs],
            [kafka.decode_message_set(b[:-3], 0) for b in blobs if b],
            [kafka.encode_member_assignment(a) for a in assignments],
            [kafka.decode_member_assignment(
                kafka.encode_member_assignment(a)) for a in assignments],
            [kafka.encode_consumer_metadata(t) for t in subscriptions],
            [kafka.decode_consumer_metadata(
                kafka.encode_consumer_metadata(t)) for t in subscriptions],
            [kafka.range_assign(m, p) for m, p in groups])
    assert got["port"] == got["jax"]


# -- the Kafka client over FakeKafkaBroker -----------------------------------------

def drain(client, topic, n, commit=True):
    async def main():
        out = []
        for _ in range(n):
            message = await asyncio.wait_for(client.subscribe(topic), 10.0)
            out.append((message.topic, message.value, message.key,
                        message.metadata, message.param("offset")))
            if commit:
                message.commit()
        return out

    return asyncio.run(main())


def test_kafka_produce_fetch_commit_as_jax(monkeypatch):
    fix_clock(monkeypatch, "datasource.pubsub.kafka")
    got = {}
    for side in SIDES:
        broker = FakeKafkaBroker()
        client, container = kafka_client(side, broker)
        try:
            client.create_topic("orders")
            for i in range(5):
                client.publish("orders", b'{"n": %d}' % i,
                               key=b"k" if i % 2 else b"")
            consumed = drain(client, "orders", 5)
            got[side] = (broker.logs[("orders", 0)], consumed,
                         dict(broker.offsets), client.health_check(),
                         {n: container.metrics.value(n, topic="orders")
                          for n in ("app_pubsub_publish_total_count",
                                    "app_pubsub_publish_success_count",
                                    "app_pubsub_subscribe_success_count")})
            client.delete_topic("orders")
            got[side] += (("orders", 0) in broker.logs,)
        finally:
            client.close()
            broker.stop()
    got["port"][3]["details"]["broker"] = got["jax"][3]["details"]["broker"]
    assert got["port"] == got["jax"]
    assert got["port"][2] == {("workers", "orders", 0): 5}


def test_kafka_restart_resumes_from_committed_offset_as_jax():
    got = {}
    for side in SIDES:
        broker = FakeKafkaBroker()
        broker.logs[("jobs", 0)] = [(b"", b"job-%d" % i) for i in range(6)]
        first, _ = kafka_client(side, broker)
        try:
            before = [m[1] for m in drain(first, "jobs", 3)]
        finally:
            first.close()
        second, _ = kafka_client(side, broker)
        try:
            after = [m[1] for m in drain(second, "jobs", 3)]
        finally:
            second.close()
            broker.stop()
        got[side] = (before, after, dict(broker.offsets))
    assert got["port"] == got["jax"]
    assert got["port"][1] == [b"job-3", b"job-4", b"job-5"]


def test_kafka_traced_publish_as_jax(monkeypatch):
    fix_clock(monkeypatch, "datasource.pubsub.kafka")
    seeded_ids(monkeypatch, 17)
    got = {}
    for side in SIDES:
        trace = mod(side, "trace")
        exporter = trace.ListExporter()
        tracer = trace.Tracer(exporter=exporter)
        broker = FakeKafkaBroker()
        client, _ = kafka_client(side, broker, tracer=tracer)
        try:
            client.publish("traced", b"untraced")
            with tracer.start_span("handler"):
                client.publish("traced", b'{"n": 1}')
            consumed = drain(client, "traced", 2)
        finally:
            client.close()
            broker.stop()
            tracer.shutdown()
        got[side] = (broker.logs[("traced", 0)], consumed,
                     [(s.name, s.trace_id, s.span_id, s.parent_id,
                       s.attributes) for s in exporter.find("pubsub.publish")])
    assert got["port"] == got["jax"]
    assert got["port"][0][1][1].startswith(b"\x00GTR1")


def test_kafka_pause_and_resume_as_jax():
    got = {}
    for side in SIDES:
        broker = FakeKafkaBroker()
        client, container = kafka_client(side, broker)
        try:
            async def main():
                client.publish("orders", b"m1")
                first = await asyncio.wait_for(client.subscribe("orders"),
                                               10.0)
                client.pause("orders", reason="admission_depth")
                client.pause("orders", reason="admission_depth")
                paused = client.is_paused("orders")
                await asyncio.sleep(0.2)       # the long poll in flight
                client.publish("orders", b"m2")
                task = asyncio.ensure_future(client.subscribe("orders"))
                done, _ = await asyncio.wait([task], timeout=0.4)
                client.resume("orders")
                second = await asyncio.wait_for(task, 10.0)
                return first.value, paused, bool(done), second.value

            out = asyncio.run(main())
            got[side] = (out, client.is_paused("orders"),
                         container.metrics.snapshot()[
                             "app_pubsub_consumer_paused_total"].series)
        finally:
            client.close()
            broker.stop()
    assert got["port"] == got["jax"]
    assert got["port"][0] == (b"m1", True, False, b"m2")


class OutOfRangeBroker(FakeKafkaBroker):
    """Answers OFFSET_OUT_OF_RANGE to a fetch past the log's end."""

    def _handle(self, api_key, reader, _string, _bytes, enc_set, dec_set,
                conn=None):
        if api_key != 1:
            return super()._handle(api_key, reader, _string, _bytes,
                                   enc_set, dec_set, conn)
        reader.int32()
        reader.int32()
        reader.int32()
        reader.int32()
        topic = reader.string()
        reader.int32()
        partition = reader.int32()
        offset = reader.int64()
        log = self.logs.get((topic, partition), [])
        error = 1 if offset > len(log) else 0
        message_set = b""
        for i, (key, value) in enumerate([] if error else log[offset:]):
            one = enc_set([(key, value)])
            message_set += struct.pack(">q", offset + i) + one[8:]
        return (struct.pack(">i", 0) + struct.pack(">i", 1) + _string(topic)
                + struct.pack(">i", 1)
                + struct.pack(">ihq", partition, error, len(log))
                + _bytes(message_set))


def test_kafka_broker_restart_and_offset_out_of_range_as_jax():
    got = {}
    for side in SIDES:
        broker = FakeKafkaBroker()
        client, _ = kafka_client(side, broker)
        out = []
        try:
            client.publish("orders", b"before")
            port = broker.port
            # the client sees the close, and a redial is refused
            for sock in [broker.server] + broker.conns:
                sock.shutdown(socket.SHUT_RDWR)
            broker.stop()
            with pytest.raises(Exception) as err:
                client.publish("orders", b"into the void")
            out.append(type(err.value).__name__)
            broker = FakeKafkaBroker(port=port)
            for _ in range(50):
                try:
                    client.publish("orders", b"after")
                    break
                except Exception:                         # noqa: BLE001
                    time.sleep(0.1)
            out.append(broker.logs[("orders", 0)])
        finally:
            client.close()
            broker.stop()
        stale = OutOfRangeBroker()
        stale.logs[("jobs", 0)] = [(b"", b"a"), (b"", b"b")]
        stale.offsets[("workers", "jobs", 0)] = 9       # past the end
        client, _ = kafka_client(side, stale)
        try:
            out.append([m[1] for m in drain(client, "jobs", 2)])
        finally:
            client.close()
            stale.stop()
        got[side] = out
    assert got["port"] == got["jax"]
    assert got["port"][2] == [b"a", b"b"]


@pytest.mark.parametrize("code", [25, 22, 27, 7])
def test_kafka_coordinator_error_codes_as_jax(code):
    """Heartbeat and join answers: 22, 25 and 27 rebalance (25 resets
    the member id), any other code is a plain error; the committer
    carries its generation and member, which the coordinator fences."""
    got = {}
    for side in SIDES:
        kafka = mod(side, "datasource.pubsub.kafka")
        broker = FakeKafkaBroker()
        client, _ = kafka_client(side, broker)

        class Coordinator:
            def call(self, api_key, api_version, body):
                return kafka._Reader(struct.pack(">h", code))

        out = []
        try:
            for call in (lambda: client._heartbeat(Coordinator(), 3, "m-1"),
                         lambda: client._join_group(Coordinator(), "t",
                                                    "stale")):
                with pytest.raises(kafka.KafkaError) as err:
                    call()
                out.append((type(err.value).__name__, str(err.value),
                            getattr(err.value, "reset_member", None)))
            with pytest.raises(kafka.KafkaRebalance) as err:
                client._make_committer("t", 0, 5, 7, "member-x")()
            out.append(str(err.value))
        finally:
            client.close()
            broker.stop()
        got[side] = out
    assert got["port"] == got["jax"]


def test_kafka_fetch_errors_growth_and_leader_outage_as_jax():
    """A fetch error code other than out-of-range raises; in static mode
    a partition added after subscribe gets a fetcher; a partition whose
    leader refuses connections does not stop its siblings."""
    got = {}
    for side in SIDES:
        kafka = mod(side, "datasource.pubsub.kafka")
        broker = FakeKafkaBroker()
        broker.partitions["logs"] = 1
        broker.logs[("logs", 0)] = [(b"", b"p0-old")]
        client, _ = kafka_client(side, broker, {
            "KAFKA_GROUP_MODE": "static", "KAFKA_METADATA_REFRESH_S": "0.2"})

        class Conn:
            def call(self, api_key, api_version, body):
                return kafka._Reader(
                    struct.pack(">ii", 0, 1) + struct.pack(">h", 1) + b"t"
                    + struct.pack(">i", 1) + struct.pack(">ihq", 0, 6, 0)
                    + struct.pack(">i", 0))

        out = []
        try:
            with pytest.raises(kafka.KafkaError) as err:
                client._fetch("t", 0, 0, broker=Conn())
            out.append(str(err.value))
            out.append(drain(client, "logs", 1)[0][1])
            broker.partitions["logs"] = 2
            broker.logs[("logs", 1)] = [(b"", b"p1-new")]
            out.append(drain(client, "logs", 1)[0][1:4:2])
        finally:
            client.close()
            broker.stop()
        broker = FakeKafkaBroker()
        broker.partitions["events"] = 2
        broker.logs[("events", 0)] = []
        broker.logs[("events", 1)] = [(b"", b"ok-%d" % i) for i in range(3)]
        client, _ = kafka_client(side, broker, {"KAFKA_GROUP_MODE": "static"})
        dead = FakeKafkaBroker()
        dead_port = dead.port
        dead.stop()
        refresh = client._refresh_metadata

        def poisoned(topic):
            parts = refresh(topic)
            client._leaders[("events", 0)] = ("127.0.0.1", dead_port)
            return parts

        client._refresh_metadata = poisoned
        try:
            out.append([m[1] for m in drain(client, "events", 3)])
        finally:
            client.close()
            broker.stop()
        got[side] = out
    assert got["port"] == got["jax"]
    assert got["port"][1:] == [b"p0-old", (b"p1-new", {"partition": 1,
                                                       "offset": 0}),
                               [b"ok-0", b"ok-1", b"ok-2"]]


# -- MQTT --------------------------------------------------------------------------

def mqtt_client(side, broker, qos=0):
    container = mock(side)
    return mod(side, "datasource.pubsub.mqtt").MQTTClient(
        mod(side, "config").MapConfig({
            "MQTT_HOST": "127.0.0.1", "MQTT_PORT": str(broker.port),
            "MQTT_QOS": str(qos), "MQTT_CLIENT_ID": "svc"}),
        container.logger, container.metrics)


def packet_body(frame):
    """The bytes after an MQTT packet's fixed header."""
    i = 1
    while frame[i] & 0x80:
        i += 1
    return frame[i + 1:]


def test_mqtt_packet_bytes_as_jax():
    rng = random.Random(5)
    cases = [(f"a/{rng.randint(0, 99)}", bytes(rng.getrandbits(8) for _ in
                                              range(rng.choice([0, 5, 127,
                                                                128, 300]))),
              rng.randint(1, 65535), rng.randint(0, 1)) for _ in range(40)]
    got = {}
    for side in SIDES:
        mqtt = mod(side, "datasource.pubsub.mqtt")
        frames = [mqtt.encode_publish(t, p, pid, qos) for t, p, pid, qos
                  in cases]
        got[side] = (
            frames,
            [mqtt.decode_publish(f[0] & 0x0F, packet_body(f))
             for f in frames],
            [mqtt.encode_subscribe(pid, t, qos) for t, _, pid, qos in cases],
            [mqtt.encode_connect("svc", 30), mqtt.encode_connect(
                "svc", 10, "user", "pw", clean=False),
             mqtt.encode_connect("svc", 5, "user")],
            [mqtt._encode_varint(n) for n in (0, 127, 128, 16383, 16384,
                                              2097151, 268435455)])
    assert got["port"] == got["jax"]


def test_mqtt_roundtrip_as_jax():
    got = {}
    for side in SIDES:
        broker = FakeMQTTBroker()
        client = mqtt_client(side, broker, qos=1)
        try:
            async def main():
                first = asyncio.ensure_future(client.subscribe("orders"))
                while not broker.subscribers:
                    await asyncio.sleep(0.01)
                client.publish("orders", b'{"id": 1}')
                message = await asyncio.wait_for(first, 5.0)
                message.commit()
                return (message.topic, message.bind(), message.param("topic"),
                        message.committed, message.to_log())

            got[side] = (asyncio.run(main()), client.health_check())
        finally:
            client.close()
            broker.stop()
    got["port"][1]["details"]["host"] = got["jax"][1]["details"]["host"]
    assert got["port"] == got["jax"]


def test_mqtt_reconnect_subscribes_again_as_jax():
    """Both packages' clients lose their connections at once; each
    redials, subscribes again and gets what is published after the
    outage."""
    broker = FakeMQTTBroker()
    clients = {side: mqtt_client(side, broker) for side in SIDES}
    try:
        async def main():
            pending = {side: asyncio.ensure_future(c.subscribe(f"o-{side}"))
                       for side, c in clients.items()}
            while len(broker.subscribers) < 2:
                await asyncio.sleep(0.01)
            with broker.lock:
                severed, broker.conns = list(broker.conns), []
                broker.subscribers = []
            for conn in severed:
                conn.shutdown(socket.SHUT_RDWR)   # the clients see it now
                conn.close()
            deadline = time.monotonic() + 10.0
            while not (all(c._connected.is_set() for c in clients.values())
                       and len(broker.subscribers) >= 2):
                assert time.monotonic() < deadline, "no reconnect"
                await asyncio.sleep(0.05)
            for side, client in clients.items():
                client.publish(f"o-{side}", b'{"id": 2}')
            return {side: (m.topic, m.bind()) for side, m in zip(
                pending, await asyncio.wait_for(
                    asyncio.gather(*pending.values()), 10.0))}

        out = asyncio.run(main())
        health = {side: c.health_check()["status"]
                  for side, c in clients.items()}
    finally:
        for client in clients.values():
            client.close()
        broker.stop()
    assert out == {"jax": ("o-jax", {"id": 2}),
                   "port": ("o-port", {"id": 2})}
    assert health == {"jax": "UP", "port": "UP"}


# -- Google ------------------------------------------------------------------------

def test_google_without_driver_raises_as_jax():
    got = {}
    for side in SIDES:
        container = mock(side, {"GOOGLE_PROJECT_ID": "p"})
        google = mod(side, "datasource.pubsub.google")
        with pytest.raises(google.GoogleClientError) as err:
            mod(side, "datasource.pubsub").new_pubsub(
                "google", container.config, container.logger,
                container.metrics)
        got[side] = str(err.value)
    assert got["port"] == got["jax"]


def test_google_over_stub_driver_as_jax(monkeypatch):
    got = {}
    for side in SIDES:
        publisher, subscriber = _FakePublisher(), _FakeSubscriber()
        pubsub_v1 = _module("google.cloud.pubsub_v1",
                            PublisherClient=lambda: publisher,
                            SubscriberClient=lambda: subscriber)
        cloud = _module("google.cloud", pubsub_v1=pubsub_v1)
        monkeypatch.setitem(sys.modules, "google",
                            _module("google", cloud=cloud))
        monkeypatch.setitem(sys.modules, "google.cloud", cloud)
        monkeypatch.setitem(sys.modules, "google.cloud.pubsub_v1", pubsub_v1)
        google = mod(side, "datasource.pubsub.google")
        bare = mock(side)
        with pytest.raises(google.GoogleClientError) as err:
            google.GoogleClient(bare.config, bare.logger, bare.metrics)
        container = mock(side, {"GOOGLE_PROJECT_ID": "proj-1",
                                "GOOGLE_SUBSCRIPTION_NAME": "svc"})
        client = google.GoogleClient(container.config, container.logger,
                                     container.metrics)
        client.create_topic("orders")
        client.publish("orders", b"payload-1", key=b"k1")

        async def roundtrip():
            task = asyncio.ensure_future(client.subscribe("orders"))
            path = "projects/proj-1/subscriptions/svc-orders"
            while path not in subscriber.callbacks:
                await asyncio.sleep(0.005)
            received = _FakeReceived(b"payload-1")
            subscriber.callbacks[path](received)
            message = await asyncio.wait_for(task, 10.0)
            message.commit()
            return message.topic, message.value, received.acked

        out = [str(err.value), asyncio.run(roundtrip()),
               client.health_check()]
        client.delete_topic("orders")
        client.close()
        got[side] = out + [publisher.published, publisher.topics_created,
                           publisher.topics_deleted, subscriber.subscriptions,
                           [p.cancelled for p in subscriber.pulls]]
    assert got["port"] == got["jax"]

