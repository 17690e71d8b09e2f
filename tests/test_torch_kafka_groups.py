"""The port's Kafka consumer group against the JAX package's, over the
JAX tests' ``FakeKafkaBroker`` and its coordinator: range assignment,
static mode, two members splitting a topic, a dead member's partitions
reclaimed by the survivor, and one JAX member with one port member in a
single group, each processing its share once and fencing the other's
stale commits."""

import asyncio
import importlib
import random

import pytest

from tests.test_kafka_groups import _drain, _wait_stable
from tests.test_pubsub_wire import FakeKafkaBroker

PKGS = {"jax": "gofr_tpu", "port": "gofr_tpu_torch"}
SIDES = ("jax", "port")


def mod(side, name):
    return importlib.import_module(f"{PKGS[side]}.{name}")


def member(side, broker, name, extra=None):
    new = mod(side, "container").new_mock_container
    container = new() if side == "jax" else new(device="cpu")
    values = {"PUBSUB_BROKER": f"127.0.0.1:{broker.port}",
              "CONSUMER_ID": "workers", "APP_NAME": name,
              "KAFKA_FETCH_MAX_WAIT_MS": "20",
              "KAFKA_HEARTBEAT_INTERVAL_MS": "100"}
    values.update(extra or {})
    return mod(side, "datasource.pubsub.kafka").KafkaClient(
        mod(side, "config").MapConfig(values), container.logger,
        container.metrics)


def topic_broker(partitions, join_window=0.3):
    broker = FakeKafkaBroker(join_window=join_window)
    broker.partitions["jobs"] = partitions
    for p in range(partitions):
        broker.logs[("jobs", p)] = []
    return broker


def produce(broker, tag, partitions):
    for p in range(partitions):
        broker.logs[("jobs", p)].append((b"", f"{tag}-p{p}".encode()))


def stable(broker, members):
    return asyncio.get_running_loop().run_in_executor(
        None, _wait_stable, broker, "workers", members)


def test_range_assign_seeded_as_jax():
    rng = random.Random(41)
    cases = []
    for _ in range(200):
        topics = [f"t{i}" for i in range(rng.randint(1, 4))]
        members = {f"m{rng.randint(0, 99):02d}": rng.sample(
            topics, rng.randint(1, len(topics)))
            for _ in range(rng.randint(1, 6))}
        partitions = {t: sorted(rng.sample(range(16), rng.randint(0, 16)))
                      for t in topics}
        cases.append((members, partitions))
    got = {side: [mod(side, "datasource.pubsub.kafka").range_assign(m, p)
                  for m, p in cases] for side in SIDES}
    assert got["port"] == got["jax"]


def test_static_mode_fetches_every_partition_as_jax():
    got = {}
    for side in SIDES:
        broker = FakeKafkaBroker()
        broker.partitions["jobs"] = 3
        for p in range(3):
            broker.logs[("jobs", p)] = [(b"", f"p{p}".encode())]
        client = member(side, broker, "solo", {"KAFKA_GROUP_MODE": "static",
                                               "CONSUMER_ID": "solo"})
        sink = []
        try:
            asyncio.run(_drain(client, "jobs", sink, expect=3, grace=0.2))
            got[side] = (sorted(m.value for m in sink),
                         "solo" in broker.groups, dict(broker.offsets))
        finally:
            client.close()
            broker.stop()
    assert got["port"] == got["jax"]
    assert got["port"][:2] == ([b"p0", b"p1", b"p2"], False)


@pytest.mark.parametrize("first,second", [("port", "port"),
                                          ("jax", "port")])
def test_members_split_then_survivor_reclaims(first, second):
    """Two members of one group split four partitions, each message
    processed once; the first member dies and the second takes its
    partitions, resuming from its commits without replaying them."""
    broker = topic_broker(4)
    c1 = member(first, broker, "c1")
    c2 = member(second, broker, "c2")
    phase1, phase2, survivor = [], [], []

    async def scenario():
        task1 = asyncio.ensure_future(_drain(c1, "jobs", phase1, expect=4,
                                             grace=0.3))
        task2 = asyncio.ensure_future(_drain(c2, "jobs", phase2, expect=4,
                                             grace=0.3))
        split = await stable(broker, 2)
        for i in range(2):
            produce(broker, f"first{i}", 4)
        await asyncio.gather(task1, task2)
        c1.close()
        await stable(broker, 1)
        produce(broker, "second", 4)
        await _drain(c2, "jobs", survivor, expect=4, grace=0.3)
        return split

    try:
        split = asyncio.run(scenario())
    finally:
        c2.close()
        broker.stop()
    sets = [set(a.get("jobs", [])) for a in split.values()]
    assert sets[0] & sets[1] == set() and sets[0] | sets[1] == {0, 1, 2, 3}
    firsts = sorted(m.value for m in phase1 + phase2)
    assert firsts == sorted(f"first{i}-p{p}".encode() for i in range(2)
                            for p in range(4))
    assert phase1 and phase2
    assert {m.metadata["partition"] for m in phase1}.isdisjoint(
        {m.metadata["partition"] for m in phase2})
    assert sorted(m.value for m in survivor) == sorted(
        f"second-p{p}".encode() for p in range(4))
    assert {("workers", "jobs", p): 3 for p in range(4)} == {
        k: v for k, v in broker.offsets.items() if k[0] == "workers"}


@pytest.mark.parametrize("zombie,joiner", [("port", "jax"),
                                           ("jax", "port")])
def test_stale_generation_commit_is_fenced_across_packages(zombie, joiner):
    """A member holding a message from an older generation cannot commit
    it once the other package's member has joined the group."""
    broker = FakeKafkaBroker(join_window=0.3)
    broker.partitions["jobs"] = 2
    broker.logs[("jobs", 0)] = [(b"", b"m0")]
    broker.logs[("jobs", 1)] = []
    c1 = member(zombie, broker, "c1")
    kafka = mod(zombie, "datasource.pubsub.kafka")

    async def scenario():
        held = await asyncio.wait_for(c1.subscribe("jobs"), 10.0)
        c2 = member(joiner, broker, "c2")
        consume = asyncio.ensure_future(_drain(c2, "jobs", [], expect=10**6,
                                               deadline=30.0))
        try:
            await stable(broker, 2)
            with pytest.raises(kafka.KafkaRebalance, match="fenced"):
                held.commit()
        finally:
            q = c2._queues.get("jobs")
            if q is not None:
                q.put_nowait(None)
            await consume
            c2.close()
        return held.value

    try:
        assert asyncio.run(scenario()) == b"m0"
        assert ("workers", "jobs", 0) not in broker.offsets
    finally:
        c1.close()
        broker.stop()
