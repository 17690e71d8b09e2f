"""The datasources (counterpart of ``gofr_tpu/datasource``): the health
contract every datasource's ``health_check()`` returns, the local file
system, pub/sub (in memory, Kafka, MQTT, Google), Redis, SQL, Mongo,
Cassandra and ClickHouse."""

UP = "UP"
DOWN = "DOWN"


def health(status: str, **details) -> dict:
    return {"status": status, "details": details}
