"""The datasources the port serves from (a copy of the part of
``gofr_tpu/datasource`` the app and the batch lane need): the health
contract, the local file system, the pub/sub contract and the in-memory
broker."""

UP = "UP"
DOWN = "DOWN"


def health(status: str, **details) -> dict:
    return {"status": status, "details": details}
