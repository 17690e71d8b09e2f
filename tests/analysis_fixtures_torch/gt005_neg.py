"""GT005 negative fixture: a catalog table registered through a loop.

Parsed by graftcheck in tests, never imported.
"""

CATALOG = (
    ("app_fixture_requests_total", "counter", None, "documented + used"),
    ("uptime_seconds", "gauge", None, "unprefixed runtime gauge"),
)


def _register(manager, catalog):
    for name, kind, buckets, desc in catalog:
        if kind == "histogram":
            manager.new_histogram(name, desc, buckets)
        else:
            getattr(manager, f"new_{kind}")(name, desc)
    return manager


def register(manager):
    return _register(manager, CATALOG)


def observe(metrics):
    metrics.increment_counter("app_fixture_requests_total")
    metrics.set_gauge("uptime_seconds", 1.0)
