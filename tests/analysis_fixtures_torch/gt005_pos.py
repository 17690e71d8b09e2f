"""GT005 positive fixture: names registered through tables.

Parsed by graftcheck in tests, never imported.
"""

CATALOG = (
    ("app_fixture_requests_total", "counter", None, "documented + used"),
    ("bad-charset-name", "counter", None, "hyphens break OpenMetrics"),
    ("app_fixture_undocumented_total", "counter", None,
     "registered but absent from gt005_docs.md"),
)

# never handed to a registration: its names do not count as registered
UNUSED = (
    ("app_fixture_never_registered_total", "counter", None, "unused row"),
)


def _register(manager, catalog):
    for name, kind, buckets, desc in catalog:
        getattr(manager, f"new_{kind}")(name, desc)


def register(manager):
    _register(manager, CATALOG)


def observe(metrics):
    metrics.increment_counter("app_fixture_requests_total")
    metrics.increment_counter("app_fixture_never_registered_total")
