"""The status-provider registry of the health plane (port of that part of
the JAX package's ``telemetry/health.py``).

A subsystem registers a zero-argument callable whose small dict is its
entry in the ``/status`` summary (the serving engine registers
``"serving"``).  The standing plane itself (time series, SLO rules,
straggler diagnosis, the HTTP exposition) is not ported yet.
"""

import threading

_STATUS_PROVIDERS = {}
_STATUS_LOCK = threading.Lock()


def register_status_provider(name, fn):
    """Register ``fn`` under ``name`` (the latest registration wins: a new
    serving engine replaces its predecessor's entry).  A provider that
    raises is reported as ``{"error": ...}``."""
    with _STATUS_LOCK:
        _STATUS_PROVIDERS[str(name)] = fn


def unregister_status_provider(name):
    with _STATUS_LOCK:
        _STATUS_PROVIDERS.pop(str(name), None)


def provider_statuses():
    """``{name: fn()}`` over the registered providers."""
    with _STATUS_LOCK:
        providers = list(_STATUS_PROVIDERS.items())
    out = {}
    for name, fn in providers:
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 - status is best effort
            out[name] = {"error": str(e)}
    return out
