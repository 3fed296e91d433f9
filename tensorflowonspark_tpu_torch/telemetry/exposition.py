"""HTTP exposition of the health plane (port of the JAX package's
``telemetry/exposition.py``).

A :class:`~.health.HealthPlane` (or any object with ``merged_snapshot()``,
``healthz()`` and ``status()``) gets an HTTP endpoint that a
Prometheus-compatible collector, a load balancer or ``curl`` can read:

- ``GET /metrics``: the fleet-merged registry snapshot as OpenMetrics
  text (:func:`to_openmetrics`): counters as ``_total`` samples, gauges
  as they are, histograms as cumulative ``_bucket{le=}`` samples plus
  the exact ``_sum`` / ``_count`` pair;
- ``GET /healthz``: liveness from heartbeat age and compute state merged
  with page-severity SLO alerts; 200 when healthy, 503 with the reasons
  when not;
- ``GET /status``: a compact JSON summary: per-executor rates, alerts
  and their history, straggler hints, the registered providers;
- ``GET /usage``: per-tenant cost attribution as OpenMetrics counters
  labelled ``tenant="..."`` (``?format=json`` for the JSON view);
- ``GET /journal``: the fleet's typed-event record as JSON.

:func:`parse_openmetrics` is the strict parser the tests read
``/metrics`` with: TYPE-declared families, counter samples ending in
``_total``, cumulative non-decreasing buckets, a ``+Inf`` bucket equal
to ``_count``, the ``# EOF`` terminator.

Metric names are sanitized for the exposition only (dots become
underscores: ``serving.request_latency_sec`` ->
``serving_request_latency_sec``); the registry keeps the dotted names.
"""

import json
import logging
import re
import threading

try:  # http.server is stdlib, but keep imports at the top gated so a
    # stripped-down interpreter can still import the telemetry package
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
except ImportError:  # pragma: no cover
    BaseHTTPRequestHandler = object
    ThreadingHTTPServer = None

logger = logging.getLogger(__name__)

#: Content type of ``/metrics`` (the OpenMetrics media type; Prometheus
#: also accepts it).
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")

#: One OpenMetrics sample line: ``name{labels} value`` (no timestamps
#: — the scraper stamps arrival time, the store keeps history).
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>[^ ]+)$"
)
_LABEL_RE = re.compile(r'^(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>[^"]*)"$')


def sanitize_name(name):
    """Registry name → OpenMetrics metric name (dots and other
    punctuation become underscores; a leading digit gets a ``_``)."""
    out = _SANITIZE.sub("_", str(name))
    if not out or not _NAME_OK.match(out):
        out = "_" + out
    return out


def _fmt(v):
    """OpenMetrics number formatting: integers bare, floats via repr
    (full precision: the exact sums survive the text round trip)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def to_openmetrics(snapshot):
    """Registry snapshot (or fleet merge) → OpenMetrics text.

    Mapping: counters emit one ``<name>_total`` sample; gauges one
    ``<name>`` sample; histograms the cumulative
    ``<name>_bucket{le="..."}`` series (every nonzero bucket's upper
    bound, then ``+Inf``) plus ``<name>_sum`` (the exact running sum)
    and ``<name>_count``.  Ends with the mandatory ``# EOF``.
    """
    lines = []
    for name in sorted(snapshot.get("counters", {})):
        om = sanitize_name(name)
        lines.append("# TYPE {0} counter".format(om))
        lines.append(
            "{0}_total {1}".format(
                om, _fmt(snapshot["counters"][name])
            )
        )
    for name in sorted(snapshot.get("gauges", {})):
        om = sanitize_name(name)
        lines.append("# TYPE {0} gauge".format(om))
        lines.append("{0} {1}".format(om, _fmt(snapshot["gauges"][name])))
    for name in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][name] or {}
        om = sanitize_name(name)
        lines.append("# TYPE {0} histogram".format(om))
        cum = 0
        for _lo, hi, c in h.get("buckets", []):
            if hi is None:  # the overflow bucket folds into +Inf
                continue
            cum += c
            lines.append(
                '{0}_bucket{{le="{1}"}} {2}'.format(om, _fmt(float(hi)), cum)
            )
        total = int(h.get("count", 0))
        lines.append('{0}_bucket{{le="+Inf"}} {1}'.format(om, total))
        lines.append("{0}_sum {1}".format(om, _fmt(h.get("sum", 0.0))))
        lines.append("{0}_count {1}".format(om, total))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def parse_openmetrics(text):
    """STRICT OpenMetrics text parser (the test round-trip oracle).

    Returns ``{family: {"type": str, "samples": [(name, labels,
    value)]}}``.  Raises :class:`ValueError` on any violation of the
    invariants a collector relies on:

    - the exposition must end with ``# EOF`` (nothing after it);
    - every sample's family must have a prior ``# TYPE`` declaration;
    - counter samples must use the ``_total`` suffix;
    - histogram ``_bucket`` series must be cumulative (non-decreasing
      in ``le`` order), include ``le="+Inf"``, and have
      ``+Inf == _count``;
    - values must parse as numbers, labels as ``key="value"``.
    """
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if not lines or lines[-1] != "# EOF":
        raise ValueError("exposition does not end with '# EOF'")
    families = {}
    for line in lines[:-1]:
        if not line:
            raise ValueError("blank line inside exposition")
        if line.startswith("#"):
            parts = line.split(" ")
            if len(parts) < 2:
                raise ValueError("unparseable comment line %r" % line)
            if len(parts) >= 4 and parts[1] == "TYPE":
                fam, ftype = parts[2], parts[3]
                if fam in families:
                    raise ValueError(
                        "duplicate TYPE declaration for %r" % fam
                    )
                if ftype not in ("counter", "gauge", "histogram",
                                 "summary", "unknown"):
                    raise ValueError(
                        "unknown metric type %r for %r" % (ftype, fam)
                    )
                families[fam] = {"type": ftype, "samples": []}
                continue
            if parts[1] == "EOF":
                raise ValueError("'# EOF' before the end of the exposition")
            if parts[1] in ("HELP", "UNIT"):
                continue
            raise ValueError("unparseable comment line %r" % line)
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError("unparseable sample line %r" % line)
        name = m.group("name")
        labels = {}
        if m.group("labels"):
            for part in m.group("labels").split(","):
                lm = _LABEL_RE.match(part.strip())
                if not lm:
                    raise ValueError(
                        "unparseable label %r in %r" % (part, line)
                    )
                labels[lm.group("k")] = lm.group("v")
        raw = m.group("value")
        try:
            value = float(raw)
        except ValueError:
            raise ValueError("unparseable value %r in %r" % (raw, line))
        fam = _family_of(name, families)
        if fam is None:
            raise ValueError(
                "sample %r has no TYPE-declared family" % name
            )
        families[fam]["samples"].append((name, labels, value))
    _validate_families(families)
    return families


def _family_of(sample_name, families):
    if sample_name in families:
        return sample_name
    for suffix in ("_total", "_bucket", "_sum", "_count", "_created"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if base in families:
                return base
    return None


def _validate_families(families):
    for fam, rec in families.items():
        ftype, samples = rec["type"], rec["samples"]
        if ftype == "counter":
            for name, _labels, _v in samples:
                if name != fam + "_total":
                    raise ValueError(
                        "counter %r sample %r lacks the _total "
                        "suffix" % (fam, name)
                    )
        elif ftype == "histogram":
            buckets = [
                (labels.get("le"), v)
                for name, labels, v in samples
                if name == fam + "_bucket"
            ]
            if not buckets:
                raise ValueError("histogram %r has no buckets" % fam)
            les = [le for le, _ in buckets]
            if "+Inf" not in les:
                raise ValueError(
                    "histogram %r lacks the +Inf bucket" % fam
                )
            counts = [v for _le, v in buckets]
            if any(b > a for a, b in zip(counts[1:], counts)):
                raise ValueError(
                    "histogram %r buckets are not cumulative "
                    "non-decreasing: %s" % (fam, counts)
                )
            # le values must be sorted ascending with +Inf last
            finite = [float(le) for le in les[:-1]]
            if les[-1] != "+Inf" or finite != sorted(finite):
                raise ValueError(
                    "histogram %r le series is not ascending with "
                    "+Inf last: %s" % (fam, les)
                )
            count = [
                v for name, _l, v in samples if name == fam + "_count"
            ]
            if not count:
                raise ValueError("histogram %r lacks _count" % fam)
            if counts[-1] != count[0]:
                raise ValueError(
                    "histogram %r +Inf bucket (%s) != _count (%s)"
                    % (fam, counts[-1], count[0])
                )
            if not any(
                name == fam + "_sum" for name, _l, _v in samples
            ):
                raise ValueError("histogram %r lacks _sum" % fam)
    return families


# ----------------------------------------------------------------------
# the HTTP server
# ----------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    """The routes, bound to a health plane through the server."""

    server_version = "tfos-health/1.0"

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        plane = self.server.plane
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = to_openmetrics(plane.merged_snapshot()).encode(
                    "utf-8"
                )
                self._reply(200, OPENMETRICS_CONTENT_TYPE, body)
            elif path == "/healthz":
                hz = plane.healthz()
                self._reply(
                    200 if hz.get("healthy") else 503,
                    "application/json",
                    json.dumps(hz).encode("utf-8"),
                )
            elif path == "/status":
                self._reply(
                    200, "application/json",
                    json.dumps(plane.status()).encode("utf-8"),
                )
            elif path == "/journal" and hasattr(
                plane, "journal_events"
            ):
                # the fleet's typed-event record, as JSON
                self._reply(
                    200, "application/json",
                    json.dumps(plane.journal_events()).encode("utf-8"),
                )
            elif path == "/usage" and hasattr(plane, "usage"):
                # per-tenant cost attribution: OpenMetrics counters with
                # a bounded `tenant` label by default (they read back
                # through the strict parser), the JSON view (with the
                # heavy-hitter estimates) on ?format=json
                usage = plane.usage()
                if "format=json" in (
                    self.path.partition("?")[2] or ""
                ):
                    self._reply(
                        200, "application/json",
                        json.dumps(usage).encode("utf-8"),
                    )
                else:
                    from tensorflowonspark_tpu_torch.telemetry import (
                        ledger as _ledger_mod,
                    )

                    body = _ledger_mod.usage_openmetrics(
                        usage.get("tenants", {})
                    ).encode("utf-8")
                    self._reply(200, OPENMETRICS_CONTENT_TYPE, body)
            else:
                self._reply(
                    404, "text/plain",
                    b"not found; routes: /metrics /healthz /status "
                    b"/journal /usage\n",
                )
        except Exception as e:  # noqa: BLE001 - a scrape must see 500,
            logger.warning(  # not a dropped connection
                "health exposition handler failed", exc_info=True
            )
            try:
                self._reply(
                    500, "text/plain", str(e).encode("utf-8", "replace")
                )
            except OSError:
                pass

    def _reply(self, code, ctype, body):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # noqa: A003 - silence stderr
        logger.debug("health http: " + fmt, *args)


class ExpositionServer(object):
    """Threaded HTTP server exposing one plane's routes.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``host`` defaults to loopback — bind ``0.0.0.0`` explicitly to
    expose the fleet's metrics beyond the driver host."""

    def __init__(self, plane, port=0, host="127.0.0.1"):
        if ThreadingHTTPServer is None:  # pragma: no cover
            raise RuntimeError("http.server unavailable in this build")
        self.plane = plane
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.plane = plane
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = None

    @property
    def url(self):
        return "http://{0}:{1}".format(self.host, self.port)

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="health-exposition",
        )
        self._thread.start()
        logger.info("health exposition serving on %s", self.url)
        return self

    def stop(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:  # pragma: no cover
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
