"""Per-request usage ledger: cost attribution by request and tenant
(port of the JAX package's ``telemetry/ledger.py``).

One row per request: queue-wait seconds, decode chip-seconds (each
decode chunk's wall time split by live slot share, so the rows sum back
to the measured decode wall), KV page-seconds (pages held x chunk
duration), prefix tokens saved, wire bytes, tokens in and out.  The rows
fold into per-tenant aggregates under the reserved ``"tenant"`` input
(:data:`DEFAULT_TENANT` when a request carries none).

Bounds: the row store is an LRU of closed rows (open rows never evict;
totals survive, since aggregates fold incrementally); the tenant table
holds at most ``max_tenants`` entries, the coldest tenant folding into
:data:`OVERFLOW_TENANT`, and a space-saving sketch (:class:`SpaceSaving`)
ranks heavy hitters past that bound.

The ledger mirrors its per-tenant totals into the registry as
``usage.<field>.<tenant>`` counters (bounded by the tenant table).
Every mutator returns at once when the registry is disabled
(``TFOS_TELEMETRY=0`` / ``set_enabled(False)``).
"""

import collections
import re
import threading

from tensorflowonspark_tpu_torch.telemetry import registry as _registry
from tensorflowonspark_tpu_torch.telemetry.catalog import TENANT_COLUMN

#: Tenant assigned to requests that carry no ``"tenant"`` input.
DEFAULT_TENANT = "default"

#: Reserved tenant bucket absorbing evicted per-tenant aggregates when
#: the bounded tenant table overflows (never evicted itself).
OVERFLOW_TENANT = "__other__"

#: Resource fields carried per row and per tenant.  ``requests`` is
#: bumped once per CLOSED request; everything else accrues as charged.
#: ``chip_sec`` is DECODE chip-seconds (per-chunk wall apportioned by
#: live slot share — the rows sum back to measured decode wall);
#: ``prefill_chip_sec`` is the request's prefill program wall, split
#: out so a disaggregated engine's two programs attribute separately
#: (unified engines charge their admit dispatch wall here too).
FIELDS = (
    "requests", "tokens_in", "tokens_out", "queue_wait_sec",
    "chip_sec", "prefill_chip_sec", "page_sec", "prefix_tokens_saved",
    "wire_bytes",
)

#: Registry-mirror metric prefix: per-tenant totals publish as
#: ``usage.<field>.<tenant>`` counters, which merge across processes
#: like any counter (they sum).
MIRROR_PREFIX = "usage."

_TENANT_SAFE = re.compile(r"[^A-Za-z0-9_\-]")


def safe_tenant(tenant):
    """Tenant key → registry-safe token (no dots — the mirror name
    ``usage.<field>.<tenant>`` must split back unambiguously)."""
    out = _TENANT_SAFE.sub("_", str(tenant))
    return out or "_"


class SpaceSaving(object):
    """Bounded top-K heavy-hitter sketch (the *space-saving* algorithm:
    Metwally, Agrawal & El Abbadi, "Efficient computation of frequent
    and top-k elements in data streams").

    Keeps at most ``capacity`` ``(count, err)`` entries.  A new key
    arriving at capacity replaces the minimum entry and inherits its
    count as the overestimation error, which preserves the guarantees
    the algorithm is known for: every tracked count overestimates the
    true count by at most its ``err``, and any key whose true weight
    exceeds ``total / capacity`` is guaranteed to be tracked.
    """

    __slots__ = ("capacity", "total", "_counts", "_errs")

    def __init__(self, capacity=64):
        self.capacity = max(1, int(capacity))
        self.total = 0.0
        self._counts = {}
        self._errs = {}

    def add(self, key, weight=1.0):
        w = float(weight)
        if w <= 0.0:
            return
        self.total += w
        if key in self._counts:
            self._counts[key] += w
            return
        if len(self._counts) < self.capacity:
            self._counts[key] = w
            self._errs[key] = 0.0
            return
        victim = min(self._counts, key=self._counts.get)
        floor = self._counts.pop(victim)
        self._errs.pop(victim)
        self._counts[key] = floor + w
        self._errs[key] = floor

    def estimate(self, key):
        """``(count, err)`` — the true weight lies in
        ``[count - err, count]``; ``(0.0, 0.0)`` for untracked keys."""
        return self._counts.get(key, 0.0), self._errs.get(key, 0.0)

    def top(self, n=None):
        """``[(key, count, err)]`` heaviest first."""
        items = sorted(
            self._counts.items(), key=lambda kv: -kv[1]
        )
        if n is not None:
            items = items[:int(n)]
        return [(k, c, self._errs[k]) for k, c in items]

    def __len__(self):
        return len(self._counts)


def _zero_row():
    return {f: 0 if f in ("requests", "tokens_in", "tokens_out",
                          "prefix_tokens_saved", "wire_bytes") else 0.0
            for f in FIELDS}


class UsageLedger(object):
    """Per-request resource rows + bounded per-tenant aggregates (see
    module docstring).

    Thread-safe under one ledger-level lock: mutations are dict
    arithmetic on a handful of fields, far off any device dispatch
    path (charges happen once per decode CHUNK, not per token).

    Args:
      max_rows: bound on retained per-request rows (closed rows evict
        LRU; open rows never evict).
      max_tenants: bound on the exact per-tenant table (the coldest
        tenant folds into :data:`OVERFLOW_TENANT` past it).
      sketch_capacity: :class:`SpaceSaving` entry bound (defaults to
        ``2 * max_tenants``).
      registry: metrics registry for the per-tenant mirror counters
        (default: the process registry — which also supplies the
        enabled flag).
    """

    def __init__(self, max_rows=4096, max_tenants=32,
                 sketch_capacity=None, registry=None):
        self.max_rows = max(1, int(max_rows))
        self.max_tenants = max(1, int(max_tenants))
        self._registry = registry
        self._lock = threading.Lock()
        self._rows = collections.OrderedDict()  # rid -> row dict
        self._tenants = {}                      # tenant -> totals dict
        self.sketch = SpaceSaving(
            sketch_capacity or 2 * self.max_tenants
        )
        self.rows_evicted = 0
        #: conservation remainder: the resource fields of every row
        #: that left the bounded table (LRU eviction, or a closed rid
        #: re-opened fresh) fold in here, so ``sum(rows()) + evicted_
        #: totals`` stays exact at any traffic volume
        self.evicted_totals = _zero_row()
        self.tenants_folded = 0
        self._mirror = {}  # (field, tenant) -> registry Counter
        #: tri-state override: None follows the registry's enabled
        #: flag (the TFOS_TELEMETRY story); True/False pins the
        #: ledger independently (the bench isolates the ledger's own
        #: increment this way)
        self.enabled_override = None

    # -- enable story ---------------------------------------------------

    def _reg(self):
        if self._registry is None:
            # resolve the process registry once — the enabled flag is
            # read off the cached object (set_enabled flips the flag,
            # not the object)
            self._registry = _registry.get_registry()
        return self._registry

    @property
    def enabled(self):
        if self.enabled_override is not None:
            return self.enabled_override
        return self._reg().enabled

    # -- row lifecycle --------------------------------------------------

    def _tenant_totals(self, tenant):
        t = self._tenants.get(tenant)
        if t is None:
            if (len(self._tenants) >= self.max_tenants
                    and tenant != OVERFLOW_TENANT):
                self._fold_coldest()
            t = self._tenants[tenant] = _zero_row()
        return t

    def _fold_coldest(self):
        """Fold the lightest tenant (by token weight) into the
        overflow bucket to free a table slot."""
        victims = [k for k in self._tenants if k != OVERFLOW_TENANT]
        if not victims:
            return
        victim = min(
            victims,
            key=lambda k: (self._tenants[k]["tokens_in"]
                           + self._tenants[k]["tokens_out"]),
        )
        vt = self._tenants.pop(victim)
        other = self._tenant_totals(OVERFLOW_TENANT)
        for f in FIELDS:
            other[f] += vt[f]
            self._mirror_inc(f, OVERFLOW_TENANT, vt[f])
        self.tenants_folded += 1

    def _mirror_inc(self, field, tenant, delta):
        if not delta:
            return
        key = (field, tenant)
        c = self._mirror.get(key)
        if c is None:
            c = self._mirror[key] = self._reg().counter(
                MIRROR_PREFIX + field + "." + safe_tenant(tenant)
            )
        c.inc(delta)

    def _apply(self, row, field, delta):
        """Add ``delta`` to a row field AND the row's tenant totals
        (plus the registry mirror) — the one write path, so rows,
        tenant aggregates, and the fleet mirror can never drift."""
        if not delta:
            return
        row[field] += delta
        t = self._tenant_totals(row[TENANT_COLUMN])
        t[field] += delta
        self._mirror_inc(field, row[TENANT_COLUMN], delta)
        if field in ("tokens_in", "tokens_out"):
            # heavy-hitter sketch weighs tenants by token volume
            self.sketch.add(row[TENANT_COLUMN], delta)

    def _retag(self, row, tenant):
        """Name a row's tenant.  Only a row with NOTHING accrued yet
        retags (every open path names the tenant before any charge);
        once usage has landed on a tenant it stays there — moving it
        would rewind the monotonic mirror counters, which the health
        plane would read as a process restart."""
        if row[TENANT_COLUMN] == tenant:
            return
        if any(row[f] for f in FIELDS):
            return
        row[TENANT_COLUMN] = tenant

    def _get_or_create(self, rid, fresh_if_closed=False):
        row = self._rows.get(rid)
        if row is not None and not (fresh_if_closed and row["closed"]):
            self._rows.move_to_end(rid)
            return row
        row = dict(_zero_row(), rid=str(rid), tenant=DEFAULT_TENANT,
                   closed=False, latency_sec=0.0, redispatches=0)
        if rid in self._rows:
            # a closed rid re-opening fresh: its prior incarnation's
            # charges leave the table — fold them into the remainder
            # so the conservation law (rows + evicted_totals) holds
            self._fold_evicted(self._rows.pop(rid))
        self._rows[rid] = row
        self._evict_rows()
        return row

    def _fold_evicted(self, row):
        for f in FIELDS:
            self.evicted_totals[f] += row.get(f, 0)

    def _evict_rows(self):
        while len(self._rows) > self.max_rows:
            victim = next(
                (k for k, r in self._rows.items() if r["closed"]), None
            )
            if victim is None:
                return  # everything open: never drop a live request
            self._fold_evicted(self._rows.pop(victim))
            self.rows_evicted += 1

    def open(self, rid, tenant=None, tokens_in=None, wire_bytes=0,
             prefix_tokens_saved=0, queue_wait_sec=0.0):
        """Open (or re-open) the request row ``rid``.

        Set-if-unset semantics for ``tenant``/``tokens_in`` (the fleet
        router opens first with the user-facing prompt; a replica
        engine re-opening a re-dispatched request — whose engine-level
        prompt includes committed tokens — must not inflate them);
        additive for the wear fields.  A CLOSED row re-opens fresh
        (the rid namespace recycles across jobs)."""
        if not self.enabled:
            return
        with self._lock:
            row = self._get_or_create(rid, fresh_if_closed=True)
            if tenant is not None:
                self._retag(row, str(tenant))
            if tokens_in is not None and row["tokens_in"] == 0:
                self._apply(row, "tokens_in", int(tokens_in))
            self._apply(row, "wire_bytes", int(wire_bytes))
            self._apply(row, "prefix_tokens_saved",
                        int(prefix_tokens_saved))
            self._apply(row, "queue_wait_sec", float(queue_wait_sec))

    def charge(self, rid, chip_sec=0.0, page_sec=0.0):
        """Accrue decode cost onto an open row (per decode chunk: the
        chunk's wall time over the live slot count, and pages-held ×
        chunk duration)."""
        if not self.enabled:
            return
        with self._lock:
            row = self._get_or_create(rid)
            self._apply(row, "chip_sec", float(chip_sec))
            self._apply(row, "page_sec", float(page_sec))

    def redispatch(self, rid):
        """Count a fleet re-dispatch against the row (a replica's death:
        the row keeps accruing on the surviving replica)."""
        if not self.enabled:
            return
        with self._lock:
            self._get_or_create(rid)["redispatches"] += 1

    def close(self, rid, tokens_out=None, latency_sec=None,
              chip_sec=0.0, page_sec=0.0):
        """Close (or re-close) ``rid``.  ``tokens_out`` uses
        ASSIGNMENT semantics with delta correction: a replica engine
        closes with its continuation count, the fleet router re-closes
        with the merged committed+continuation total, and the tenant
        aggregate lands on the final value exactly once.
        ``chip_sec``/``page_sec`` additively flush decode cost the
        caller accrued locally (the engine batches per-chunk charges
        and settles them here — one lock crossing per request)."""
        if not self.enabled:
            return
        with self._lock:
            row = self._get_or_create(rid)
            self._apply(row, "chip_sec", float(chip_sec))
            self._apply(row, "page_sec", float(page_sec))
            if tokens_out is not None:
                self._apply(row, "tokens_out",
                            int(tokens_out) - row["tokens_out"])
            if latency_sec is not None:
                row["latency_sec"] = float(latency_sec)
            if not row["closed"]:
                row["closed"] = True
                self._apply(row, "requests", 1)

    def settle(self, rid, tenant=None, tokens_in=None, wire_bytes=0,
               prefix_tokens_saved=0, queue_wait_sec=0.0, chip_sec=0.0,
               prefill_chip_sec=0.0, page_sec=0.0, tokens_out=None,
               latency_sec=None, close=True):
        """Open-accrue-close in ONE lock crossing — the serving
        engine's shape: it accumulates a request's admission fields
        and per-chunk decode cost on its own (lock-free) request
        record and settles the ledger once at the terminal point, so
        the cost plane never taxes the decode cadence.  Semantics
        match :meth:`open` (set-if-unset tenant/tokens_in, additive
        wear fields) + :meth:`close` (assignment-with-delta
        ``tokens_out``); ``close=False`` leaves the row open (the
        replica-death wreckage flush — the surviving replica
        continues the row)."""
        if not self.enabled:
            return
        with self._lock:
            # fresh-if-closed: a settle is always a NEW or CONTINUING
            # request — engine-local rids recycle across jobs, and a
            # previous job's closed row must never absorb this one
            # (re-close corrections go through :meth:`close`)
            row = self._get_or_create(rid, fresh_if_closed=True)
            if tenant is not None:
                self._retag(row, str(tenant))
            if tokens_in is not None and row["tokens_in"] == 0:
                self._apply(row, "tokens_in", int(tokens_in))
            self._apply(row, "wire_bytes", int(wire_bytes))
            self._apply(row, "prefix_tokens_saved",
                        int(prefix_tokens_saved))
            self._apply(row, "queue_wait_sec", float(queue_wait_sec))
            self._apply(row, "chip_sec", float(chip_sec))
            self._apply(row, "prefill_chip_sec", float(prefill_chip_sec))
            self._apply(row, "page_sec", float(page_sec))
            if tokens_out is not None:
                self._apply(row, "tokens_out",
                            int(tokens_out) - row["tokens_out"])
            if latency_sec is not None:
                row["latency_sec"] = float(latency_sec)
            if close and not row["closed"]:
                row["closed"] = True
                self._apply(row, "requests", 1)

    def record(self, rid, tenant=None, tokens_in=0, tokens_out=0,
               latency_sec=None, wire_bytes=0):
        """One-shot open+close (the static schedule's row shape: no
        chunk accounting, just tokens/latency/tenant)."""
        self.settle(rid, tenant=tenant, tokens_in=tokens_in,
                    wire_bytes=wire_bytes, tokens_out=tokens_out,
                    latency_sec=latency_sec)

    # -- introspection --------------------------------------------------

    def row(self, rid):
        with self._lock:
            r = self._rows.get(rid)
            return dict(r) if r is not None else None

    def rows(self, tenant=None, limit=None):
        """Newest-last per-request rows (optionally one tenant's)."""
        with self._lock:
            out = [dict(r) for r in self._rows.values()
                   if tenant is None or r[TENANT_COLUMN] == tenant]
        if limit is not None:
            out = out[-int(limit):]
        return out

    def tenants(self):
        """``{tenant: totals}`` — a copy of the aggregate table."""
        with self._lock:
            return {t: dict(v) for t, v in self._tenants.items()}

    def top(self, n=10):
        """Heavy hitters by token weight: ``[(tenant, est, err)]``
        from the space-saving sketch (survives table overflow)."""
        with self._lock:
            return self.sketch.top(n)

    def snapshot(self):
        """Plain-dict export mirroring ``registry.snapshot()``'s
        spirit: JSON-serializable, delta-able
        (:func:`snapshot_delta`), mergeable (:func:`merge_usage`)."""
        with self._lock:
            return {
                "tenants": {t: dict(v) for t, v in self._tenants.items()},
                "requests_tracked": len(self._rows),
                "rows_evicted": self.rows_evicted,
                "evicted_totals": dict(self.evicted_totals),
                "tenants_folded": self.tenants_folded,
                "top": [
                    [k, round(c, 6), round(e, 6)]
                    for k, c, e in self.sketch.top(10)
                ],
            }


def snapshot_delta(cur, base):
    """``cur - base`` over two :meth:`UsageLedger.snapshot` dicts —
    the per-job / per-bench-window accounting primitive (the
    registry's ``snapshot_delta`` rule, applied to tenant tables)."""
    base = base or {}
    bt = base.get("tenants", {})
    tenants = {}
    for t, v in (cur.get("tenants") or {}).items():
        b = bt.get(t, {})
        d = {f: v.get(f, 0) - b.get(f, 0) for f in FIELDS}
        if any(d.values()):
            tenants[t] = d
    return {
        "tenants": tenants,
        "requests_tracked": cur.get("requests_tracked", 0),
        "rows_evicted": (cur.get("rows_evicted", 0)
                         - base.get("rows_evicted", 0)),
        "tenants_folded": (cur.get("tenants_folded", 0)
                           - base.get("tenants_folded", 0)),
        "top": cur.get("top", []),
    }


def merge_usage(snapshots):
    """Fold per-executor ledger snapshots into one fleet view
    (tenant fields sum — the ``merge_snapshots`` counter rule)."""
    tenants = {}
    evicted = folded = tracked = 0
    for snap in snapshots:
        if not snap:
            continue
        for t, v in (snap.get("tenants") or {}).items():
            agg = tenants.setdefault(t, _zero_row())
            for f in FIELDS:
                agg[f] += v.get(f, 0)
        tracked += snap.get("requests_tracked", 0)
        evicted += snap.get("rows_evicted", 0)
        folded += snap.get("tenants_folded", 0)
    top = sorted(
        ((t, v["tokens_in"] + v["tokens_out"]) for t, v in tenants.items()),
        key=lambda kv: -kv[1],
    )
    return {
        "tenants": tenants,
        "requests_tracked": tracked,
        "rows_evicted": evicted,
        "tenants_folded": folded,
        "top": [[t, w, 0.0] for t, w in top[:10]],
    }


def tenants_from_snapshot(snapshot):
    """Recover the per-tenant table from a registry snapshot's mirror
    counters (``usage.<field>.<tenant>``): a merged fleet snapshot gives
    the fleet-wide table without a second wire format."""
    tenants = {}
    for name, v in (snapshot or {}).get("counters", {}).items():
        if not name.startswith(MIRROR_PREFIX):
            continue
        parts = name[len(MIRROR_PREFIX):].split(".", 1)
        if len(parts) != 2 or parts[0] not in FIELDS:
            continue
        field, tenant = parts
        t = tenants.setdefault(tenant, _zero_row())
        t[field] = v
    return tenants


def chip_sec_per_token(rows, min_tokens=1):
    """``{key: chip_sec / tokens_out}`` over a table of cost rows (a
    tenant table, as :func:`tenants_from_snapshot` gives).  Rows with
    fewer than ``min_tokens`` emitted are skipped: a cold row's ratio is
    all prefill."""
    out = {}
    for key, row in (rows or {}).items():
        toks = int(row.get("tokens_out", 0))
        if toks < max(1, int(min_tokens)):
            continue
        out[key] = float(row.get("chip_sec", 0.0)) / toks
    return out


def _fmt(v):
    """OpenMetrics number text: integers bare, floats by ``repr`` (full
    precision)."""
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


def usage_openmetrics(tenants):
    """Per-tenant totals as OpenMetrics counters with a ``tenant`` label
    (the reference's ``/usage`` route body; its cardinality is bounded
    by the ledger's tenant table)."""
    lines = []
    for field in FIELDS:
        om = "usage_" + field
        lines.append("# TYPE {0} counter".format(om))
        for tenant in sorted(tenants):
            lines.append('{0}_total{{tenant="{1}"}} {2}'.format(
                om, safe_tenant(tenant), _fmt(tenants[tenant][field])
            ))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


_GLOBAL = None
_GLOBAL_LOCK = threading.Lock()


def get_ledger():
    """The process-wide usage ledger every serving surface charges
    into (same enable story as the default registry)."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = UsageLedger()
    return _GLOBAL
