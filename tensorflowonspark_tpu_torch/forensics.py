"""Post-mortem incident forensics: timeline and critical-path analyzer
(port of the JAX package's ``forensics.py``).

The read side of the forensics plane.  Input is whatever an incident
left behind: flight-recorder bundles (:mod:`.telemetry.blackbox`),
journal JSONL files (:mod:`.telemetry.journal`), or a
``TPUCluster.journal()`` export.  The output is an incident report::

    python -m tensorflowonspark_tpu_torch.forensics explain DUMP_OR_DIR \\
        [--out report.txt] [--trace merged.json] [--json]

The report reconstructs, across every executor found in the sources:

- the **clock-aligned timeline**: each source's events shifted onto the
  reference (driver) clock by the heartbeat-RTT offset estimates
  (``ClockSync`` samples in ``TPUCluster.journal()`` exports), so that
  cross-executor order is causal;
- the **triggering event**, the first fault-class event of the aligned
  timeline, and the **suspected fault kind** it implies in the chaos
  plan's vocabulary (:data:`FAULT_MAP`: ``watchdog_fire`` is a wedged
  dispatch, ``prefill_worker_dead`` a killed prefill worker, ...), with
  the affected executor;
- the **critical path** through the span tree of the busiest trace (or
  of the p99 exemplar's, or of ``--request``): the chain of spans that
  set the end-to-end latency, each link's own share, and the dominant
  phase;
- the **p99 exemplars**: trace ids the shared request-latency
  histogram kept on its tail buckets (bundles carry its snapshot);
- the **remediation** and **config change** sections: the journal
  events of those planes (:data:`REMEDIATION_KINDS`,
  :data:`PLANNER_KINDS`), read like any other events;
- optionally a **merged Chrome trace** (``--trace``,
  :func:`~.telemetry.tracing.merge_traces`).

Everything here is host work on dicts, with neither ``torch`` nor a
cluster nor a network: the analyzer runs on a laptop against files
copied off a dead fleet.  Reports equal the JAX package's on the same
files.
"""

import argparse
import glob
import json
import os
import sys

from tensorflowonspark_tpu_torch.telemetry import blackbox as _blackbox
from tensorflowonspark_tpu_torch.telemetry import journal as _journal
from tensorflowonspark_tpu_torch.telemetry import registry as _reg
from tensorflowonspark_tpu_torch.telemetry import tracing as _tracing

#: The shared request-latency histogram (serving_engine.LATENCY_METRIC,
#: spelled out so that the analyzer imports no torch): its tail-bucket
#: exemplars carry trace ids, which is how ``explain`` names the p99
#: request and pulls its merged trace.
LATENCY_METRIC = "serving.request_latency_sec"

#: Event kinds that open an incident, in the order a timeline scan
#: trusts them (the first of these on the aligned timeline is the
#: *triggering event*).
FAULT_KINDS = (
    "watchdog_fire",
    "leader_failover",
    "executor_dead",
    "restart_budget_exhausted",
    "restart",
    "executor_restart",
    "swap_rollback",
    "replica_dead",
    "replica_quarantined",
    "prefill_worker_dead",
    "prefill_watchdog_fire",
    "lease_reaped",
    "remediation_budget_exhausted",
    "straggler_flagged",
    "alert_firing",
)

#: Remediation-plane event kinds: the policy engine's audited decisions
#: and guardrail events.  Rendered as their own
#: report section — a decision is a RESPONSE, not a trigger (except
#: budget exhaustion, which is an incident and sits in FAULT_KINDS).
REMEDIATION_KINDS = (
    "remediation_decision",
    "remediation_deferred",
    "remediation_budget_exhausted",
    "remediation_rearmed",
)

#: Planner-plane event kinds: the cost-model planner's
#: startup decision, the live re-planner's audited config changes,
#: and the engine's between-chunk knob retunes.  Rendered as their
#: own report section so ``explain`` answers "why did the config
#: change?" with the triggering evidence.
PLANNER_KINDS = (
    "planner_decision",
    "replan",
    "engine_retune",
    "push_every_retune",
)

#: Triggering event kind → the injected/root fault it implies (the
#: chaos-plan vocabulary, testing/chaos.py — so an ``explain`` over a
#: chaos run names the injected fault, and a real incident names its
#: closest analogue).
FAULT_MAP = {
    "watchdog_fire": "wedge_dispatch",
    "watchdog_recover": "wedge_dispatch",
    "leader_failover": "kill_leader",
    "executor_dead": "kill",
    "restart": "kill",
    "executor_restart": "kill",
    "restart_budget_exhausted": "kill",
    "swap_rollback": "corrupt_checkpoint",
    "checkpoint_quarantined": "corrupt_checkpoint",
    "alert_firing": "slo_burn",
    "straggler_flagged": "slow_executor",
    "replica_dead": "kill_replica",
    "replica_quarantined": "device_error",
    "prefill_worker_dead": "kill_prefill",
    "prefill_watchdog_fire": "wedge_prefill",
    "lease_reaped": "leak_lease",
    "remediation_budget_exhausted": "remediation_runaway",
}


# ----------------------------------------------------------------------
# source loading
# ----------------------------------------------------------------------


def load_sources(paths):
    """Normalize input files into source dicts.

    Accepts, per path: a flight-recorder bundle (``.json`` with the
    blackbox format tag), a ``TPUCluster.journal()`` export (``.json``
    with ``events``/``clocks``), a journal JSONL file, or a directory
    (every ``*.json``/``*.jsonl`` inside).  Returns
    ``[{"path", "executor", "pid", "events": [dict], "spans": [dict],
    "epoch_wall": float|None, "offset": float}]`` — ``offset`` is
    pre-filled from the source's own clock data when it has any
    (journal exports carry the fleet ClockSync snapshot) and 0.0
    otherwise.
    """
    files = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            files.extend(sorted(
                glob.glob(os.path.join(p, "*.json"))
                + glob.glob(os.path.join(p, "*.jsonl"))
            ))
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(
            "no dump/journal files under {0!r}".format(list(paths))
        )
    sources = []
    for f in files:
        if f.endswith(".jsonl"):
            events = [e.to_dict() for e in _journal.load_journal(f)]
            sources.append(_source(f, events=events))
            continue
        with open(f) as fh:
            try:
                data = json.load(fh)
            except ValueError:
                continue
        if not isinstance(data, dict):
            continue
        if data.get("format") == _blackbox.BUNDLE_FORMAT:
            sources.append(_source(
                f,
                executor=data.get("executor"),
                pid=data.get("pid"),
                events=data.get("events") or [],
                spans=data.get("spans") or [],
                epoch_wall=(data.get("clock") or {}).get("epoch_wall"),
                metrics=data.get("metrics"),
            ))
        elif "events" in data:
            # a TPUCluster.journal() export: fleet events with the
            # ClockSync snapshot — split per executor so each slice
            # gets its own offset
            clocks = data.get("clocks") or {}
            by_exec = {}
            for ev in data["events"]:
                by_exec.setdefault(ev.get("executor"), []).append(ev)
            for eid, evs in sorted(
                by_exec.items(), key=lambda kv: str(kv[0])
            ):
                clk = clocks.get(str(eid)) or {}
                sources.append(_source(
                    f, executor=eid, events=evs,
                    offset=float(clk.get("offset", 0.0) or 0.0),
                ))
    return sources


def _source(path, executor=None, pid=None, events=None, spans=None,
            epoch_wall=None, offset=0.0, metrics=None):
    if executor is None and events:
        execs = {e.get("executor") for e in events}
        execs.discard(None)
        if len(execs) == 1:
            executor = execs.pop()
    return {
        "path": path, "executor": executor, "pid": pid,
        "events": events or [], "spans": spans or [],
        "epoch_wall": epoch_wall, "offset": float(offset),
        "metrics": metrics,
    }


# ----------------------------------------------------------------------
# timeline alignment
# ----------------------------------------------------------------------


def build_timeline(sources, offsets=None):
    """Merge every source's events onto the reference clock.

    ``offsets`` optionally maps executor id → offset seconds
    (overriding per-source offsets — e.g. a fresher ClockSync
    snapshot).  Returns time-sorted entries
    ``[{"t", "executor", "kind", "severity", "trace", "attrs"}]``
    with ``t`` on the aligned (driver) clock.  Duplicate events (the
    same (executor, pid, seq) arriving via both a dump bundle and the
    fleet journal) collapse to one entry."""
    offsets = offsets or {}
    seen = set()
    out = []
    for src in sources:
        off = src["offset"]
        eid = src["executor"]
        for key in (eid, str(eid)):
            if key in offsets:
                off = float(offsets[key])
                break
        for ev in src["events"]:
            if not isinstance(ev, dict) or "ts" not in ev:
                continue
            executor = ev.get("executor", eid)
            seq = ev.get("seq", 0)
            if seq:
                dedup = (executor, ev.get("pid", 0), seq)
                if dedup in seen:
                    continue
                seen.add(dedup)
            out.append({
                "t": float(ev["ts"]) + off,
                "executor": executor,
                "kind": ev.get("kind", "?"),
                "severity": ev.get("severity", "info"),
                "trace": ev.get("trace"),
                "attrs": ev.get("attrs") or {},
            })
    out.sort(key=lambda e: e["t"])
    return out


# ----------------------------------------------------------------------
# critical path
# ----------------------------------------------------------------------


def critical_path(spans):
    """The chain of spans that determined end-to-end latency.

    Spans are tracer records (``t0``/``dur`` relative seconds, ``id``/
    ``parent`` tree links).  The walk starts at the root whose
    interval ends last and repeatedly descends into the child that
    ends last — the link that *released* its parent; each link's
    ``self_sec`` is the part of its duration the next link down does
    not explain.  Returns ``{"path": [{"name", "t0", "dur",
    "self_sec", "trace"}], "total_sec", "dominant_phase"}`` (empty
    path for no spans).  Zero-duration marks are excluded — they are
    events, not work."""
    timed = [s for s in spans if s.get("dur", 0.0) > 0.0]
    if not timed:
        return {"path": [], "total_sec": 0.0, "dominant_phase": None}
    children = {}
    ids = {s.get("id") for s in timed}
    roots = []
    for s in timed:
        parent = s.get("parent")
        if parent in ids:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)

    def end(s):
        return s["t0"] + s["dur"]

    cur = max(roots, key=end)
    path = [cur]
    while True:
        kids = children.get(cur.get("id"))
        if not kids:
            break
        cur = max(kids, key=end)
        path.append(cur)
    out = []
    contrib = {}
    for i, s in enumerate(path):
        nxt = path[i + 1]["dur"] if i + 1 < len(path) else 0.0
        self_sec = max(0.0, s["dur"] - nxt)
        out.append({
            "name": s["name"], "t0": s["t0"], "dur": s["dur"],
            "self_sec": self_sec, "trace": s.get("trace"),
        })
        contrib[s["name"]] = contrib.get(s["name"], 0.0) + self_sec
    dominant = max(contrib.items(), key=lambda kv: kv[1])[0]
    return {
        "path": out,
        "total_sec": path[0]["dur"],
        "dominant_phase": dominant,
    }


def _busiest_trace(spans):
    """The trace id with the most recorded span time (the incident's
    busiest request/step — where the critical path is computed)."""
    totals = {}
    for s in spans:
        t = s.get("trace")
        if t is not None:
            totals[t] = totals.get(t, 0.0) + s.get("dur", 0.0)
    if not totals:
        return None
    return max(totals.items(), key=lambda kv: kv[1])[0]


# ----------------------------------------------------------------------
# the explain report
# ----------------------------------------------------------------------


def latency_exemplars(sources, q=99):
    """Tail-latency exemplars found in the sources' registry
    snapshots (flight-recorder bundles carry one): each names the
    TRACE id of a request that actually lives at/above the ``q``-th
    percentile of the shared request-latency histogram.  Newest-
    heaviest first, deduped by trace id."""
    out = []
    seen = set()
    for src in sources:
        snap = ((src.get("metrics") or {}).get("histograms") or {}).get(
            LATENCY_METRIC
        )
        for ex in _reg.tail_exemplars(snap, q):
            if ex["ref"] in seen:
                continue
            seen.add(ex["ref"])
            out.append(dict(ex, source=src["path"]))
    out.sort(key=lambda e: -e["value"])
    return out


def explain(paths, offsets=None, request=None):
    """Analyze dump/journal sources into one incident report dict.

    Keys: ``incident`` (fault_kind / trigger kind / executor /
    severity / t), ``timeline`` (aligned entries), ``critical_path``,
    ``events_by_kind``, ``executors``, ``window_sec``, ``sources``,
    and ``p99_exemplars`` — tail-latency trace ids found in the
    sources' registry snapshots (the shared latency histogram keeps
    trace-id exemplars on its tail buckets, so the report can name the
    p99 request).  ``request`` pins the
    critical-path analysis to ONE trace id (e.g. a reported
    exemplar); when omitted and tail exemplars exist with recorded
    spans, the heaviest exemplar's trace is preferred over the
    busiest-trace heuristic.
    """
    sources = load_sources(
        paths if isinstance(paths, (list, tuple)) else [paths]
    )
    timeline = build_timeline(sources, offsets=offsets)
    counts = {}
    for ev in timeline:
        counts[ev["kind"]] = counts.get(ev["kind"], 0) + 1
    trigger = next(
        (ev for ev in timeline if ev["kind"] in FAULT_KINDS), None
    )
    if trigger is None:
        trigger = next(
            (ev for ev in timeline if ev["severity"] == "page"), None
        )
    incident = None
    if trigger is not None:
        incident = {
            "fault_kind": FAULT_MAP.get(trigger["kind"], trigger["kind"]),
            "trigger": trigger["kind"],
            "executor": trigger["executor"],
            "severity": trigger["severity"],
            "t": trigger["t"],
            "attrs": trigger["attrs"],
        }
    # the critical path comes from: the caller-pinned request, else
    # the heaviest tail-latency exemplar with recorded spans (the p99
    # request the histogram named), else the busiest trace (usually
    # the dump bundle of the faulted process)
    spans = []
    for src in sources:
        spans.extend(src["spans"])
    exemplars = latency_exemplars(sources)
    span_traces = {s.get("trace") for s in spans}
    trace_id = request
    if trace_id is None:
        trace_id = next(
            (ex["ref"] for ex in exemplars if ex["ref"] in span_traces),
            None,
        )
    if trace_id is None:
        trace_id = _busiest_trace(spans)
    cp = critical_path(
        [s for s in spans if trace_id is None or s.get("trace") == trace_id]
    )
    cp["trace"] = trace_id
    faults = [ev for ev in timeline if ev["kind"] in FAULT_KINDS]
    # the remediation plane's audited decisions: what the
    # policy engine did — or deliberately did not do — about the
    # faults above, with the triggering evidence it journaled
    remediation = [
        ev for ev in timeline if ev["kind"] in REMEDIATION_KINDS
    ]
    # the planner plane's audited decisions: why the config
    # is what it is, and why (and on what evidence) it changed live
    config_changes = [
        ev for ev in timeline if ev["kind"] in PLANNER_KINDS
    ]
    return {
        "incident": incident,
        "timeline": timeline,
        "critical_path": cp,
        "p99_exemplars": exemplars,
        "events_by_kind": counts,
        "faults": faults,
        "remediation": remediation,
        "config_changes": config_changes,
        "executors": sorted(
            {ev["executor"] for ev in timeline
             if ev["executor"] is not None},
            key=str,
        ),
        "window_sec": (
            round(timeline[-1]["t"] - timeline[0]["t"], 6)
            if len(timeline) > 1 else 0.0
        ),
        "sources": [s["path"] for s in sources],
    }


def merged_chrome(paths, offsets=None, request=None):
    """One Perfetto-loadable Chrome trace over every source with
    spans, clock-aligned (see
    :func:`~.telemetry.tracing.merge_traces`).
    ``request`` filters to ONE trace id — the merged cross-executor
    story of a single request (e.g. a p99 exemplar)."""
    sources = load_sources(
        paths if isinstance(paths, (list, tuple)) else [paths]
    )
    offsets = offsets or {}
    parts = []
    for src in sources:
        src = dict(src)
        if request is not None:
            src["spans"] = [
                s for s in src["spans"] if s.get("trace") == request
            ]
        if not src["spans"]:
            continue
        off = offsets.get(src["executor"], src["offset"])
        # span t0 is relative to the tracer epoch; epoch_wall anchors
        # it on the wall clock, the offset aligns executors — merged
        # ts therefore share one absolute timebase (large, but Chrome
        # renders relative to the trace minimum)
        base = src["epoch_wall"] or 0.0
        trace = {"traceEvents": [
            {
                "name": s["name"], "ph": "X",
                "ts": round((base + s["t0"]) * 1e6, 3),
                "dur": round(s.get("dur", 0.0) * 1e6, 3),
                "pid": src.get("pid") or 0,
                "tid": s.get("tid", 0),
                "args": dict(
                    s.get("attrs") or {},
                    **{k: s[k] for k in ("trace", "severity")
                       if s.get(k) is not None}
                ),
            }
            for s in src["spans"]
        ]}
        parts.append((
            trace, off,
            "executor{0}".format(src["executor"])
            if src["executor"] is not None
            else os.path.basename(src["path"]),
        ))
    return _tracing.merge_traces(parts)


def render_report(report):
    """The human-readable rendering of an :func:`explain` report."""
    lines = ["== incident forensics =="]
    inc = report.get("incident")
    if inc is not None:
        lines.append(
            "suspected fault : {0} (triggering event: {1}, severity "
            "{2})".format(inc["fault_kind"], inc["trigger"],
                          inc["severity"])
        )
        lines.append(
            "affected        : executor {0}".format(inc["executor"])
        )
    else:
        lines.append("suspected fault : none found (no fault-class "
                     "events in the sources)")
    lines.append(
        "executors seen  : {0}".format(
            ", ".join(str(e) for e in report["executors"]) or "-"
        )
    )
    lines.append(
        "window          : {0:.3f}s, {1} events".format(
            report["window_sec"], len(report["timeline"])
        )
    )
    for ex in report.get("p99_exemplars", [])[:3]:
        lines.append(
            "p99 exemplar    : trace {0!r} at {1:.1f}ms (bucket <= "
            "{2})".format(
                ex["ref"], 1e3 * ex["value"],
                "inf" if ex.get("bucket_hi") is None
                else "%.4fs" % ex["bucket_hi"],
            )
        )
    cp = report["critical_path"]
    if cp["path"]:
        lines.append("critical path   : trace {0!r}, {1:.6f}s total, "
                     "dominant phase {2!r}".format(
                         cp.get("trace"), cp["total_sec"],
                         cp["dominant_phase"]))
        for link in cp["path"]:
            lines.append(
                "    {0:<24} dur {1:>10.6f}s  self {2:>10.6f}s".format(
                    link["name"], link["dur"], link["self_sec"]
                )
            )
    else:
        lines.append("critical path   : no timed spans in the sources")
    rem = report.get("remediation") or []
    if rem:
        lines.append("-- remediation decisions (why did the fleet do "
                     "that?) --")
        t0r = report["timeline"][0]["t"] if report["timeline"] else 0.0
        for ev in rem[:20]:
            attrs = ev.get("attrs") or {}
            if ev["kind"] == "remediation_decision":
                desc = "{0} by {1}{2}{3}".format(
                    attrs.get("action"), attrs.get("policy"),
                    " on {0}".format(attrs["target"])
                    if attrs.get("target") else "",
                    "" if attrs.get("executed")
                    else (" [dry-run]" if attrs.get("dry_run")
                          else " [not executed]"),
                )
                evidence = attrs.get("evidence")
                if evidence:
                    desc += "  evidence: {0}".format(
                        json.dumps(evidence, sort_keys=True)[:160]
                    )
                if attrs.get("reason"):
                    desc += "  ({0})".format(attrs["reason"])
            else:
                desc = "{0} {1}".format(
                    ev["kind"],
                    json.dumps(attrs, sort_keys=True)[:120]
                    if attrs else "",
                ).rstrip()
            lines.append(
                "    +{0:>9.3f}s  [{1:>4}] {2}".format(
                    ev["t"] - t0r, ev["severity"], desc
                )
            )
    cfg = report.get("config_changes") or []
    if cfg:
        lines.append("-- config changes (why did the config "
                     "change?) --")
        t0c = report["timeline"][0]["t"] if report["timeline"] else 0.0
        for ev in cfg[:20]:
            attrs = ev.get("attrs") or {}
            if ev["kind"] == "planner_decision":
                desc = (
                    "planned {0}: {1}  (gap to runner-up {2}%, "
                    "profile: {3})".format(
                        attrs.get("workload"),
                        json.dumps(attrs.get("chosen") or {},
                                   sort_keys=True)[:160],
                        attrs.get("gap_pct"),
                        attrs.get("profile_source"),
                    )
                )
            elif ev["kind"] == "replan":
                desc = "replan [{0}] {1}: {2} -> {3}{4}".format(
                    attrs.get("trigger"), attrs.get("knob"),
                    attrs.get("old"), attrs.get("new"),
                    "" if attrs.get("applied") else " [not applied]",
                )
                evidence = attrs.get("evidence")
                if evidence:
                    desc += "  evidence: {0}".format(
                        json.dumps(evidence, sort_keys=True)[:160]
                    )
            else:
                desc = "{0} {1}".format(
                    ev["kind"],
                    json.dumps(attrs, sort_keys=True)[:140]
                    if attrs else "",
                ).rstrip()
            lines.append(
                "    +{0:>9.3f}s  [{1:>4}] {2}".format(
                    ev["t"] - t0c, ev["severity"], desc
                )
            )
    lines.append("-- clock-aligned timeline (fault-class + page "
                 "events) --")
    shown = 0
    t0 = report["timeline"][0]["t"] if report["timeline"] else 0.0
    for ev in report["timeline"]:
        if ev["kind"] not in FAULT_KINDS and ev["severity"] == "info":
            continue
        lines.append(
            "    +{0:>9.3f}s  exec {1!s:>4}  [{2:>4}] {3} {4}".format(
                ev["t"] - t0, ev["executor"], ev["severity"],
                ev["kind"],
                json.dumps(ev["attrs"]) if ev["attrs"] else "",
            ).rstrip()
        )
        shown += 1
        if shown >= 40:
            lines.append("    ... (truncated)")
            break
    if not shown:
        lines.append("    (none)")
    return "\n".join(lines)


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m tensorflowonspark_tpu_torch.forensics",
        description=(
            "Post-mortem incident analysis over flight-recorder dumps "
            "and event journals."
        ),
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser(
        "explain", help="reconstruct the incident from dumps/journals"
    )
    ex.add_argument(
        "paths", nargs="+",
        help="dump bundle(s), journal .jsonl/.json file(s), or "
        "directories of them",
    )
    ex.add_argument(
        "--offsets",
        help="JSON file mapping executor id -> clock offset seconds "
        "(overrides offsets found in the sources)",
    )
    ex.add_argument("--out", help="also write the report text here")
    ex.add_argument(
        "--trace", help="write the merged, clock-aligned Chrome trace "
        "here (Perfetto-loadable)",
    )
    ex.add_argument(
        "--request", default=None,
        help="pin the analysis to ONE request trace id (e.g. a "
        "reported p99 exemplar): the critical path and --trace "
        "export then tell that request's cross-executor story",
    )
    ex.add_argument(
        "--json", action="store_true",
        help="print the report as JSON instead of text",
    )
    args = parser.parse_args(argv)
    offsets = None
    if args.offsets:
        with open(args.offsets) as f:
            offsets = json.load(f)
    report = explain(args.paths, offsets=offsets, request=args.request)
    text = render_report(report)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump(merged_chrome(
                args.paths, offsets=offsets, request=args.request
            ), f)
        print("merged Chrome trace written to {0}".format(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
