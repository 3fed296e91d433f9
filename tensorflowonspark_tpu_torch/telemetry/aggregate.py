"""Merging registry snapshots into one fleet view (port of the pure
functions of the JAX package's ``telemetry/aggregate.py``).

Counters sum, histograms merge bucket-wise (the fixed geometric buckets
make that exact) with their percentiles recomputed, gauges keep the
largest value.  The node publisher that ships snapshots over heartbeats
is the cluster side of the plane, not ported yet.
"""

from tensorflowonspark_tpu_torch.telemetry import registry as _registry


def merge_snapshots(snapshots):
    """Fold per-executor registry snapshots into ONE fleet snapshot.

    Counters sum; histograms merge bucket-wise (the fixed geometric
    bucket scheme makes this exact) with ``p50``/``p99`` recomputed
    over the merged counts; gauges take the max (a per-executor gauge
    summed across the fleet would be meaningless — the per-executor
    values stay available in the unmerged view).
    """
    counters = {}
    gauges = {}
    hists = {}  # name -> {"count","sum","buckets": {le: count}, min, max}
    for snap in snapshots:
        if not snap:
            continue
        for name, v in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + v
        for name, v in (snap.get("gauges") or {}).items():
            gauges[name] = max(gauges.get(name, v), v)
        for name, h in (snap.get("histograms") or {}).items():
            agg = hists.setdefault(
                name,
                {"count": 0, "sum": 0.0, "buckets": {},
                 "min": None, "max": None, "exemplars": {}},
            )
            agg["count"] += h.get("count", 0)
            agg["sum"] += h.get("sum", 0.0)
            for lo, hi, c in h.get("buckets", []):
                key = (lo, hi)
                agg["buckets"][key] = agg["buckets"].get(key, 0) + c
            for lo, hi, ex in h.get("exemplars", []) or []:
                # newest exemplar per bucket wins across executors —
                # the reference stays one concrete recent request
                key = (lo, hi)
                prev = agg["exemplars"].get(key)
                if prev is None or ex.get("ts", 0) > prev.get("ts", 0):
                    agg["exemplars"][key] = ex
            for k, pick in (("min", min), ("max", max)):
                v = h.get(k)
                if v is not None:
                    agg[k] = v if agg[k] is None else pick(agg[k], v)
    merged_h = {}
    for name, agg in hists.items():
        triples = sorted(
            ([lo, hi, c] for (lo, hi), c in agg["buckets"].items()),
            key=lambda t: t[0],
        )
        h = {
            # exact sum (registry.Histogram.snapshot carries the exact
            # running sum): the merged mean is sum/count, never
            # bucket-interpolated
            "count": agg["count"], "sum": agg["sum"],
            "min": agg["min"], "max": agg["max"], "buckets": triples,
        }
        if agg["exemplars"]:
            h["exemplars"] = sorted(
                ([lo, hi, ex] for (lo, hi), ex in agg["exemplars"].items()),
                key=lambda t: t[0],
            )
        h["p50"] = _registry.histogram_percentile(h, 50)
        h["p99"] = _registry.histogram_percentile(h, 99)
        if h["count"]:
            h["mean"] = h["sum"] / h["count"]
        merged_h[name] = h
    return {"counters": counters, "gauges": gauges,
            "histograms": merged_h}


def fleet_view(per_executor):
    """``{executor_id: {"metrics": snapshot, ...}}`` ->
    ``{"executors": <input>, "fleet": merged snapshot}`` (the shape of
    the reference's ``TPUCluster.metrics()``)."""
    return {
        "executors": per_executor,
        "fleet": merge_snapshots(
            rec.get("metrics") for rec in per_executor.values()
        ),
    }
