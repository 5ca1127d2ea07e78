"""Trace summary CLI: ``python -m repro_torch.obs trace.json``.

Prints per-phase totals, per-process busy/idle fractions, per-batch
latency quantiles, and the per-subscriber fabric publish breakdown from
an exported Chrome-trace file.  ``--validate`` checks the file against
the Chrome trace-event schema instead (exit 1 on problems), as the
JAX package's CLI does.

``summary_lines(events)`` is the library entry point:
``repro_torch.quickstart`` and ``chip_smoke.py`` print its lines.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

from repro_torch.obs.metrics import IntervalUnion
from repro_torch.obs.trace import Event, validate_chrome


def events_from_chrome(doc) -> List[Event]:
    """Invert ``to_chrome``: back to internal event tuples (seconds)."""
    procs: Dict[int, str] = {}
    threads: Dict[Tuple[int, int], str] = {}
    out: List[Event] = []
    evs = doc.get("traceEvents", [])
    for ev in evs:
        if ev.get("ph") == "M":
            if ev["name"] == "process_name":
                procs[ev["pid"]] = ev["args"]["name"]
            elif ev["name"] == "thread_name":
                threads[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    for ev in evs:
        ph = ev.get("ph")
        if ph == "M":
            continue
        proc = procs.get(ev["pid"], str(ev["pid"]))
        tid = threads.get((ev["pid"], ev["tid"]), str(ev["tid"]))
        args = dict(ev.get("args") or {})
        if "id" in ev:
            args.setdefault("id", ev["id"])
        out.append((proc, tid, ph, ev["name"], ev.get("cat", ""),
                    ev["ts"] / 1e6, ev.get("dur", 0.0) / 1e6, args or None))
    return out


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def summarize(events: List[Event]) -> dict:
    """Aggregate raw event tuples into the summary dict the CLI (and
    the train.py tail) renders."""
    phases: Dict[Tuple[str, str], Dict[str, float]] = {}
    proc_busy: Dict[str, IntervalUnion] = {}
    bounds: Dict[str, Tuple[float, float]] = {}
    batch_durs: List[float] = []
    publish: Dict[str, Dict[str, float]] = {}
    recoveries: List[dict] = []
    queue_waits: List[float] = []
    ttfh: List[float] = []
    paged = {"pages_in_use_last": 0, "pages_in_use_max": 0,
             "pages_total": 0, "radix_nodes_last": 0,
             "prefix_reuse_rows": 0, "prefix_tokens_reused": 0,
             "admission_backpressure": 0}
    instants = 0
    for proc, tid, ph, name, cat, ts, dur, args in events:
        lo, hi = bounds.get(proc, (ts, ts))
        bounds[proc] = (min(lo, ts), max(hi, ts + dur))
        if ph == "i":
            instants += 1
            # engine per-row marks: queue wait rides each harvest, time
            # to first harvest rides each batch's first finished row;
            # paged-KV gauges ride each round ("pages") and each
            # radix-hit admission ("prefix-reuse")
            if cat == "engine" and args:
                if name == "harvest-row" and "queue_wait_s" in args:
                    queue_waits.append(float(args["queue_wait_s"]))
                elif name == "first-harvest" and "ttfh_s" in args:
                    ttfh.append(float(args["ttfh_s"]))
                elif name == "pages":
                    used = int(args.get("pages_in_use", 0))
                    paged["pages_in_use_last"] = used
                    paged["pages_in_use_max"] = max(
                        paged["pages_in_use_max"], used)
                    paged["pages_total"] = int(args.get("pages_total", 0))
                    paged["radix_nodes_last"] = int(
                        args.get("radix_nodes", 0))
                elif name == "prefix-reuse":
                    paged["prefix_reuse_rows"] += 1
                    paged["prefix_tokens_reused"] += int(
                        args.get("cached_tokens", 0))
                elif name == "admission-backpressure":
                    paged["admission_backpressure"] += 1
            continue
        if ph != "X":
            continue
        key = (cat, name.split(":", 1)[0])
        agg = phases.get(key)
        if agg is None:
            agg = phases[key] = {"count": 0, "total_s": 0.0, "max_s": 0.0}
        agg["count"] += 1
        agg["total_s"] += dur
        agg["max_s"] = max(agg["max_s"], dur)
        proc_busy.setdefault(proc, IntervalUnion()).add(ts, ts + dur)
        if cat == "controller" and name == "batch":
            batch_durs.append(dur)
        if cat == "fabric" and name.startswith(("publish:", "commit:")):
            kind, sub = name.split(":", 1)
            rec = publish.setdefault(
                sub, {"count": 0, "stage_s": 0.0, "commit_s": 0.0,
                      "wait_s": 0.0})
            if kind == "publish":
                rec["count"] += 1
                for k in ("stage_s", "wait_s"):
                    rec[k] += (args or {}).get(k, 0.0)
            else:                            # stage->commit latency span
                rec["commit_s"] += dur
        if cat == "supervisor" and name == "recover":
            recoveries.append({"proc": proc, "ts": ts, "dur": dur,
                               **(args or {})})
    procs = {}
    for proc, (lo, hi) in sorted(bounds.items()):
        busy = proc_busy.get(proc)
        busy_s = busy.total if busy is not None else 0.0
        wall = hi - lo
        procs[proc] = {"wall_s": wall, "busy_s": busy_s,
                       "idle_frac": 1.0 - busy_s / wall if wall > 0 else 0.0}
    batch_durs.sort()
    queue_waits.sort()
    ttfh.sort()
    # radix hit rate: radix-hit admissions over all prefill-into-slot
    # spans (every admission opens one, hit or miss)
    admissions = sum(agg["count"] for (cat, name), agg in phases.items()
                     if cat == "engine" and name == "prefill-into-slot")
    paged["radix_hit_rate"] = (paged["prefix_reuse_rows"] / admissions
                               if admissions else 0.0)
    return {
        "events": len(events),
        "instants": instants,
        "processes": procs,
        "phases": {f"{cat}/{name}" if cat else name: agg
                   for (cat, name), agg in sorted(phases.items())},
        "batch_latency": {"count": len(batch_durs),
                          "p50_s": _quantile(batch_durs, 0.5),
                          "p99_s": _quantile(batch_durs, 0.99)},
        "engine_rows": {"harvested": len(queue_waits),
                        "queue_wait_p50_s": _quantile(queue_waits, 0.5),
                        "queue_wait_p99_s": _quantile(queue_waits, 0.99),
                        "ttfh_p50_s": _quantile(ttfh, 0.5),
                        "ttfh_p99_s": _quantile(ttfh, 0.99)},
        "paged_kv": paged,
        "publish_by_subscriber": publish,
        "recoveries": recoveries,
    }


def summary_lines(events: List[Event]) -> List[str]:
    """Human-readable summary (one string per line)."""
    s = summarize(events)
    lines = [f"trace: {s['events']} events "
             f"({s['instants']} instant) from "
             f"{len(s['processes'])} process(es)"]
    for proc, p in s["processes"].items():
        lines.append(f"  proc {proc:<18} wall={p['wall_s']:.3f}s "
                     f"busy={p['busy_s']:.3f}s idle={p['idle_frac']:.1%}")
    for name, agg in s["phases"].items():
        lines.append(f"  phase {name:<24} n={agg['count']:<5d} "
                     f"total={agg['total_s']:.3f}s max={agg['max_s']:.3f}s")
    bl = s["batch_latency"]
    if bl["count"]:
        lines.append(f"  batch latency: n={bl['count']} "
                     f"p50={bl['p50_s']:.3f}s p99={bl['p99_s']:.3f}s")
    er = s["engine_rows"]
    if er["harvested"]:
        lines.append(f"  engine rows: n={er['harvested']} "
                     f"queue-wait p50={er['queue_wait_p50_s']:.3f}s "
                     f"p99={er['queue_wait_p99_s']:.3f}s "
                     f"first-harvest p50={er['ttfh_p50_s']:.3f}s "
                     f"p99={er['ttfh_p99_s']:.3f}s")
    pk = s["paged_kv"]
    if pk["pages_total"] or pk["prefix_reuse_rows"]:
        lines.append(f"  paged kv: pages {pk['pages_in_use_last']}"
                     f"/{pk['pages_total']} in use "
                     f"(peak {pk['pages_in_use_max']}) "
                     f"radix-hit {pk['radix_hit_rate']:.1%} "
                     f"reused {pk['prefix_tokens_reused']} prefix tok "
                     f"over {pk['prefix_reuse_rows']} row(s) "
                     f"backpressure {pk['admission_backpressure']}")
    for sub, rec in s["publish_by_subscriber"].items():
        lines.append(f"  publish -> {sub:<15} n={rec['count']:<4d} "
                     f"stage={rec['stage_s']:.3f}s "
                     f"commit={rec['commit_s']:.3f}s "
                     f"wait={rec['wait_s']:.3f}s")
    for r in s["recoveries"]:
        lines.append(f"  recovery: {r.get('actor', '?')} at t={r['ts']:.3f}s "
                     f"took {r['dur']:.3f}s")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize or validate an exported Chrome-trace file.")
    ap.add_argument("trace", help="path to a --trace out.json export")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check only; exit 1 on problems")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as JSON instead of text")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    if args.validate:
        problems = validate_chrome(doc)
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        print(f"{args.trace}: "
              f"{'INVALID' if problems else 'valid Chrome trace'} "
              f"({len(doc.get('traceEvents', []))} events)")
        return 1 if problems else 0
    events = events_from_chrome(doc)
    if args.json:
        print(json.dumps(summarize(events), indent=2))
    else:
        for line in summary_lines(events):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
