"""Replay an HM_TRACE file into the busy-vs-wall stage timeline.

Takes the Chrome trace-event JSON a run wrote under HM_TRACE=<path>
(hypermerge_tpu_torch/telemetry/trace.py) and prints a per-stage
concurrency table — busy seconds per span name vs the overlapped wall
clock, so a trace from ANY run (bench, daemon, test) answers "where
did the time go" without re-running it under a profiler. The port of
scripts/profile_trace.py: the same output for the same trace.

Usage:
    python -m hypermerge_tpu_torch.tools.profile_trace /tmp/t.json
        [--by name|cat] [--top N] [--threads]

--by cat groups by subsystem (live/pipeline/net/storage/mesh/serve)
instead of span name; --threads adds a per-thread busy breakdown. The
serving tier's spans show up as `serve.read` (per-request latency,
admission to completion) and `serve.batch` (one coalesced kernel
flush) — their count ratio IS the read-batching factor.

Under HM_PACK_WORKERS>1 the pack plane fans out: each pool worker
emits its own `pipeline.pack` spans from an `hm-pipe-pack-<i>` thread,
so `--threads` draws one busy lane per pack worker (their sum past the
`pipeline.pack` row's share of the wall is the pool's realized
speedup). Device packs (HM_DEVICE_PACK=1, the pack_prefix kernel) run
inside those same spans —
whether the kernel or the host packed is in the metrics registry, not
the trace: `pack.device_packs` counts kernel-packed slabs and
`pack.device_fallbacks` counts silent host fallbacks.

Instrumented runs (HM_LOCKDEP=1 / HM_RACEDEP=1) add two instants in
the `lock` category: `lock.held_blocking` (a blocking primitive ran
while a no-block emission lock was held — each one is a stall of every
doc's patch pushes) and `lock.racedep_violation` (the lockset detector
observed a guard-manifest violation). Their counts surface in the
instants total; grep the trace JSON for the names to locate them on
the timeline.
"""

import argparse
import json
import sys
from collections import defaultdict


def load_events(path):
    with open(path) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if isinstance(e, dict)]


def timeline(events, by="name"):
    """(rows, wall_s, t0_us): rows are (key, count, busy_s) sorted by
    busy desc, over the complete ("X") events."""
    spans = [e for e in events if e.get("ph") == "X"]
    if not spans:
        return [], 0.0, 0.0
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e.get("dur", 0) for e in spans)
    wall = (t1 - t0) / 1e6
    busy = defaultdict(lambda: [0, 0.0])
    for e in spans:
        key = e.get("cat", "hm") if by == "cat" else e["name"]
        cell = busy[key]
        cell[0] += 1
        cell[1] += e.get("dur", 0) / 1e6
    rows = sorted(
        ((k, c, s) for k, (c, s) in busy.items()),
        key=lambda r: -r[2],
    )
    return rows, wall, t0


def thread_busy(events, tid_names):
    busy = defaultdict(float)
    for e in events:
        if e.get("ph") == "X":
            busy[e.get("tid")] += e.get("dur", 0) / 1e6
    return sorted(
        ((tid_names.get(t, f"tid {t}"), s) for t, s in busy.items()),
        key=lambda r: -r[1],
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m hypermerge_tpu_torch.tools.profile_trace",
        description=__doc__,
    )
    ap.add_argument("trace", help="Chrome trace JSON (HM_TRACE output)")
    ap.add_argument("--by", choices=("name", "cat"), default="name")
    ap.add_argument("--top", type=int, default=24)
    ap.add_argument(
        "--threads", action="store_true",
        help="also print per-thread busy totals",
    )
    args = ap.parse_args(argv)

    events = load_events(args.trace)
    rows, wall, _t0 = timeline(events, by=args.by)
    if not rows:
        print("no complete spans in trace", file=sys.stderr)
        sys.exit(1)
    n_instant = sum(1 for e in events if e.get("ph") == "i")
    print(
        f"trace: {sum(c for _k, c, _s in rows)} spans"
        + (f" + {n_instant} instants" if n_instant else "")
        + f", wall {wall:.3f}s"
    )
    print(f"stage timeline [busy (overlapped)] by {args.by}:")
    busy_total = 0.0
    for key, count, busy_s in rows[: args.top]:
        busy_total += busy_s
        bar = "#" * max(1, int(40 * busy_s / max(wall, 1e-9)))
        print(f"  {key:<26} {busy_s:9.3f}s x{count:<6} |{bar}")
    dropped = rows[args.top:]
    if dropped:
        rest = sum(s for _k, _c, s in dropped)
        busy_total += rest
        print(f"  (+{len(dropped)} more stages, {rest:.3f}s)")
    print(
        f"  wall {wall:.3f}s, busy total {busy_total:.3f}s -> "
        f"{busy_total / max(wall, 1e-9):.2f}x concurrency"
    )
    if args.threads:
        names = {
            e["tid"]: e["args"]["name"]
            for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"
        }
        print("per-thread busy:")
        for name, s in thread_busy(events, names):
            print(f"  {name:<26} {s:9.3f}s")


if __name__ == "__main__":
    main()
