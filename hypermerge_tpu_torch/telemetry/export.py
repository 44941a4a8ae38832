"""Exporters: Chrome trace-event JSON and Prometheus text format.

- ``chrome_trace_events`` / ``write_chrome_trace`` render the span
  ring as the Trace Event Format ("X" complete events + "i" instants,
  plus thread-name metadata), the JSON Perfetto and chrome://tracing
  load directly.
- ``prometheus_text`` renders the metrics registry as the Prometheus
  exposition format (one ``# TYPE`` header per family, label sets
  preserved, histograms as cumulative ``_bucket{le=...}`` +
  ``_sum``/``_count``). Metric names sanitize to the Prometheus
  charset with an ``hm_`` prefix: ``live.ticks`` -> ``hm_live_ticks``.

Both formats are pinned by golden tests (tests/test_telemetry.py).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

from .registry import REGISTRY, MetricsRegistry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return "hm_" + _NAME_RE.sub("_", name)


def _prom_labels(labels, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """The registry as Prometheus exposition text (a snapshot, not a
    server — tools/top.py --prom and operators' curl-into-a-file)."""
    reg = registry if registry is not None else REGISTRY
    by_family: Dict[str, List[Any]] = {}
    kinds: Dict[str, str] = {}
    for m in reg.series():
        by_family.setdefault(m.name, []).append(m)
        kinds[m.name] = m.kind
    lines: List[str] = []
    for name in sorted(by_family):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} {kinds[name]}")
        for m in sorted(by_family[name], key=lambda s: s.labels):
            if m.kind == "histogram":
                v = m.value()
                acc = 0
                for ub, c in zip(m.buckets, v["buckets"]):
                    acc += c
                    le = 'le="' + _fmt(float(ub)) + '"'
                    lines.append(
                        f"{pname}_bucket"
                        f"{_prom_labels(m.labels, le)} {acc}"
                    )
                acc += v["buckets"][-1]
                inf = 'le="+Inf"'
                lines.append(
                    f"{pname}_bucket"
                    f"{_prom_labels(m.labels, inf)} {acc}"
                )
                lines.append(
                    f"{pname}_sum{_prom_labels(m.labels)} "
                    f"{_fmt(round(v['sum'], 6))}"
                )
                lines.append(
                    f"{pname}_count{_prom_labels(m.labels)} {v['count']}"
                )
            else:
                lines.append(
                    f"{pname}{_prom_labels(m.labels)} "
                    f"{_fmt(float(m.value()))}"
                )
    return "\n".join(lines) + "\n"


def chrome_trace_events(
    events, tid_names: Optional[Dict[int, str]] = None
) -> List[Dict[str, Any]]:
    """Span-ring tuples -> Trace Event Format dicts. Thread idents map
    to small stable tids (Perfetto's track list stays readable) with
    thread_name metadata rows."""
    pid = os.getpid()
    tid_map: Dict[int, int] = {}
    out: List[Dict[str, Any]] = []
    for ph, name, cat, ts, dur, tid, args in events:
        small = tid_map.setdefault(tid, len(tid_map) + 1)
        ev: Dict[str, Any] = {
            "ph": ph,
            "name": name,
            "cat": cat or "hm",
            "ts": round(ts, 3),
            "pid": pid,
            "tid": small,
        }
        if ph == "X":
            ev["dur"] = round(dur, 3)
        elif ph == "i":
            ev["s"] = "t"  # thread-scoped instant
        if args:
            ev["args"] = args
        out.append(ev)
    meta: List[Dict[str, Any]] = [{
        "ph": "M",
        "name": "process_name",
        "pid": pid,
        "tid": 0,
        "args": {"name": "hypermerge-tpu"},
    }]
    names = tid_names or {}
    for raw, small in sorted(tid_map.items(), key=lambda kv: kv[1]):
        meta.append({
            "ph": "M",
            "name": "thread_name",
            "pid": pid,
            "tid": small,
            "args": {"name": names.get(raw, f"thread-{raw}")},
        })
    return meta + out


def write_chrome_trace(
    path: str, events, tid_names: Optional[Dict[int, str]] = None
) -> str:
    """Write ``{"traceEvents": [...]}`` to ``path`` atomically (the
    atexit writer must never leave a torn file a later Perfetto load
    chokes on)."""
    payload = {
        "traceEvents": chrome_trace_events(events, tid_names),
        "displayTimeUnit": "ms",
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path
