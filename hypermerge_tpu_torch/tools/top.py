"""Live per-subsystem telemetry for a running hypermerge daemon (the
port of tools/top.py).

Polls the backend's ``Telemetry`` query over the IPC/serve seam
(net/ipc.py unix socket) and renders per-subsystem counter RATES — the
"what is this daemon doing right now" view: live ticks/s, replication
frames/s, TCP bytes/s, fsync barriers/s, mesh dispatches/s, pipeline
queue depths — and the read-serving tier's serve.* block: reads/s,
batched dispatches/s, residency hit/install/eviction rates,
fallbacks/s (the [serve] group; `python -m
hypermerge_tpu_torch.tools.serve --ipc <sock>` exposes the same
socket). The ``[wal]`` group renders the group-commit journal's
``storage.wal.*`` rates — appends/s vs fsyncs/s (the
O(1)-fsync-per-window claim as a live ratio), checkpoints/s, journal
bytes/s, and replayed blocks (recovery).

DHT-discovered daemons (net/discovery/) show the ``[dht]`` group —
announce/lookup/RPC rates plus ``dht.lookup_hops`` (hops/lookup =
``lookup_hops`` rate over ``lookups`` rate) and
``dht.stale_evictions`` (k-bucket liveness churn) — and the
``[gossip]`` group: ``gossip.sent`` vs ``gossip.suppressed`` is the
bounded-fanout claim as a live ratio (suppressed counts the peers the
``HM_GOSSIP_FANOUT`` cap skipped per broadcast; anti-entropy sweeps
never appear here because they are deliberately unsampled).

The sharded write plane (``--hub`` + ``HM_WORKERS=N``) adds the
``[workers]`` fleet table: one row per worker PROCESS with pid,
liveness, durable-edit rate (``storage.wal.appends`` per worker),
outbound queue depth, and supervisor respawn count — the same split
the merged payload mirrors into ``workers.<i>.*`` counters for the
Prometheus dump.

The async transport (``HM_NET_ASYNC=1``) folds into the ``[net]``
group: ``net.aio.conns`` (live multiplexed-connection gauge),
``net.aio.loop_busy_ms`` (cumulative non-idle loop-thread time — its
rate over wall time is the loop saturation ratio), frame/byte/ping
rates, and ``net.aio.sheds``. The steady-state gossip counters land
next to them: ``net.cursor.full_tx`` vs ``net.cursor.delta_tx`` vs
``net.cursor.suppressed`` (the delta-cursor win as a live ratio), plus
``dht.sign_cache_hits`` and ``dht.seeds_tx``/``dht.seeds_rx``
(announce-signing amortization and push-seeding) in ``[dht]``.

The service plane (``HM_SERVICE``, serve/overload.py) renders the
``[service]`` group from the payload's ``service`` report block: the
brownout ladder's live rung + pressure + ack-pacing stretch on one
line, the controller's counter rates (``service.shed_reads``/s is the
refusal rate, ``service.brownout_reads``/s the host-memo degradation
rate, ``service.transitions`` the ladder's movement), and one row per
quota tenant — admitted/refused totals plus current token-bucket
occupancy (1.0 = exhausted).

Instrumented daemons (HM_LOCKDEP=1 / HM_RACEDEP=1) additionally show
the ``[lock]`` group: ``lock.held_blocking_ms.<class>`` rates — the
per-lock-class blocking-debt series whose ``live_engine`` row is the
write-plane split gate (ms of blocking calls under that lock, per
second) — and ``lock.racedep_violations``, the lockset race detector's
finding counter (any nonzero rate means a guard-manifest violation was
just observed; pull the daemon's lockdep report for the stacks).

    # against a daemon (python -m hypermerge_tpu_torch.net.ipc repo sock --persist)
    python -m hypermerge_tpu_torch.tools.top --sock /tmp/backend.sock [--interval 1.0]

    # one shot, machine-readable
    python -m hypermerge_tpu_torch.tools.top --sock /tmp/backend.sock --once --json

    # one in-process snapshot of a repo on disk (no daemon needed)
    python -m hypermerge_tpu_torch.tools.top /path/to/repo --once [--prom]

Counter names are ``<subsystem>.<metric>`` (see
hypermerge_tpu_torch/telemetry/__init__.py); the left column groups by
the prefix. Rates are exact deltas between polls of the merged
per-thread shards — no sampling. The in-process mode opens the repo on
--device (the GPU unless `--device cpu` is given); --sock opens none.
"""

import json
import socket
import sys
import threading
import time

from ..analysis.lockdep import make_lock
from . import add_device, device_of, parser


class IpcTelemetry:
    """A minimal Telemetry-query client on the backend's unix socket —
    the same framed duplex a RepoFrontend uses, without needing one
    (top must not open docs or mutate frontend state)."""

    def __init__(self, sock_path: str) -> None:
        from ..net.tcp import TcpDuplex

        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(sock_path)
        self._duplex = TcpDuplex(sock, is_client=True)
        if self._duplex.closed:
            raise ConnectionError(
                f"handshake with backend at {sock_path} failed"
            )
        self._lock = make_lock("tools.top")
        self._next_qid = 0
        self._waiting = {}
        self._duplex.on_message(self._on_msg)

    def _on_msg(self, msg) -> None:
        if not isinstance(msg, dict) or msg.get("type") != "Reply":
            return  # patches/gossip from the live daemon: not ours
        with self._lock:
            slot = self._waiting.pop(msg.get("queryId"), None)
        if slot is not None:
            slot["payload"] = msg.get("payload")
            slot["event"].set()

    def poll(self, timeout: float = 10.0) -> dict:
        from .. import msgs

        slot = {"event": threading.Event(), "payload": None}
        with self._lock:
            qid = self._next_qid
            self._next_qid += 1
            self._waiting[qid] = slot
        self._duplex.send(msgs.query_msg(qid, msgs.telemetry_query()))
        if not slot["event"].wait(timeout):
            with self._lock:  # retries must not leak a slot per miss
                self._waiting.pop(qid, None)
            raise TimeoutError("telemetry query timed out")
        payload = slot["payload"]
        if not isinstance(payload, dict):
            raise RuntimeError(
                "backend does not answer Telemetry queries "
                "(pre-round-13 daemon?)"
            )
        return payload

    def close(self) -> None:
        self._duplex.close()


def format_rows(prev: dict, cur: dict, dt: float) -> str:
    """The rendered table: counters grouped by subsystem prefix, with
    per-second deltas against the previous poll (blank on the first)."""
    counters = cur.get("counters", {})
    prev_counters = (prev or {}).get("counters", {})
    workers = cur.get("workers") or {}
    svc = cur.get("service") or {}
    by_sub = {}
    for name, v in counters.items():
        sub = name.split(".", 1)[0]
        if name.startswith("storage.wal."):
            # the group-commit journal gets its own rate group: one
            # glance shows appends vs fsyncs (the O(1)-per-window
            # claim as a live ratio) plus checkpoint/byte flow
            sub = "wal"
        if workers and name.startswith("workers."):
            continue  # rendered as the [workers] fleet table below
        if svc and name.startswith("service."):
            continue  # rendered as the [service] group below
        by_sub.setdefault(sub, []).append((name, v))
    lines = []
    for sub in sorted(by_sub):
        rows = [
            (n, v, v - prev_counters.get(n, 0))
            for n, v in sorted(by_sub[sub])
        ]
        if not any(v or d for _n, v, d in rows):
            continue  # a fully idle subsystem earns no screen space
        lines.append(f"[{sub}]")
        for name, v, delta in rows:
            if not v and not delta:
                continue
            rate = ""
            if prev and dt > 0 and delta:
                # signed: a draining queue gauge shows a negative rate
                rate = f"  ({delta / dt:+,.1f}/s)"
            if isinstance(v, float):
                v = round(v, 3)
            lines.append(f"  {name:<32} {v:>14,}{rate}")
    if workers:
        # the sharded write plane (HM_WORKERS daemons): one row per
        # worker process — liveness, durable-edit rate, outbound queue
        # depth, and how often the supervisor had to respawn it
        lines.append("[workers]")
        for i in sorted(workers, key=int):
            w = workers[i]
            delta = w.get("edits", 0) - prev_counters.get(
                f"workers.{i}.edits", 0
            )
            rate = ""
            if prev and dt > 0 and delta:
                rate = f"  ({delta / dt:+,.1f}/s)"
            state = "up" if w.get("alive") else "DOWN"
            lines.append(
                f"  worker {i}  pid {w.get('pid')}  {state:<4} "
                f"edits {w.get('edits', 0):>10,}{rate}  "
                f"queue {w.get('queue', 0):,}  "
                f"respawns {w.get('respawns', 0):,}"
            )
    if svc:
        # the overload controller (serve/overload.py): ladder rung +
        # live pressure + write ack-pacing on one line, refusal/
        # degradation rates below, then the per-tenant quota table
        lines.append("[service]")
        lines.append(
            f"  state {svc.get('state_name', '?'):<9} "
            f"pressure {float(svc.get('pressure', 0.0)):.2f}  "
            f"ack_stretch {svc.get('ack_stretch_ms', 0)}ms  "
            f"transitions {svc.get('transitions', 0):,}"
        )
        skip = ("service.state", "service.pressure",
                "service.ack_stretch_ms")
        for name in sorted(
            n for n in counters
            if n.startswith("service.") and n not in skip
        ):
            v = counters[name]
            delta = v - prev_counters.get(name, 0)
            if not v and not delta:
                continue
            rate = ""
            if prev and dt > 0 and delta:
                rate = f"  ({delta / dt:+,.1f}/s)"
            if isinstance(v, float):
                v = round(v, 3)
            lines.append(f"  {name:<32} {v:>14,}{rate}")
        for t, row in sorted((svc.get("tenants") or {}).items()):
            lines.append(
                f"  tenant {t:<14} "
                f"admitted {row.get('admitted', 0):>10,}  "
                f"refused {row.get('refused', 0):>10,}  "
                f"quota {float(row.get('quota_occupancy', 0.0)):.2f}"
            )
    if cur.get("tracing"):
        lines.append(
            f"[trace] {cur.get('trace_spans', 0)} spans buffered"
            + (
                f" -> {cur['trace_path']}"
                if cur.get("trace_path")
                else " (in-memory ring)"
            )
        )
    return "\n".join(lines)


def _in_process_payload(repo_path: str, device) -> dict:
    """Open the repo in-process on `device` and snapshot its registry
    (no daemon: the numbers describe THIS process' open, not a running
    server). Shares the exact recipe with `tools.meta --stats`."""
    from .. import telemetry

    return telemetry.snapshot_repo(repo_path, device)


def main(argv=None) -> None:
    ap = parser("tools.top", __doc__)
    ap.add_argument("repo", nargs="?", help="repo directory (in-process)")
    ap.add_argument("--sock", help="daemon unix socket (net/ipc.py)")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument(
        "--once", action="store_true", help="print one snapshot and exit"
    )
    ap.add_argument("--json", action="store_true", help="raw JSON payload")
    ap.add_argument(
        "--prom", action="store_true",
        help="Prometheus text snapshot (in-process mode only)",
    )
    ap.add_argument(
        "--no-clear", action="store_true",
        help="append instead of redrawing the screen",
    )
    add_device(ap)
    args = ap.parse_args(argv)
    if not args.sock and not args.repo:
        ap.error("need --sock SOCKPATH or a repo directory")

    if args.sock is None:
        device = device_of(ap, args)
        payload = _in_process_payload(args.repo, device)
        if args.prom:
            from .. import telemetry

            print(telemetry.prometheus_text(), end="")
        elif args.json:
            print(json.dumps(payload, sort_keys=True))
        else:
            print(format_rows({}, payload, 0.0))
        return
    if args.prom:
        ap.error("--prom needs in-process mode (repo directory)")

    client = IpcTelemetry(args.sock)
    try:
        prev = {}
        while True:
            try:
                cur = client.poll()
            except TimeoutError:
                # backend busy (bulk cold open, big tick): skip the
                # frame, keep watching
                print("… backend busy, retrying", file=sys.stderr)
                if args.once:
                    sys.exit(2)
                time.sleep(args.interval)
                continue
            if args.json:
                print(json.dumps(cur, sort_keys=True), flush=True)
            else:
                dt = cur.get("time", 0) - prev.get("time", 0)
                if not args.no_clear and prev:
                    print("\x1b[2J\x1b[H", end="")
                print(
                    f"hm top — {args.sock} — "
                    + time.strftime("%H:%M:%S"),
                )
                print(format_rows(prev, cur, dt), flush=True)
            if args.once:
                return
            prev = cur
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        client.close()


if __name__ == "__main__":
    main()
