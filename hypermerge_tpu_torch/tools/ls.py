"""List every document in a repo directory: url, actor count, clock
total, feed bytes on disk, read-serving residency, and per-doc
crash/scrub status (the port of tools/ls.py).

    python -m hypermerge_tpu_torch.tools.ls /path/to/repo [--audit] [--sock /tmp/serve.sock]

The `residency=` column comes from the backend's Telemetry query (the
serve block the top tool also sees): `resident(<bytes>B)` — the doc's
summary columns are pinned in device memory and reads batch through
the query kernels; `evicted` — it was resident until the
HM_SERVE_MAX_BYTES LRU shed it (the next read reinstalls); `host` —
reads take per-request host materialization (tier off or never read).
Without --sock the column describes THIS in-process open — a fresh
open has served no reads, so everything shows `host`. Point --sock at
a RUNNING daemon's query socket (`tools.serve --ipc <sock>` or
`net/ipc.py`) to list the residency the daemon is actually serving
from.

The `peers=`/`announce=` columns (shown when the backend has a swarm)
come from the Telemetry payload's `net` block: how many connected
peers replicate each doc right now, and whether the doc's feeds are
joined for discovery (announced/looked-up). Against a DHT-discovered
daemon (net/discovery/ DhtSwarm) a `dht:` header line adds the node
id, routing-table size, and stored announce-record count — the same
block `tools.meta --dht` probes from outside.

The `workers=` column (shown when --sock points at a sharded hub
daemon, `net/ipc.py --hub` + `HM_WORKERS=N`) names the worker process
that OWNS each doc's shard as `workers=<shard>/<N>` — every Change for
the doc routes through that worker's engine and WAL — and a `workers:`
header line summarizes the fleet from the Telemetry payload: how many
workers are up, their summed durable edits, and supervisor respawns.
A sharded daemon's docs live in per-worker shard repos
(`<repo>/shard-<k>`); ls walks those too, one `shard-k  N docs`
section each.

The `service:` header line (shown when the backend runs the overload
controller, HM_SERVICE=1, serve/overload.py) is the service plane at
a glance: brownout-ladder rung (healthy/brownout/shed), live pressure,
refusal and host-degradation totals, and how many quota tenants the
front door has seen — the same `service` block the top tool renders
as the [service] group.

The `scrub=` column surfaces crash damage without a full scrub
(storage/scrub.py doc_status): `ok`, `recovered` (the last crash
recovery repaired something for this doc's feeds — torn tails,
sidecar resets, seals), `truncated-N-blocks` (recovery dropped N
unverifiable blocks; they re-replicate from peers), or
`unsigned_tail` (blocks currently beyond the last signature record).

The `wal=` column is the group-commit journal's per-doc verdict from
the persisted scrub report (storage/scrub.py wal_status): `replayed`
(the last recovery re-appended journaled blocks into this doc's feeds
— a power cut had dropped unfsynced log pages), `checkpointed` (the
crashed session touched this doc but its blocks were already durable
in the logs), or `clean` (untouched by the crashed session, or no
journal ran).

--audit additionally re-hashes each feed against its signed merkle
records (storage/integrity.py) and flags tampering. A writable feed
whose process crashed between an append and the periodic signature
(lazy signing, HM_SIGN_INTERVAL) shows the distinct UNSIGNED-TAIL
status instead of TAMPERED: the signed prefix verifies and the tail is
locally authored — recoverable by sealing (any open of the repo that
appends, or `Feed.seal()`, signs a fresh head record; the next audit
is clean). TAMPERED is reserved for evidence that cannot be explained
by a crash: hash/signature mismatches, records covering blocks the log
lost, or uncovered blocks on a read-only feed.

--device cpu runs the repo on the CPU (default: the GPU).
"""
import os

from .. import telemetry
from ..net.ipc import _shard_of
from ..repo import Repo
from ..storage.integrity import AUDIT_TAMPERED, AUDIT_UNSIGNED_TAIL
from ..storage.scrub import doc_status, last_report, wal_status
from ..utils.ids import to_doc_url
from . import add_device, device_of, parser


def _feed_bytes(path: str, actor_id: str) -> int:
    d = os.path.join(path, "feeds", actor_id[:2])
    total = 0
    if os.path.isdir(d):
        for name in os.listdir(d):
            if name.startswith(actor_id):
                p = os.path.join(d, name)
                if os.path.isfile(p):
                    total += os.path.getsize(p)
                elif os.path.isdir(p):
                    for f in os.listdir(p):
                        total += os.path.getsize(os.path.join(p, f))
    return total


def main(argv=None) -> None:
    ap = parser("tools.ls", __doc__)
    ap.add_argument("repo", help="repo directory")
    ap.add_argument(
        "--audit", action="store_true",
        help="verify each feed's signed merkle chain",
    )
    ap.add_argument(
        "--sock", default=None,
        help="query a running daemon's Telemetry socket for the LIVE "
        "residency column (tools.serve --ipc / net/ipc.py)",
    )
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_of(ap, args)

    repo = Repo(path=args.repo, device=device)
    back = repo.back
    doc_ids = back.clocks.all_doc_ids(back.id)
    report = last_report(args.repo)
    recovered = back.recovery_report is not None
    print(
        f"repo {back.id[:8]}…  {len(doc_ids)} docs"
        + ("  (crash recovery ran on this open)" if recovered else "")
    )
    # telemetry summary for THIS open (registry-sourced): what opening
    # the repo cost in recoveries/fsyncs so far
    snap = telemetry.snapshot()
    tele_keys = (
        "storage.recoveries", "storage.fsyncs", "storage.barriers",
        "pipeline.slabs", "mesh.dispatches", "live.adopted",
        "serve.reads", "serve.fallbacks",
    )
    tele = " ".join(
        f"{k.split('.', 1)[1]}={snap[k]}"
        for k in tele_keys
        if snap.get(k)
    )
    if tele:
        print(f"telemetry: {tele}")
    # per-doc read-serving residency, sourced from the Telemetry query
    # (the same payload the top tool polls): --sock asks the RUNNING
    # daemon which docs it serves from device memory; otherwise the
    # column describes this in-process open (cold => host everywhere)
    if args.sock:
        from .top import IpcTelemetry

        client = IpcTelemetry(args.sock)
        try:
            payload = client.poll()
        finally:
            client.close()
    else:
        tq = []
        repo.telemetry(tq.append)
        payload = (tq[0] or {}) if tq else {}
    serve = payload.get("serve")
    net = (payload.get("net") or {}).get("docs", {})
    dht = payload.get("dht")
    svc = payload.get("service")
    if svc is not None:
        # service plane (serve/overload.py): one status line — ladder
        # rung, live pressure, refusal/degradation totals, tenant
        # count — from the same Telemetry payload the top tool polls
        print(
            f"service: {svc.get('state_name', '?')} "
            f"pressure={float(svc.get('pressure', 0.0)):.2f} "
            f"shed={svc.get('shed_reads', 0)} "
            f"brownout={svc.get('brownout_reads', 0)} "
            f"deferred={svc.get('deferred_installs', 0)} "
            f"tenants={len(svc.get('tenants') or {})}"
        )
    if dht is not None:
        # DHT-discovered daemon: one header line of swarm truth (the
        # per-doc peers=/announce= columns below come from the same
        # payload)
        print(
            f"dht: node {dht['node_id'][:12]}… "
            f"nodes={dht['nodes']} records={dht['records']} "
            f"joined={len(dht['joined'])}"
        )

    workers = payload.get("workers") or {}
    if workers:
        # sharded hub daemon: one fleet summary line; the per-doc
        # workers= column below names each doc's owning shard
        up = sum(1 for w in workers.values() if w.get("alive"))
        print(
            f"workers: {up}/{len(workers)} up "
            f"edits={sum(w.get('edits', 0) for w in workers.values())} "
            f"respawns="
            f"{sum(w.get('respawns', 0) for w in workers.values())}"
        )

    def swarm_cols(doc_id):
        ent = net.get(doc_id)
        if ent is None:
            return ""
        ann = "yes" if ent.get("announced") else "no"
        return f"peers={ent.get('peers', 0)} announce={ann} "

    def worker_col(doc_id):
        if not workers:
            return ""
        return f"workers={_shard_of(doc_id, len(workers))}/{len(workers)} "

    def residency(doc_id):
        if serve is None:
            return "host"
        ent = serve["resident"].get(doc_id)
        if ent is not None:
            return f"resident({ent['bytes']}B)"
        if doc_id in serve["evicted"]:
            return "evicted"
        return "host"

    def list_docs(b, path, rep):
        for doc_id in b.clocks.all_doc_ids(b.id):
            cursor = b.cursors.get(b.id, doc_id)
            clock = b.clocks.get(b.id, doc_id)
            total_changes = sum(clock.values())
            nbytes = sum(_feed_bytes(path, a) for a in cursor)
            line = (
                f"{to_doc_url(doc_id)}  actors={len(cursor)} "
                f"changes={total_changes} bytes={nbytes} "
                f"{swarm_cols(doc_id)}"
                f"{worker_col(doc_id)}"
                f"residency={residency(doc_id)} "
                f"scrub={doc_status(b, doc_id, rep)} "
                f"wal={wal_status(rep, cursor)}"
            )
            if args.audit:
                # three-way status: OK / UNSIGNED-TAIL (crash-orphaned
                # lazy-signing tail, recoverable via seal()) / TAMPERED
                statuses = {
                    b.feeds.open_feed(a).audit_status() for a in cursor
                }
                if AUDIT_TAMPERED in statuses:
                    line += "  integrity=TAMPERED"
                elif AUDIT_UNSIGNED_TAIL in statuses:
                    line += (
                        "  integrity=UNSIGNED-TAIL (seal() to re-sign)"
                    )
                else:
                    line += "  integrity=OK"
            print(line)

    list_docs(back, args.repo, report)
    repo.close()
    # a sharded hub daemon's docs live in per-worker shard repos
    # (<repo>/shard-<k>, net/ipc.py _ShardRouter) — the top-level dir
    # holds no feeds of its own, so list each shard's inventory too
    for name in sorted(os.listdir(args.repo)):
        spath = os.path.join(args.repo, name)
        if not (name.startswith("shard-") and os.path.isdir(spath)):
            continue
        srepo = Repo(path=spath, device=device)
        sids = srepo.back.clocks.all_doc_ids(srepo.back.id)
        print(f"{name}  {len(sids)} docs")
        list_docs(srepo.back, spath, last_report(spath))
        srepo.close()


if __name__ == "__main__":
    main()
