"""Audit + repair a repo directory after a crash (or on suspicion) —
the port of tools/scrub.py.

    python -m hypermerge_tpu_torch.tools.scrub /path/to/repo [--dry-run] [--audit] [--json]

Drives the whole-repo recovery pass (storage/scrub.py recover_repo):
feed torn-tail truncation, signature-chain repair (torn fragments;
records claiming blocks the log lost), sealing writable feeds'
crash-orphaned unsigned tails, truncating read-only feeds'
unverifiable tails (they re-replicate from peers), columnar-sidecar
reset when a sidecar ran ahead of its block log, corpus-slab
repair-forward, and sqlite clock reconciliation against feed reality.

The same pass runs automatically when a repo whose previous session
crashed (the repo.dirty marker) is reopened; this CLI exists to run it
on demand, to preview it (--dry-run), and to add the full merkle
re-hash (--audit) that open-time recovery skips for speed. It sets
HM_RECOVER=0 in its own environment (the backend must not recover
first), so call `main` in a process of its own or restore the variable.

--device cpu runs the backend on the CPU (default: the GPU).
"""

import json
import os
import sys

from ..backend.repo_backend import RepoBackend
from ..storage.integrity import AUDIT_OK
from ..storage.scrub import recover_repo
from . import add_device, device_of, parser


def main(argv=None) -> None:
    ap = parser("tools.scrub", __doc__)
    ap.add_argument("repo", help="repo directory")
    ap.add_argument(
        "--dry-run", action="store_true",
        help="report what a repair would do without writing anything",
    )
    ap.add_argument(
        "--audit", action="store_true",
        help="additionally re-hash every feed against its signed "
        "merkle chain (O(bytes); open-time recovery skips this)",
    )
    ap.add_argument(
        "--json", action="store_true", help="print the report as JSON"
    )
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_of(ap, args)

    if not os.path.isdir(args.repo):
        print(f"no such repo directory: {args.repo}", file=sys.stderr)
        raise SystemExit(2)

    # HM_RECOVER=0: the backend must not run its own recovery pass
    # first — this CLI runs the pass (and --dry-run must see the
    # damage, not the already-repaired state)
    os.environ["HM_RECOVER"] = "0"
    # a dry run must not eat the crash marker: closing the backend
    # below marks the repo clean, which would skip the automatic
    # recovery on the next real open. Its CONTENT (the crashed
    # session's generation stamp, which bounds the recovery scan to
    # the journal's dirty ledger) must survive byte-for-byte too.
    marker = os.path.join(args.repo, "repo.dirty")
    was_dirty = os.path.exists(marker)
    marker_bytes = b""
    if was_dirty:
        with open(marker, "rb") as fh:
            marker_bytes = fh.read()
    back = RepoBackend(path=args.repo, device=device)
    try:
        report = recover_repo(back, repair=not args.dry_run)
        if args.audit:
            audits = {}
            for name in sorted(
                set(back.feed_info.all_public_ids())
                | {r for r in report.get("per_feed", ())}
            ):
                feed = back.feeds.open_feed(name)
                audits[name] = feed.audit_status()
            report["audit"] = {
                "feeds": len(audits),
                "not_ok": {
                    n: s for n, s in audits.items() if s != AUDIT_OK
                },
            }
        if args.json:
            print(json.dumps(report))
        else:
            verb = "would repair" if args.dry_run else "repaired"
            print(
                f"scrub {args.repo}: {report['feeds']} feed(s), "
                f"{verb}: "
                f"{report['bytes_truncated']}B torn feed tails, "
                f"{report['sig_records_dropped']} orphaned sig "
                f"record(s), "
                f"{report['unsigned_tails_sealed']} tail(s) sealed, "
                f"{report['tail_blocks_dropped']} unverifiable "
                f"block(s) dropped, "
                f"{report['colcache_reset']} sidecar(s) reset, "
                f"{report['clock_rows_clamped']} clock row(s) "
                f"clamped "
                f"({report['t_recover_ms']}ms)"
            )
            wal = report.get("wal") or {}
            if wal.get("present"):
                replayed = wal.get(
                    "replay_would" if args.dry_run else "replayed", 0
                )
                rverb = "would replay" if args.dry_run else "replayed"
                print(
                    f"  journal: {wal['records']} record(s) over "
                    f"{wal['dirty_feeds']} dirty feed(s), {rverb} "
                    f"{replayed} block(s), "
                    f"{wal.get('skipped', 0)} already in the logs, "
                    f"{wal['torn_bytes']}B torn tail"
                    + (
                        f"; scan bounded to the session ledger "
                        f"({report.get('feeds_skipped', 0)} sidecar(s) "
                        "skipped)"
                        if wal.get("bounded")
                        else "; stamp mismatch: full scan"
                    )
                )
            for name, entry in sorted(
                report.get("per_feed", {}).items()
            ):
                print(f"  {name[:12]}…  {entry}")
            if args.audit and report["audit"]["not_ok"]:
                for n, s in sorted(report["audit"]["not_ok"].items()):
                    print(f"  AUDIT {n[:12]}…  {s}")
            elif args.audit:
                print(
                    f"  audit: all {report['audit']['feeds']} "
                    "feed(s) verify"
                )
    finally:
        back.close()
        if args.dry_run and was_dirty:
            with open(marker, "wb") as fh:
                fh.write(marker_bytes)


if __name__ == "__main__":
    main()
