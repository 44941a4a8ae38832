"""Print a url's metadata: for a document, its actor list, clock, and
history length; for a hyperfile, its size and mime type (the port of
tools/meta.py; reference tools/Meta.ts — `repo.meta(url, cb)` surfaced
on the command line).

    python -m hypermerge_tpu_torch.tools.meta /path/to/repo 'hypermerge:/<docId>'
    python -m hypermerge_tpu_torch.tools.meta /path/to/repo 'hyperfile:/<fileId>'
    python -m hypermerge_tpu_torch.tools.meta --devices
    python -m hypermerge_tpu_torch.tools.meta /path/to/repo --stats
    python -m hypermerge_tpu_torch.tools.meta --dht [--bootstrap host:port,host:port]

Output is one JSON object. Documents are opened first (metadata queries
answer from the open doc's backend state); unknown urls print null and
exit non-zero.

`--devices` prints the port's device topology instead (no repo
needed): the visible cards, their kind, the (dp, sp) mesh the bulk
loader would build over them and whether every pair has peer access
(parallel/mesh.py `device_topology`) — the object `python -m
bench_torch --devices` prints. With `--device cpu` it describes the CPU.

`--dht` probes a running DHT fleet from outside: boots an EPHEMERAL
node (net/discovery/dht.py), bootstraps it from `--bootstrap` or
`HM_DHT_BOOTSTRAP`, walks toward its own id, and prints the node id
and per-bucket occupancy JSON — "is the fleet reachable and how big
does it look from here" in one command. `nodes` is the routing-table
size after the walk; an empty table means no bootstrap answered. It
opens no repo and needs no device.

`--stats` opens the repo (and its docs: the bulk open, whose slab runs
the pack and materialize kernels) and prints the process-wide telemetry
snapshot JSON (telemetry.snapshot_repo) — the same counter names as
the top tool.

Every mode but --dht runs on --device: the GPU unless `--device cpu`
is given; without a GPU the tool exits 1 with the device error.
"""

import json
import sys
import threading

from ..repo import Repo
from ..utils.ids import is_doc_url
from . import add_device, device_of, parser


def topology(device) -> dict:
    """The port's device topology on `device`: the visible cards on the
    GPU, a one-rank plain mesh on the CPU (the same keys)."""
    from ..parallel.mesh import device_topology, make_mesh

    if device.type == "cuda":
        return device_topology()
    topo = device_topology(make_mesh(1, devices=[device]))
    topo.update(n_devices=1, platform="cpu", device_kind="cpu")
    return topo


def main(argv=None) -> None:
    ap = parser("tools.meta", __doc__)
    ap.add_argument("repo", nargs="?", help="repo directory")
    ap.add_argument(
        "url", nargs="?",
        help="hypermerge:/ doc url or hyperfile:/ url",
    )
    ap.add_argument(
        "--timeout", type=float, default=30.0,
        help="seconds to wait for the doc to come up (default 30)",
    )
    ap.add_argument(
        "--devices", action="store_true",
        help="print visible device / mesh topology JSON and exit",
    )
    ap.add_argument(
        "--stats", action="store_true",
        help="open the repo and print the telemetry registry snapshot",
    )
    ap.add_argument(
        "--dht", action="store_true",
        help="probe the DHT fleet with an ephemeral node and print "
        "node id + bucket occupancy JSON",
    )
    ap.add_argument(
        "--bootstrap", default=None,
        help="host:port[,host:port] DHT bootstrap list for --dht "
        "(default: HM_DHT_BOOTSTRAP)",
    )
    add_device(ap)
    args = ap.parse_args(argv)

    if args.dht:
        from ..net.discovery import DhtNode

        bootstrap = None
        if args.bootstrap:
            bootstrap = []
            for part in args.bootstrap.split(","):
                host, _, port = part.strip().rpartition(":")
                bootstrap.append((host, int(port)))
        node = DhtNode(bootstrap=bootstrap)
        try:
            node.bootstrap_now()
            print(json.dumps({
                "node_id": node.id_hex,
                "dht_address": list(node.address),
                "nodes": node.table.size(),
                "buckets": node.table.occupancy(),
                "records": node.records.size(),
            }, sort_keys=True), flush=True)
            sys.exit(0 if node.table.size() else 1)
        finally:
            node.close()
    device = device_of(ap, args)
    if args.devices:
        print(json.dumps(topology(device), sort_keys=True), flush=True)
        return
    if args.stats:
        if args.repo is None:
            ap.error("--stats requires a repo directory")
        from .. import telemetry

        payload = telemetry.snapshot_repo(args.repo, device)
        print(
            json.dumps(payload["counters"], sort_keys=True), flush=True
        )
        return
    if args.repo is None or args.url is None:
        ap.error("repo and url are required (or use --devices)")

    repo = Repo(path=args.repo, device=device)
    try:
        if is_doc_url(args.url):
            # metadata answers from the open doc: materialize it first
            try:
                repo.open(args.url).value(timeout=args.timeout)
            except TimeoutError:
                # unknown doc (nothing local, no peer): same contract
                # as an unknown hyperfile — null, non-zero exit
                print("null", flush=True)
                sys.exit(1)
        got = {}
        done = threading.Event()

        def on_meta(payload) -> None:
            got["meta"] = payload
            done.set()

        repo.meta(args.url, on_meta)
        if not done.wait(args.timeout):
            print("timed out waiting for metadata", file=sys.stderr)
            sys.exit(2)
        meta = got["meta"]
        print(json.dumps(meta, default=str, sort_keys=True), flush=True)
        if meta is None:
            sys.exit(1)
    finally:
        repo.close()


if __name__ == "__main__":
    main()
