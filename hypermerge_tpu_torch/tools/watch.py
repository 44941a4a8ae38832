"""Watch a document: print its materialized state as JSON on every
change (the port of tools/watch.py; reference tools/Watch.ts:31-34).

    python -m hypermerge_tpu_torch.tools.watch /path/to/repo 'hypermerge:/<docId>'
    python -m hypermerge_tpu_torch.tools.watch /path/to/repo 'hypermerge:/<docId>' \
        --connect HOST:PORT        # also join a peer and watch live

Runs until interrupted (ctrl-c), then closes the repo and its swarm.
--device cpu runs the repo on the CPU (default: the GPU).
"""

import json
import time

from ..models.plain import to_plain as _plain
from ..repo import Repo
from . import add_device, device_of, parser


def main(argv=None) -> None:
    ap = parser("tools.watch", __doc__)
    ap.add_argument("repo", help="repo directory")
    ap.add_argument("url", help="doc url to watch")
    ap.add_argument("--connect", help="HOST:PORT of a peer to join")
    ap.add_argument(
        "--once", action="store_true", help="print current state and exit"
    )
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_of(ap, args)

    repo = Repo(path=args.repo, device=device)
    swarm = None
    if args.connect:
        from ..net.tcp import TcpSwarm

        swarm = TcpSwarm()
        repo.set_swarm(swarm)
        host, _, port = args.connect.partition(":")
        swarm.connect((host, int(port)))

    def show(doc, index):
        print(
            json.dumps(
                {"history": index, "doc": _plain(doc)}, default=str
            ),
            flush=True,
        )

    def close():
        repo.close()
        if swarm is not None:
            swarm.destroy()

    if args.once:
        show(repo.doc(args.url), -1)
        close()
        return
    repo.watch(args.url, show)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        close()


if __name__ == "__main__":
    main()
