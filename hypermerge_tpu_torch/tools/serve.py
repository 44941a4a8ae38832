"""Serve a repo to the network: listen on TCP, replicate every feed to
any peer that proves knowledge of the docs (the port of
tools/serve.py; reference tools/Serve.ts — with encrypted transport
and capability checks instead of an open relay).

    python -m hypermerge_tpu_torch.tools.serve /path/to/repo [--port 9130] \
        [--open 'hypermerge:/<docId>' ...] [--ipc /tmp/serve.sock]

Peers connect with TcpSwarm.connect((host, port)) — e.g. the chat
example's `join`, or `tools.watch --connect`.

--ipc additionally listens on a unix socket speaking the framed Query
protocol (msgs.query_msg): `Read` queries route through the
read-serving tier (serve/tier.py, HM_SERVE=1: device-resident summary
columns and the serve kernels) and `Telemetry` queries feed the top
tool — so one daemon replicates to peers AND serves thousands of
concurrent point reads without materializing docs host-side per
request.

Runs until interrupted (ctrl-c), then closes the query socket, the
repo and its swarm. --device cpu runs the repo on the CPU (default:
the GPU).
"""

import os
import socket
import threading
import time

from .. import msgs
from ..net.tcp import TcpDuplex, TcpSwarm
from ..repo import Repo
from ..utils.ids import to_doc_url
from . import add_device, device_of, parser


class QueryServer:
    """The read/telemetry socket: accepts framed-duplex clients and
    answers Query messages straight off the backend — Read through the
    serving tier (its batcher coalesces concurrent clients into one
    kernel dispatch), Telemetry with the registry snapshot + per-doc
    residency. Everything else on the socket is ignored; doc state
    never mutates through this seam."""

    def __init__(self, backend, sock_path: str) -> None:
        self._back = backend
        if os.path.exists(sock_path):
            os.remove(sock_path)
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(sock_path)
        self._server.listen(8)
        self._closed = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="hm-serve-ipc", daemon=True
        )
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._server.accept()
            except OSError:
                return  # closed
            duplex = TcpDuplex(conn, is_client=False)
            if duplex.closed:
                continue
            duplex.on_message(
                lambda msg, d=duplex: self._on_msg(d, msg)
            )

    def _on_msg(self, duplex, msg) -> None:
        if not isinstance(msg, dict) or msg.get("type") != "Query":
            return
        qid = msg.get("queryId")
        query = msg.get("query") or {}
        t = query.get("type")
        if t == "Read":
            self._back.read_doc(
                query.get("id"),
                query.get("query") or {},
                lambda payload: duplex.send(
                    msgs.reply_msg(qid, payload)
                ),
            )
        elif t == "Telemetry":
            duplex.send(
                msgs.reply_msg(qid, self._back.telemetry_payload())
            )
        else:
            duplex.send(msgs.reply_msg(qid, None))

    def close(self) -> None:
        self._closed = True
        try:
            self._server.close()
        except OSError:
            pass


def main(argv=None) -> None:
    ap = parser("tools.serve", __doc__)
    ap.add_argument("repo", help="repo directory")
    ap.add_argument("--port", type=int, default=9130)
    ap.add_argument(
        "--open",
        nargs="*",
        default=None,
        help="doc urls to open (default: every doc in the repo)",
    )
    ap.add_argument(
        "--ipc",
        default=None,
        help="unix socket answering Read/Telemetry queries "
        "(tools.top, read clients)",
    )
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_of(ap, args)

    repo = Repo(path=args.repo, device=device)
    swarm = TcpSwarm(port=args.port)
    repo.set_swarm(swarm)
    urls = args.open or [
        to_doc_url(d)
        for d in repo.back.clocks.all_doc_ids(repo.back.id)
    ]
    repo.open_many(urls)
    qserver = None
    if args.ipc:
        qserver = QueryServer(repo.back, args.ipc)
        print(f"read queries on {args.ipc}", flush=True)
    host, port = swarm.address
    print(f"serving {len(urls)} docs on {host}:{port}", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        if qserver is not None:
            qserver.close()
        repo.close()
        swarm.destroy()


if __name__ == "__main__":
    main()
