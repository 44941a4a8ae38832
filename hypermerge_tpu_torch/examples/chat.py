"""P2P chat over an encrypted TCP swarm — the port of
examples/chat/chat.py (reference examples/chat/channel.js: a doc with a
`messages` list, each peer appending and watching).

Serve (creates the channel doc, prints its url + address):
    python -m hypermerge_tpu_torch.examples.chat serve --name alice [--port 9120]

Join from another terminal/machine:
    python -m hypermerge_tpu_torch.examples.chat join HOST:PORT \
        'hypermerge:/<docId>' --name bob

Type lines to send; incoming messages print as they replicate. Each
peer's messages ride its own signed feed; the doc converges via CRDT
merge, so any number of peers can talk with no server. ctrl-d (stdin
EOF) or ctrl-c closes the repo and its swarm. --device cpu runs the
repo on the CPU (default: the GPU).
"""

import sys

from ..analysis.lockdep import make_lock
from ..net.tcp import TcpSwarm
from ..repo import Repo
from ..tools import add_device, device_of, parser


def run_chat(repo: Repo, url: str, name: str) -> None:
    seen = [0]
    lock = make_lock("examples.chat")

    def on_change(doc, _index):
        if doc is None:
            return
        msgs = doc.get("messages", [])
        with lock:
            for m in list(msgs)[seen[0] :]:
                if isinstance(m, dict) and m.get("from") != name:
                    print(f"\r<{m.get('from')}> {m.get('text')}")
                    print("> ", end="", flush=True)
            seen[0] = len(msgs)

    handle = repo.watch(url, on_change)
    print("connected — type messages, ctrl-d to quit")
    print("> ", end="", flush=True)
    try:
        for line in sys.stdin:
            text = line.rstrip("\n")
            if text:
                repo.change(
                    url,
                    # bind by value: queued change fns run later on a
                    # pending doc, after `text` has been rebound
                    lambda d, text=text: d["messages"].append(
                        {"from": name, "text": text}
                    ),
                )
            print("> ", end="", flush=True)
    except KeyboardInterrupt:
        pass
    handle.close()


def main(argv=None) -> None:
    ap = parser("examples.chat", __doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    serve = sub.add_parser("serve", help="create a channel and listen")
    serve.add_argument("--port", type=int, default=9120)
    serve.add_argument("--name", default="host")
    serve.add_argument("--repo", default=None, help="persist to this dir")
    add_device(serve)
    join = sub.add_parser("join", help="join a channel")
    join.add_argument("address", help="HOST:PORT of a serving peer")
    join.add_argument("url", help="the channel doc url")
    join.add_argument("--name", default="guest")
    join.add_argument("--repo", default=None)
    add_device(join)
    args = ap.parse_args(argv)
    device = device_of(ap, args)

    repo = (
        Repo(path=args.repo, device=device) if args.repo
        else Repo(memory=True, device=device)
    )
    if args.cmd == "serve":
        swarm = TcpSwarm(port=args.port)
        repo.set_swarm(swarm)
        url = repo.create({"messages": []})
        host, port = swarm.address
        print(f"channel: {url}")
        print(f"peers join with: {host}:{port} '{url}'")
        run_chat(repo, url, args.name)
    else:
        swarm = TcpSwarm()
        repo.set_swarm(swarm)
        host, _, port = args.address.partition(":")
        swarm.connect((host, int(port)))
        run_chat(repo, args.url, args.name)
    repo.close()
    swarm.destroy()


if __name__ == "__main__":
    main()
