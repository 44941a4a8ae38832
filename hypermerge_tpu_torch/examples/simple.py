"""Two repos in one process replicating a doc — the port of
examples/simple/simple.py (reference examples/simple/src/simple.ts):
repoA creates a doc, both repos watch it, edits from each side converge
through the swarm.

    python -m hypermerge_tpu_torch.examples.simple [--device cpu]
"""

import threading

from ..net.swarm import LoopbackHub, LoopbackSwarm
from ..repo import Repo
from ..tools import add_device, device_of, parser


def main(argv=None) -> None:
    ap = parser("examples.simple", __doc__)
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_of(ap, args)

    hub = LoopbackHub()
    repo_a = Repo(memory=True, device=device)
    repo_b = Repo(memory=True, device=device)
    repo_a.set_swarm(LoopbackSwarm(hub))
    repo_b.set_swarm(LoopbackSwarm(hub))

    doc_url = repo_a.create({"numbers": [2, 3, 4]})
    done_a, done_b = threading.Event(), threading.Event()

    def watcher(name, done):
        def on_change(state, _i) -> None:
            print(name, state)
            if state and len(state.get("numbers", [])) == 5:
                done.set()

        return on_change

    repo_a.watch(doc_url, watcher("RepoA", done_a))
    repo_b.watch(doc_url, watcher("RepoB", done_b))

    repo_a.change(
        doc_url,
        lambda d: (d["numbers"].append(5), d.__setitem__("foo", "bar")),
    )
    repo_b.change(
        doc_url,
        lambda d: (
            d["numbers"].insert(0, 1),
            d.__setitem__("bar", "foo"),
        ),
    )

    try:
        if not (done_a.wait(timeout=15) and done_b.wait(timeout=15)):
            raise SystemExit("did not converge")
        a, b = repo_a.doc(doc_url), repo_b.doc(doc_url)
        assert a == b, (a, b)
        print("converged:", a)
    finally:
        repo_a.close()
        repo_b.close()


if __name__ == "__main__":
    main()
