"""Frontend/backend process split — the seam, realized across processes.

Parity: the reference's stated design goal is that RepoFrontend runs on
a UI thread/process while RepoBackend runs elsewhere, joined only by
JSON-serializable messages (reference README.md:160-184, one frontend
per backend). Every message in msgs.py is a plain dict, so the split is
a transport choice: this module pumps the two queues over a unix-domain
socket using the same framed duplex the TCP swarm uses.

Backend process:
    python -m hypermerge_tpu_torch.net.ipc /path/to/repo /tmp/backend.sock
        [--hub] [--persist] [--listen | --connect HOST:PORT | --dht]
        [--device {cuda,cpu}]

Frontend process:
    from hypermerge_tpu_torch.net.ipc import connect_frontend
    front, close = connect_frontend("/tmp/backend.sock")
    url = front.create({"hello": "world"})
    ...
    close()

The device path, storage, crypto, and networking all live with the
backend; the frontend process needs none of them loaded.

The port's copy of hypermerge_tpu/net/ipc.py. The daemon is an entry
point, so it runs its backend on the GPU unless its caller asks for the
CPU (`--device cpu`, `serve_backend(..., device="cpu")`); without a GPU
it exits with `device.resolve`'s error. A hub with HM_WORKERS=N builds
no backend itself: each worker it spawns is this module run as a
once-mode daemon on the hub's device, with a backend of its own.
"""

from __future__ import annotations

import hashlib
import os
import socket
import subprocess
import sys
import threading
import time
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Set, Tuple

from ..analysis.lockdep import make_lock
from .tcp import TcpDuplex

if TYPE_CHECKING:  # torch loads with the backend, never in a frontend
    from ..device import DeviceLike


class ReplyFence:
    """Fences one backend's query replies across frontend swaps.

    Persist mode reuses ONE live backend for successive frontends. The
    swap drains *buffered* messages, but a handler still in flight on
    another thread (a Materialize query walking a large history, a
    patch decode) pushes its Reply AFTER the drain — and the next
    frontend's queryId counter restarts at the same small integers, so
    a previous frontend's late reply would resolve the wrong promise.

    Inbound Query ids are tagged with the accepting connection's epoch;
    outbound Replies only pass a gate bound to the same epoch (and are
    untagged back to the frontend's raw id). A reply produced by an
    in-flight handler from a previous frontend therefore dies at the
    gate instead of being delivered cross-session.
    """

    def __init__(self) -> None:
        self.epoch = 0

    def advance(self) -> int:
        self.epoch += 1
        return self.epoch

    def inbound(self, msg, epoch: int):
        """Tag a frontend->backend Query with the accepting
        connection's epoch (the backend echoes queryId opaquely into
        its Reply). The epoch is bound at accept time, NOT read at
        dispatch time: a previous connection's reader thread that
        dispatches a decoded frame after the swap must tag with ITS
        epoch, so the resulting Reply still dies at the new gate."""
        if isinstance(msg, dict) and msg.get("type") == "Query":
            msg = dict(msg)
            msg["queryId"] = [epoch, msg["queryId"]]
        return msg

    def outbound(self, epoch: int, msg):
        """The backend->frontend message for a gate bound to `epoch`,
        with the raw queryId restored — or None when the Reply belongs
        to a different frontend session (dropped)."""
        if isinstance(msg, dict) and msg.get("type") == "Reply":
            qid = msg.get("queryId")
            if isinstance(qid, list) and len(qid) == 2:
                if qid[0] != epoch:
                    return None  # a previous frontend's late reply
                msg = dict(msg)
                msg["queryId"] = qid[1]
        return msg

    def gate(self, send):
        """A subscriber for backend.to_frontend bound to the CURRENT
        epoch: drops other epochs' replies, untags this one's."""
        epoch = self.epoch

        def fn(msg):
            out = self.outbound(epoch, msg)
            if out is not None:
                send(out)

        return fn


class _FrontendHub:
    """Many frontends, ONE daemon backend — the connection/interest
    table behind `serve_backend(hub=True)` (`--hub`), and the process
    topology bench `config_writers` measures: N writer processes
    editing disjoint docs against one backend, whose per-doc emission
    domains (backend/emission.py) let their {patch -> feed append ->
    WAL commit -> push} pipelines run concurrently.

    Each accepted frontend gets a connection key. Its Query ids are
    tagged `[key, raw]` so Replies route back to the issuing frontend
    only (the ReplyFence trick, per connection instead of per epoch —
    every frontend's queryId counter starts at the same small
    integers). Doc-addressed pushes (Ready/Patch/ActorId/Download/...)
    route by INTEREST: a frontend that named a doc id in any message
    (Open/Create/Request/...) receives that doc's pushes, and
    disjoint-doc writers never see each other's patch traffic; Close/
    Destroy retires the interest. Un-addressed pushes broadcast.
    Write topology: MANY writing frontends per doc. Create/Open/
    NeedsActorId are tagged with the connection key (`writer`), and the
    backend mints one actor PER WRITING CONNECTION (repo_backend
    `_grant_writer_actor`), so concurrent same-doc writers never share
    a seq counter. Ready/ActorId replies carrying a `writer` tag route
    ONLY to that connection (tag stripped); Patch traffic stays
    interest-broadcast — every connection converges through the
    backend's emission-ordered patch stream. HM_HUB_WRITERS=0 reverts
    to the legacy one-writer-per-doc tagging-free protocol.
    Socket sends run OUTSIDE the hub lock (`net.ipc.hub`,
    analysis/hierarchy.py): a slow frontend must not stall accepts or
    another connection's teardown."""

    def __init__(self, back) -> None:
        self._back = back
        self._writers = (
            os.environ.get("HM_HUB_WRITERS", "1") != "0"
        )
        self._lock = make_lock("net.ipc.hub")
        self._conns: Dict[int, TcpDuplex] = {}
        self._interest: Dict[str, Set[int]] = {}  # doc id -> conn keys
        self._next_key = 0

    def attach(self, duplex: TcpDuplex) -> None:
        with self._lock:
            self._next_key += 1
            key = self._next_key
            self._conns[key] = duplex
        duplex.on_close(lambda _k=key: self._detach(_k))
        duplex.on_message(lambda msg, _k=key: self._inbound(_k, msg))

    def _detach(self, key: int) -> None:
        with self._lock:
            self._conns.pop(key, None)
            # drop doc entries whose last watcher left — a long-lived
            # daemon's interest table must track LIVE interest, not
            # every doc id ever named (it would grow monotonically
            # with lifetime doc count otherwise)
            emptied = []
            for doc_id, keys in self._interest.items():
                keys.discard(key)
                if not keys:
                    emptied.append(doc_id)
            for doc_id in emptied:
                del self._interest[doc_id]
        if self._writers:
            # the backend forgets the gone connection's per-doc actor
            # grants (a long-lived daemon must not leak one map entry
            # per connection ever accepted). Outside the hub lock: the
            # backend takes its own locks.
            self._back.receive({"type": "WriterGone", "writer": key})

    def snapshot_interest(self):
        """Doc ids any live connection currently watches — the shard
        router's respawn replay set (a revived worker re-Opens these so
        its docs announce and resume patch pushes)."""
        with self._lock:
            return list(self._interest.keys())

    def _inbound(self, key: int, msg) -> None:
        if isinstance(msg, dict):
            t = msg.get("type")
            doc_id = (
                msg.get("publicKey") if t == "Create" else msg.get("id")
            )
            with self._lock:
                if doc_id is not None:
                    if t in ("Close", "Destroy"):
                        keys = self._interest.get(doc_id)
                        if keys is not None:
                            keys.discard(key)
                            if not keys:
                                del self._interest[doc_id]
                    else:
                        self._interest.setdefault(doc_id, set()).add(key)
                if t == "OpenBulk":
                    for i in msg.get("ids", ()):
                        self._interest.setdefault(i, set()).add(key)
            if t == "Query":
                msg = dict(msg)
                msg["queryId"] = [key, msg["queryId"]]
                # tenant attribution for the service plane: every
                # connection is its own tenant unless the client
                # named one — the overload controller's quotas and
                # refusal counters key on this
                inner = msg.get("query")
                if (
                    isinstance(inner, dict)
                    and inner.get("type") == "Read"
                    and isinstance(inner.get("query"), dict)
                    and "tenant" not in inner["query"]
                ):
                    inner = dict(inner)
                    inner["query"] = dict(
                        inner["query"], tenant=f"conn{key}"
                    )
                    msg["query"] = inner
            elif self._writers and t in (
                "Create", "Open", "NeedsActorId"
            ):
                # many-writer plane: the backend grants this CONNECTION
                # its own actor per doc and routes the tagged Ready/
                # ActorId back here only
                msg = dict(msg)
                msg["writer"] = key
        self._back.receive(msg)

    def dispatch(self, msg) -> None:
        """The ONE to_frontend subscriber: Replies to their issuing
        connection, doc-addressed pushes to the interested
        connections, everything else to everyone."""
        if isinstance(msg, dict):
            if msg.get("type") == "Reply":
                qid = msg.get("queryId")
                if not (isinstance(qid, list) and len(qid) == 2):
                    return  # not hub-tagged: no route back
                with self._lock:
                    duplex = self._conns.get(qid[0])
                if duplex is not None:
                    out = dict(msg)
                    out["queryId"] = qid[1]
                    self._send(duplex, out)
                return
            writer = msg.get("writer")
            if writer is not None:
                # per-connection push (tagged Ready/ActorId): ONLY the
                # connection it was minted for sees it. writer == -1 is
                # the respawn-replay sentinel (routes to nobody — the
                # Open existed to re-announce the doc in the worker).
                with self._lock:
                    duplex = self._conns.get(writer)
                if duplex is not None:
                    out = dict(msg)
                    del out["writer"]
                    self._send(duplex, out)
                return
            doc_id = msg.get("id")
            if doc_id is not None:
                with self._lock:
                    targets = [
                        self._conns[k]
                        for k in self._interest.get(doc_id, ())
                        if k in self._conns
                    ]
                for duplex in targets:
                    self._send(duplex, msg)
                return
        with self._lock:
            targets = list(self._conns.values())
        for duplex in targets:
            self._send(duplex, msg)

    @staticmethod
    def _send(duplex: TcpDuplex, msg) -> None:
        try:
            duplex.send(msg)
        except OSError:
            pass  # the duplex's on_close detach reaps the connection


def _shard_of(doc_id: str, n: int) -> int:
    """Stable doc-id -> worker shard (sha1 prefix mod n): every process
    — hub, tests, tools — computes the same owner for a doc."""
    digest = hashlib.sha1(
        doc_id.encode("utf-8", "surrogatepass")
    ).hexdigest()
    return int(digest[:8], 16) % n


class _ShardRouter:
    """HM_WORKERS per-doc-range worker PROCESSES behind one hub — the
    GIL-free write plane. The hub-facing surface is a RepoBackend
    stand-in (`receive`/`close`); behind it, doc-addressed messages
    route by `_shard_of(doc_id)` to a worker subprocess (a plain
    once-mode `net.ipc` daemon owning `<repo>/shard-<k>` — its OWN
    engine, feeds, and WAL) over the same framed duplex frontends use.
    Worker ReplyFence tagging nests queryIds transparently.

    Telemetry Queries fan out to every worker and merge (counters sum,
    time is the max, per-worker `workers.<i>.*` gauges are injected);
    a dead worker is covered by a timeout so `tools/top.py` never
    hangs on a crash window.

    Worker death (duplex close) is SUPERVISED: after
    HM_WORKER_RESPAWN_MS the old process is reaped, a fresh one is
    spawned on the same shard repo + socket, the hub's live interest
    set is replayed as `writer=-1` Opens (re-announce without waking
    any frontend), and messages buffered during the outage flush. The
    revived worker's own crash recovery (dirty marker + WAL journal
    prefix) restores every acked edit; persisted actor keys keep the
    reconnecting frontends' actors writable. An unacked in-flight
    request dies with the worker — exactly the pre-ack loss crash
    semantics the WAL tests pin.

    Every worker runs on `device` ("cuda" or "cpu"), passed on its
    command line at spawn and respawn; the router itself touches no
    device.
    """

    def __init__(
        self,
        repo_path: Optional[str],
        sock_base: str,
        n_workers: int,
        device: str,
    ) -> None:
        self._repo_path = repo_path
        self._sock_base = sock_base
        self._n = n_workers
        self._device = device
        self._lock = make_lock("net.ipc.router")
        self._workers: List[Optional[Dict[str, Any]]] = [None] * n_workers
        self._pending: List[List[Any]] = [[] for _ in range(n_workers)]
        self._respawns = [0] * n_workers
        self._gen = 0
        self._tele: Dict[int, Dict[str, Any]] = {}
        self._next_tele = 0
        self._closed = False
        # set-once wiring, installed by start() BEFORE workers spawn
        self._dispatch: Callable[[Any], None] = lambda _msg: None
        self._interest: Callable[[], list] = lambda: []
        if repo_path is not None:
            os.makedirs(repo_path, exist_ok=True)

    # -- lifecycle -----------------------------------------------------

    def start(self, dispatch, snapshot_interest) -> None:
        """Wire the hub sinks, then bring up every worker (order
        matters: a worker's first push must find dispatch installed)."""
        self._dispatch = dispatch
        self._interest = snapshot_interest
        for i in range(self._n):
            pid = self._spawn(i)
            print(f"worker {i} pid {pid}", flush=True)

    def _shard_repo(self, i: int) -> str:
        if self._repo_path is None:
            return ":memory:"
        return os.path.join(self._repo_path, f"shard-{i}")

    def _spawn(self, i: int) -> int:
        """Start worker i and connect to it (retried: the worker binds
        its socket only after its interpreter + backend imports). The
        worker is a fork + exec of this module (never a fork of this
        process), on the router's device."""
        wsock = f"{self._sock_base}.w{i}"
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "hypermerge_tpu_torch.net.ipc",
                self._shard_repo(i),
                wsock,
                "--device",
                self._device,
            ],
            stdout=subprocess.DEVNULL,
        )
        deadline = time.monotonic() + 120.0
        while True:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"worker {i} died on startup "
                    f"(rc={proc.returncode})"
                )
            if time.monotonic() > deadline:
                proc.kill()
                raise RuntimeError(f"worker {i} never bound {wsock}")
            try:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.connect(wsock)
            except OSError:
                time.sleep(0.05)
                continue
            duplex = TcpDuplex(s, is_client=True)
            if duplex.closed:  # bind/handshake race: try again
                time.sleep(0.05)
                continue
            break
        with self._lock:
            self._gen += 1
            gen = self._gen
            self._workers[i] = {
                "proc": proc,
                "duplex": duplex,
                "gen": gen,
                "pid": proc.pid,
            }
        duplex.on_message(lambda msg, _i=i: self._from_worker(_i, msg))
        duplex.on_close(lambda _i=i, _g=gen: self._worker_gone(_i, _g))
        return proc.pid

    def _worker_gone(self, i: int, gen: int) -> None:
        with self._lock:
            slot = self._workers[i]
            if self._closed or slot is None or slot["gen"] != gen:
                return  # shutdown, or a respawn already superseded it
        threading.Thread(
            target=self._respawn, args=(i, gen), daemon=True
        ).start()

    def _respawn(self, i: int, gen: int) -> None:
        time.sleep(
            float(os.environ.get("HM_WORKER_RESPAWN_MS", "200")) / 1e3
        )
        with self._lock:
            slot = self._workers[i]
            if self._closed or slot is None or slot["gen"] != gen:
                return
        try:
            slot["proc"].kill()
            slot["proc"].wait(10)
        except OSError:
            pass
        try:
            pid = self._spawn(i)
        except RuntimeError:
            with self._lock:  # crash loop: leave the slot for close()
                if not self._closed:
                    self._workers[i] = None
            return
        with self._lock:
            self._respawns[i] += 1
            flush = list(self._pending[i])
            del self._pending[i][:]
        # re-announce the shard's live docs (writer=-1: the tagged
        # Readys route to nobody; frontends already initialized) so
        # journal-prefix recovery materializes them and patch pushes
        # resume, THEN release anything buffered during the outage
        for doc_id in self._interest():
            if _shard_of(doc_id, self._n) == i:
                self._send_to(
                    i, {"type": "Open", "id": doc_id, "writer": -1}
                )
        for msg in flush:
            self._send_to(i, msg)
        print(f"worker {i} pid {pid} respawned", flush=True)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            slots = [w for w in self._workers if w is not None]
        for w in slots:
            try:
                w["duplex"].close()
            except OSError:
                pass
            w["proc"].terminate()
        for w in slots:
            try:
                w["proc"].wait(10)
            except subprocess.TimeoutExpired:
                w["proc"].kill()
                w["proc"].wait(10)
        for i in range(self._n):
            wsock = f"{self._sock_base}.w{i}"
            if os.path.exists(wsock):
                os.remove(wsock)

    # -- hub-facing backend surface ------------------------------------

    def receive(self, msg) -> None:
        if not isinstance(msg, dict):
            return
        t = msg.get("type")
        if t == "Query":
            query = msg.get("query")
            qtype = (
                query.get("type") if isinstance(query, dict) else None
            )
            if qtype == "Telemetry":
                self._telemetry_fanout(msg)
                return
            doc_id = (
                query.get("id") if isinstance(query, dict) else None
            )
            if doc_id is not None:
                self._send_to(_shard_of(doc_id, self._n), msg)
                return
        elif t == "OpenBulk":
            buckets: Dict[int, list] = {}
            for doc_id in msg.get("ids", ()):
                buckets.setdefault(
                    _shard_of(doc_id, self._n), []
                ).append(doc_id)
            for i, ids in buckets.items():
                self._send_to(i, {**msg, "ids": ids})
            return
        else:
            doc_id = (
                msg.get("publicKey") if t == "Create" else msg.get("id")
            )
            if doc_id is not None:
                self._send_to(_shard_of(doc_id, self._n), msg)
                return
        # not doc-addressed (WriterGone, unkeyed queries, ...): every
        # worker gets it
        for i in range(self._n):
            self._send_to(i, msg)

    def _send_to(self, i: int, msg) -> None:
        with self._lock:
            slot = self._workers[i]
            if slot is None or slot["duplex"].closed:
                # respawn window: park (bounded) — flushed on revival
                if len(self._pending[i]) < 10_000:
                    self._pending[i].append(msg)
                return
            duplex = slot["duplex"]
        try:
            duplex.send(msg)
        except OSError:
            with self._lock:
                if len(self._pending[i]) < 10_000:
                    self._pending[i].append(msg)

    def _from_worker(self, i: int, msg) -> None:
        if isinstance(msg, dict) and msg.get("type") == "Reply":
            qid = msg.get("queryId")
            if (
                isinstance(qid, list)
                and len(qid) == 3
                and qid[0] == "_tele"
            ):
                self._tele_collect(qid[1], qid[2], msg.get("payload"))
                return
        self._dispatch(msg)

    # -- telemetry fan-out/merge ---------------------------------------

    def _telemetry_fanout(self, msg) -> None:
        with self._lock:
            tok = self._next_tele
            self._next_tele += 1
            slot = {
                "qid": msg.get("queryId"),
                "left": set(range(self._n)),
                "payloads": {},
                "timer": None,
            }
            self._tele[tok] = slot
        timer = threading.Timer(2.0, self._tele_finish, args=(tok,))
        timer.daemon = True
        slot["timer"] = timer
        timer.start()
        for i in range(self._n):
            self._send_to(
                i,
                {
                    "type": "Query",
                    "queryId": ["_tele", tok, i],
                    "query": {"type": "Telemetry"},
                },
            )

    def _tele_collect(self, tok: int, i: int, payload) -> None:
        with self._lock:
            slot = self._tele.get(tok)
            if slot is None:
                return  # timer already fired with partial results
            slot["payloads"][i] = payload
            slot["left"].discard(i)
            done = not slot["left"]
        if done:
            self._tele_finish(tok)

    def _tele_finish(self, tok: int) -> None:
        with self._lock:
            slot = self._tele.pop(tok, None)
        if slot is None:
            return
        if slot["timer"] is not None:
            slot["timer"].cancel()
        self._dispatch(
            {
                "type": "Reply",
                "queryId": slot["qid"],
                "payload": self._merge_tele(slot["payloads"]),
            }
        )

    def _merge_tele(self, payloads: Dict[int, Any]) -> Dict[str, Any]:
        """One fleet-shaped payload from N worker payloads: counters
        sum, `time` is the max, net doc tables union, and a `workers`
        block (mirrored into `workers.<i>.*` counters so counter-only
        consumers like the Prometheus dump see them too) carries the
        per-worker split."""
        counters: Dict[str, Any] = {}
        merged: Dict[str, Any] = {
            "counters": counters,
            "time": 0.0,
            "workers": {},
        }
        for i in range(self._n):
            p = payloads.get(i)
            with self._lock:
                slot = self._workers[i]
                queue = (
                    len(slot["duplex"]._outbox)
                    if slot is not None
                    else 0
                )
                respawns = self._respawns[i]
                pid = slot["pid"] if slot is not None else None
                alive = p is not None
            edits = 0
            if isinstance(p, dict):
                for name, v in (p.get("counters") or {}).items():
                    if isinstance(v, (int, float)):
                        counters[name] = counters.get(name, 0) + v
                if isinstance(p.get("time"), (int, float)):
                    merged["time"] = max(merged["time"], p["time"])
                for section in ("serve", "dht"):
                    if section in p and section not in merged:
                        merged[section] = p[section]
                net = p.get("net")
                if isinstance(net, dict):
                    merged.setdefault("net", {"docs": {}})[
                        "docs"
                    ].update(net.get("docs") or {})
                pc = p.get("counters") or {}
                # WAL appends count every locally-written change block
                # on the durable plane (the hot-doc bench's metric);
                # engine-applied changes cover the WAL-off config
                edits = pc.get("storage.wal.appends") or pc.get(
                    "live.local_changes", 0
                )
            merged["workers"][str(i)] = {
                "pid": pid,
                "alive": alive,
                "edits": edits,
                "queue": queue,
                "respawns": respawns,
            }
            counters[f"workers.{i}.edits"] = edits
            counters[f"workers.{i}.queue"] = queue
            counters[f"workers.{i}.respawns"] = respawns
        return merged


def serve_backend(
    sock_path: str,
    repo_path: Optional[str] = None,
    memory: bool = False,
    once: bool = True,
    tcp_listen: bool = False,
    tcp_connect: Optional[list] = None,
    hub: bool = False,
    dht: bool = False,
    dht_bootstrap: Optional[list] = None,
    device: "DeviceLike" = None,
) -> None:
    """Host a RepoBackend behind a unix socket. `once` serves a single
    frontend connection then returns (the reference pairs exactly one
    frontend per backend). With `tcp_listen`/`tcp_connect` the backend
    process also joins the peer swarm over TCP (the daemon owns the
    networking; the frontend process needs none of it loaded). With
    `dht` it joins fleet-style instead (net/discovery/ DhtSwarm): dial
    targets come from DHT announce/lookup — no addresses to configure
    beyond `dht_bootstrap` ("host:port" strings; default
    HM_DHT_BOOTSTRAP). The backend runs on `device` (None: the GPU),
    resolved before the socket is bound: without a GPU and without
    device="cpu" this raises and nothing is served."""
    from ..backend.repo_backend import RepoBackend
    from ..device import resolve

    dev = resolve(device)
    if os.path.exists(sock_path):
        os.remove(sock_path)
    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    server.bind(sock_path)
    # backlog > 1: a probe burst (port scan, health check) must not make
    # a real frontend's connect fail with EAGAIN while the accept loop
    # is still tearing down the previous connection (AF_UNIX connect
    # does not wait for backlog space on Linux)
    server.listen(8)
    print(f"backend ready on {sock_path}", flush=True)

    def build_backend() -> "RepoBackend":
        # the daemon's repo + swarm come up BEFORE a frontend attaches:
        # it replicates with peers on its own; the frontend is a client
        back = RepoBackend(path=repo_path, memory=memory, device=dev)
        if dht or dht_bootstrap:
            from .discovery import DhtSwarm

            bootstrap = None
            if dht_bootstrap:
                bootstrap = []
                for addr in dht_bootstrap:
                    h, _, p = addr.rpartition(":")
                    bootstrap.append((h, int(p)))
            swarm = DhtSwarm(bootstrap=bootstrap)
            # fleet posture: every feed on record joins discovery NOW
            # (announce + serve), not at first frontend/doc open
            back.hydrate_feeds()
            back.set_swarm(swarm)
            th, tp = swarm.address
            dh, dp = swarm.dht_address
            print(
                f"dht node {swarm.node.id_hex[:12]}… udp {dh}:{dp} "
                f"swarm listening on {th}:{tp}",
                flush=True,
            )
        elif tcp_listen or tcp_connect:
            from .tcp import TcpSwarm

            swarm = TcpSwarm()
            back.set_swarm(swarm)
            host, port = swarm.address
            print(f"swarm listening on {host}:{port}", flush=True)
            for addr in tcp_connect or []:
                h, _, p = addr.rpartition(":")
                swarm.connect((h, int(p)))
        return back

    if hub:
        # many-frontend mode: every accepted connection joins the hub;
        # the backend's push stream routes by doc interest and Replies
        # by issuing connection. The daemon runs until killed. With
        # HM_WORKERS=N (> 0) the "backend" is a _ShardRouter over N
        # per-doc-range worker processes instead of an in-process
        # RepoBackend — the hub builds no backend (and makes no CUDA
        # context) nor holds the GIL for engine work, and disjoint
        # shards commit in parallel across real processes. (Worker
        # daemons own their own repos, on this daemon's device; swarm
        # flags apply to single-backend daemons only.)
        workers = int(os.environ.get("HM_WORKERS", "0") or "0")
        if workers > 0:
            back = _ShardRouter(repo_path, sock_path, workers, dev.type)
            hub_obj = _FrontendHub(back)
            back.start(hub_obj.dispatch, hub_obj.snapshot_interest)
        else:
            back = build_backend()
            hub_obj = _FrontendHub(back)
            back.subscribe(hub_obj.dispatch)
        try:
            while True:
                conn, _ = server.accept()
                duplex = TcpDuplex(conn, is_client=False)
                if duplex.closed:
                    continue  # probe/failed handshake
                hub_obj.attach(duplex)
        finally:
            back.close()
            server.close()
            if os.path.exists(sock_path):
                os.remove(sock_path)
        return
    back = build_backend()
    idle_sink = False  # a discard sink is attached between frontends
    fence = ReplyFence()  # queryIds are epoch-tagged per frontend: a
    # previous frontend's in-flight handler cannot deliver its late
    # Reply to the next one (whose queryId counter restarts)
    try:
        while True:
            conn, _ = server.accept()
            duplex = TcpDuplex(conn, is_client=False)
            if duplex.closed:
                # failed handshake (probe, health check, misconfigured
                # client): this was not the frontend — the LIVE backend,
                # its swarm, and its replicated state stay untouched
                continue
            if idle_sink:
                # swap the discard sink for the real frontend; drop the
                # handful of messages a push could buffer in the swap
                # window (a PREVIOUS frontend's replies/patches must
                # never reach this one — its queryId counter restarts)
                back.to_frontend.unsubscribe()
                back.to_frontend.drain()
                idle_sink = False
            epoch = fence.advance()
            back.subscribe(fence.gate(duplex.send))
            duplex.on_message(
                lambda msg, _f=fence, _e=epoch: back.receive(
                    _f.inbound(msg, _e)
                )
            )
            gone = threading.Event()
            duplex.on_close(gone.set)
            gone.wait()
            if once:
                return
            # non-once: REUSE the live backend for the next frontend —
            # closing + rebuilding per cycle would rebind the advertised
            # swarm port (stranding --connect peers), drop a :memory:
            # repo's replicated state, and spin up a fresh set of
            # debouncer threads/device caches every cycle. While no
            # frontend is attached, a DISCARD sink consumes pushes
            # (swarm-replicated patches, gossip) so the queue cannot
            # grow without bound on an idle daemon; the next frontend
            # opens its docs fresh and gets its own Ready/patch stream.
            back.to_frontend.unsubscribe()
            back.to_frontend.drain()
            back.subscribe(lambda _msg: None)
            idle_sink = True
    finally:
        back.close()
        server.close()
        if os.path.exists(sock_path):
            os.remove(sock_path)


def connect_frontend(
    sock_path: str,
) -> Tuple["RepoFrontend", Callable[[], None]]:
    """A RepoFrontend wired to a remote backend. Returns (frontend,
    close)."""
    from ..frontend.repo_frontend import RepoFrontend

    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(sock_path)
    duplex = TcpDuplex(sock, is_client=True)
    if duplex.closed:
        raise ConnectionError(
            f"handshake with backend at {sock_path} failed"
        )
    front = RepoFrontend()
    front.subscribe(duplex.send)
    duplex.on_message(front.receive)
    return front, duplex.close


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m hypermerge_tpu_torch.net.ipc",
        description="Host a RepoBackend daemon behind a unix socket.",
    )
    ap.add_argument("repo_path", help="repo directory, or :memory:")
    ap.add_argument("sock_path", help="unix socket for the frontend")
    ap.add_argument(
        "--listen", action="store_true",
        help="join the peer swarm: listen on TCP (address printed)",
    )
    ap.add_argument(
        "--connect", action="append", default=[], metavar="HOST:PORT",
        help="join the peer swarm: dial another backend (repeatable)",
    )
    ap.add_argument(
        "--dht", action="store_true",
        help="join the peer swarm fleet-style via the DHT "
        "(net/discovery/): announce/lookup by doc id, no explicit "
        "addresses; bootstrap from --dht-bootstrap or "
        "HM_DHT_BOOTSTRAP",
    )
    ap.add_argument(
        "--dht-bootstrap", action="append", default=[],
        metavar="HOST:PORT",
        help="DHT bootstrap node (repeatable; implies --dht)",
    )
    ap.add_argument(
        "--persist", action="store_true",
        help="keep serving after a frontend disconnects (ONE live "
        "backend is reused across frontend cycles: swarm port and "
        "replicated state persist)",
    )
    ap.add_argument(
        "--hub", action="store_true",
        help="serve MANY concurrent frontends against the one "
        "backend (per-connection reply routing, per-doc interest "
        "routing) — the many-writer daemon of bench config_writers",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the backend (each worker's, under HM_WORKERS) runs: "
        "the GPU unless the CPU is asked for",
    )
    args = ap.parse_args()
    from ..device import resolve

    try:
        device = resolve(args.device)
    except RuntimeError as e:
        ap.exit(1, f"{ap.prog}: {e}\n")
    serve_backend(
        args.sock_path,
        repo_path=None if args.repo_path == ":memory:" else args.repo_path,
        memory=args.repo_path == ":memory:",
        once=not args.persist,
        tcp_listen=args.listen,
        tcp_connect=args.connect,
        hub=args.hub,
        dht=args.dht,
        dht_bootstrap=args.dht_bootstrap,
        device=device,
    )


if __name__ == "__main__":
    main()
