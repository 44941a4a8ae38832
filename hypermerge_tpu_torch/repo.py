"""Repo — the facade binding one RepoFrontend and one RepoBackend (the
port's copy of hypermerge_tpu/repo.py).

Parity: reference src/Repo.ts:11-58 — wires the two halves with mutual
subscribe and re-exports their methods. Here both halves live in-process;
the message protocol between them is plain dicts, so either half can be
moved across a thread/process boundary without API changes (the
reference's stated design goal, README.md:160-184).

The backend runs its kernels on `device`: cuda unless the caller asks for
"cpu" (device.resolve raises when no GPU is present). `set_swarm`
attaches a peer swarm (net/: TcpSwarm over encrypted, authenticated TCP,
or the in-process LoopbackSwarm); changes that arrive from a peer apply
through the live engine's tick on that device. Hyperfiles
(files/) are the reference's: `back.get_file_store()` writes and reads
them as feeds of their own, a remote one fetched over the swarm, and
`start_file_server` serves them over HTTP on a unix socket, which `files`
(a FileServerClient) then talks to.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .backend.repo_backend import RepoBackend
from .device import DeviceLike
from .frontend.handle import Handle
from .frontend.repo_frontend import RepoFrontend
from .utils.ids import DocUrl


class Repo:
    def __init__(
        self, path: Optional[str] = None, memory: bool = False,
        device: DeviceLike = None,
    ) -> None:
        self.front = RepoFrontend()
        self.back = RepoBackend(path=path, memory=memory, device=device)
        self.front.subscribe(self.back.receive)
        self.back.subscribe(self.front.receive)

    # -- identity -------------------------------------------------------

    @property
    def id(self) -> str:
        return self.back.id

    # -- doc api (delegated to the frontend) ---------------------------

    def create(self, init: Optional[dict] = None) -> DocUrl:
        return self.front.create(init)

    def open(self, url: str) -> Handle:
        return self.front.open(url)

    def open_many(self, urls) -> list:
        """Batched cold open: one backend bulk load (device slabs for
        large counts), handles whose snapshots decode lazily on first
        read. THE way to bring a big repo up (BASELINE config 4)."""
        return self.front.open_many(urls)

    def doc(self, url: str, cb: Optional[Callable] = None) -> Any:
        return self.front.doc(url, cb)

    def read(
        self, url: str, query: dict, cb: Optional[Callable] = None
    ) -> Any:
        """One-shot read served WITHOUT materializing the doc
        host-side: under HM_SERVE=1 (default) the backend's serving
        tier answers from device-resident summary columns via batched
        device query kernels; HM_SERVE=0 is the bit-identical
        per-request host twin. Query kinds: {"kind": "text", "path":
        ["body"]}, {"kind": "lookup", "path": ["a", "b"]}, {"kind":
        "index", "path": ["list"], "index": 3}, {"kind": "len",
        "path": []}, {"kind": "clock"}, {"kind": "history"}. A device
        fault of the tier raises serve.ServeDeviceError (the cb path
        gets {"_error": message}), never a None."""
        return self.front.read(url, query, cb)

    def watch(self, url: str, cb: Callable[[Any, int], None]) -> Handle:
        return self.front.watch(url, cb)

    def change(
        self, url: str, fn: Callable[[Any], None], message: str = ""
    ) -> None:
        self.front.change(url, fn, message)

    def merge(
        self, url: str, target: str, timeout: Optional[float] = 30.0
    ) -> None:
        """Adopt `target`'s actors/clock into `url`. If the target is an
        unknown doc that never becomes ready, the pending merge expires
        after `timeout` seconds (logged; pass None to wait forever)."""
        self.front.merge(url, target, timeout=timeout)

    def fork(self, url: str) -> DocUrl:
        return self.front.fork(url)

    def materialize(
        self, url: str, history: int, cb: Callable[[Any], None]
    ) -> None:
        self.front.materialize(url, history, cb)

    def meta(self, url: str, cb: Callable[[Any], None]) -> None:
        self.front.meta(url, cb)

    def telemetry(self, cb: Callable[[Any], None]) -> None:
        """Backend telemetry snapshot (see RepoFrontend.telemetry)."""
        self.front.telemetry(cb)

    def message(self, url: str, contents: Any) -> None:
        self.front.message(url, contents)

    def close_doc(self, url: str) -> None:
        self.front.close_doc(url)

    def destroy(self, url: str) -> None:
        self.front.destroy(url)

    def debug(self, url: str) -> dict:
        return self.front.debug(url)

    # -- infrastructure -------------------------------------------------

    @property
    def files(self):
        return self.front.files

    def set_swarm(self, swarm, join_options=None) -> None:
        """Attach a peer swarm. `join_options` sets the repo's swarm
        posture (net/swarm.JoinOptions — announce and/or lookup;
        reference src/Repo.ts:20 setSwarm(swarm, joinOptions)). Under
        HM_FAULT the swarm is wrapped in a seeded FaultSwarm
        (net/faults.py)."""
        self.back.set_swarm(swarm, join_options)

    def start_file_server(self, path: str) -> None:
        self.back.start_file_server(path)

    def close(self) -> None:
        self.back.close()
