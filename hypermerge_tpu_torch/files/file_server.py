"""FileServer: HTTP over a Unix socket serving hyperfiles.

Parity: reference src/FileServer.ts:7-101 — `POST /` uploads a body and
replies with the file header JSON; `GET/HEAD /hyperfile:/<id>` serves the
blob with ETag=sha256, Content-Length, Content-Type=mimeType and
X-Block-Count headers (src/FileServer.ts:84-93). The socket path comes
from the repo (FileServerReady message), mirroring toIpcPath
(src/Misc.ts:120-129) — on this platform a plain Unix socket path.
"""

from __future__ import annotations

import os
import socketserver
import threading
from http.server import BaseHTTPRequestHandler
from typing import Optional

from ..utils import json_buffer
from ..utils.ids import validate_file_url
from .file_store import FileStore
from .stream_logic import MAX_BLOCK_SIZE


class _UnixHTTPServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class _Handler(BaseHTTPRequestHandler):
    # Set per-server via type(); silences default stderr logging.
    store: FileStore = None  # type: ignore[assignment]
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # pragma: no cover - silence
        pass

    # BaseHTTPRequestHandler wants a client address tuple; over AF_UNIX
    # it's a string or empty — normalize so logging helpers don't choke.
    def address_string(self) -> str:  # pragma: no cover
        return "unix"

    def _body_chunks(self, length: int):
        remaining = length
        while remaining > 0:
            chunk = self.rfile.read(min(remaining, MAX_BLOCK_SIZE))
            if not chunk:
                # A short body means the client disconnected mid-upload.
                # Raising here aborts FileStore.write BEFORE the trailing
                # header block is appended, so the truncated feed is never
                # durably recorded as a complete file (header-last
                # completeness contract, reference src/FileStore.ts:38-67).
                raise ConnectionError(
                    f"client disconnected with {remaining} bytes unread"
                )
            remaining -= len(chunk)
            yield chunk

    def do_POST(self) -> None:
        length = int(self.headers.get("Content-Length", "0"))
        if self.path != "/":
            # drain the body so a keep-alive connection stays parseable
            try:
                for _ in self._body_chunks(length):
                    pass
            except ConnectionError:
                self.close_connection = True
                return
            self._error(404, "upload path is /")
            return
        mime = self.headers.get("Content-Type", "application/octet-stream")
        # stream straight into the chunked write path — never buffer the
        # whole upload in memory
        try:
            header = self.store.write(self._body_chunks(length), mime)
        except ConnectionError as exc:
            self.close_connection = True
            try:
                self._error(400, str(exc))
            except OSError:
                pass  # the socket is gone; nothing to tell the client
            return
        payload = json_buffer.bufferify(header.to_json())
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:
        self._serve(send_body=True)

    def do_HEAD(self) -> None:
        self._serve(send_body=False)

    def _serve(self, send_body: bool) -> None:
        try:
            file_id = validate_file_url(self.path.lstrip("/"))
        except ValueError as exc:
            self._error(404, str(exc))
            return
        remote_wait = 0.0
        try:
            header = self.store.header(file_id)
        except (FileNotFoundError, KeyError, ValueError) as exc:
            # not held locally: a swarm-wired store can fetch it from a
            # peer (reference behavior — file feeds replicate like any
            # feed); bounded wait, then stream as blocks arrive
            remote_wait = float(
                os.environ.get("HM_FILE_FETCH_TIMEOUT_S", "15")
            )
            if not self.store.remote_capable() or remote_wait <= 0:
                self._error(404, str(exc))
                return
            try:
                header = self.store.header_wait(file_id, remote_wait)
            except TimeoutError as texc:
                self._error(404, str(texc))
                return
        self.send_response(200)
        self.send_header("Content-Type", header.mime_type)
        self.send_header("Content-Length", str(header.size))
        self.send_header("ETag", header.sha256)
        self.send_header("X-Block-Count", str(header.blocks))
        self.end_headers()
        if send_body:
            for chunk in self.store.read(file_id, timeout=remote_wait):
                self.wfile.write(chunk)

    def _error(self, code: int, message: str) -> None:
        body = json_buffer.bufferify({"error": message})
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        # HEAD responses carry headers only (RFC 9110 §9.3.2) — writing a
        # body would desync a keep-alive client's framing.
        if self.command != "HEAD":
            self.wfile.write(body)


class FileServer:
    def __init__(self, store: FileStore) -> None:
        self.store = store
        self._server: Optional[_UnixHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def listen(self, path: str) -> None:
        if os.path.exists(path):
            os.unlink(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        handler = type("BoundHandler", (_Handler,), {"store": self.store})
        self._server = _UnixHTTPServer(path, handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="file-server"
        )
        self._thread.start()

    @property
    def listening(self) -> bool:
        return self._server is not None

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            try:
                os.unlink(self._server.server_address)  # type: ignore[arg-type]
            except OSError:
                pass
            self._server = None
