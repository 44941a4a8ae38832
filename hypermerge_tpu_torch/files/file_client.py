"""FileServerClient: frontend-side HTTP client of the file server.

Parity: reference src/FileServerClient.ts:8-59 — write/header/read over
the Unix-socket server the backend announced via FileServerReady.
"""

from __future__ import annotations

import http.client
import socket
from typing import Iterable, Tuple, Union

from ..utils import json_buffer
from ..utils.ids import validate_file_url
from .file_store import FileHeader


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: float = 30.0) -> None:
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._socket_path)
        self.sock = sock


class FileServerClient:
    def __init__(self, socket_path: str) -> None:
        self.socket_path = socket_path

    def _conn(self) -> _UnixHTTPConnection:
        return _UnixHTTPConnection(self.socket_path)

    def write(
        self,
        data: Union[bytes, Iterable[bytes]],
        mime_type: str = "application/octet-stream",
    ) -> FileHeader:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            data = b"".join(data)
        conn = self._conn()
        try:
            conn.request(
                "POST", "/", body=bytes(data), headers={"Content-Type": mime_type}
            )
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise IOError(f"upload failed ({resp.status}): {body!r}")
            return FileHeader.from_json(json_buffer.parse(body))
        finally:
            conn.close()

    def header(self, url: str) -> FileHeader:
        file_id = validate_file_url(url)
        conn = self._conn()
        try:
            conn.request("HEAD", f"/hyperfile:/{file_id}")
            resp = conn.getresponse()
            resp.read()
            if resp.status != 200:
                raise FileNotFoundError(url)
            return FileHeader(
                url=url,
                size=int(resp.headers["Content-Length"]),
                mime_type=resp.headers["Content-Type"],
                sha256=resp.headers["ETag"],
                blocks=int(resp.headers["X-Block-Count"]),
            )
        finally:
            conn.close()

    def read(self, url: str) -> Tuple[FileHeader, bytes]:
        file_id = validate_file_url(url)
        conn = self._conn()
        try:
            conn.request("GET", f"/hyperfile:/{file_id}")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise FileNotFoundError(url)
            header = FileHeader(
                url=url,
                size=int(resp.headers["Content-Length"]),
                mime_type=resp.headers["Content-Type"],
                sha256=resp.headers["ETag"],
                blocks=int(resp.headers["X-Block-Count"]),
            )
            return header, body
        finally:
            conn.close()
