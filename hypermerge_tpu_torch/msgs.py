"""Message schemas: the three wire protocols.

Parity with the reference's protocol files (SURVEY.md §2.1):
- frontend <-> backend repo messages (reference src/RepoMsg.ts:6-158)
- connection handshake messages (reference src/NetworkMsg.ts:3-13)
- peer <-> peer doc messages (reference src/PeerMsg.ts:4-17)

All messages are plain dicts (JSON-serializable) with a "type" tag, so the
frontend/backend boundary can cross threads or processes unchanged — the
seam where the device bulk backend plugs in (SURVEY.md §7.1). Constructors
below are thin typed helpers; consumers dispatch on msg["type"].
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# frontend -> backend


def create_msg(public_key: str, secret_key: str) -> Dict[str, Any]:
    return {"type": "Create", "publicKey": public_key, "secretKey": secret_key}


def open_msg(doc_id: str) -> Dict[str, Any]:
    return {"type": "Open", "id": doc_id}


def open_bulk_msg(doc_ids: List[str]) -> Dict[str, Any]:
    """Open many docs in one batched cold start (backend
    load_documents_bulk — the device slab path)."""
    return {"type": "OpenBulk", "ids": list(doc_ids)}


def request_msg(doc_id: str, request: Dict[str, Any]) -> Dict[str, Any]:
    """A local ChangeRequest (crdt.change.ChangeRequest.to_json())."""
    return {"type": "Request", "id": doc_id, "request": request}


def close_msg(doc_id: str) -> Dict[str, Any]:
    return {"type": "Close", "id": doc_id}


def destroy_msg(doc_id: str) -> Dict[str, Any]:
    return {"type": "Destroy", "id": doc_id}


def merge_msg(doc_id: str, actors: List[str]) -> Dict[str, Any]:
    """actors: clock strings ("<actor>:<seq>" | "<actor>")."""
    return {"type": "Merge", "id": doc_id, "actors": actors}


def needs_actor_msg(doc_id: str) -> Dict[str, Any]:
    return {"type": "NeedsActorId", "id": doc_id}


def doc_message_msg(doc_id: str, contents: Any) -> Dict[str, Any]:
    """Ephemeral app-level message routed to peers of a doc."""
    return {"type": "DocMessage", "id": doc_id, "contents": contents}


def query_msg(query_id: int, query: Dict[str, Any]) -> Dict[str, Any]:
    """Query/reply envelope (Materialize, Metadata — reference
    QueryMsg/ReplyMsg wrapping, src/RepoMsg.ts)."""
    return {"type": "Query", "queryId": query_id, "query": query}


def materialize_query(doc_id: str, history: int) -> Dict[str, Any]:
    return {"type": "Materialize", "id": doc_id, "history": history}


def metadata_query(url_id: str) -> Dict[str, Any]:
    return {"type": "Metadata", "id": url_id}


def read_query(doc_id: str, query: Dict[str, Any]) -> Dict[str, Any]:
    """A one-shot read against the serving tier (serve/tier.py
    READ_KINDS): answered from device-resident state under HM_SERVE=1,
    from per-request host materialization under HM_SERVE=0 —
    bit-identical payloads either way."""
    return {"type": "Read", "id": doc_id, "query": dict(query)}


def telemetry_query() -> Dict[str, Any]:
    """Process-wide telemetry snapshot (counters + trace state) from
    the backend — the live-introspection feed tools/top.py polls over
    the IPC/serve seam."""
    return {"type": "Telemetry"}


# ---------------------------------------------------------------------------
# backend -> frontend


def ready_msg(
    doc_id: str,
    actor_id: Optional[str],
    patch: Optional[Dict[str, Any]],
    history: int,
) -> Dict[str, Any]:
    return {
        "type": "Ready",
        "id": doc_id,
        "actorId": actor_id,
        "patch": patch,
        "history": history,
    }


def actor_id_msg(doc_id: str, actor_id: str) -> Dict[str, Any]:
    return {"type": "ActorId", "id": doc_id, "actorId": actor_id}


def patch_msg(
    doc_id: str, patch: Dict[str, Any], history: int
) -> Dict[str, Any]:
    return {"type": "Patch", "id": doc_id, "patch": patch, "history": history}


def doc_message_fwd_msg(doc_id: str, contents: Any) -> Dict[str, Any]:
    return {"type": "DocMessageFwd", "id": doc_id, "contents": contents}


def reply_msg(query_id: int, payload: Any) -> Dict[str, Any]:
    return {"type": "Reply", "queryId": query_id, "payload": payload}


def download_msg(
    doc_id: str, actor_id: str, index: int, size: int, elapsed_ms: float
) -> Dict[str, Any]:
    """Block-download progress (reference ActorBlockDownloadedMsg,
    src/RepoMsg.ts:146-153)."""
    return {
        "type": "Download",
        "id": doc_id,
        "actorId": actor_id,
        "index": index,
        "size": size,
        "time": elapsed_ms,
    }


def file_server_ready_msg(path: str) -> Dict[str, Any]:
    return {"type": "FileServerReady", "path": path}


def bulk_ready_msg(doc_ids: List[str]) -> Dict[str, Any]:
    """Bulk cold start finished: these docs are ready backend-side; a
    frontend opening one receives its Ready (with snapshot patch) then.
    Keeping the per-doc patch out of this message is the point — 10k
    snapshot decodes must not happen eagerly."""
    return {"type": "BulkReady", "ids": list(doc_ids)}


# ---------------------------------------------------------------------------
# connection handshake (reference src/NetworkMsg.ts)


def info_msg(peer_id: str) -> Dict[str, Any]:
    return {"type": "Info", "peerId": peer_id}


def confirm_connection_msg(connection_id: str) -> Dict[str, Any]:
    return {"type": "ConfirmConnection", "connectionId": connection_id}


# ---------------------------------------------------------------------------
# peer <-> peer (reference src/PeerMsg.ts)


def cursor_message(
    doc_id: str, cursors: Dict[str, Any], clocks: Dict[str, Any]
) -> Dict[str, Any]:
    """Cursor + clock gossip per doc (reference CursorMessage)."""
    return {
        "type": "CursorMessage",
        "id": doc_id,
        "cursors": cursors,
        "clocks": clocks,
    }


def document_message(doc_id: str, contents: Any) -> Dict[str, Any]:
    return {"type": "DocumentMessage", "id": doc_id, "contents": contents}
