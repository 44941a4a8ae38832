"""Handle — the user-facing subscription object.

Parity: reference src/Handle.ts:5-124 — one value subscriber, one progress
subscriber, one message subscriber per handle; change/fork/merge
conveniences; close() detaches.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


class Handle(Generic[T]):
    def __init__(self, doc_frontend) -> None:
        self._df = doc_frontend
        self.id = doc_frontend.doc_id
        self.url = doc_frontend.url
        self.value_fn: Optional[Callable[[T, int], None]] = None
        self.progress_fn: Optional[Callable[[dict], None]] = None
        self.message_fn: Optional[Callable[[Any], None]] = None
        self._state: Optional[T] = None
        self._index = 0
        self._have_state = threading.Event()
        self._closed = False

    # -- pushes from DocFrontend ---------------------------------------

    def push(self, state: T, index: int) -> None:
        if self._closed:
            return
        self._state = state
        self._index = index
        self._have_state.set()
        if self.value_fn is not None:
            self.value_fn(state, index)

    def push_progress(self, progress: dict) -> None:
        if not self._closed and self.progress_fn is not None:
            self.progress_fn(progress)

    def push_message(self, contents: Any) -> None:
        if not self._closed and self.message_fn is not None:
            self.message_fn(contents)

    # -- subscription api ----------------------------------------------

    def subscribe(self, fn: Callable[[T, int], None]) -> "Handle[T]":
        if self.value_fn is not None:
            raise RuntimeError("handle already has a value subscriber")
        self.value_fn = fn
        self._df.poke()  # resolve a lazy-ready (bulk-opened) doc
        if self._have_state.is_set():
            fn(self._state, self._index)
        return self

    def once(self, fn: Callable[[T, int], None]) -> "Handle[T]":
        def one(state: T, index: int) -> None:
            self.value_fn = None
            fn(state, index)

        return self.subscribe(one)

    def subscribe_progress(self, fn: Callable[[dict], None]) -> "Handle[T]":
        self.progress_fn = fn
        return self

    def subscribe_message(self, fn: Callable[[Any], None]) -> "Handle[T]":
        self.message_fn = fn
        return self

    def value(self, timeout: Optional[float] = 10.0) -> T:
        """Blocking convenience: the latest materialized state (set as soon
        as the doc is ready)."""
        self._df.poke()  # resolve a lazy-ready (bulk-opened) doc
        if not self._have_state.wait(timeout):
            raise TimeoutError(f"doc {self.id[:6]} never became ready")
        return self._state  # type: ignore[return-value]

    # -- conveniences ---------------------------------------------------

    def change(self, fn: Callable[[Any], None], message: str = "") -> None:
        self._df.change(fn, message)

    def fork(self) -> str:
        """A new doc seeded with this one's state (reference
        src/Handle.ts:21-23)."""
        return self._df._repo.fork(self.url)

    def merge(self, other: "Handle") -> "Handle[T]":
        """Adopt `other`'s actors into this doc (reference
        src/Handle.ts:33-36)."""
        self._df._repo.merge(self.url, other.url)
        return self

    def message(self, contents: Any) -> None:
        self._df.send_doc_message(contents)

    def close(self) -> None:
        self._closed = True
        self.value_fn = None
        self.progress_fn = None
        self.message_fn = None
        self._df.release_handle(self)
