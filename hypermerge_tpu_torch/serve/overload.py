"""The typed refusal of the reference's service plane — the one part of
hypermerge_tpu/serve/overload.py the port needs.

The reference's OverloadController (brownout ladder, per-tenant quotas)
is not ported: the port runs as the reference does under HM_SERVICE=0,
and its backend never refuses a read. RepoFrontend.read still knows the
refusal payload, so it keeps the exception that payload raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Overload(RuntimeError):
    """A typed refusal from the front door: raised by the blocking
    ``Repo.read`` path when the backend answers with an overload payload
    instead of a value."""

    def __init__(
        self,
        retry_after_s: float,
        state: str = "shed",
        tenant: Optional[str] = None,
    ) -> None:
        super().__init__(
            f"overloaded ({state}): retry after {retry_after_s:.3f}s"
        )
        self.retry_after_s = retry_after_s
        self.state = state
        self.tenant = tenant


def overload_error(info: Dict[str, Any]) -> Overload:
    """The ``{"overload": {...}}`` reply payload, as an exception."""
    return Overload(
        float(info.get("retry_after_s", 0.1)),
        str(info.get("state", "shed")),
        info.get("tenant"),
    )
