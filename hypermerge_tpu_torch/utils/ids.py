"""Branded id types and id<->url codecs.

Maps reference src/Misc.ts:6-57: RepoId/DocId/ActorId/HyperfileId are all
base58 public keys with distinct roles; urls are `hypermerge:/<docId>` and
`hyperfile:/<hyperfileId>`. `root_actor_id(doc_id) == doc_id` — the document
id doubles as its root actor's feed key (reference src/Misc.ts:51-53).

Python has no nominal branded strings; we use NewType aliases for static
clarity and runtime validator functions (reference src/Metadata.ts:83-121
validateURL/validateDocURL/validateFileURL).
"""

from __future__ import annotations

from typing import NewType, Tuple, Union

from . import base58

RepoId = NewType("RepoId", str)
DocId = NewType("DocId", str)
ActorId = NewType("ActorId", str)
HyperfileId = NewType("HyperfileId", str)
DiscoveryId = NewType("DiscoveryId", str)
DocUrl = NewType("DocUrl", str)
HyperfileUrl = NewType("HyperfileUrl", str)

DOC_SCHEME = "hypermerge"
FILE_SCHEME = "hyperfile"


def is_base58_key(s: str) -> bool:
    try:
        return len(base58.decode(s)) == 32
    except ValueError:
        return False


def to_doc_url(doc_id: str) -> DocUrl:
    return DocUrl(f"{DOC_SCHEME}:/{doc_id}")


def to_hyperfile_url(file_id: str) -> HyperfileUrl:
    return HyperfileUrl(f"{FILE_SCHEME}:/{file_id}")


def parse_url(url: str) -> Tuple[str, str]:
    """Returns (scheme, id). Raises ValueError on malformed urls."""
    scheme, sep, rest = url.partition(":/")
    if not sep or not rest or "/" in rest:
        raise ValueError(f"invalid url: {url!r}")
    if not is_base58_key(rest):
        raise ValueError(f"url id is not a valid key: {url!r}")
    return scheme, rest


def validate_url(url: str) -> Tuple[str, str]:
    scheme, id_ = parse_url(url)
    if scheme not in (DOC_SCHEME, FILE_SCHEME):
        raise ValueError(f"unknown url scheme: {url!r}")
    return scheme, id_


def validate_doc_url(url: Union[str, DocUrl]) -> DocId:
    scheme, id_ = parse_url(url)
    if scheme != DOC_SCHEME:
        raise ValueError(f"not a document url: {url!r}")
    return DocId(id_)


def validate_file_url(url: Union[str, HyperfileUrl]) -> HyperfileId:
    scheme, id_ = parse_url(url)
    if scheme != FILE_SCHEME:
        raise ValueError(f"not a hyperfile url: {url!r}")
    return HyperfileId(id_)


def url_to_id(url: str) -> str:
    return parse_url(url)[1]


def is_doc_url(url: str) -> bool:
    try:
        validate_doc_url(url)
        return True
    except ValueError:
        return False


def is_file_url(url: str) -> bool:
    try:
        validate_file_url(url)
        return True
    except ValueError:
        return False


def root_actor_id(doc_id: DocId) -> ActorId:
    """The document id IS its root actor's feed public key."""
    return ActorId(str(doc_id))


def get_or_create(mapping, key, factory):
    """dict.setdefault with a lazy factory (reference src/Misc.ts:76-93)."""
    try:
        return mapping[key]
    except KeyError:
        value = factory(key)
        mapping[key] = value
        return value
