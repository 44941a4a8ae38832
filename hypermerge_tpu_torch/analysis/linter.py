"""Static invariant linter: machine-checks the concurrency rules this
repo used to enforce by comment.

One AST pass over the port's tree (the package, bench_torch/ and
chip_smoke.py), driven by the declared rule data in
`analysis/hierarchy.py` and `analysis/envvars.py`:

- **lock-order** — nested `with` acquisitions must follow the declared
  rank order (doc.emit -> engine -> doc -> repo -> actor -> store.*;
  leaves nest nothing), and no ENGINE_ENTRYPOINTS call may run under a
  lock ranked below the engine (the repo->engine inversion that made
  the open()/Ready deadlock).
- **no-block** — no blocking primitive (fsync / socket send / sqlite
  commit / join / sleep / first-wait) lexically inside a `with` region
  holding a no-block class (the emission locks). The runtime half
  (`lockdep.blocking`) catches the interprocedural cases this lexical
  rule cannot see.
- **churn-send** — no direct `X.connection.send(...)` /
  `X.connection.open_channel(...)` outside net/peer.py:
  `NetworkPeer.try_send` is THE churn-safe send idiom (`connection`
  can flip to None between a check and the send).
- **env-registry** — every `os.environ` read of an `HM_*` name must be
  declared in `analysis/envvars.py`, with the call-site default
  matching the registered one; registry entries nothing reads, and
  entries missing from the README table, are violations too.
- **telemetry-name** — registry series created with a literal name
  must match the `subsystem.metric` dotted convention
  (`live.ticks`, `net.tcp.frames_tx`); the runtime half asserts the
  same at registry-creation time under HM_LOCKDEP=1.
- **raw-lock** — every `threading.Lock()/RLock()/Condition()` creation
  in the package must go through `analysis.lockdep.make_lock /
  make_rlock / make_condition` (with a class declared in the
  manifest), so runtime lockdep sees every lock. Bare test/analysis
  code is exempt.
- **guarded-attr** — every `self.<attr>` read/write of an attribute
  declared in the guard manifest (`analysis/guards.py`, the
  GUARDED_BY map) must sit lexically inside a `with` of its declared
  guard or inside a `guards.REQUIRES` method. Writes are hard errors;
  reads may satisfy the `atomic_read_ok` escape; `init_only` fields
  flag any write outside `__init__`. Tree runs also flag stale
  manifest entries and classes missing from the README guard table.
  The runtime half (`HM_RACEDEP=1` lockset descriptors) covers the
  non-`self` receivers and interprocedural flows this lexical rule
  cannot see.

Suppression requires a justification, either inline —

    ...  # lint: allow(no-block) — <why this one is safe>

— or as an entry in `analysis/suppressions.py`. A suppression with an
empty justification, or a file entry matching nothing, is itself a
violation: the suppressions file cannot silently rot.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

from . import guards as guardsmod
from . import suppressions as suppmod
from .envvars import BY_NAME as ENV_BY_NAME, REGISTRY as ENV_REGISTRY
from .hierarchy import (
    BLOCKING_CALLS,
    BY_NAME as LOCK_BY_NAME,
    ENGINE_ENTRYPOINTS,
    LEAVES,
    NO_BLOCK,
    RANKED,
    TELEMETRY_NAME_RE,
)

RULES = (
    "lock-order",
    "no-block",
    "churn-send",
    "env-registry",
    "telemetry-name",
    "raw-lock",
    "guarded-attr",
    "suppression",
)

# method names that MUTATE the container a guarded field holds — for
# the guarded-attr rule, `self._docs.pop(...)` is a WRITE to the
# field's state, not a read (field-level granularity would otherwise
# let `atomic_read_ok` excuse a lock-free mutation)
_MUTATORS = frozenset(
    {
        "append", "appendleft", "add", "pop", "popitem", "clear",
        "remove", "discard", "insert", "extend", "setdefault",
        "move_to_end",
    }
)

_NAME_RE = TELEMETRY_NAME_RE
_PREFIX_RE = re.compile(r"^[a-z][a-z0-9_]*\.")
_ALLOW_RE = re.compile(
    r"#\s*lint:\s*allow\(([a-z-]+)\)\s*(?:[-—–:]+\s*(.*))?$"
)

# receivers we trust to be the metrics registry (telemetry-name rule)
_REGISTRY_RECEIVERS = {"telemetry", "reg", "registry", "REGISTRY"}
_ENGINE_RANK = RANKED["live.engine"]


class Violation(NamedTuple):
    rule: str
    path: str  # repo-relative
    line: int
    msg: str
    suppressed: bool
    justification: str = ""

    def format(self) -> str:
        mark = " [suppressed]" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.msg}{mark}"


# ---------------------------------------------------------------------------
# scope


def repo_root() -> str:
    """The tree the linter covers (parent of the package dir)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def default_files(root: Optional[str] = None) -> List[str]:
    root = root or repo_root()
    out: List[str] = []
    pkg = os.path.join(root, "hypermerge_tpu_torch")
    for base in (pkg, os.path.join(root, "bench_torch")):
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    for fn in ("chip_smoke.py",):
        p = os.path.join(root, fn)
        if os.path.exists(p):
            out.append(p)
    return out


def _rel(path: str, root: str) -> str:
    try:
        return os.path.relpath(path, root)
    except ValueError:  # pragma: no cover - windows drives
        return path


def _in_package(rel: str) -> bool:
    return rel.replace(os.sep, "/").startswith("hypermerge_tpu_torch/")


# ---------------------------------------------------------------------------
# lock-expression resolution


class _LockTable:
    """Maps lock-holding expressions to manifest classes, derived from
    the factory call sites themselves (`self._x = make_rlock("cls")`):
    the code is the single source of truth, the linter just reads it.

    Resolution for `with` items:
      - `self.<attr>`     -> exact (module class, attr) binding
      - `<name>.<attr>`   -> by attr, when the attr is unique tree-wide
      - `<name>`          -> module-level binding
      - `<x>.emission`    -> doc.emit (the per-doc EmissionDomain)
    """

    def __init__(self) -> None:
        self.by_class_attr: Dict[Tuple[str, str], str] = {}
        self.by_attr: Dict[str, Set[str]] = {}
        self.module_names: Dict[Tuple[str, str], str] = {}

    def learn(self, rel: str, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for sub in ast.walk(node):
                cls = self._factory_class(sub)
                if cls is None:
                    continue
                for tgt in sub.targets:  # type: ignore[attr-defined]
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        self.by_class_attr[(node.name, tgt.attr)] = cls
                        self.by_attr.setdefault(tgt.attr, set()).add(cls)
        for node in ast.walk(tree):
            cls = self._factory_class(node)
            if cls is None:
                continue
            for tgt in node.targets:  # type: ignore[attr-defined]
                if isinstance(tgt, ast.Name):
                    self.module_names[(rel, tgt.id)] = cls
                    self.by_attr.setdefault(tgt.id, set()).add(cls)

    @staticmethod
    def _factory_class(node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Assign):
            return None
        call = node.value
        if not isinstance(call, ast.Call) or not call.args:
            return None
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None
        )
        if name not in ("make_lock", "make_rlock", "make_condition"):
            return None
        arg = call.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
        return None

    def resolve(
        self, expr: ast.AST, rel: str, cls_name: Optional[str]
    ) -> Optional[str]:
        if isinstance(expr, ast.Call):
            return None
        if isinstance(expr, ast.Attribute):
            if expr.attr == "emission":
                return "doc.emit"
            if (
                isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and cls_name is not None
            ):
                hit = self.by_class_attr.get((cls_name, expr.attr))
                if hit is not None:
                    return hit
            owners = self.by_attr.get(expr.attr, set())
            if len(owners) == 1:
                return next(iter(owners))
            return None
        if isinstance(expr, ast.Name):
            return self.module_names.get((rel, expr.id))
        return None


# ---------------------------------------------------------------------------
# helpers


def _call_name(node: ast.Call) -> Optional[str]:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted rendering of an attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _env_name(node: ast.Call) -> Optional[Tuple[str, Optional[str]]]:
    """(HM_* name, literal default or None) for an os.environ read.
    Matches `<any>.environ.get`, `<any>.getenv` (import aliases like
    `_os` included) and bare `environ.get`/`getenv`."""
    dotted = _dotted(node.func)
    leaf = dotted.rsplit(".", 1)[-1] if dotted else ""
    is_get = dotted.endswith("environ.get") or dotted == "environ.get"
    if not (is_get or leaf == "getenv"):
        return None
    if node.args and isinstance(node.args[0], ast.Constant):
        name = node.args[0].value
        if isinstance(name, str) and name.startswith("HM_"):
            default: Optional[str] = None
            if len(node.args) > 1 and isinstance(
                node.args[1], ast.Constant
            ):
                d = node.args[1].value
                default = d if isinstance(d, str) else None
            return name, default
    return None


def _env_subscript(node: ast.Subscript) -> Optional[str]:
    """HM_* name for an `os.environ["HM_X"]` READ (Load context)."""
    if not isinstance(node.ctx, ast.Load):
        return None
    if not (
        isinstance(node.value, ast.Attribute)
        and node.value.attr == "environ"
    ):
        return None
    sl = node.slice
    if isinstance(sl, ast.Constant) and isinstance(sl.value, str) and (
        sl.value.startswith("HM_")
    ):
        return sl.value
    return None


def _literal_prefix(node: ast.AST) -> Optional[str]:
    """The leading literal text of a metric-name expression: full
    string for a Constant, left side of a `"lit" + x` BinOp, leading
    literal of an f-string. None when nothing literal leads."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _literal_prefix(node.left)
    if isinstance(node, ast.JoinedStr) and node.values:
        first = node.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return first.value
    return None


# ---------------------------------------------------------------------------
# the per-file rule pass


class _FileLinter(ast.NodeVisitor):
    def __init__(
        self,
        rel: str,
        src: str,
        table: _LockTable,
        out: List[Violation],
        env_reads: Dict[str, List[Tuple[str, int, Optional[str]]]],
        guard_seen: Optional[Set[Tuple[str, str]]] = None,
    ) -> None:
        self.rel = rel
        self.relu = rel.replace(os.sep, "/")
        self.lines = src.splitlines()
        self.table = table
        self.out = out
        self.env_reads = env_reads
        self.guard_seen = guard_seen if guard_seen is not None else set()
        self.cls_stack: List[str] = []
        # (class name or None, line) per enclosing `with` item that
        # resolved to a tracked lock
        self.with_stack: List[Tuple[Optional[str], int]] = []
        self.fn_depth_at_with: List[int] = []
        self.fn_depth = 0
        self.fn_stack: List[str] = []
        # guarded-attr: self.<attr> nodes already classified as writes
        # (assignment targets, mutator receivers) — visit_Attribute
        # must not re-classify them as reads
        self._guard_done: Set[int] = set()
        self.in_pkg = _in_package(rel)
        self.is_peer = self.relu.endswith("net/peer.py")
        self.is_analysis = "/analysis/" in "/" + self.relu

    # -- emit ----------------------------------------------------------

    def hit(self, rule: str, line: int, msg: str) -> None:
        self.out.append(
            Violation(rule, self.rel, line, msg, False)
        )

    # -- structure tracking --------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.cls_stack.append(node.name)
        self.generic_visit(node)
        self.cls_stack.pop()

    def _visit_fn(self, node) -> None:
        name = getattr(node, "name", "<lambda>")
        self.fn_stack.append(name)
        self.fn_depth += 1
        # a method listed in guards.REQUIRES runs its WHOLE body with
        # the named lock held (every caller acquires it — the Clang
        # REQUIRES annotation as manifest data); nested defs still
        # start from an empty held set (they may run on any thread)
        req = (
            guardsmod.REQUIRES.get((self.cls_stack[-1], name))
            if self.cls_stack
            else None
        )
        if req is not None:
            self.with_stack.append((req, node.lineno))
            self.fn_depth_at_with.append(self.fn_depth)
        self.generic_visit(node)
        if req is not None:
            self.with_stack.pop()
            self.fn_depth_at_with.pop()
        self.fn_depth -= 1
        self.fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn
    visit_Lambda = _visit_fn

    def _held(self) -> List[Tuple[Optional[str], int]]:
        """With-items lexically held at the current node — excluding
        regions opened in an OUTER function scope (a closure body does
        not run under the with that surrounds its definition)."""
        return [
            w
            for w, d in zip(self.with_stack, self.fn_depth_at_with)
            if d == self.fn_depth
        ]

    def visit_With(self, node: ast.With) -> None:
        resolved: List[Tuple[Optional[str], int]] = []
        cls_name = self.cls_stack[-1] if self.cls_stack else None
        for item in node.items:
            lock_cls = self.table.resolve(
                item.context_expr, self.rel, cls_name
            )
            if lock_cls is not None:
                resolved.append((lock_cls, item.context_expr.lineno))
        if resolved and self.in_pkg:
            self._check_order(resolved)
        for r in resolved:
            self.with_stack.append(r)
            self.fn_depth_at_with.append(self.fn_depth)
        self.generic_visit(node)
        for _ in resolved:
            self.with_stack.pop()
            self.fn_depth_at_with.pop()

    def _check_order(
        self, acquiring: List[Tuple[Optional[str], int]]
    ) -> None:
        held = [h for h in self._held() if h[0] is not None]
        for cls, line in acquiring:
            my_rank = RANKED.get(cls)
            for hcls, hline in held:
                if hcls == cls:
                    continue  # re-entrant same-class (RLock) regions
                if hcls in LEAVES and cls in RANKED and cls not in LEAVES:
                    self.hit(
                        "lock-order", line,
                        f"acquires {cls!r} inside leaf lock {hcls!r} "
                        f"(held since line {hline})",
                    )
                    continue
                hr = RANKED.get(hcls)
                if my_rank is not None and hr is not None and hr >= my_rank:
                    self.hit(
                        "lock-order", line,
                        f"acquires {cls!r} (rank {my_rank}) while "
                        f"holding {hcls!r} (rank {hr}) — inverts the "
                        f"declared hierarchy "
                        f"(analysis/hierarchy.py)",
                    )

    # -- guarded-attr (analysis/guards.py) -----------------------------

    @staticmethod
    def _self_attr(node: ast.AST) -> Optional[ast.Attribute]:
        """The `self.<attr>` Attribute node under zero or more
        subscripts (`self.x`, `self.x[k]`, `self.x[k][j]`)."""
        while isinstance(node, ast.Subscript):
            node = node.value
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node
        return None

    def _collect_target_attrs(
        self, tgt: ast.AST, out: List[ast.Attribute]
    ) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._collect_target_attrs(el, out)
            return
        if isinstance(tgt, ast.Starred):
            self._collect_target_attrs(tgt.value, out)
            return
        a = self._self_attr(tgt)
        if a is not None:
            out.append(a)

    def _guard_access(self, attr_node: ast.Attribute, write: bool) -> None:
        """Check one `self.<attr>` access against the guard manifest
        (the `guarded-attr` rule). Writes are hard errors outside the
        declared guard; reads may be excused by `atomic_read_ok`."""
        self._guard_done.add(id(attr_node))
        if not self.in_pkg or not self.cls_stack:
            return
        cls = self.cls_stack[-1]
        entry = guardsmod.guard_for(cls, attr_node.attr)
        if entry is None:
            return
        self.guard_seen.add((cls, attr_node.attr))
        if "__init__" in self.fn_stack:
            return  # not shared yet: constructor writes are exempt
        if entry.escape == "unguarded":
            return
        line = attr_node.lineno
        if entry.escape == "init_only":
            if write:
                self.hit(
                    "guarded-attr", line,
                    f"writes init-only field {cls}.{attr_node.attr} "
                    f"outside __init__ (analysis/guards.py)",
                )
            return
        held = {h for h, _ln in self._held() if h is not None}
        if entry.guard in held:
            return
        if write:
            self.hit(
                "guarded-attr", line,
                f"writes {cls}.{attr_node.attr} outside a `with` of "
                f"its declared guard {entry.guard!r} "
                f"(analysis/guards.py)",
            )
        elif entry.escape != "atomic_read_ok":
            self.hit(
                "guarded-attr", line,
                f"reads {cls}.{attr_node.attr} outside a `with` of "
                f"its declared guard {entry.guard!r} — take the lock, "
                f"or declare the read atomic_read_ok in "
                f"analysis/guards.py",
            )

    def visit_Assign(self, node: ast.Assign) -> None:
        attrs: List[ast.Attribute] = []
        for tgt in node.targets:
            self._collect_target_attrs(tgt, attrs)
        for a in attrs:
            self._guard_access(a, write=True)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        a = self._self_attr(node.target)
        if a is not None:
            self._guard_access(a, write=True)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        a = self._self_attr(node.target)
        if a is not None and node.value is not None:
            self._guard_access(a, write=True)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            a = self._self_attr(tgt)
            if a is not None:
                self._guard_access(a, write=True)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if id(node) not in self._guard_done:
            a = self._self_attr(node)
            if a is node:
                self._guard_access(node, write=not isinstance(
                    node.ctx, ast.Load
                ))
        self.generic_visit(node)

    # -- calls ---------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node)
        fn = node.func
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr in _MUTATORS
            and isinstance(fn.value, ast.Attribute)
        ):
            # mutating the container a guarded field holds IS a write
            # to the guarded state. Direct receivers only: an element
            # access (`self._m[k].add(1)`) reaches a DIFFERENT object
            # (field-level granularity), and init_only/unguarded
            # fields hold service objects whose API may collide with
            # container-mutator names — their story is rebinding, not
            # content.
            a = self._self_attr(fn.value)
            if a is not None:
                entry = (
                    guardsmod.guard_for(self.cls_stack[-1], a.attr)
                    if self.cls_stack
                    else None
                )
                if entry is not None and entry.escape in (
                    "", "atomic_read_ok"
                ):
                    self._guard_access(a, write=True)
        if self.in_pkg:
            self._rule_raw_lock(node, name)
            self._rule_churn_send(node, name)
            self._rule_under_lock_calls(node, name)
        self._rule_env(node)
        self._rule_telemetry(node, name)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        name = _env_subscript(node)
        if name is not None:
            self.env_reads.setdefault(name, []).append(
                (self.rel, node.lineno, None)
            )
            if name not in ENV_BY_NAME:
                self.hit(
                    "env-registry", node.lineno,
                    f"reads undeclared env var {name!r} — declare it "
                    f"in analysis/envvars.py (name, default, one-line "
                    f"doc)",
                )
        self.generic_visit(node)

    def _rule_raw_lock(self, node: ast.Call, name: Optional[str]) -> None:
        if self.is_analysis:
            return
        fn = node.func
        is_threading = (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "threading"
        )
        if not is_threading:
            return
        if name in ("Lock", "RLock"):
            self.hit(
                "raw-lock", node.lineno,
                f"raw threading.{name}() — create locks via "
                f"analysis.lockdep.make_{'lock' if name == 'Lock' else 'rlock'}"
                f"(<class>) with a class declared in "
                f"analysis/hierarchy.py so runtime lockdep can see it",
            )
        elif name == "Condition" and not node.args:
            self.hit(
                "raw-lock", node.lineno,
                "bare threading.Condition() hides its lock from "
                "lockdep — use analysis.lockdep.make_condition(<class>)",
            )

    def _rule_churn_send(self, node: ast.Call, name: Optional[str]) -> None:
        if self.is_peer or name not in ("send", "open_channel"):
            return
        fn = node.func
        if (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Attribute)
            and fn.value.attr == "connection"
        ):
            self.hit(
                "churn-send", node.lineno,
                f"direct {_dotted(fn)}(...) — `peer.connection` can "
                f"flip to None between a check and the send; "
                f"NetworkPeer.try_send is THE churn-safe idiom",
            )

    def _rule_under_lock_calls(
        self, node: ast.Call, name: Optional[str]
    ) -> None:
        held = [h for h in self._held() if h[0] is not None]
        if not held:
            return
        # engine entrypoints under a below-engine lock: the repo->engine
        # inversion (open()/Ready deadlock shape)
        if name in ENGINE_ENTRYPOINTS:
            for hcls, hline in held:
                hr = RANKED.get(hcls)
                if hr is not None and hr > _ENGINE_RANK:
                    self.hit(
                        "lock-order", node.lineno,
                        f"calls {name}() (acquires 'live.engine', rank "
                        f"{_ENGINE_RANK}) while holding {hcls!r} (rank "
                        f"{hr}, held since line {hline}) — the engine "
                        f"lock must be outermost",
                    )
        # blocking primitives under a no-block (emission) lock
        if name in BLOCKING_CALLS and any(h in NO_BLOCK for h, _ in held):
            if name == "join" and self._is_str_join(node):
                return
            holder = next(h for h, _ in held if h in NO_BLOCK)
            self.hit(
                "no-block", node.lineno,
                f"blocking call {name}() inside the {holder!r} "
                f"emission lock — a stalled emission stalls every "
                f"doc's {{compute patch -> push}} pairs",
            )

    @staticmethod
    def _is_str_join(node: ast.Call) -> bool:
        fn = node.func
        return (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Constant)
            and isinstance(fn.value.value, str)
        )

    def _rule_env(self, node: ast.Call) -> None:
        hit = _env_name(node)
        if hit is None:
            return
        name, default = hit
        self.env_reads.setdefault(name, []).append(
            (self.rel, node.lineno, default)
        )
        reg = ENV_BY_NAME.get(name)
        if reg is None:
            self.hit(
                "env-registry", node.lineno,
                f"reads undeclared env var {name!r} — declare it in "
                f"analysis/envvars.py (name, default, one-line doc)",
            )
        elif default is not None and reg.default is not None and (
            default != reg.default
        ):
            self.hit(
                "env-registry", node.lineno,
                f"{name} default {default!r} drifts from the "
                f"registered default {reg.default!r} "
                f"(analysis/envvars.py)",
            )

    def _rule_telemetry(self, node: ast.Call, name: Optional[str]) -> None:
        if name not in ("counter", "gauge", "histogram") or not node.args:
            return
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            return
        recv = fn.value
        recv_name = (
            recv.id if isinstance(recv, ast.Name) else
            recv.attr if isinstance(recv, ast.Attribute) else None
        )
        if recv_name not in _REGISTRY_RECEIVERS:
            return
        prefix = _literal_prefix(node.args[0])
        if prefix is None:
            return  # dynamic name: the runtime assert covers it
        full_literal = isinstance(node.args[0], ast.Constant)
        ok = (
            bool(_NAME_RE.match(prefix)) if full_literal
            else bool(_PREFIX_RE.match(prefix))
        )
        if not ok:
            self.hit(
                "telemetry-name", node.lineno,
                f"series name {prefix!r} breaks the dotted "
                f"`subsystem.metric` convention (telemetry/__init__.py)"
                f" — tools/top.py groups rates by the prefix",
            )


# ---------------------------------------------------------------------------
# suppression matching


def _apply_suppressions(
    viols: List[Violation], sources: Dict[str, List[str]]
) -> List[Violation]:
    used_file_entries: Set[int] = set()
    out: List[Violation] = []
    for v in viols:
        lines = sources.get(v.path, [])
        just = _inline_allow(lines, v.line, v.rule)
        if just is not None:
            if not just.strip():
                out.append(v._replace(suppressed=False))
                out.append(
                    Violation(
                        "suppression", v.path, v.line,
                        f"inline allow({v.rule}) has no justification "
                        f"— write `# lint: allow({v.rule}) — <why>`",
                        False,
                    )
                )
                continue
            out.append(v._replace(suppressed=True, justification=just))
            continue
        matched = False
        for i, s in enumerate(suppmod.SUPPRESSIONS):
            if s.rule != v.rule:
                continue
            if not fnmatch.fnmatch(v.path.replace(os.sep, "/"), s.path_glob):
                continue
            line_txt = lines[v.line - 1] if 0 < v.line <= len(lines) else ""
            if s.contains and s.contains not in line_txt:
                continue
            used_file_entries.add(i)
            if not s.justification.strip():
                out.append(v)
                out.append(
                    Violation(
                        "suppression", "hypermerge_tpu_torch/analysis/"
                        "suppressions.py", 1,
                        f"suppression #{i} ({s.rule} in {s.path_glob}) "
                        f"has no justification",
                        False,
                    )
                )
                matched = True
                break
            out.append(v._replace(suppressed=True,
                                  justification=s.justification))
            matched = True
            break
        if not matched:
            out.append(v)
    for i, s in enumerate(suppmod.SUPPRESSIONS):
        if i not in used_file_entries:
            out.append(
                Violation(
                    "suppression",
                    "hypermerge_tpu_torch/analysis/suppressions.py", 1,
                    f"stale suppression #{i} ({s.rule} in "
                    f"{s.path_glob}): matches no current violation — "
                    f"delete it",
                    False,
                )
            )
    return out


def _inline_allow(
    lines: List[str], line: int, rule: str
) -> Optional[str]:
    """Justification text when line (or the line above) carries a
    matching `# lint: allow(rule)` comment; None when absent."""
    for ln in (line, line - 1):
        if 0 < ln <= len(lines):
            m = _ALLOW_RE.search(lines[ln - 1])
            if m and m.group(1) == rule:
                return m.group(2) or ""
    return None


# ---------------------------------------------------------------------------
# entry points


def lint_files(
    paths: List[str], root: Optional[str] = None
) -> List[Violation]:
    root = root or repo_root()
    # tree-wide checks (stale registry entries, README coverage) only
    # make sense when the read-scan covered the whole default file
    # set — a scoped `python -m hypermerge_tpu_torch.tools.lint
    # some/file.py` run must not flag
    # every HM_* var that one file happens not to read
    whole_tree = {os.path.abspath(p) for p in paths} >= {
        os.path.abspath(p) for p in default_files(root)
    }
    table = _LockTable()
    parsed: List[Tuple[str, ast.AST, str]] = []
    out: List[Violation] = []
    sources: Dict[str, List[str]] = {}
    for p in paths:
        rel = _rel(p, root)
        try:
            with open(p, "r", encoding="utf-8") as fh:
                src = fh.read()
            tree = ast.parse(src, filename=p)
        except (OSError, SyntaxError) as e:
            out.append(
                Violation("lock-order", rel, getattr(e, "lineno", 0) or 0,
                          f"unparseable: {e}", False)
            )
            continue
        sources[rel] = src.splitlines()
        if _in_package(rel):
            table.learn(rel, tree)
        parsed.append((rel, tree, src))
    env_reads: Dict[str, List[Tuple[str, int, Optional[str]]]] = {}
    guard_seen: Set[Tuple[str, str]] = set()
    for rel, tree, src in parsed:
        _FileLinter(rel, src, table, out, env_reads, guard_seen).visit(
            tree
        )
    if whole_tree:
        _check_env_registry(out, env_reads, root)
        _check_guards_registry(out, guard_seen, root)
    return _apply_suppressions(out, sources)


def lint_source(
    src: str, path: str = "hypermerge_tpu_torch/_fixture.py"
) -> List[Violation]:
    """Lint one in-memory snippet (test fixtures). The path decides
    scope rules (package-only rules need a hypermerge_tpu_torch/ path)."""
    table = _LockTable()
    tree = ast.parse(src)
    if _in_package(path):
        table.learn(path, tree)
    out: List[Violation] = []
    env_reads: Dict[str, List[Tuple[str, int, Optional[str]]]] = {}
    _FileLinter(path, src, table, out, env_reads).visit(tree)
    return _apply_suppressions(out, {path: src.splitlines()})


def lint_repo(root: Optional[str] = None) -> List[Violation]:
    root = root or repo_root()
    return lint_files(default_files(root), root)


def unsuppressed(viols: List[Violation]) -> List[Violation]:
    return [v for v in viols if not v.suppressed]


PORT_README_HEADING = "## PyTorch/CUDA port"


def _port_readme(root: str) -> str:
    """The README's port section (its heading up to the next `## `
    heading): the generated env and guard tables the tree checks live
    there, apart from the reference package's own tables."""
    try:
        with open(os.path.join(root, "README.md"), encoding="utf-8") as fh:
            text = fh.read()
    except OSError:
        return ""
    start = text.find("\n" + PORT_README_HEADING + "\n")
    if start < 0:
        return ""
    end = text.find("\n## ", start + 1)
    return text[start:end] if end >= 0 else text[start:]


def _check_env_registry(
    out: List[Violation],
    env_reads: Dict[str, List[Tuple[str, int, Optional[str]]]],
    root: str,
) -> None:
    readme = _port_readme(root)
    for var in ENV_REGISTRY:
        if var.name not in env_reads:
            out.append(
                Violation(
                    "env-registry",
                    "hypermerge_tpu_torch/analysis/envvars.py", 1,
                    f"stale registry entry {var.name}: nothing in the "
                    f"tree reads it — delete it or wire it up",
                    False,
                )
            )
        # backticked form: the generated table renders `HM_X`, and a
        # plain substring match would let a name that prefixes another
        # (HM_FSYNC vs HM_FSYNC_MS) pass on the longer row alone
        if readme and f"`{var.name}`" not in readme:
            out.append(
                Violation(
                    "env-registry",
                    "hypermerge_tpu_torch/analysis/envvars.py", 1,
                    f"{var.name} is registered but missing from the "
                    f"README port section's env-var table (regenerate "
                    f"with `python -m hypermerge_tpu_torch.tools.lint "
                    f"--env-table`)",
                    False,
                )
            )


def _check_guards_registry(
    out: List[Violation], guard_seen: Set[Tuple[str, str]], root: str
) -> None:
    """Tree-wide guard-manifest hygiene (whole-tree runs only): an
    entry no `self.<attr>` access matches is stale (renamed/deleted
    field rots silently otherwise), and every row of the generated
    guard-map table must appear verbatim in the README (the
    --guards-table mirror of the env-table drift rule; a row check —
    not a class-name check — so moving a field between escape
    classes without regenerating is also drift)."""
    for (cls, attr) in sorted(guardsmod.BY_CLS_ATTR):
        if (cls, attr) not in guard_seen:
            out.append(
                Violation(
                    "guarded-attr",
                    "hypermerge_tpu_torch/analysis/guards.py", 1,
                    f"stale guard entry {cls}.{attr}: no such "
                    f"attribute access in the tree — delete it or fix "
                    f"the name",
                    False,
                )
            )
    readme = _port_readme(root)
    if readme:
        for row in guardsmod.markdown_table().splitlines()[2:]:
            if row not in readme:
                out.append(
                    Violation(
                        "guarded-attr",
                        "hypermerge_tpu_torch/analysis/guards.py", 1,
                        f"README port section's guard-map table is "
                        f"missing the row "
                        f"{row!r} (regenerate with `python -m "
                        f"hypermerge_tpu_torch.tools.lint --guards-table`)",
                        False,
                    )
                )
