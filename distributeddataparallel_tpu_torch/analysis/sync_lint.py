"""Concurrency + clock AST rules for the port's runtime/serving protocol code.

The port's copy of the JAX package's ``analysis/sync_lint.py``.

``ast_rules`` covers the train-step dispatch path; this pass covers the
code the protocol layer (``analysis.protocol``) models — sockets,
virtual clocks, serve loops, and lock-guarded shared state.  Four rules
(ids and waivers in ``analysis.rules``):

- AL105 blocking-socket: a ``socket.create_connection`` /
  ``socket.socket(...)`` call outside a ``retry_call`` retry wrapper.
  The rendezvous/fleet wire protocol survives transient connect races
  only because every dial goes through ``RetryPolicy`` backoff — a bare
  dial turns a half-open accept queue into a crash.
- AL106 wallclock-in-virtual-path: ``time.time()`` / ``time.monotonic()``
  *called* inside a module on the VirtualClock-replayable path
  (``VIRTUAL_CLOCK_MODULES``).  Those modules take an injectable
  ``time_fn`` precisely so tests replay deterministically; a literal
  wall-clock call silently forks virtual and real time.  (A default
  argument like ``time_fn=time.monotonic`` is a reference, not a call,
  and does not fire.)
- AL107 host-sync-in-serve-loop: ``.item()`` / ``.tolist()`` /
  ``.cpu()`` / ``np.asarray`` inside a per-step serving-loop function (a function
  whose name matches ``_SERVE_LOOP_RE`` in a ``SERVE_PATH`` module).
  One host sync per decode step caps fleet throughput exactly like the
  reference DDP script's per-log ``loss.item()`` capped training.
- AL108 lock-discipline: an attribute a class mutates under
  ``with self.<lock>:`` in one method but mutates bare in another
  (``__init__`` excluded — construction happens-before the threads).
  The lock either protects the attribute everywhere or protects
  nothing.

Waiver pragma (same mechanics as ``ast_rules``): ``# ddplint:
allow[<tag>]`` with tags ``blocking-socket``, ``wallclock``,
``serve-host-sync``, ``lock-discipline``.

Module-import rule: stdlib only.
"""

from __future__ import annotations

import ast
import re

from distributeddataparallel_tpu_torch.analysis.ast_rules import (
    HOST_READ_METHODS,
    _dotted,
    _pragma_lines,
    _waived,
)
from distributeddataparallel_tpu_torch.analysis.rules import Finding

#: modules replayable under loadgen.VirtualClock / an injected time_fn —
#: the deterministic-replay property AL106 protects
VIRTUAL_CLOCK_MODULES = frozenset({
    "distributeddataparallel_tpu_torch/serving/router.py",
    "distributeddataparallel_tpu_torch/serving/fleet.py",
    "distributeddataparallel_tpu_torch/serving/loadgen.py",
    "distributeddataparallel_tpu_torch/serving/engine.py",
})

#: modules whose step/pump functions are the per-token serving hot path
SERVE_PATH = frozenset({
    "distributeddataparallel_tpu_torch/serving/engine.py",
    "distributeddataparallel_tpu_torch/serving/fleet.py",
    "distributeddataparallel_tpu_torch/serving/handoff.py",
    "distributeddataparallel_tpu_torch/serving/kv_cache.py",
})

_SERVE_LOOP_RE = re.compile(
    r"(^|_)(step|pump|drain|poll|serve|decode)(_|$)|^run"
)

_WALLCLOCK_CALLS = ("time.time", "time.monotonic", "time.perf_counter")

_SOCKET_CALLS = ("socket.create_connection", "socket.socket")


def _lock_attrs(cls: ast.ClassDef) -> set[str]:
    """Attribute names assigned a ``threading.Lock()``/``RLock()`` in
    this class body (usually ``_lock`` in ``__init__``)."""
    out = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = _dotted(node.value.func) or ""
            if name.endswith("Lock"):  # threading.Lock / RLock
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        out.add(tgt.attr)
    return out


def _self_attr(node) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


_MUTATORS = frozenset({
    "append", "extend", "pop", "popitem", "clear", "update", "add",
    "remove", "discard", "insert", "setdefault", "put",
})


def _mutations(fn) -> list[tuple[str, int, bool]]:
    """(attr, lineno, under_lock) for every ``self.X`` mutation in
    ``fn``: assignment/augmented-assignment targets, ``del``,
    subscript stores (``self.X[k] = v``), and mutating method calls
    (``self.X.append(...)``)."""
    out = []

    def visit(node, locked):
        if isinstance(node, ast.With):
            grabs = any(
                _self_attr(item.context_expr) is not None
                or (isinstance(item.context_expr, ast.Call)
                    and _self_attr(item.context_expr.func) is not None)
                for item in node.items
            )
            for child in ast.iter_child_nodes(node):
                visit(child, locked or grabs)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target] if isinstance(node, ast.AugAssign)
                else node.targets
            )
            for tgt in targets:
                base = tgt
                while isinstance(base, ast.Subscript):
                    base = base.value
                attr = _self_attr(base)
                if attr is not None:
                    out.append((attr, node.lineno, locked))
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr in _MUTATORS):
                attr = _self_attr(f.value)
                if attr is not None:
                    out.append((attr, node.lineno, locked))
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    for stmt in fn.body:
        visit(stmt, False)
    return out


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str, pragmas: dict):
        self.rel = rel
        self.pragmas = pragmas
        self.findings: list[Finding] = []
        self.virtual = rel in VIRTUAL_CLOCK_MODULES
        self.serve = rel in SERVE_PATH
        self._retry_nodes: set[int] = set()  # ids of nodes under retry_call
        self._fn_stack: list = []

    def _flag(self, rule: str, node, tag: str, msg: str) -> None:
        if not _waived(self.pragmas, node.lineno, tag):
            self.findings.append(
                Finding(rule, f"{self.rel}:{node.lineno}", msg)
            )

    # -- retry_call scope ---------------------------------------------
    def _mark_retry(self, node) -> None:
        for sub in ast.walk(node):
            self._retry_nodes.add(id(sub))

    # -- AL108 per class ----------------------------------------------
    def visit_ClassDef(self, node) -> None:
        locks = _lock_attrs(node)
        if locks:
            guarded: set[str] = set()
            per_fn: list[tuple[str, list]] = []
            for item in node.body:
                if not isinstance(
                    item, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                muts = [
                    m for m in _mutations(item) if m[0] not in locks
                ]
                per_fn.append((item.name, muts))
                if item.name != "__init__":
                    guarded |= {a for a, _ln, lk in muts if lk}
            for fname, muts in per_fn:
                if fname == "__init__":
                    continue
                for attr, lineno, locked in muts:
                    if attr in guarded and not locked:
                        self._flag(
                            "AL108",
                            type("N", (), {"lineno": lineno})(),
                            "lock-discipline",
                            f"{node.name}.{attr} mutated without the "
                            f"lock in {fname}() but under it elsewhere "
                            "— the lock protects nothing",
                        )
        self.generic_visit(node)

    # -- calls: AL105 / AL106 / AL107 ---------------------------------
    def visit_Call(self, node) -> None:
        dotted = _dotted(node.func) or ""
        attr = (
            node.func.attr
            if isinstance(node.func, ast.Attribute) else None
        )

        if dotted == "retry_call" or dotted.endswith(".retry_call"):
            for arg in [*node.args, *(kw.value for kw in node.keywords)]:
                self._mark_retry(arg)

        if dotted in _SOCKET_CALLS and id(node) not in self._retry_nodes:
            self._flag(
                "AL105", node, "blocking-socket",
                f"{dotted}(...) outside a retry_call wrapper — a "
                "transient connect race becomes a crash instead of a "
                "RetryPolicy backoff",
            )

        if self.virtual and dotted in _WALLCLOCK_CALLS:
            self._flag(
                "AL106", node, "wallclock",
                f"{dotted}() called in a VirtualClock-replayable module "
                "— use the injected time_fn so replays stay "
                "deterministic",
            )

        if self.serve and self._in_serve_loop():
            if dotted in ("np.asarray", "numpy.asarray"):
                self._flag(
                    "AL107", node, "serve-host-sync",
                    f"{dotted} inside serve-loop function "
                    f"{self._fn_stack[-1]}() — one device->host sync "
                    "per step serializes the fleet",
                )
            elif (attr in HOST_READ_METHODS and not node.args
                  and not node.keywords):
                self._flag(
                    "AL107", node, "serve-host-sync",
                    f".{attr}() inside serve-loop function "
                    f"{self._fn_stack[-1]}() (device->host sync)",
                )
        self.generic_visit(node)

    def _in_serve_loop(self) -> bool:
        return bool(
            self._fn_stack and _SERVE_LOOP_RE.search(self._fn_stack[-1])
        )

    def _visit_fn(self, node) -> None:
        self._fn_stack.append(node.name)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn


def lint_source(src: str, rel: str) -> list[Finding]:
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError:
        return []  # ast_rules already reports unparseable files
    # two passes so a retry_call later in the file still covers a
    # create_connection textually above it (order-independent scope)
    v = _Visitor(rel, _pragma_lines(src))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func) or ""
            if dotted == "retry_call" or dotted.endswith(".retry_call"):
                for arg in [*node.args,
                            *(kw.value for kw in node.keywords)]:
                    v._mark_retry(arg)
    v.visit(tree)
    return v.findings


def lint_paths(paths, root) -> list[Finding]:
    from pathlib import Path

    root = Path(root)
    findings: list[Finding] = []
    for p in paths:
        p = Path(p)
        rel = p.relative_to(root).as_posix() if p.is_absolute() \
            else Path(p).as_posix()
        findings += lint_source((root / rel).read_text(), rel)
    return findings
