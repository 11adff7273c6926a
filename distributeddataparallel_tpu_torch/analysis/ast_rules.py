"""AST lint: host-side hazards on the port's step path.

The port's copy of the JAX package's ``analysis/ast_rules.py``.  The graph
layer (``analysis.graph_lint``) records what one eager step issues; this
layer reads the Python that dispatches steps, logs, checkpoints and
supervises.  Four rules (ids and waivers in ``analysis.rules``):

- AL101 host-sync: ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``float(<call>)`` / ``np.asarray`` / ``torch.cuda.synchronize`` inside
  HOT_PATH modules.  Each waits for the device when handed a CUDA tensor,
  which breaks the port's rule of no host read inside a step (the train
  loop reads a step's values only when they leave the dispatch window).
- AL102 time-in-jit: wall clock / host RNG inside the inner functions of
  a ``make_*_step`` factory: a per-rank host value inside the step.
- AL103 broad-except: bare ``except`` / ``except (Base)Exception``
  anywhere in the tree.  Supervision and IO-retry paths legitimately
  swallow everything, but must say so with a pragma + justification.
- AL104 event-kind: every ``EventLog.emit("<kind>", ...)`` literal must
  be registered in the port's ``observability.schema.EVENT_KINDS``.

Waiver pragma: ``# ddplint: allow[<tag>]`` on the offending line or the
line directly above (for wrapped statements); tags are ``host-sync``,
``time-in-jit``, ``broad-except``, ``event-kind``.

Module-import rule: stdlib only (plus ``observability.schema`` and
``analysis.rules``, themselves stdlib-only).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from distributeddataparallel_tpu_torch.analysis.rules import Finding
from distributeddataparallel_tpu_torch.observability.schema import EVENT_KINDS

PRAGMA_RE = re.compile(r"#\s*ddplint:\s*allow\[([a-z\-,\s]+)\]")

#: modules on the per-step dispatch path, where an accidental host sync
#: is a throughput bug rather than a style nit (paths relative to the
#: repo root, posix separators)
HOT_PATH = frozenset({
    "distributeddataparallel_tpu_torch/training/train_step.py",
    "distributeddataparallel_tpu_torch/training/optim.py",
    "distributeddataparallel_tpu_torch/parallel/data_parallel.py",
    "distributeddataparallel_tpu_torch/parallel/fsdp.py",
    "distributeddataparallel_tpu_torch/parallel/zero.py",
    "distributeddataparallel_tpu_torch/parallel/overlap.py",
    "distributeddataparallel_tpu_torch/parallel/tensor_parallel.py",
    "distributeddataparallel_tpu_torch/parallel/context_parallel.py",
    "distributeddataparallel_tpu_torch/parallel/pipeline_parallel.py",
    "distributeddataparallel_tpu_torch/parallel/expert_parallel.py",
    "distributeddataparallel_tpu_torch/parallel/powersgd.py",
    "distributeddataparallel_tpu_torch/parallel/sampler.py",
    "distributeddataparallel_tpu_torch/ops/attention.py",
    "distributeddataparallel_tpu_torch/ops/flash_attention.py",
    "distributeddataparallel_tpu_torch/ops/losses.py",
    "distributeddataparallel_tpu_torch/ops/moe.py",
    # measurement code rides the step path too — its intentional syncs
    # carry the allow[host-sync] pragma instead of being out of scope
    "distributeddataparallel_tpu_torch/observability/profiler.py",
    "distributeddataparallel_tpu_torch/utils/metrics.py",
})

#: (file basename, enclosing function) pairs where np.asarray is the
#: POINT — host-side helpers that live in hot-path files but only ever
#: run off the step path
ASARRAY_EXEMPT = frozenset({
    ("fsdp.py", "flatten_full"),        # f32 master-flat materialization
    ("fsdp.py", "fsdp_gather_params"),  # full-params host consolidation
    ("pipeline_parallel.py", "permute_layers"),  # init-time host permute
})

#: method calls that copy a tensor to the host: AL101 in HOT_PATH
#: modules, AL107 in serve loops
HOST_READ_METHODS = ("item", "tolist", "cpu")

#: call patterns treated as wall clock / host RNG for AL102, as dotted
#: prefixes of the called name
_TIME_RNG_PREFIXES = (
    "time.", "datetime.", "np.random.", "numpy.random.", "random.",
)

_MAKE_STEP_RE = re.compile(r"^make_\w*step$")


def _pragma_lines(src: str) -> dict[int, set[str]]:
    """line number -> set of allow tags covering that line.

    A pragma covers its own line and propagates down through the rest
    of a contiguous comment block onto the first code line below it, so
    a multi-line justification comment still waives the statement it
    sits on top of."""
    out: dict[int, set[str]] = {}
    lines = src.splitlines()
    for i, line in enumerate(lines, start=1):
        m = PRAGMA_RE.search(line)
        if not m:
            continue
        tags = {t.strip() for t in m.group(1).split(",")}
        out.setdefault(i, set()).update(tags)
        j = i + 1
        while j <= len(lines) and lines[j - 1].lstrip().startswith("#"):
            out.setdefault(j, set()).update(tags)
            j += 1
        if j <= len(lines):
            out.setdefault(j, set()).update(tags)
    return out


def _waived(pragmas: dict, line: int, tag: str) -> bool:
    # pragma on the line itself or the line directly above
    return tag in pragmas.get(line, ()) or tag in pragmas.get(line - 1, ())


def _dotted(node) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str, pragmas: dict, *, hot: bool):
        self.rel = rel
        self.base = rel.rsplit("/", 1)[-1]
        self.pragmas = pragmas
        self.hot = hot
        self.findings: list[Finding] = []
        self.emitted: dict[str, list[str]] = {}
        self._fn_stack: list = []       # enclosing FunctionDefs
        self._traced_depth = 0          # >0 while inside traced scope

    # -- helpers ------------------------------------------------------
    def _flag(self, rule: str, node, tag: str, msg: str) -> None:
        if not _waived(self.pragmas, node.lineno, tag):
            self.findings.append(
                Finding(rule, f"{self.rel}:{node.lineno}", msg)
            )

    def _enclosing_fn(self) -> str | None:
        return self._fn_stack[-1].name if self._fn_stack else None

    # -- scope tracking -----------------------------------------------
    def _visit_fn(self, node) -> None:
        traced = bool(
            # every def nested inside a make_*_step factory body is the
            # step or a part of it
            self._fn_stack
            and _MAKE_STEP_RE.match(self._fn_stack[0].name)
            and not _MAKE_STEP_RE.match(node.name)
        )
        self._fn_stack.append(node)
        self._traced_depth += traced
        self.generic_visit(node)
        self._traced_depth -= traced
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    # -- AL103 broad-except -------------------------------------------
    def visit_ExceptHandler(self, node) -> None:
        names = []
        types = node.type.elts if isinstance(node.type, ast.Tuple) \
            else ([node.type] if node.type is not None else [])
        for t in types:
            n = _dotted(t)
            if n:
                names.append(n.rsplit(".", 1)[-1])
        if node.type is None:
            self._flag(
                "AL103", node, "broad-except",
                "bare `except:` swallows KeyboardInterrupt/SystemExit",
            )
        elif any(n in ("Exception", "BaseException") for n in names):
            self._flag(
                "AL103", node, "broad-except",
                f"broad `except {' ,'.join(names)}` without justification",
            )
        self.generic_visit(node)

    # -- calls: AL101 / AL102 / AL104 ---------------------------------
    def visit_Call(self, node) -> None:
        fn = node.func
        dotted = _dotted(fn) or ""
        attr = fn.attr if isinstance(fn, ast.Attribute) else None

        if self.hot:
            if (attr in HOST_READ_METHODS and not node.args
                    and not node.keywords):
                self._flag(
                    "AL101", node, "host-sync",
                    f".{attr}() in a hot-path module (device->host sync)",
                )
            elif dotted == "torch.cuda.synchronize":
                self._flag(
                    "AL101", node, "host-sync",
                    "torch.cuda.synchronize in a hot-path module (the host "
                    "waits for the device)",
                )
            elif (
                isinstance(fn, ast.Name) and fn.id == "float"
                and len(node.args) == 1
                and isinstance(node.args[0], ast.Call)
            ):
                self._flag(
                    "AL101", node, "host-sync",
                    "float(<call>) in a hot-path module (materializes "
                    "the result on host)",
                )
            elif dotted in ("np.asarray", "numpy.asarray"):
                if (self.base, self._enclosing_fn()) not in ASARRAY_EXEMPT:
                    self._flag(
                        "AL101", node, "host-sync",
                        "np.asarray in a hot-path module (device->host "
                        "copy of a tensor)",
                    )

        if self._traced_depth and any(
            dotted.startswith(p) for p in _TIME_RNG_PREFIXES
        ):
            self._flag(
                "AL102", node, "time-in-jit",
                f"{dotted}(...) inside a step function — a host clock or "
                "RNG read inside the step differs by rank and by run",
            )

        if attr == "emit":
            kind = None
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                kind = node.args[0].value
            for kw in node.keywords:
                if kw.arg == "kind" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    kind = kw.value.value
            if kind is not None:
                self.emitted.setdefault(kind, []).append(
                    f"{self.rel}:{node.lineno}"
                )
                if kind not in EVENT_KINDS:
                    self._flag(
                        "AL104", node, "event-kind",
                        f"emit kind {kind!r} not registered in "
                        "observability.schema.EVENT_KINDS",
                    )
        self.generic_visit(node)


def lint_source(
    src: str, rel: str, *, collect=None
) -> list[Finding]:
    """Lint one file's source.  ``rel`` is its repo-relative posix path
    (drives HOT_PATH membership and finding locations).  ``collect``,
    if given, is a dict accumulating emitted kind -> [locations]."""
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [Finding("AL103", f"{rel}:{e.lineno or 0}",
                        f"unparseable: {e.msg}")]
    v = _Visitor(rel, _pragma_lines(src), hot=rel in HOT_PATH)
    v.visit(tree)
    if collect is not None:
        for kind, sites in v.emitted.items():
            collect.setdefault(kind, []).extend(sites)
    return v.findings


def default_targets(root) -> list[Path]:
    """The tree ddplint covers: the port's package (its entry points
    ``dpp.py``, ``serve.py`` and ``profile_step.py`` included) — tests are
    exercised, not linted."""
    root = Path(root)
    return sorted(
        p for p in (root / "distributeddataparallel_tpu_torch").rglob("*.py")
        if "__pycache__" not in p.parts
    )


def lint_paths(paths, root, *, collect=None) -> list[Finding]:
    root = Path(root)
    findings: list[Finding] = []
    for p in paths:
        p = Path(p)
        rel = p.relative_to(root).as_posix() if p.is_absolute() \
            else Path(p).as_posix()
        findings += lint_source(
            (root / rel).read_text(), rel, collect=collect
        )
    return findings


def collect_emitted_kinds(root, paths=None) -> dict[str, list[str]]:
    """kind -> [file:line ...] for every statically-visible emit literal
    in the tree.  ``check_events.py --schema-sync`` diffs this against
    EVENT_KINDS so drift is a hard error in both directions."""
    collect: dict[str, list[str]] = {}
    lint_paths(paths or default_targets(root), root, collect=collect)
    return collect
