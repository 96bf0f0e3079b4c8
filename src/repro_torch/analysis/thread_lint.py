"""Thread-safety lint for the ``rt/`` runtime: a ``# guarded-by``
annotation discipline checked by AST (the port's copy of
``repro.analysis.thread_lint``; pure AST, unchanged rules).

The runtime's threading model is deliberately narrow — reader threads
only enqueue to a ``queue.Queue``, the orchestrator's membership thread
is the single non-main writer — and this pass makes that model a
*checked contract* instead of a comment:

  THR001  an attribute is mutated outside ``__init__`` and accessed
          from two or more thread entrypoints, but carries no
          ``# guarded-by:`` annotation.
  THR002  an attribute annotated ``# guarded-by: <lock>`` is accessed
          (anywhere outside ``__init__``) without holding
          ``with self.<lock>:``.
  THR003  a ``guarded-by`` annotation is malformed: it names an
          attribute that is not a lock, or ``none`` without a reason.
  THR004  an attribute annotated ``# guarded-by: main-thread`` is
          accessed from a thread entrypoint.

Model
-----
*Units* are class methods; a nested ``def`` used as a
``threading.Thread(target=...)`` becomes its own unit (e.g. the
server's per-connection ``reader``), every other nested def/lambda
merges into its enclosing method.  *Roots* label which threads can
execute a unit: public and dunder methods root at ``main``;
``threading.Thread(target=self._m)`` roots ``_m`` at its own name; a
``# called-from: <root>`` comment on (or directly above) a ``def``
declares an additional cross-class entrypoint (e.g. ``RTServer.attach``
is called from the orchestrator's membership thread).  Roots propagate
through the intra-class ``self.method()`` call graph to a fixed point;
unreached private methods default to ``main``.

Attributes assigned ``queue.Queue`` / ``threading.Event`` /
``threading.Lock|RLock|Condition`` are exempt (thread-safe by
construction), as are ``__init__``-time accesses (the object is not
shared yet).

Annotation grammar (on the declaring assignment's line, or the line
above it)::

    self.dead = set()        # guarded-by: _roster_lock
    self._grad_cache = {}    # guarded-by: main-thread
    self._step = 0           # guarded-by: none (GIL-atomic int ...)

Known soundness limits (documented, not checked): callables captured in
one unit but invoked from another (e.g. a ``round_fn`` lambda handed to
a Channel) are attributed to the *defining* unit; attribute access on
non-``self`` objects (``self.server.dead`` from the orchestrator) is
invisible — cross-object entrypoints must be declared with
``# called-from`` on the owning class's methods.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.report import Finding

__all__ = ["run", "lint_file", "lint_source", "attr_roots"]

MAIN = "main"

_LOCK_CTORS = {"Lock", "RLock", "Condition"}
_EXEMPT_CTORS = {"Queue", "SimpleQueue", "LifoQueue", "Event",
                 "Semaphore", "BoundedSemaphore"} | _LOCK_CTORS
_MUTATORS = {"add", "discard", "remove", "update", "clear", "pop",
             "popitem", "append", "extend", "insert", "setdefault",
             "difference_update", "intersection_update",
             "symmetric_difference_update", "put", "put_nowait"}

_ANNOT_RE = re.compile(r"#\s*guarded-by:\s*(.+?)\s*$")
_CALLED_RE = re.compile(r"#\s*called-from:\s*([\w\-, ]+)")
_DECL_RE = re.compile(r"self\.(\w+)\s*(?::[^=]+)?=(?!=)")


def _self_attr(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _ctor_name(node: ast.expr) -> Optional[str]:
    """'Queue' for queue.Queue(...), 'Lock' for threading.Lock(), etc."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


class _Annotation:
    def __init__(self, spec: str, line: int):
        self.raw = spec.strip()
        self.line = line
        if self.raw == "main-thread":
            self.kind = "main"
            self.arg = ""
        elif self.raw.startswith("none"):
            self.kind = "none"
            m = re.match(r"none\s*\((.+)\)\s*$", self.raw)
            self.arg = m.group(1).strip() if m else ""
        else:
            self.kind = "lock"
            self.arg = self.raw.split()[0]


def _parse_annotations(source_lines: List[str]) -> Dict[int, _Annotation]:
    """line-number -> annotation, attached to the assignment line (the
    comment may trail the assignment or sit on the line above it)."""
    out: Dict[int, _Annotation] = {}
    for i, text in enumerate(source_lines, start=1):
        m = _ANNOT_RE.search(text)
        if not m:
            continue
        ann = _Annotation(m.group(1), i)
        if _DECL_RE.search(text.split("#")[0]):
            out[i] = ann
        else:
            # standalone comment: attach to the next code line (skipping
            # any further comment lines)
            for j in range(i + 1, min(i + 6, len(source_lines) + 1)):
                t = source_lines[j - 1].strip()
                if not t or t.startswith("#"):
                    continue
                out[j] = ann
                break
    return out


def _called_from(source_lines: List[str], def_line: int) -> Set[str]:
    roots: Set[str] = set()
    for ln in range(max(1, def_line - 2), def_line + 1):
        m = _CALLED_RE.search(source_lines[ln - 1])
        if m:
            roots.update(r.strip() for r in m.group(1).split(",")
                         if r.strip())
    return roots


class _Access:
    __slots__ = ("attr", "kind", "line", "locks", "unit")

    def __init__(self, attr, kind, line, locks, unit):
        self.attr, self.kind, self.line = attr, kind, line
        self.locks, self.unit = frozenset(locks), unit


class _UnitWalker:
    """Collect self.<attr> accesses in one unit, tracking the held-lock
    stack and skipping nested thread-target units."""

    def __init__(self, unit: str, lock_attrs: Set[str],
                 skip_defs: Set[ast.FunctionDef]):
        self.unit = unit
        self.locks = lock_attrs
        self.skip = skip_defs
        self.held: List[str] = []
        self.out: List[_Access] = []

    def _emit(self, attr, kind, line):
        self.out.append(_Access(attr, kind, line, self.held, self.unit))

    def _target(self, node: ast.expr):
        """Classify assignment-target writes: self.X = / self.X[..] =."""
        if isinstance(node, ast.Tuple) or isinstance(node, ast.List):
            for e in node.elts:
                self._target(e)
            return
        a = _self_attr(node)
        if a is not None:
            self._emit(a, "write", node.lineno)
            return
        if isinstance(node, ast.Subscript):
            a = _self_attr(node.value)
            if a is not None:
                self._emit(a, "write", node.lineno)
                return
            self.walk(node.value)
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            # e.g. self.x.y = ... reads self.x
            for child in ast.iter_child_nodes(node):
                self.walk(child)

    def walk(self, node: ast.AST):
        if isinstance(node, ast.FunctionDef) and node in self.skip:
            return
        if isinstance(node, ast.With) or isinstance(node, ast.AsyncWith):
            acquired = []
            for item in node.items:
                ln = _self_attr(item.context_expr)
                if ln is not None and ln in self.locks:
                    acquired.append(ln)
                else:
                    self.walk(item.context_expr)
            self.held.extend(acquired)
            for stmt in node.body:
                self.walk(stmt)
            del self.held[len(self.held) - len(acquired):]
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                self._target(t)
            self.walk(node.value)
            return
        if isinstance(node, ast.AnnAssign):
            self._target(node.target)
            if node.value is not None:
                self.walk(node.value)
            return
        if isinstance(node, ast.AugAssign):
            a = _self_attr(node.target)
            if a is not None:
                self._emit(a, "write", node.lineno)
            else:
                self._target(node.target)
            self.walk(node.value)
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    a = _self_attr(t.value)
                    if a is not None:
                        self._emit(a, "write", t.lineno)
                        continue
                self.walk(t)
            return
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                a = _self_attr(f.value)
                if a is not None:
                    self._emit(a, "write", node.lineno)
                    for arg in node.args:
                        self.walk(arg)
                    for kw in node.keywords:
                        self.walk(kw.value)
                    return
            for child in ast.iter_child_nodes(node):
                self.walk(child)
            return
        a = _self_attr(node) if isinstance(node, ast.Attribute) else None
        if a is not None:
            self._emit(a, "read", node.lineno)
            return
        for child in ast.iter_child_nodes(node):
            self.walk(child)


def _nested_thread_targets(method: ast.FunctionDef
                           ) -> Dict[str, ast.FunctionDef]:
    """Nested defs handed to threading.Thread(target=...) by name."""
    nested = {n.name: n for n in ast.walk(method)
              if isinstance(n, ast.FunctionDef) and n is not method}
    targets: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(method):
        if isinstance(node, ast.Call) and _ctor_name(node) == "Thread":
            for kw in node.keywords:
                if kw.arg == "target" and isinstance(kw.value, ast.Name) \
                        and kw.value.id in nested:
                    targets[kw.value.id] = nested[kw.value.id]
    return targets


def _self_thread_targets(cls: ast.ClassDef) -> Set[str]:
    """Method names handed to threading.Thread(target=self._m)."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Call) and _ctor_name(node) == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    a = _self_attr(kw.value)
                    if a is not None:
                        out.add(a)
    return out


def _self_calls(body_owner: ast.AST, skip: Set[ast.FunctionDef]
                ) -> Set[str]:
    out: Set[str] = set()
    stack = list(ast.iter_child_nodes(body_owner))
    while stack:
        node = stack.pop()
        if isinstance(node, ast.FunctionDef) and node in skip:
            continue
        if isinstance(node, ast.Call):
            a = _self_attr(node.func)
            if a is not None:
                out.add(a)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _analyze_class(cls: ast.ClassDef, source_lines: List[str],
                   annotations: Dict[int, _Annotation], relpath: str
                   ) -> Tuple[List[Finding], Dict[str, Set[str]]]:
    methods = {n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)}

    # lock / exempt attribute discovery (any assignment in the class)
    lock_attrs: Set[str] = set()
    exempt: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value = node.target, node.value
        else:
            continue
        a = _self_attr(target)
        if a is None:
            continue
        ctor = _ctor_name(value)
        if ctor in _LOCK_CTORS:
            lock_attrs.add(a)
        elif ctor in _EXEMPT_CTORS:
            exempt.add(a)

    thread_methods = _self_thread_targets(cls)

    # units: methods + nested thread targets
    units: Dict[str, ast.AST] = {}
    unit_roots: Dict[str, Set[str]] = {}
    unit_calls: Dict[str, Set[str]] = {}
    skip_per_method: Dict[str, Set[ast.FunctionDef]] = {}
    for name, m in methods.items():
        nested = _nested_thread_targets(m)
        skip = set(nested.values())
        skip_per_method[name] = skip
        units[name] = m
        roots: Set[str] = set()
        if name in thread_methods:
            roots.add(name)
        elif not name.startswith("_") or \
                (name.startswith("__") and name.endswith("__")):
            roots.add(MAIN)
        roots |= _called_from(source_lines, m.lineno)
        unit_roots[name] = roots
        unit_calls[name] = _self_calls(m, skip)
        for nname, ndef in nested.items():
            uname = f"{name}.{nname}"
            units[uname] = ndef
            unit_roots[uname] = {nname}
            unit_calls[uname] = _self_calls(ndef, set())

    # propagate roots through the self-call graph to a fixed point
    changed = True
    while changed:
        changed = False
        for caller, callees in unit_calls.items():
            for callee in callees:
                if callee in unit_roots and \
                        not unit_roots[caller] <= unit_roots[callee]:
                    unit_roots[callee] |= unit_roots[caller]
                    changed = True
    # unreached private helpers: callable from outside -> assume main
    for name, roots in unit_roots.items():
        if not roots:
            roots.add(MAIN)

    # collect accesses per unit (skip __init__: pre-sharing)
    accesses: List[_Access] = []
    for uname, node in units.items():
        if uname == "__init__" or uname.startswith("__init__."):
            continue
        w = _UnitWalker(uname, lock_attrs,
                        skip_per_method.get(uname, set()))
        body = node.body if isinstance(node, ast.FunctionDef) else [node]
        for stmt in body:
            w.walk(stmt)
        accesses.extend(w.out)

    # per-attribute aggregation
    by_attr: Dict[str, List[_Access]] = {}
    for acc in accesses:
        if acc.attr in lock_attrs or acc.attr in exempt:
            continue
        by_attr.setdefault(acc.attr, []).append(acc)

    # attribute -> annotation, via declaring assignments anywhere
    attr_ann: Dict[str, _Annotation] = {}
    for line_no, ann in annotations.items():
        text = source_lines[line_no - 1].split("#")[0]
        m = _DECL_RE.search(text)
        if m and cls.lineno <= line_no <= (cls.end_lineno or 10 ** 9):
            attr_ann.setdefault(m.group(1), ann)

    findings: List[Finding] = []
    # malformed annotations are findings even on never-accessed attrs
    bad_ann: Set[str] = set()
    for attr, ann in sorted(attr_ann.items()):
        if ann.kind == "none" and not ann.arg:
            findings.append(Finding(
                "THR003", relpath, ann.line,
                f"{cls.name}.{attr}: 'guarded-by: none' needs a "
                "(reason)", detail=f"{cls.name}.{attr}:none"))
            bad_ann.add(attr)
        elif ann.kind == "lock" and ann.arg not in lock_attrs:
            findings.append(Finding(
                "THR003", relpath, ann.line,
                f"{cls.name}.{attr}: guarded-by names '{ann.arg}', "
                "which is not a threading.Lock/RLock attribute of "
                f"{cls.name}", detail=f"{cls.name}.{attr}:badlock"))
            bad_ann.add(attr)

    roots_out: Dict[str, Set[str]] = {}
    for attr, accs in sorted(by_attr.items()):
        roots = set()
        for acc in accs:
            roots |= unit_roots.get(acc.unit, {MAIN})
        roots_out[attr] = roots
        written = any(a.kind == "write" for a in accs)
        ann = attr_ann.get(attr)
        if ann is None:
            if written and len(roots) >= 2:
                findings.append(Finding(
                    "THR001", relpath, accs[0].line,
                    f"{cls.name}.{attr} is mutated and accessed from "
                    f"threads {sorted(roots)} but has no "
                    "# guarded-by: annotation",
                    detail=f"{cls.name}.{attr}"))
            continue
        if attr in bad_ann or ann.kind == "none":
            continue
        if ann.kind == "lock":
            n = 0
            for acc in accs:
                n += 1
                if ann.arg not in acc.locks:
                    findings.append(Finding(
                        "THR002", relpath, acc.line,
                        f"{cls.name}.{attr} ({acc.kind} in {acc.unit}) "
                        f"outside 'with self.{ann.arg}:'",
                        detail=f"{cls.name}.{attr}:{acc.unit}:{n}"))
            continue
        # ann.kind == "main": no access from thread-rooted units
        n = 0
        for acc in accs:
            n += 1
            aroots = unit_roots.get(acc.unit, {MAIN})
            if aroots - {MAIN}:
                findings.append(Finding(
                    "THR004", relpath, acc.line,
                    f"{cls.name}.{attr} is annotated main-thread but "
                    f"{acc.unit} ({acc.kind}) runs on "
                    f"{sorted(aroots - {MAIN})}",
                    detail=f"{cls.name}.{attr}:{acc.unit}:{n}"))
    return findings, roots_out


def lint_source(source: str, relpath: str) -> List[Finding]:
    tree = ast.parse(source, filename=relpath)
    lines = source.splitlines()
    annotations = _parse_annotations(lines)
    findings: List[Finding] = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            f, _ = _analyze_class(node, lines, annotations, relpath)
            findings.extend(f)
    return findings


def attr_roots(source: str, class_name: str) -> Dict[str, Set[str]]:
    """The computed thread-root sets per attribute of ``class_name`` —
    exposed so regression tests can *prove* an attribute is main-only
    (e.g. the server's GRAD/ACK replay caches)."""
    tree = ast.parse(source)
    lines = source.splitlines()
    annotations = _parse_annotations(lines)
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            _, roots = _analyze_class(node, lines, annotations, "<mem>")
            return roots
    raise ValueError(f"class {class_name} not found")


def lint_file(path: Path, root: Path) -> List[Finding]:
    rel = str(path.relative_to(root.parent)) if root in path.parents \
        or path == root else str(path)
    return lint_source(path.read_text(), rel)


def run(root) -> List[Finding]:
    """Lint every ``.py`` under ``root``'s ``rt/`` directory."""
    root = Path(root)
    rt = root / "rt"
    findings: List[Finding] = []
    for path in sorted(rt.rglob("*.py")) if rt.exists() else []:
        findings.extend(lint_file(path, root))
    return findings
