"""RNG-stream lint (the port of ``repro.analysis.rng_lint``): every RNG
construction in ``src/repro_torch`` must go through ``repro_torch.streams``
(or use a literal key provably inside a registered tuple namespace).

The pass catalogues every ``np.random.default_rng(...)`` and every torch
generator-root construction by AST, resolves literal keys, and checks them
against the port's registry:

  RNG001  ``default_rng`` with a non-literal (or unattributable scalar)
          key outside ``streams.py`` — the namespace cannot be proven;
          construct via a registered streams constructor.
  RNG002  literal tuple key matching no registered tuple pattern.
  RNG003  the registry itself is inconsistent: two tuple namespaces can
          collide, or a banned length-1 tuple pattern is declared
          (``streams.registry_overlaps``).
  RNG004  a torch key root constructed outside ``streams.py``:
          ``torch.Generator(...)``, ``torch.manual_seed(...)`` or
          ``<generator>.manual_seed(...)`` (``torch.cuda.manual_seed``
          and ``manual_seed_all`` too) — use ``streams.model_generator``
          / ``sampler_generator`` / ``warmup_generator`` /
          ``meta_generator`` so key roots stay catalogued. (The
          reference's RNG004 is the raw jax key; the port has none.)

``streams.py`` itself is exempt: it is where constructions are
*supposed* to live.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence, Union

from repro_torch import streams
from repro_torch.analysis.report import Finding

__all__ = ["run", "lint_file", "lint_source"]

EXEMPT_FILES = ("streams.py",)

# attribute chains that construct a numpy Generator
_NP_CTORS = {
    ("np", "random", "default_rng"),
    ("numpy", "random", "default_rng"),
    ("random", "default_rng"),          # from numpy import random
    ("default_rng",),                   # from numpy.random import default_rng
}
# attribute chains that construct a torch generator root
_TORCH_CTORS = {
    ("torch", "Generator"), ("Generator",), ("torch", "manual_seed"),
    ("torch", "random", "manual_seed"),
}
# a method that seeds (re-roots) a generator, whatever the object
_SEED_METHODS = {"manual_seed", "manual_seed_all"}


def _dotted(node: ast.expr) -> Optional[tuple]:
    """('np', 'random', 'default_rng') for np.random.default_rng, etc."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _literal_int(node: ast.expr) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _literal_int(node.operand)
        return None if inner is None else -inner
    return None


def _literal_key(node: ast.expr) -> Union[int, tuple, None]:
    """Resolve an int literal or an all-int-literal tuple; None if the
    key is not statically resolvable."""
    v = _literal_int(node)
    if v is not None:
        return v
    if isinstance(node, ast.Tuple):
        elems = [_literal_int(e) for e in node.elts]
        if all(e is not None for e in elems):
            return tuple(elems)
    return None


def _matches_pattern(key: tuple, pattern: Sequence) -> bool:
    if len(key) != len(pattern):
        return False
    for v, p in zip(key, pattern):
        if isinstance(p, streams.Sym):
            if not (p.lo <= v and (p.hi is None or v < p.hi)):
                return False
        elif v != p:
            return False
    return True


def _registered_tuple(key: tuple) -> Optional[str]:
    for spec in streams.REGISTRY.values():
        if spec.pool == "tuple" and _matches_pattern(key, spec.key):
            return spec.name
    return None


def lint_source(source: str, relpath: str) -> List[Finding]:
    """Lint one file's source.  ``relpath`` is used in findings and to
    apply the streams.py exemption."""
    if Path(relpath).name in EXEMPT_FILES:
        return []
    tree = ast.parse(source, filename=relpath)
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _dotted(node.func)
        if chain is None:
            # a seed method on a call's result: Generator(...).manual_seed
            f = node.func
            if not (isinstance(f, ast.Attribute) and f.attr in _SEED_METHODS):
                continue
            if isinstance(f.value, ast.Call) \
                    and _dotted(f.value.func) in _TORCH_CTORS:
                continue            # the constructor is the finding
            chain = (f.attr,)
        if chain in _TORCH_CTORS or chain[-1] in _SEED_METHODS:
            findings.append(Finding(
                "RNG004", relpath, node.lineno,
                "raw torch generator root outside repro_torch.streams — "
                "use a registered root constructor (streams."
                "model_generator, sampler_generator, warmup_generator, "
                "meta_generator)",
                detail=f"L{_stable_ord(tree, node)}"))
            continue
        if chain not in _NP_CTORS:
            continue
        if not node.args:
            # unseeded OS-entropy generator: no namespace to police
            continue
        key = _literal_key(node.args[0])
        if key is None:
            findings.append(Finding(
                "RNG001", relpath, node.lineno,
                "non-literal RNG key outside repro_torch.streams — the "
                "stream namespace cannot be proven; use a registered "
                "streams constructor",
                detail=f"L{_stable_ord(tree, node)}"))
        elif isinstance(key, tuple):
            name = _registered_tuple(key)
            if name is None:
                findings.append(Finding(
                    "RNG002", relpath, node.lineno,
                    f"literal tuple key {key} matches no registered "
                    "stream namespace (see repro_torch.streams.REGISTRY)",
                    detail=f"key{key}"))
        else:
            findings.append(Finding(
                "RNG001", relpath, node.lineno,
                f"literal scalar key {key} outside repro_torch.streams — "
                "scalar-pool streams are only attributable through "
                "their registered constructors",
                detail=f"key({key})"))
    return findings


def _stable_ord(tree: ast.AST, target: ast.Call) -> int:
    """Ordinal of ``target`` among all Call nodes in the file — a
    line-number-free discriminator for finding keys."""
    n = 0
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            n += 1
            if node is target:
                return n
    return 0


def lint_file(path: Path, root: Path) -> List[Finding]:
    rel = str(path.relative_to(root.parent)) if root in path.parents \
        or path == root else str(path)
    return lint_source(path.read_text(), rel)


def run(root) -> List[Finding]:
    """Lint every ``.py`` under ``root`` + validate the registry."""
    root = Path(root)
    findings: List[Finding] = []
    for problem in streams.registry_overlaps():
        findings.append(Finding("RNG003", "repro_torch/streams.py", 0,
                                f"registry inconsistency: {problem}",
                                detail=problem))
    for path in sorted(root.rglob("*.py")):
        findings.extend(lint_file(path, root))
    return findings
