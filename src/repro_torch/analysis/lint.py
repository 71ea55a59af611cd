"""AST lint of the port's source tree, and its dead-module census — the
port of ``repro/analysis/lint.py``.

Rules (ids in :data:`repro_torch.analysis.report.RULES`):

* ``lint-compile-in-init`` — ``torch.compile`` or a CUDA-graph capture
  (``torch.cuda.graph``, ``CUDAGraph``, ``make_graphed_callables``,
  ``capture_begin``) lexically inside an ``__init__``: a fresh compile or
  capture per instance (the reference's per-instance ``jax.jit``). The
  engine's captures live in ``serve/graphs.py``, which is exempt. Scope:
  ``src/repro_torch``.
* ``lint-sync-in-loop`` — a device sync (``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``synchronize``) inside a Python
  ``for``/``while`` in ``serve/``: it serializes the tick loop on device
  completion (the reference's ``block_until_ready`` rule). Scope:
  ``src/repro_torch/serve``.
* ``lint-torch-in-loop`` — a ``torch.*`` call inside a Python loop in
  ``serve/``: one dispatch a token, where serve code batches device work
  into one call a tick (the reference's ``jnp`` rule). Scope:
  ``src/repro_torch/serve``.
* ``lint-dead-module`` — every ``src/repro_torch`` module is imported by
  something (``src``, ``tests``, ``scripts``, ``benchmarks``,
  ``examples``, or a script at the repo's root); package ``__init__``s and
  ``__main__``-guarded entry points are exempt.
* ``lint-stale-allow`` — a ``# torch-audit: allow(rule)`` comment that
  no longer sits on, or directly above, a line with that violation.
  Suppressions are read from COMMENT tokens only, never from strings (the
  fixtures quote them). The marker differs from the reference's
  ``# audit: allow(...)``, whose lint reads every file under ``src/``.

The reference's ``lint-moa-shim`` has no counterpart: the port has no
shim.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.report import Violation

__all__ = ["lint_source", "lint_tree", "dead_module_census", "run_lint",
           "ALLOW_MARKER"]

_LINT_TARGET = "lint"

#: directories (relative to the repo root) whose modules count as importers
_IMPORTER_DIRS = ("src", "tests", "scripts", "benchmarks", "examples")

#: the tree the rules lint, and the serve package the loop rules cover
_PORT = "src/repro_torch/"
_SERVE = "src/repro_torch/serve/"
#: the module allowed to capture CUDA graphs (the engine's graph cache)
_GRAPHS_FILE = "src/repro_torch/serve/graphs.py"

ALLOW_MARKER = "torch-audit"
#: ``# torch-audit: allow(<rule-id>)`` on the flagged line or the line
#: directly above it (where its rationale sits)
_ALLOW_RE = re.compile(r"#\s*torch-audit:\s*allow\(([\w-]+)\)")

#: capture or compile calls, by their final attribute name
_COMPILE_CALLS = {"compile", "graph", "CUDAGraph", "make_graphed_callables",
                  "capture_begin"}
#: method calls that wait on the device
_SYNC_CALLS = {"item", "cpu", "tolist", "numpy", "synchronize"}


def _allow_comments(source: str) -> List[Tuple[int, str]]:
    """``(line, rule)`` of every suppression in a real COMMENT token."""
    out: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                for rule in _ALLOW_RE.findall(tok.string):
                    out.append((tok.start[0], rule))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        pass                      # ast.parse already reports unparseables
    return out


def _root(node) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class _Linter(ast.NodeVisitor):
    """One pass, tracking the enclosing function and loop stacks."""

    def __init__(self, rel_path: str, in_serve: bool):
        self.rel = rel_path
        self.in_serve = in_serve
        self.fn_stack: List[str] = []
        self.loop_depth = 0
        self.out: List[Violation] = []

    def _visit_fn(self, node):
        self.fn_stack.append(node.name)
        outer_loops = self.loop_depth
        self.loop_depth = 0          # a nested def resets the loop context
        self.generic_visit(node)
        self.loop_depth = outer_loops
        self.fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _visit_loop(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _visit_loop
    visit_While = _visit_loop
    visit_AsyncFor = _visit_loop

    def _flag(self, rule: str, node, message: str):
        self.out.append(Violation(rule=rule, target=_LINT_TARGET,
                                  file=self.rel, line=node.lineno,
                                  message=message))

    def visit_Call(self, node: ast.Call):
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None)
        root = _root(func)
        if name in _COMPILE_CALLS and root == "torch" \
                and "__init__" in self.fn_stack and self.rel != _GRAPHS_FILE:
            self._flag("lint-compile-in-init", node,
                       f"torch {name} inside __init__ compiles or captures "
                       "per instance — capture through serve/graphs.py")
        if name == "capture_begin" and "__init__" in self.fn_stack \
                and self.rel != _GRAPHS_FILE:
            self._flag("lint-compile-in-init", node,
                       "a CUDA-graph capture inside __init__ — capture "
                       "through serve/graphs.py")
        if self.in_serve and self.loop_depth > 0:
            if isinstance(func, ast.Attribute) and name in _SYNC_CALLS:
                self._flag("lint-sync-in-loop", node,
                           f".{name}() inside a serve loop waits on the "
                           "device each iteration")
            elif root == "torch":
                self._flag("lint-torch-in-loop", node,
                           "torch call inside a per-token Python loop — "
                           "batch device work into one call per tick")
        self.generic_visit(node)


def lint_source(rel_path: str, source: str) -> List[Violation]:
    """Lint one module given its repo-relative path and source text."""
    rel = rel_path.replace(os.sep, "/")
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation(
            rule="lint-parse-error", target=_LINT_TARGET, file=rel,
            line=e.lineno or 0, message=f"unparseable module: {e.msg}")]
    linter = _Linter(rel, rel.startswith(_SERVE))
    linter.visit(tree)
    allows = _allow_comments(source)

    def allowed(v: Violation) -> bool:
        return any(rule == v.rule and ln in (v.line, v.line - 1)
                   for ln, rule in allows)

    kept = [v for v in linter.out if not allowed(v)]
    for ln, rule in allows:
        if not any(v.rule == rule and v.line in (ln, ln + 1)
                   for v in linter.out):
            kept.append(Violation(
                rule="lint-stale-allow", target=_LINT_TARGET, file=rel,
                line=ln,
                message=(f"# {ALLOW_MARKER}: allow({rule}) suppresses "
                         f"nothing — no live {rule} violation on this or the "
                         "next line; delete the comment or re-point it")))
    return sorted(kept, key=lambda v: (v.line, v.rule))


def _py_files(root: str, sub: str) -> Iterable[str]:
    base = os.path.join(root, sub)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, fn), root)


def lint_tree(repo_root: str) -> Tuple[List[Violation], int]:
    """Lint every module of ``src/repro_torch``; ``(violations, files)``."""
    out: List[Violation] = []
    n = 0
    for rel in _py_files(repo_root, _PORT):
        with open(os.path.join(repo_root, rel), encoding="utf-8") as f:
            out.extend(lint_source(rel, f.read()))
        n += 1
    return out, n


# ---------------------------------------------------------------------------
# dead-module census
# ---------------------------------------------------------------------------


def _module_name(rel: str) -> Optional[str]:
    """src/repro_torch/a/b.py → repro_torch.a.b (None outside src/)."""
    rel = rel.replace(os.sep, "/")
    if not rel.startswith("src/") or not rel.endswith(".py"):
        return None
    mod = rel[len("src/"):-len(".py")]
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    return mod.replace("/", ".")


def _imported_modules(tree: ast.AST, known: Set[str]) -> Set[str]:
    """Module names this AST imports, anywhere in it, resolved against
    ``known`` (``from a import b`` marks ``a.b`` when it is a module)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names = [node.module] + [f"{node.module}.{alias.name}"
                                     for alias in node.names]
        else:
            continue
        out.update(n for n in names if n in known)
    return out


def _sources(repo_root: str) -> Dict[str, Tuple[Optional[str], ast.AST]]:
    rels = [rel for sub in _IMPORTER_DIRS
            if os.path.isdir(os.path.join(repo_root, sub))
            for rel in _py_files(repo_root, sub)]
    rels += sorted(f for f in os.listdir(repo_root) if f.endswith(".py"))
    out = {}
    for rel in rels:
        with open(os.path.join(repo_root, rel), encoding="utf-8") as f:
            try:
                tree = ast.parse(f.read())
            except SyntaxError:
                continue
        out[rel] = (_module_name(rel), tree)
    return out


def dead_module_census(repo_root: str) -> List[Violation]:
    """Every ``src/repro_torch`` module imported by nothing (package
    ``__init__``s and ``__main__``-guarded entry points exempt)."""
    sources = _sources(repo_root)
    known = {mod for mod, _ in sources.values() if mod}
    imported: Set[str] = set()
    for rel, (mod, tree) in sources.items():
        imported.update(n for n in _imported_modules(tree, known)
                        if n != mod)
    out: List[Violation] = []
    for rel in sorted(sources):
        mod, tree = sources[rel]
        if not mod or not (mod == "repro_torch"
                           or mod.startswith("repro_torch.")):
            continue
        if rel.endswith("__init__.py") or mod in imported:
            continue
        if any(isinstance(n, ast.If) and isinstance(n.test, ast.Compare)
               and isinstance(n.test.left, ast.Name)
               and n.test.left.id == "__name__" for n in ast.walk(tree)):
            continue                 # __main__-guarded entry point
        out.append(Violation(
            rule="lint-dead-module", target=_LINT_TARGET, file=rel, line=1,
            message=(f"module {mod} is imported by nothing under "
                     f"{'/'.join(_IMPORTER_DIRS)} or the repo's root — wire "
                     "it up or remove it")))
    return out


def run_lint(repo_root: str) -> Tuple[List[Violation], int]:
    """Both passes; ``(violations, files linted)``."""
    violations, n_files = lint_tree(repo_root)
    violations.extend(dead_module_census(repo_root))
    return violations, n_files
