"""Source-layer rules: repo-specific AST lint over ``src/repro_torch``
(port of ``repro/analysis/source_rules.py``).

Two rules the protocols were built to make possible:

* :class:`NoIsinstanceDispatch`: the search path dispatches on protocol
  methods, never ``isinstance`` over scorer / index classes. The lowering
  chain in ``kernels/__init__.py`` (scorer class -> kernel) is the one
  sanctioned boundary and lies outside ``HOT_PATHS``, as the reference's
  ``kernels/__init__.py`` lies outside its own.
* :class:`NoHostSyncInStep` (in place of the reference's
  ``NoHostSyncInJit``: PyTorch runs eagerly, so there is no traced body
  to find by its decorator): the bodies of a declared list of serving-step
  functions (``STEP_FUNCTIONS``) call no ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``np.*`` or ``torch.cuda.synchronize``, each a
  blocking device -> host copy or wait on every call. A declared function
  that is missing fails the rule, so a rename cannot drop it silently.
  The rule reads the bodies alone; what their callees do is measured on
  the card by :class:`repro_torch.analysis.trace_rules.NoHostSyncInStep`.

The reference's ``NoJaxDebug`` and ``NoRawCompatAPIs`` are about JAX APIs
and have no counterpart; the port's "no JAX import" rule lives in
``tests/test_torch_port_rules.py``.

Each rule walks pre-parsed ASTs from a shared :class:`SourceTree`. A
violation can be waived for one line with a trailing
``# analysis: allow-<rule-tag>`` comment -- greppable and reviewed, unlike
an allowlist buried here.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.registry import Rule, RuleResult

__all__ = ["SourceTree", "NoIsinstanceDispatch", "NoHostSyncInStep",
           "DISPATCH_CLASSES", "HOT_PATHS", "STEP_FUNCTIONS"]

# Scorer / Index protocol classes: isinstance over any of these in hot-
# path modules is type dispatch the protocols exist to remove.
DISPATCH_CLASSES = frozenset({
    "LinearScorer", "GleanVecScorer", "QuantizedScorer",
    "GleanVecQuantizedScorer", "SortedGleanVecScorer",
    "SortedGleanVecQuantizedScorer", "FlatIndex", "IVFIndex",
    "GraphIndex", "ShardedIndex",
})

# Hot-path module prefixes (relative to src/repro_torch, '/'-separated)
# where protocol dispatch is the law. ``kernels/__init__.py`` is NOT here:
# scorers lower to kernels there and nowhere else.
HOT_PATHS = ("core/search.py", "core/scorer.py", "index/", "serve/")

# The serving step: module -> the functions (``Class.method`` for methods)
# whose bodies must not host-sync.
STEP_FUNCTIONS: Dict[str, Tuple[str, ...]] = {
    "core/search.py": ("state_search", "state_candidates"),
    "index/protocol.py": ("FlatIndex.prepare_queries",
                          "FlatIndex.candidates"),
    "index/ivf.py": ("IVFIndex.prepare_queries", "IVFIndex.candidates"),
    "index/graph.py": ("GraphIndex.prepare_queries",
                       "GraphIndex.candidates"),
    "index/distributed.py": ("ShardedIndex.prepare_queries",
                             "ShardedIndex.candidates",
                             "ShardedIndex.search_local"),
}

# method calls that copy a tensor to the host or wait for the device
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})


class SourceTree:
    """``src/repro_torch`` parsed once: (relpath, source lines, ast) per
    file, shared by every source rule."""

    def __init__(self, root: str):
        self.root = root
        self.files: List[Tuple[str, List[str], ast.AST]] = []
        for dirpath, dirnames, filenames in sorted(os.walk(root)):
            dirnames.sort()
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                with open(path) as f:
                    src = f.read()
                try:
                    tree = ast.parse(src, filename=rel)
                except SyntaxError:
                    continue        # not this layer's problem
                self.files.append((rel, src.splitlines(), tree))

    @classmethod
    def of(cls, subject) -> "SourceTree":
        return subject if isinstance(subject, cls) else cls(subject)


def _attr_chain(node) -> str:
    """Dotted name of an attribute chain (``torch.cuda.synchronize`` ->
    "torch.cuda.synchronize"), or "" for non-name roots."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _waived(lines: List[str], lineno: int, tag: str) -> bool:
    ln = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
    return f"# analysis: allow-{tag}" in ln


class _SourceRule(Rule):
    family = "source"
    tag = ""            # the allow-comment suffix

    def check(self, tree) -> RuleResult:
        tree = SourceTree.of(tree)
        findings = []
        for rel, lines, mod in tree.files:
            for lineno, msg in self.visit_file(rel, mod):
                if not _waived(lines, lineno, self.tag):
                    findings.append(f"{rel}:{lineno}: {msg}")
        findings += self.missing(tree)
        if findings:
            return self._fail("; ".join(findings))
        return self._pass(f"{len(tree.files)} files clean")

    def visit_file(self, rel: str, mod: ast.AST):
        raise NotImplementedError

    def missing(self, tree: SourceTree) -> List[str]:
        return []


class NoIsinstanceDispatch(_SourceRule):
    """No ``isinstance`` over Scorer/Index protocol classes in hot-path
    modules: dispatch goes through protocol methods, so index x scorer x
    placement stay orthogonal axes."""

    name = "NoIsinstanceDispatch"
    tag = "isinstance"
    contract = ("hot paths (core/search, core/scorer, index/, serve/) never "
                "isinstance-dispatch on protocol classes")

    def visit_file(self, rel, mod):
        if not any(rel.startswith(p) for p in HOT_PATHS):
            return
        for node in ast.walk(mod):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "isinstance"
                    and len(node.args) == 2):
                continue
            t = node.args[1]
            for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                nm = e.id if isinstance(e, ast.Name) else \
                    (e.attr if isinstance(e, ast.Attribute) else "")
                if nm in DISPATCH_CLASSES:
                    yield node.lineno, f"isinstance dispatch on {nm}"


def _functions(mod: ast.AST):
    """(qualified name, node) of the module's functions and its classes'
    methods (one level, as ``STEP_FUNCTIONS`` names them)."""
    for node in mod.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{item.name}", item


class NoHostSyncInStep(_SourceRule):
    """The declared serving-step functions' bodies never call ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.*`` / ``numpy.*`` or
    ``torch.cuda.synchronize``."""

    name = "NoHostSyncInStep"
    tag = "host-sync"
    contract = ("serving-step bodies (search.state_search / state_candidates,"
                " every index's prepare_queries / candidates) never call "
                ".item(), .tolist(), .cpu(), .numpy(), np.* or "
                "torch.cuda.synchronize")

    def __init__(self, steps: Dict[str, Sequence[str]] = None):
        self.steps = STEP_FUNCTIONS if steps is None else steps

    def visit_file(self, rel, mod):
        wanted = set(self.steps.get(rel, ()))
        for qual, fn in _functions(mod):
            if qual not in wanted:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                chain = _attr_chain(node.func)
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in SYNC_METHODS:
                    yield node.lineno, \
                        f".{node.func.attr}() host sync in step {qual}"
                elif chain.startswith(("np.", "numpy.")):
                    yield node.lineno, f"{chain}() in step {qual}"
                elif chain == "torch.cuda.synchronize":
                    yield node.lineno, f"{chain}() in step {qual}"

    def missing(self, tree):
        found = {rel: {q for q, _ in _functions(mod)}
                 for rel, _, mod in tree.files}
        return [f"{rel}: declared step function {q} not found"
                for rel, quals in self.steps.items() for q in quals
                if q not in found.get(rel, set())]
