"""Graph-reachability call graph over a set of Python sources.

The port's counterpart of ``masters_thesis_tpu/analysis/callgraph.py``. The
JAX package asks which functions run under a JAX trace; the port asks which
run inside a CUDA graph on the card: the training step, the evaluation
chunk and each serving bucket are each one captured graph (ROADMAP
"Graphs"), and a host read there either breaks the capture or freezes a
value into every replay. The lint must run without building the model, so
the answer is approximated statically:

1. **Seeds** — the function handed to a ``GraphedCall`` (``GraphedCall(f,
   ...)``, ``GraphedCall(self._step, ...)``, or a local name bound to one
   of them or to ``functools.partial(f, ...)``); every call made inside a
   ``with torch.cuda.graph(...)`` block; and the ``forward`` of every
   ``nn.Module`` subclass in the sources, since the port's modules run
   inside the programs' graphs on the card (the training step, the
   evaluation chunk, the serving buckets).
2. **Propagation** — whatever a graph-reachable function calls is
   graph-reachable when the call resolves within the analysed sources: a
   bare name (same module, or imported), ``module.f`` through an import,
   ``self.m()`` to the enclosing class's method; nested ``def``s too. The
   kernel wrappers' plain twins are reached this way, through the wrapper
   that calls them.

As in the JAX pass, a flag must be provable: a call through a variable, an
attribute of an unknown object, or a method name shared by several classes
is not followed, so what it reaches is not held to the graph rules.
Stdlib only.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

#: Call targets (last segment) whose first argument runs as a CUDA graph.
GRAPH_WRAPPERS = {"GraphedCall"}
#: ``with`` contexts (dotted name suffix) whose block is captured.
GRAPH_CONTEXTS = ("cuda.graph",)
#: Base classes (last segment) whose ``forward`` runs inside the graphs.
MODULE_BASES = {"Module"}
_PARTIALS = {"partial", "functools.partial"}
#: Calls (last segment) that call their first argument in the caller's
#: context (activation checkpointing, partial application).
CALLS_FIRST_ARG = {"checkpoint", "partial"}


def dotted_name(node: ast.AST) -> str | None:
    """'torch.cuda.graph' for nested Attribute/Name chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def is_graph_context(expr: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` (any alias ending in ``cuda.graph``)."""
    if not isinstance(expr, ast.Call):
        return False
    name = dotted_name(expr.func)
    return name is not None and name.endswith(GRAPH_CONTEXTS)


@dataclasses.dataclass
class FunctionInfo:
    key: str  # "<module>:<qualpath>"
    name: str
    module: str
    cls: str | None  # the class whose ``self`` the body sees
    node: ast.FunctionDef
    params: list[str]
    calls: set[str] = dataclasses.field(default_factory=set)
    children: list[str] = dataclasses.field(default_factory=list)
    seeded: bool = False
    #: Local name -> the expressions it is bound to (``f = g``,
    #: ``run, args = g, (...)``, ``f = partial(g, ...)``).
    aliases: dict[str, list[ast.AST]] = dataclasses.field(
        default_factory=dict)


class _ModuleCollector(ast.NodeVisitor):
    def __init__(self, module: str, graph: "CallGraph"):
        self.module = module
        self.graph = graph
        #: Enclosing scopes: ("class", name) or ("def", key).
        self.stack: list[tuple[str, str]] = []
        self.in_graph_block = 0

    # ------------------------------------------------------------- scopes

    def _function(self) -> FunctionInfo | None:
        for kind, name in reversed(self.stack):
            if kind == "def":
                return self.graph.functions[name]
        return None

    def _class(self) -> str | None:
        """The class whose ``self`` the current scope sees."""
        fn = self._function()
        if fn is not None:
            return fn.cls
        if self.stack and self.stack[-1][0] == "class":
            return self.stack[-1][1]
        return None

    # ------------------------------------------------------------- imports

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module:
            for alias in node.names:
                self.graph.imports[self.module][alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}")
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.graph.imports[self.module][alias.asname or alias.name] = (
                alias.name)
        self.generic_visit(node)

    # ------------------------------------------------------ classes, defs

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        bases = {(dotted_name(b) or "").split(".")[-1] for b in node.bases}
        if bases & MODULE_BASES:
            self.graph.module_classes.add((self.module, node.name))
        self.stack.append(("class", node.name))
        self.generic_visit(node)
        self.stack.pop()

    def _handle_def(self, node: ast.FunctionDef) -> None:
        quals = [name.split(":")[-1].split(".")[-1] if kind == "def" else name
                 for kind, name in self.stack]
        key = f"{self.module}:{'.'.join(quals + [node.name])}"
        is_method = bool(self.stack) and self.stack[-1][0] == "class"
        cls = self.stack[-1][1] if is_method else self._class()
        params = [a.arg for a in node.args.posonlyargs + node.args.args
                  + node.args.kwonlyargs]
        if node.args.vararg:
            params.append(node.args.vararg.arg)
        info = FunctionInfo(key, node.name, self.module, cls, node, params)
        if (is_method and node.name == "forward"
                and (self.module, cls) in self.graph.module_classes):
            info.seeded = True
        self.graph.functions[key] = info
        if is_method:
            self.graph.methods[(self.module, cls, node.name)] = key
        else:
            self.graph.by_name.setdefault((self.module, node.name),
                                          []).append(key)
        parent = self._function()
        if parent is not None:
            parent.children.append(key)
        self.stack.append(("def", key))
        outer, self.in_graph_block = self.in_graph_block, 0
        self.generic_visit(node)
        self.in_graph_block = outer
        self.stack.pop()

    visit_FunctionDef = _handle_def
    visit_AsyncFunctionDef = _handle_def

    # --------------------------------------------------------- statements

    def visit_Assign(self, node: ast.Assign) -> None:
        fn = self._function()
        if fn is not None:
            for tgt in node.targets:
                pairs = [(tgt, node.value)]
                if (isinstance(tgt, ast.Tuple) and isinstance(node.value,
                                                              ast.Tuple)
                        and len(tgt.elts) == len(node.value.elts)):
                    pairs = list(zip(tgt.elts, node.value.elts))
                for name, value in pairs:
                    if isinstance(name, ast.Name):
                        fn.aliases.setdefault(name.id, []).append(value)
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        graph_block = any(is_graph_context(i.context_expr) for i in node.items)
        for item in node.items:
            self.visit(item)
        if graph_block:
            self.in_graph_block += 1
            fn = self._function()
            if fn is not None:
                self.graph.graph_blocks.setdefault(fn.key, []).append(node)
        for stmt in node.body:
            self.visit(stmt)
        if graph_block:
            self.in_graph_block -= 1

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call) -> None:
        callee = dotted_name(node.func)
        fn = self._function()
        if fn is not None and callee is not None:
            fn.calls.add(callee)
            # A local alias is called through (``run(*args)``), and so is
            # the function that ``checkpoint`` or ``partial`` is handed.
            if isinstance(node.func, ast.Name):
                fn.calls |= self._callables(node.func, fn)
            if callee.split(".")[-1] in CALLS_FIRST_ARG and node.args:
                fn.calls |= self._callables(node.args[0], fn)
        if self.in_graph_block and callee is not None:
            self._seed(node.func, fn)
        if callee is not None and callee.split(".")[-1] in GRAPH_WRAPPERS:
            body = node.args[0] if node.args else next(
                (k.value for k in node.keywords if k.arg == "body"), None)
            if body is not None:
                self._seed(body, fn)
        self.generic_visit(node)

    # -------------------------------------------------------------- seeds

    def _callables(self, expr: ast.AST, fn: FunctionInfo | None,
                   depth: int = 0) -> set[str]:
        """Dotted names of the functions a callable expression in ``fn``'s
        scope (or at module level) may be: a name, through its local
        aliases; ``self.m``; the function of a ``partial(f, ...)``."""
        if depth > 4:
            return set()
        if isinstance(expr, ast.Call):
            if dotted_name(expr.func) in _PARTIALS and expr.args:
                return self._callables(expr.args[0], fn, depth + 1)
            return set()
        if (isinstance(expr, ast.Name) and fn is not None
                and expr.id in fn.aliases):
            out: set[str] = set()
            for value in fn.aliases[expr.id]:
                out |= self._callables(value, fn, depth + 1)
            return out
        name = dotted_name(expr)
        return {name} if name is not None else set()

    def _seed(self, expr: ast.AST, fn: FunctionInfo | None) -> None:
        """Mark what ``expr`` names as a graph seed."""
        for name in self._callables(expr, fn):
            self.graph.seeds.append((self.module, self._class(), name))


class CallGraph:
    """Package-wide function index with graph-reachability propagation."""

    def __init__(self) -> None:
        self.functions: dict[str, FunctionInfo] = {}
        self.by_name: dict[tuple[str, str], list[str]] = {}
        #: (module, class, method) -> key.
        self.methods: dict[tuple[str, str, str], str] = {}
        self.imports: dict[str, dict[str, str]] = {}
        #: (module, class in scope, dotted callee) of each seed expression.
        self.seeds: list[tuple[str, str | None, str]] = []
        self.module_classes: set[tuple[str, str]] = set()
        #: Function key -> its ``with torch.cuda.graph(...)`` statements.
        self.graph_blocks: dict[str, list[ast.With]] = {}
        self.modules: dict[str, Path] = {}
        self._reached: set[str] = set()

    @classmethod
    def build(cls, trees: dict[str, tuple[Path, ast.AST]]) -> "CallGraph":
        """``trees``: module name -> (path, parsed AST)."""
        graph = cls()
        for module, (path, tree) in trees.items():
            graph.modules[module] = path
            graph.imports.setdefault(module, {})
        for module, (_path, tree) in trees.items():
            _ModuleCollector(module, graph).visit(tree)
        graph._propagate()
        return graph

    # ---------------------------------------------------------- resolution

    def resolve(self, module: str, cls: str | None, callee: str) -> list[str]:
        """Keys of analysed functions a call name provably refers to."""
        imports = self.imports.get(module, {})
        head, _, rest = callee.partition(".")
        if not rest:
            hits = list(self.by_name.get((module, callee), []))
            target = imports.get(callee)
            if target is not None:
                t_mod, _, t_name = target.rpartition(".")
                hits += self.by_name.get((t_mod, t_name), [])
            return hits
        if head == "self" and cls is not None and "." not in rest:
            key = self.methods.get((module, cls, rest))
            return [key] if key is not None else []
        target_mod = imports.get(head)
        if target_mod is not None and "." not in rest:
            return list(self.by_name.get((target_mod, rest), []))
        return []

    # --------------------------------------------------------- propagation

    def _propagate(self) -> None:
        work = [k for k, f in self.functions.items() if f.seeded]
        for module, cls, name in self.seeds:
            work.extend(self.resolve(module, cls, name))
        reached: set[str] = set()
        while work:
            key = work.pop()
            if key in reached:
                continue
            reached.add(key)
            info = self.functions[key]
            info.seeded = True
            work.extend(info.children)
            for callee in info.calls:
                work.extend(self.resolve(info.module, info.cls, callee))
        self._reached = reached

    def graph_functions(self) -> set[str]:
        return set(self._reached)

    def is_graphed(self, key: str) -> bool:
        return key in self._reached
