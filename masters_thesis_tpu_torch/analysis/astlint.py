"""The graph-path lint: AST rules for code that runs inside a CUDA graph.

The port's counterpart of ``masters_thesis_tpu/analysis/astlint.py``. The
port's contract is that a training step, an evaluation chunk and a serving
bucket are each one CUDA graph with no host read inside (ROADMAP "Graphs").
That contract breaks silently: a ``.item()`` in a step makes the capture
fail or, outside a capture, syncs every step; a Python ``if`` on a tensor
reads it on the host and freezes the branch taken at capture into every
replay. "Graph-reachable" comes from :mod:`callgraph`. The rules keep the
JAX ids, in their torch meaning:

- **TL101** host read: ``float()``/``int()``/``bool()``/``complex()``, or
  ``.item()``/``.tolist()``, on a tensor in graph-reachable code.
- **TL102** Python ``if``/``while`` (or a conditional expression) on a
  tensor's value in graph-reachable code: a torch call, a method of a
  tensor, or a comparison or arithmetic with a tensor operand. (The JAX
  rule also flags a ``for`` over a traced array; a loop over a tensor's
  first axis unrolls at its shape, fixed at capture, and reads nothing on
  the host, so the port does not flag it.)
- **TL103** random streams. JAX's rule (a PRNG key consumed twice without
  ``split``) has no object under torch's stateful generators: a generator
  advances at each draw. The port's own rule in its place: a draw in
  graph-reachable code (``torch.rand*``, ``randperm``, ``normal``,
  ``bernoulli``, ``multinomial``, ``dropout``, an in-place ``uniform_``,
  ``normal_``, ...) with no ``generator=``. The default generator's state
  is not registered with the graph, so its replays do not advance it as
  eager calls would (``GraphedCall`` registers the generators it is given).
- **TL104** precision, anywhere in the sources: a ``float64``/``double``
  dtype (``torch.float64``, ``torch.double``, ``.double()``,
  ``np.float64``, ``dtype="float64"``), ``allow_tf32 = True``, or
  ``set_float32_matmul_precision`` below ``"highest"`` (the port computes
  in f32: its numerics rule, ROADMAP).
- **TL105** host transfer or synchronisation in graph-reachable code:
  ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize()``,
  a stream's or event's ``.synchronize()``, ``torch.tensor``/
  ``as_tensor``/``from_numpy`` (a blocking copy of host data), ``np.*``
  on a tensor.

Value tracking is a per-function taint pass: parameters (but ``self`` and
``cls``, and those with a default or a host annotation) and the results of
torch calls and of tensor methods are tensors; ``.shape``, ``.dtype``,
``.device``, ``.size()``, ``.dim()``, ``.numel()``... are host values and
break the taint. What the pass cannot prove a tensor is not flagged, and
``# mtt: disable=TLxxx -- reason`` suppresses a deliberate exception.
Stdlib only.
"""

from __future__ import annotations

import ast
from pathlib import Path

from masters_thesis_tpu_torch.analysis.callgraph import CallGraph, dotted_name
from masters_thesis_tpu_torch.analysis.findings import (
    Finding,
    is_suppressed,
    suppressed_rules_by_line,
    unique_sorted,
)

#: Attribute reads that are host values even on a tensor.
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad", "itemsize", "names"}
#: Tensor methods that return host values (not a read of the data).
HOST_TENSOR_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                       "stride", "is_contiguous", "data_ptr", "get_device",
                       "is_floating_point", "storage_offset"}
#: torch calls (last segment, or its prefix) that answer a host value.
HOST_TORCH_PREFIXES = ("is_", "get_", "are_", "current_")
HOST_TORCH_CALLS = {"device", "device_count", "finfo", "iinfo", "Size",
                    "Generator", "Stream", "Event", "no_grad", "enable_grad",
                    "inference_mode", "set_grad_enabled"}
HOST_CASTS = {"float", "int", "bool", "complex"}
HOST_METHODS = {"item", "tolist"}
#: Methods that copy to the host or wait for the device.
TRANSFER_METHODS = {"cpu", "numpy", "synchronize"}
#: torch calls that copy host data to the device, blocking.
HOST_COPY_CALLS = {"tensor", "as_tensor", "from_numpy"}
#: torch random draws (last segment) and in-place tensor draws.
RANDOM_CALLS = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "normal", "bernoulli",
                "multinomial", "poisson", "dropout", "dropout1d",
                "dropout2d", "alpha_dropout", "feature_alpha_dropout"}
RANDOM_METHODS = {"uniform_", "normal_", "bernoulli_", "random_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_"}

#: Builtins whose result is always a host value.
HOST_BUILTINS = {
    "range", "len", "enumerate", "reversed", "zip", "sorted", "isinstance",
    "hasattr", "getattr", "type", "id", "repr", "str", "format",
}
#: Parameters that are never tensors.
HOST_PARAM_NAMES = {"self", "cls", "device", "dtype", "stream", "generator"}
#: dtype spellings of float64.
F64_NAMES = {"float64", "double"}
F64_STRINGS = {"float64", "double", "f8", ">f8", "<f8"}


def host_annotation(annotation: ast.AST | None) -> bool:
    """An annotation that names no tensor (``int``, ``str``, ``tuple``,
    ``torch.device``, ...)."""
    return annotation is not None and "Tensor" not in ast.unparse(annotation)


def _host_params(fn_node: ast.FunctionDef) -> set[str]:
    """Parameters provably host-side: ``self``/``cls``/``device``/...,
    annotated with a type that names no tensor, or bound through a default
    (the ``def _run(layer=layer)`` closure idiom)."""
    args = fn_node.args
    host = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs
            if a.arg in HOST_PARAM_NAMES or host_annotation(a.annotation)}
    positional = args.posonlyargs + args.args
    for a in positional[len(positional) - len(args.defaults):]:
        host.add(a.arg)
    for a, default in zip(args.kwonlyargs, args.kw_defaults):
        if default is not None:
            host.add(a.arg)
    return host


def _module_aliases(imports: dict[str, str]) -> tuple[set[str], set[str]]:
    """(torch-like local names, numpy local names) of one module."""
    torch_like = {"torch"}
    numpy_like: set[str] = set()
    for local, target in imports.items():
        root = target.split(".")[0]
        if root == "torch":
            torch_like.add(local)
        elif root == "numpy":
            numpy_like.add(local)
    return torch_like, numpy_like


def _target_names(target: ast.AST) -> list[str]:
    """Names (re)bound by an assignment target (a subscript's or an
    attribute's base only)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for elt in target.elts for n in _target_names(elt)]
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    if isinstance(target, (ast.Subscript, ast.Attribute)):
        return _target_names(target.value)
    return []


def _walk_expr(expr: ast.AST):
    """ast.walk over an expression, without lambda bodies."""
    stack = [expr]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, ast.Lambda):
                stack.append(child)


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and bool(node.args)
            and (dotted_name(node.func) or "").endswith("device")
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


class _FunctionLinter:
    """Taint and rule pass over one function body (nested defs are their
    own scopes). ``graph_stmts`` are statements of a ``torch.cuda.graph``
    block, held to the rules whatever the function."""

    def __init__(self, fn_node: ast.FunctionDef, params: list[str],
                 graphed: bool, torch_aliases: set[str],
                 numpy_aliases: set[str], path: str,
                 graph_stmts: frozenset[int] = frozenset(),
                 host_result=lambda call: False):
        self.fn = fn_node
        #: Whether a call resolves to an analysed function that returns
        #: a host value (its return annotation names no tensor).
        self.host_result = host_result
        self.graphed = graphed
        self.graph_stmts = graph_stmts
        self.torch = torch_aliases
        self.np = numpy_aliases
        self.path = path
        self.tainted: set[str] = set(params) - _host_params(fn_node)
        self.findings: list[Finding] = []
        self._in_graph = graphed

    # ------------------------------------------------------------- helpers

    def _is_torch_call(self, call: ast.Call) -> bool:
        name = dotted_name(call.func)
        return name is not None and name.split(".")[0] in self.torch

    def _is_tensor_call(self, call: ast.Call) -> bool:
        """A torch call that returns a tensor (not a host query such as
        ``torch.is_grad_enabled()`` or ``torch.cuda.current_stream()``)."""
        if not self._is_torch_call(call):
            return False
        last = dotted_name(call.func).split(".")[-1]
        return not (last.startswith(HOST_TORCH_PREFIXES)
                    or last in HOST_TORCH_CALLS)

    def _is_numpy_call(self, call: ast.Call) -> bool:
        name = dotted_name(call.func)
        return name is not None and name.split(".")[0] in self.np

    def _tensor_method(self, call: ast.Call) -> bool:
        """A method of a tensor that returns a tensor."""
        return (isinstance(call.func, ast.Attribute)
                and call.func.attr not in HOST_TENSOR_METHODS
                and call.func.attr not in HOST_METHODS
                and self._traced(call.func.value))

    def _traced(self, node: ast.AST) -> bool:
        """Whether an expression may hold a tensor."""
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False
            return self._traced(node.value)
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) and (
                    node.func.id in HOST_BUILTINS
                    or node.func.id in HOST_CASTS) or self.host_result(node):
                return False
            if self._is_tensor_call(node) or self._tensor_method(node):
                return True
            return any(self._traced(a) for a in node.args) or any(
                self._traced(k.value) for k in node.keywords)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return False
        return any(self._traced(c) for c in ast.iter_child_nodes(node))

    def _test_traced(self, test: ast.AST) -> bool:
        """A branch condition that reads a tensor's value: a torch call or
        a tensor method, or a comparison, boolean or arithmetic with a
        tensor operand (a bare name may be a host container; ``is`` and
        ``is not`` compare identity)."""
        if isinstance(test, ast.Call):
            return (self._is_tensor_call(test) or self._tensor_method(test)
                    or any(self._test_traced(a) for a in test.args))
        if isinstance(test, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
                return False
            return self._traced(test)
        if isinstance(test, ast.BoolOp):
            return any(self._test_traced(v) for v in test.values)
        if isinstance(test, ast.BinOp):
            return self._traced(test)
        if isinstance(test, ast.UnaryOp):
            return self._test_traced(test.operand)
        return False

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(rule, message, self.path,
                                     getattr(node, "lineno", 0)))

    # ---------------------------------------------------------- taint pass

    def _taint_statements(self, stmts: list[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = stmt.value
                if value is not None and self._traced(value):
                    targets = (stmt.targets if isinstance(stmt, ast.Assign)
                               else [stmt.target])
                    for target in targets:
                        self.tainted.update(_target_names(target))
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                if self._traced(stmt.iter):
                    self.tainted.update(_target_names(stmt.target))
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    if item.optional_vars is not None and self._traced(
                            item.context_expr):
                        self.tainted.update(_target_names(item.optional_vars))
            for attr in ("body", "orelse", "finalbody"):
                inner = getattr(stmt, attr, None)
                if inner:
                    self._taint_statements(inner)
            for handler in getattr(stmt, "handlers", []) or []:
                self._taint_statements(handler.body)

    # ----------------------------------------------------------- rule pass

    def run(self) -> list[Finding]:
        # Twice: the second sweep sees names tainted later in source order
        # than their first read (loop-carried values).
        self._taint_statements(self.fn.body)
        self._taint_statements(self.fn.body)
        self._visit_block(self.fn.body)
        return self.findings

    def _visit_block(self, stmts: list[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            outer = self._in_graph
            self._in_graph = outer or id(stmt) in self.graph_stmts
            self._visit_stmt(stmt)
            self._in_graph = outer

    def _visit_stmt(self, stmt: ast.stmt) -> None:
        if (self._in_graph and isinstance(stmt, (ast.If, ast.While))
                and self._test_traced(stmt.test)):
            self._emit("TL102", stmt,
                       "Python branch on a tensor's value inside a CUDA "
                       "graph (a host read, and the branch taken at capture "
                       "is frozen into every replay; use torch.where)")
        for child in ast.iter_child_nodes(stmt):
            if not isinstance(child, ast.expr):
                continue
            for node in _walk_expr(child):
                if (self._in_graph and isinstance(node, ast.IfExp)
                        and self._test_traced(node.test)):
                    self._emit("TL102", node,
                               "conditional expression on a tensor's value "
                               "inside a CUDA graph (use torch.where)")
                if isinstance(node, ast.Call):
                    self._check_call(node)
        for attr in ("body", "orelse", "finalbody"):
            inner = getattr(stmt, attr, None)
            if inner:
                self._visit_block(inner)
        for handler in getattr(stmt, "handlers", []) or []:
            self._visit_block(handler.body)

    # ------------------------------------------------------------- calls

    def _check_call(self, call: ast.Call) -> None:
        callee = dotted_name(call.func)
        last = (callee or "").split(".")[-1]
        method = call.func.attr if isinstance(call.func, ast.Attribute) else None
        # TL104 applies host-side too (module_findings adds the literals).
        if (last == "set_float32_matmul_precision" and call.args
                and isinstance(call.args[0], ast.Constant)
                and call.args[0].value != "highest"):
            self._emit("TL104", call,
                       f"matmul precision {call.args[0].value!r} (below "
                       "'highest': TF32 or bf16 passes in f32 matmuls)")
        if not self._in_graph:
            return
        # TL101 — host reads.
        if (isinstance(call.func, ast.Name) and call.func.id in HOST_CASTS
                and len(call.args) == 1 and self._traced(call.args[0])):
            self._emit("TL101", call,
                       f"{call.func.id}() on a tensor inside a CUDA graph "
                       "(a host read: the capture fails, or it syncs)")
        if method in HOST_METHODS and self._traced(call.func.value):
            self._emit("TL101", call,
                       f".{method}() on a tensor inside a CUDA graph")
        # TL103 — draws from the default generator.
        keywords = {k.arg for k in call.keywords}
        if "generator" not in keywords and (
                (last in RANDOM_CALLS and self._is_torch_call(call))
                or (method in RANDOM_METHODS
                    and self._traced(call.func.value))):
            self._emit("TL103", call,
                       f"{callee or method} draws from the default generator "
                       "inside a CUDA graph (pass generator=: the graph "
                       "registers only the generators it is given)")
        # TL105 — host transfers and synchronisation.
        if callee is not None and callee.endswith("cuda.synchronize"):
            self._emit("TL105", call,
                       "torch.cuda.synchronize() inside a CUDA graph")
        elif method in TRANSFER_METHODS:
            self._emit("TL105", call,
                       f".{method}() inside a CUDA graph (a host "
                       "transfer or a wait for the device)")
        if method == "to" and (
                any(_is_cpu(a) for a in call.args)
                or any(k.arg == "device" and _is_cpu(k.value)
                       for k in call.keywords)):
            self._emit("TL105", call,
                       ".to('cpu') inside a CUDA graph (a host transfer)")
        if last in HOST_COPY_CALLS and self._is_torch_call(call):
            self._emit("TL105", call,
                       f"{callee} inside a CUDA graph (a blocking copy of "
                       "host data; make the tensor once, outside)")
        if self._is_numpy_call(call) and (
                any(self._traced(a) for a in call.args)
                or any(self._traced(k.value) for k in call.keywords)):
            self._emit("TL105", call,
                       f"{callee} on a tensor inside a CUDA graph (a silent "
                       "host transfer; use torch)")


# --------------------------------------------------------------- driver


def _module_name(path: Path, root: Path | None) -> str:
    if root is not None:
        try:
            rel = path.resolve().relative_to(root.resolve().parent)
            return ".".join(rel.with_suffix("").parts)
        except ValueError:
            pass
    return path.stem


def discover_files(paths: list[Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(f for f in sorted(p.rglob("*.py"))
                         if "__pycache__" not in f.parts)
        elif p.suffix == ".py":
            files.append(p)
    return files


def parse_sources(paths: list[Path | str],
                  package_root: Path | str | None = None):
    """``(sources, trees, syntax errors)`` of the files under ``paths``,
    keyed by module name (anchored at ``package_root``, else the first
    directory given)."""
    paths = [Path(p) for p in paths]
    if package_root is None:
        package_root = next((p for p in paths if p.is_dir()), None)
    root = Path(package_root) if package_root else None
    sources: dict[str, str] = {}
    trees: dict[str, tuple[Path, ast.AST]] = {}
    errors: list[Finding] = []
    for f in discover_files(paths):
        module = _module_name(f, root)
        try:
            src = f.read_text()
            tree = ast.parse(src, filename=str(f))
        except SyntaxError as exc:
            errors.append(Finding("TL100", f"syntax error: {exc.msg}", str(f),
                                  exc.lineno or 0))
            continue
        sources[module] = src
        trees[module] = (f, tree)
    return sources, trees, errors


def _module_level_findings(tree: ast.AST, path: str,
                           linter: _FunctionLinter) -> list[Finding]:
    """TL104 outside any function (calls at module scope), and its dtype
    and TF32 literals anywhere in the file."""
    stack = [n for n in ast.iter_child_nodes(tree)
             if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Call):
            linter._check_call(node)
        stack.extend(ast.iter_child_nodes(node))
    findings = list(linter.findings)
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in F64_NAMES:
            findings.append(Finding("TL104", f"{node.attr} dtype in library "
                                    "code", path, node.lineno))
        if (isinstance(node, ast.keyword) and node.arg == "dtype"
                and isinstance(node.value, ast.Constant)
                and node.value.value in F64_STRINGS):
            findings.append(Finding("TL104", "dtype='float64' literal", path,
                                    node.value.lineno))
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if (node.value is not None
                    and isinstance(node.value, ast.Constant)
                    and node.value.value is True
                    and any((dotted_name(t) or "").endswith("allow_tf32")
                            for t in targets)):
                findings.append(Finding("TL104", "TF32 turned on (f32 "
                                        "matmuls and convolutions lose "
                                        "precision)", path, node.lineno))
    return findings


def lint_paths(paths: list[Path | str],
               package_root: Path | str | None = None) -> list[Finding]:
    """Run the graph-path lint over files/directories; returns the
    findings no suppression matched. ``package_root`` anchors module names
    (cross-module reachability); by default the first directory given."""
    sources, trees, findings = parse_sources(paths, package_root)
    graph = CallGraph.build(trees)
    def host_result(module: str, cls: str | None):
        def answer(call: ast.Call) -> bool:
            callee = dotted_name(call.func)
            keys = graph.resolve(module, cls, callee) if callee else []
            return bool(keys) and all(
                host_annotation(graph.functions[k].node.returns)
                for k in keys)
        return answer

    for module, (path, tree) in trees.items():
        torch_aliases, numpy_aliases = _module_aliases(
            graph.imports.get(module, {}))
        suppressions = suppressed_rules_by_line(sources[module])
        module_findings: list[Finding] = []
        for info in graph.functions.values():
            if info.module != module:
                continue
            blocks = graph.graph_blocks.get(info.key, [])
            graph_stmts = frozenset(id(s) for b in blocks for s in b.body)
            linter = _FunctionLinter(
                info.node, info.params, graph.is_graphed(info.key),
                torch_aliases, numpy_aliases, str(path), graph_stmts,
                host_result(module, info.cls))
            module_findings.extend(linter.run())
        top = _FunctionLinter(ast.parse("def _m(): pass").body[0], [], False,
                              torch_aliases, numpy_aliases, str(path))
        module_findings.extend(_module_level_findings(tree, str(path), top))
        findings.extend(f for f in module_findings
                        if not is_suppressed(f, suppressions))
    return unique_sorted(findings)

