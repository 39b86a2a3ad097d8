"""SPMD divergence lint (DV701–DV705).

The port's copy of ``masters_thesis_tpu/analysis/spmd.py``, over
``torch.distributed``. Every rank of a data-parallel run must issue the
same collectives in the same order over the same shapes: the gradient
all-reduce a step (``DataMesh.all_reduce_mean_``), the metric sums an
epoch (``all_reduce_sums``), the flag agreement (``agree``), the named
barriers of a checkpoint's publish and recovery (``fleet_barrier``), and
the entries chained into the collective schedule (``record_collective``).
When host-divergent state steers control flow around one of them, the
group hangs in the collective the divergent rank skipped. This pass finds
those schedules statically.

Taint sources, each tagged with its kind:

- ``rank`` — ``dist.get_rank()``, ``multihost_rank()``
  (``utils/backend_probe.py``), ``RANK``/``LOCAL_RANK``/
  ``JAX_PROCESS_INDEX`` read from the environment, parameters named
  ``rank``/``local_rank``/``process_index``/``proc``/..., and functions
  whose return derives from one of those (``process_identity``);
- ``env`` — ``os.environ[...]``, ``os.environ.get``, ``os.getenv``;
- ``time`` — ``time.time``/``monotonic``/``perf_counter``, ``datetime.now``;
- ``rng`` — module-level ``random.*``, ``uuid.uuid4``, ``os.urandom``,
  legacy ``np.random.*``, ``random.Random()`` without a seed;
- ``host`` — ``socket.gethostname``, ``os.getpid``,
  ``torch.cuda.device_count``/``current_device``.

``dist.get_world_size()`` is not a source: it is the same on every rank,
as the JAX pass holds of ``process_count()``.

Collectives: ``dist.all_reduce``, ``barrier``, ``broadcast``,
``all_gather*``, ``reduce_scatter*``, ``all_to_all*``, and the port's
wrappers above. Rules:

- **DV701** host-divergent control flow that only one side of reaches a
  collective (an ``if``, an early exit, a loop bound).
- **DV702** both sides reach collectives, in a different order or kind.
- **DV703** a host-divergent value flows into a collective's operand or a
  tensor's shape (``torch.zeros(n_local)``).
- **DV704** nondeterminism on the checkpoint publish/resume path.
- **DV705** a rank-0-only side effect with no named barrier in the
  function's schedule.

Taint propagates through assignments, arithmetic, f-strings, subscripts
and a few builtins; any other call launders it. What the pass cannot prove
divergent it does not flag. ``# mtt: disable=DV70x -- reason`` suppresses.
The runtime half is ``telemetry/schedule.py``: each rank chains its actual
schedule into a hash that the postmortem compares. Stdlib only.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

from masters_thesis_tpu_torch.analysis.astlint import parse_sources
from masters_thesis_tpu_torch.analysis.callgraph import CallGraph, dotted_name
from masters_thesis_tpu_torch.analysis.concurrency import (
    CallSite,
    _collect_functions,
    _collect_inventory,
    _param_types,
    _reachable,
    _Resolver,
)
from masters_thesis_tpu_torch.analysis.findings import (
    Finding,
    is_suppressed,
    suppressed_rules_by_line,
    unique_sorted,
)

# --------------------------------------------------------------- vocabulary

#: Collectives, by final attribute segment: ``torch.distributed``'s and
#: the port's wrappers (``parallel/mesh.py``, ``telemetry/schedule.py``).
COLLECTIVE_NAMES = {
    "all_reduce": "all_reduce",
    "all_reduce_mean_": "all_reduce",
    "all_reduce_sums": "all_reduce",
    "agree": "all_reduce",
    "barrier": "barrier",
    "fleet_barrier": "barrier",
    "monitored_barrier": "barrier",
    "broadcast": "broadcast",
    "broadcast_object_list": "broadcast",
    "all_gather": "all_gather",
    "all_gather_into_tensor": "all_gather",
    "all_gather_object": "all_gather",
    "reduce_scatter": "reduce_scatter",
    "reduce_scatter_tensor": "reduce_scatter",
    "all_to_all": "all_to_all",
    "all_to_all_single": "all_to_all",
    "record_collective": "schedule",
}

#: Parameters that carry a per-rank identity by convention.
RANK_PARAM_NAMES = {
    "rank", "process_index", "process_id", "proc", "host_id", "local_rank",
}
#: Environment variables that carry a rank.
RANK_ENV_NAMES = {"RANK", "LOCAL_RANK", "JAX_PROCESS_INDEX"}

#: Full dotted call → taint kind, as the port spells them.
TIME_CALLS = {
    "time.time", "time.monotonic", "time.perf_counter",
    "time.perf_counter_ns", "time.time_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.date.today",
}
RNG_CALLS = {
    "random.random", "random.randint", "random.choice", "random.shuffle",
    "random.uniform", "random.randrange", "random.sample", "random.betavariate",
    "random.gauss", "uuid.uuid4", "os.urandom",
    "np.random.rand", "np.random.randn", "np.random.randint",
    "np.random.random", "np.random.permutation", "np.random.shuffle",
    "numpy.random.rand", "numpy.random.randn", "numpy.random.randint",
    "numpy.random.random", "numpy.random.permutation",
    "numpy.random.shuffle",
}
HOST_ID_CALLS = {
    "socket.gethostname", "os.getpid",
    "torch.cuda.device_count", "torch.cuda.current_device",
}
#: Calls (last segment) that answer this process's rank.
RANK_CALLS = {"get_rank", "multihost_rank"}

#: Builtins that preserve taint from their arguments.
TAINT_PRESERVING_BUILTINS = {
    "len", "int", "float", "str", "bool", "abs", "round", "sorted",
    "min", "max", "sum", "tuple", "list", "set", "frozenset", "repr",
    "range", "enumerate", "reversed", "zip",
}

#: Array constructors whose arguments become traced shapes (DV703).
SHAPE_CTOR_NAMES = {
    "zeros", "ones", "full", "empty", "arange", "linspace", "reshape",
    "broadcast_to",
}
ARRAY_NS_HEADS = {"torch", "np", "numpy"}

#: File-mutation vocabulary for DV705 side effects.
MUTATING_METHODS = {
    "write_text", "write_bytes", "rename", "replace", "unlink", "rmtree",
    "rmdir", "mkdir", "makedirs", "symlink_to", "touch",
}
MUTATING_CALLS = {
    "os.replace", "os.rename", "os.remove", "os.unlink", "os.makedirs",
    "os.mkdir", "os.rmdir", "shutil.rmtree", "shutil.copy", "shutil.copy2",
    "shutil.copytree", "shutil.move", "np.save", "numpy.save", "np.savez",
    "numpy.savez", "atomic_write_text", "atomic_write_json", "torch.save",
}

#: Functions whose reachable closure is the checkpoint publish/resume
#: path (DV704's scope) — matched by bare function name.
CHECKPOINT_ENTRY_NAMES = {
    "save_checkpoint", "restore_checkpoint", "checkpoint_restorable",
    "last_verified_checkpoint", "verify_checkpoint", "write_manifest",
    "read_manifest", "_run_recovery", "_recover_staged", "_publish",
}

#: Unsorted-iteration producers (DV704 "order" nondeterminism).
UNORDERED_ITER_CALLS = {"iterdir", "glob", "rglob", "listdir", "scandir"}

_FLATTEN_CAP = 64  # bounded schedule expansion per function
_FIXPOINT_ROUNDS = 4


# ------------------------------------------------------------------- facts


@dataclasses.dataclass
class SpmdFn:
    """Per-function facts, duck-typing what ``_Resolver`` needs."""

    key: str
    module: str
    cls: str | None
    name: str
    path: str
    param_types: dict[str, str]
    calls: list[CallSite] = dataclasses.field(default_factory=list)
    seq: list[tuple] = dataclasses.field(default_factory=list)
    tainted_ifs: list["TaintedIf"] = dataclasses.field(default_factory=list)
    tainted_loops: list[tuple] = dataclasses.field(default_factory=list)
    operand_sinks: list[tuple] = dataclasses.field(default_factory=list)
    nondet: list[tuple] = dataclasses.field(default_factory=list)
    return_taint: frozenset[str] = frozenset()


@dataclasses.dataclass
class TaintedIf:
    line: int
    kinds: frozenset[str]
    body: list[tuple]
    orelse: list[tuple]
    rest: list[tuple]
    body_exits: bool
    orelse_exits: bool
    gate_branch: str | None  # "body"/"orelse" when the test is rank == 0


# -------------------------------------------------------- event collection


def _call_name(node: ast.Call) -> str | None:
    return dotted_name(node.func)


def _collective_on_expr(node: ast.Call) -> str | None:
    """The collective's name of ``<expr>.all_reduce(...)`` on a computed
    receiver (``_dist().all_reduce(flat)``), whose dotted name is None."""
    func = node.func
    if (isinstance(func, ast.Attribute) and dotted_name(func) is None
            and func.attr in COLLECTIVE_NAMES):
        return func.attr
    return None


def _rank_env(node: ast.AST) -> bool:
    """``os.environ["RANK"]``, ``os.environ.get("LOCAL_RANK")``,
    ``os.getenv("JAX_PROCESS_INDEX")``: an environment read of a rank."""
    key = None
    if isinstance(node, ast.Subscript):
        key = node.slice
    elif isinstance(node, ast.Call) and node.args:
        key = node.args[0]
    return isinstance(key, ast.Constant) and key.value in RANK_ENV_NAMES


def _barrier_label(node: ast.Call) -> str | None:
    """Static rendering of a collective's ``name`` argument."""
    cand = None
    if node.args:
        cand = node.args[0]
    for kw in node.keywords:
        if kw.arg == "name":
            cand = kw.value
    if cand is None:
        return None
    if isinstance(cand, ast.Constant) and isinstance(cand.value, str):
        return cand.value
    if isinstance(cand, ast.JoinedStr):
        parts = []
        for v in cand.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("{}")
        return "".join(parts)
    return None


def _side_effect_desc(node: ast.Call, dotted: str | None) -> str | None:
    if dotted is None:
        # Method call on a computed receiver — `(d / tag).replace(x)` is
        # the canonical atomic-publish idiom; the receiver expression is
        # unknowable statically but the method name still is.
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in MUTATING_METHODS
        ):
            return f"<expr>.{node.func.attr}"
        return None
    last = dotted.split(".")[-1]
    if dotted in MUTATING_CALLS or last in MUTATING_CALLS:
        return dotted
    if last in MUTATING_METHODS:
        return dotted
    if last == "open" and len(node.args) >= 2:
        mode = node.args[1]
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
            if any(c in mode.value for c in "wax"):
                return f"open(..., {mode.value!r})"
    return None


def _events_of(stmts: list[ast.stmt]) -> list[tuple]:
    """Ordered may-happen events under a block (recurses everywhere).

    Tuples: ``("C", kind, label, line)`` collective, ``("F", callee,
    line)`` call, ``("S", desc, line)`` file mutation, ``("X", kind,
    line)`` control exit. Both branches of nested ``if``s are included —
    these feed *may-reach* questions, never must-reach ones.
    """
    out: list[tuple] = []

    def visit_expr(node: ast.AST) -> None:
        for call in [
            n for n in ast.walk(node) if isinstance(n, ast.Call)
        ]:
            dotted = _call_name(call)
            if dotted is None:
                name = _collective_on_expr(call)
                if name is not None:
                    out.append(("C", COLLECTIVE_NAMES[name],
                                _barrier_label(call), call.lineno))
                    continue
                desc = _side_effect_desc(call, dotted)
                if desc is not None:
                    out.append(("S", desc, call.lineno))
                continue
            last = dotted.split(".")[-1]
            if last in COLLECTIVE_NAMES:
                out.append(
                    (
                        "C",
                        COLLECTIVE_NAMES[last],
                        _barrier_label(call),
                        call.lineno,
                    )
                )
                continue
            desc = _side_effect_desc(call, dotted)
            if desc is not None:
                out.append(("S", desc, call.lineno))
            out.append(("F", dotted, call.lineno))

    def visit_block(stmts: list[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.Return, ast.Raise)):
                if isinstance(stmt, ast.Return) and stmt.value is not None:
                    visit_expr(stmt.value)
                elif isinstance(stmt, ast.Raise) and stmt.exc is not None:
                    visit_expr(stmt.exc)
                out.append(("X", type(stmt).__name__.lower(), stmt.lineno))
            elif isinstance(stmt, (ast.Break, ast.Continue)):
                out.append(("X", type(stmt).__name__.lower(), stmt.lineno))
            elif isinstance(stmt, ast.If):
                visit_expr(stmt.test)
                visit_block(stmt.body)
                visit_block(stmt.orelse)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                visit_expr(stmt.iter)
                visit_block(stmt.body)
                visit_block(stmt.orelse)
            elif isinstance(stmt, ast.While):
                visit_expr(stmt.test)
                visit_block(stmt.body)
                visit_block(stmt.orelse)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    visit_expr(item.context_expr)
                visit_block(stmt.body)
            elif isinstance(stmt, ast.Try):
                visit_block(stmt.body)
                for h in stmt.handlers:
                    visit_block(h.body)
                visit_block(stmt.orelse)
                visit_block(stmt.finalbody)
            elif isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue  # nested defs get their own SpmdFn
            else:
                visit_expr(stmt)

    visit_block(stmts)
    return out


def _definitely_exits(stmts: list[ast.stmt]) -> bool:
    return any(
        isinstance(s, (ast.Return, ast.Raise, ast.Break, ast.Continue))
        for s in stmts
    )


# ------------------------------------------------------------- taint walk


class _TaintWalker:
    """Flow-sensitive single-pass taint walk over one function body."""

    def __init__(
        self,
        fn: SpmdFn,
        node: ast.FunctionDef,
        res: _Resolver,
        return_taint: dict[str, frozenset[str]],
    ):
        self.fn = fn
        self.node = node
        self.res = res
        self.return_taint = return_taint
        self.env: dict[str, set[str]] = {}
        self.ret: set[str] = set()

    def run(self) -> None:
        args = self.node.args
        for a in args.args + args.posonlyargs + args.kwonlyargs:
            if a.arg in RANK_PARAM_NAMES:
                self.env[a.arg] = {"rank"}
        self.block(self.node.body, enclosing_rest=[])

    # -- taint of an expression under the current env

    def taint(self, node: ast.AST | None) -> set[str]:
        if node is None:
            return set()
        if isinstance(node, ast.Name):
            return set(self.env.get(node.id, ()))
        if isinstance(node, ast.Attribute):
            dotted = dotted_name(node)
            if dotted is not None and "environ" in dotted.split("."):
                return {"env"}
            return self.taint(node.value)
        if isinstance(node, ast.Subscript):
            kinds = self.taint(node.value) | self.taint(node.slice)
            if "env" in kinds and _rank_env(node):
                kinds.add("rank")
            return kinds
        if isinstance(node, ast.Call):
            return self.call_taint(node)
        if isinstance(node, ast.BinOp):
            return self.taint(node.left) | self.taint(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand)
        if isinstance(node, ast.BoolOp):
            out: set[str] = set()
            for v in node.values:
                out |= self.taint(v)
            return out
        if isinstance(node, ast.Compare):
            out = self.taint(node.left)
            for c in node.comparators:
                out |= self.taint(c)
            return out
        if isinstance(node, ast.IfExp):
            return (
                self.taint(node.test)
                | self.taint(node.body)
                | self.taint(node.orelse)
            )
        if isinstance(node, (ast.JoinedStr,)):
            out = set()
            for v in node.values:
                out |= self.taint(v)
            return out
        if isinstance(node, ast.FormattedValue):
            return self.taint(node.value)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            out = set()
            for e in node.elts:
                out |= self.taint(e)
            return out
        if isinstance(node, ast.Dict):
            out = set()
            for k in node.keys:
                out |= self.taint(k)
            for v in node.values:
                out |= self.taint(v)
            return out
        if isinstance(node, ast.Starred):
            return self.taint(node.value)
        return set()

    def call_taint(self, node: ast.Call) -> set[str]:
        dotted = _call_name(node)
        if dotted is None:
            return set()
        last = dotted.split(".")[-1]
        arg_taint: set[str] = set()
        for a in node.args:
            arg_taint |= self.taint(a)
        for kw in node.keywords:
            arg_taint |= self.taint(kw.value)
        # Direct sources.
        if last in RANK_CALLS:
            return {"rank"}
        if dotted in ("os.getenv",) or "environ" in dotted.split("."):
            return {"env", "rank"} if _rank_env(node) else {"env"}
        if dotted in TIME_CALLS:
            return {"time"}
        if dotted in RNG_CALLS:
            return {"rng"}
        if dotted in ("random.Random",) and not node.args:
            return {"rng"}
        if dotted in HOST_ID_CALLS:
            return {"host"}
        # Taint-preserving builtins.
        if dotted in TAINT_PRESERVING_BUILTINS:
            return arg_taint
        # Interprocedural: the callee's return taint (fixpoint map).
        out: set[str] = set()
        for tgt in self.res.resolve_call(dotted, self.fn):
            out |= self.return_taint.get(tgt, frozenset())
        return out

    # -- statements

    def assign_target(self, tgt: ast.AST, kinds: set[str]) -> None:
        if isinstance(tgt, ast.Name):
            if kinds:
                self.env[tgt.id] = set(kinds)
            else:
                self.env.pop(tgt.id, None)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self.assign_target(e, kinds)
        elif isinstance(tgt, ast.Starred):
            self.assign_target(tgt.value, kinds)

    def _rank_zero_gate(self, test: ast.AST) -> str | None:
        """"body"/"orelse" when the test pins rank against 0, else None."""
        for node in ast.walk(test):
            if not isinstance(node, ast.Compare) or len(node.ops) != 1:
                continue
            left, op, right = node.left, node.ops[0], node.comparators[0]
            sides = [(left, right), (right, left)]
            for val, const in sides:
                if not (
                    isinstance(const, ast.Constant) and const.value == 0
                ):
                    continue
                if "rank" not in self.taint(val):
                    continue
                if isinstance(op, ast.Eq):
                    return "body"
                if isinstance(op, ast.NotEq):
                    return "orelse"
        return None

    def scan_calls(self, node: ast.AST) -> None:
        """Record call sites + DV703 operand/shape sinks in any expr."""
        for call in [n for n in ast.walk(node) if isinstance(n, ast.Call)]:
            dotted = _call_name(call)
            if dotted is None:
                continue
            self.fn.calls.append(CallSite(dotted, call.lineno, ()))
            parts = dotted.split(".")
            last = parts[0] if len(parts) == 1 else parts[-1]
            if last in COLLECTIVE_NAMES:
                for a in list(call.args) + [k.value for k in call.keywords]:
                    kinds = self.taint(a)
                    if kinds:
                        self.fn.operand_sinks.append(
                            (
                                "collective",
                                dotted,
                                sorted(kinds),
                                call.lineno,
                            )
                        )
                        break
            if (
                last in SHAPE_CTOR_NAMES
                and len(parts) > 1
                and parts[0] in ARRAY_NS_HEADS
            ):
                for a in call.args:
                    kinds = self.taint(a)
                    if kinds:
                        self.fn.operand_sinks.append(
                            ("shape", dotted, sorted(kinds), call.lineno)
                        )
                        break
            # DV704 raw material: time / unseeded-RNG draws.
            if dotted in TIME_CALLS:
                self.fn.nondet.append(("time", dotted, call.lineno))
            elif dotted in RNG_CALLS or (
                dotted == "random.Random" and not call.args
            ):
                self.fn.nondet.append(("rng", dotted, call.lineno))

    def block(
        self, stmts: list[ast.stmt], enclosing_rest: list[ast.stmt]
    ) -> None:
        for i, stmt in enumerate(stmts):
            rest = stmts[i + 1 :] + enclosing_rest
            self.stmt(stmt, rest)

    def stmt(self, stmt: ast.stmt, rest: list[ast.stmt]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs analyzed as their own functions
        if isinstance(stmt, ast.Assign):
            self.scan_calls(stmt.value)
            kinds = self.taint(stmt.value)
            for tgt in stmt.targets:
                self.assign_target(tgt, kinds)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self.scan_calls(stmt.value)
                self.assign_target(stmt.target, self.taint(stmt.value))
            return
        if isinstance(stmt, ast.AugAssign):
            self.scan_calls(stmt.value)
            kinds = self.taint(stmt.value) | self.taint(stmt.target)
            self.assign_target(stmt.target, kinds)
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.scan_calls(stmt.value)
                self.ret |= self.taint(stmt.value)
            return
        if isinstance(stmt, ast.If):
            self.scan_calls(stmt.test)
            kinds = self.taint(stmt.test)
            gate = self._rank_zero_gate(stmt.test)
            saved = {k: set(v) for k, v in self.env.items()}
            self.block(stmt.body, rest)
            body_env = self.env
            self.env = saved
            self.block(stmt.orelse, rest)
            for k, v in body_env.items():
                self.env[k] = self.env.get(k, set()) | v
            if kinds or gate is not None:
                self.fn.tainted_ifs.append(
                    TaintedIf(
                        line=stmt.lineno,
                        kinds=frozenset(kinds),
                        body=_events_of(stmt.body),
                        orelse=_events_of(stmt.orelse),
                        rest=_events_of(rest),
                        body_exits=_definitely_exits(stmt.body),
                        orelse_exits=_definitely_exits(stmt.orelse),
                        gate_branch=gate,
                    )
                )
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.scan_calls(stmt.iter)
            iter_taint = self.taint(stmt.iter)
            self.assign_target(stmt.target, iter_taint)
            self._nondet_iteration(stmt.iter)
            self.block(stmt.body, rest)
            self.block(stmt.orelse, rest)
            if iter_taint:
                self.fn.tainted_loops.append(
                    (
                        "for",
                        frozenset(iter_taint),
                        _events_of(stmt.body),
                        stmt.lineno,
                    )
                )
            return
        if isinstance(stmt, ast.While):
            self.scan_calls(stmt.test)
            kinds = self.taint(stmt.test)
            self.block(stmt.body, rest)
            self.block(stmt.orelse, rest)
            if kinds:
                self.fn.tainted_loops.append(
                    ("while", frozenset(kinds), _events_of(stmt.body),
                     stmt.lineno)
                )
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.scan_calls(item.context_expr)
                if item.optional_vars is not None:
                    self.assign_target(
                        item.optional_vars, self.taint(item.context_expr)
                    )
            self.block(stmt.body, rest)
            return
        if isinstance(stmt, ast.Try):
            self.block(stmt.body, rest)
            for h in stmt.handlers:
                self.block(h.body, rest)
            self.block(stmt.orelse, rest)
            self.block(stmt.finalbody, rest)
            return
        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self.scan_calls(stmt.exc)
            return
        if isinstance(stmt, ast.Expr):
            self.scan_calls(stmt.value)
            return
        if isinstance(stmt, (ast.Assert, ast.Delete, ast.Global,
                             ast.Nonlocal, ast.Pass, ast.Break,
                             ast.Continue, ast.Import, ast.ImportFrom)):
            if isinstance(stmt, ast.Assert):
                self.scan_calls(stmt.test)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self.scan_calls(child)

    def _nondet_iteration(self, it: ast.AST) -> None:
        """DV704 "order": iteration over sets / unsorted directory walks."""
        if isinstance(it, (ast.Set, ast.SetComp)):
            self.fn.nondet.append(
                ("order", "iteration over a set literal", it.lineno)
            )
            return
        if isinstance(it, ast.Call):
            dotted = _call_name(it)
            if dotted is None:
                return
            last = dotted.split(".")[-1]
            if last in UNORDERED_ITER_CALLS:
                self.fn.nondet.append(
                    ("order", f"unsorted {dotted}(...)", it.lineno)
                )


# --------------------------------------------------------------- schedules


class _ScheduleExpander:
    """Bounded, memoized expansion of event lists into collective tuples."""

    def __init__(self, funcs: dict[str, SpmdFn], res: _Resolver):
        self.funcs = funcs
        self.res = res
        self.memo: dict[str, tuple] = {}
        self.in_progress: set[str] = set()

    def of_fn(self, key: str) -> tuple:
        if key in self.memo:
            return self.memo[key]
        if key in self.in_progress:
            return ()
        self.in_progress.add(key)
        fn = self.funcs.get(key)
        out = self.of_events(fn.seq, fn) if fn is not None else ()
        self.in_progress.discard(key)
        self.memo[key] = out
        return out

    def of_events(self, events: list[tuple], fn: SpmdFn) -> tuple:
        out: list[tuple] = []
        for ev in events:
            if len(out) >= _FLATTEN_CAP:
                break
            if ev[0] == "C":
                out.append((ev[1], ev[2]))
            elif ev[0] == "F":
                targets = self.res.resolve_call(ev[1], fn)
                if len(targets) == 1:
                    out.extend(self.of_fn(targets[0]))
        return tuple(out[:_FLATTEN_CAP])


def _sched_desc(sched: tuple) -> str:
    if not sched:
        return "<none>"
    return ", ".join(
        kind if label is None else f"{kind}:{label}"
        for kind, label in sched[:6]
    ) + ("…" if len(sched) > 6 else "")


# ------------------------------------------------------------------- rules


def _taint_desc(kinds) -> str:
    return "/".join(sorted(kinds)) if kinds else "rank"


def _rule_dv701_702(
    funcs: dict[str, SpmdFn], exp: _ScheduleExpander
) -> list[Finding]:
    out: list[Finding] = []
    for fn in funcs.values():
        for ti in fn.tainted_ifs:
            if not ti.kinds:
                continue  # pure rank-0 gates are DV705's business
            body = exp.of_events(ti.body, fn)
            orelse = exp.of_events(ti.orelse, fn)
            src = _taint_desc(ti.kinds)
            if body and orelse:
                if body != orelse:
                    out.append(
                        Finding(
                            "DV702",
                            f"{fn.name}: both branches of "
                            f"{src}-divergent control flow issue "
                            f"collectives, but the schedules differ — "
                            f"if: [{_sched_desc(body)}] vs else: "
                            f"[{_sched_desc(orelse)}]",
                            fn.path,
                            ti.line,
                        )
                    )
                continue
            if body or orelse:
                reached = body or orelse
                out.append(
                    Finding(
                        "DV701",
                        f"{fn.name}: {src}-divergent branch guards "
                        f"[{_sched_desc(reached)}] — only one side "
                        f"reaches it, so ranks disagree on whether the "
                        f"collective runs",
                        fn.path,
                        ti.line,
                    )
                )
                continue
            # Early-exit divergence: one branch bails out of a function
            # whose remainder still issues collectives.
            rest = exp.of_events(ti.rest, fn)
            if rest and (ti.body_exits != ti.orelse_exits):
                out.append(
                    Finding(
                        "DV701",
                        f"{fn.name}: {src}-divergent early exit skips "
                        f"the rest of the collective schedule "
                        f"[{_sched_desc(rest)}]",
                        fn.path,
                        ti.line,
                    )
                )
        for loop_kind, kinds, body_events, line in fn.tainted_loops:
            body = exp.of_events(body_events, fn)
            if body:
                out.append(
                    Finding(
                        "DV701",
                        f"{fn.name}: {_taint_desc(kinds)}-divergent "
                        f"{loop_kind}-loop bound around "
                        f"[{_sched_desc(body)}] — per-host trip counts "
                        f"desynchronize the schedule",
                        fn.path,
                        line,
                    )
                )
    return out


def _rule_dv703(funcs: dict[str, SpmdFn]) -> list[Finding]:
    out: list[Finding] = []
    for fn in funcs.values():
        for sink, dotted, kinds, line in fn.operand_sinks:
            what = (
                "collective operand"
                if sink == "collective"
                else "traced array shape"
            )
            out.append(
                Finding(
                    "DV703",
                    f"{fn.name}: {_taint_desc(kinds)}-divergent value "
                    f"flows into a {what} ({dotted}) — per-rank "
                    f"values/shapes break the SPMD program contract",
                    fn.path,
                    line,
                )
            )
    return out


def _rule_dv704(
    funcs: dict[str, SpmdFn], res: _Resolver
) -> list[Finding]:
    entries = [
        k for k, fn in funcs.items() if fn.name in CHECKPOINT_ENTRY_NAMES
    ]
    reach = _reachable(entries, funcs, res)
    out: list[Finding] = []
    for key in sorted(reach):
        fn = funcs[key]
        for kind, desc, line in fn.nondet:
            what = {
                "time": "wall clock",
                "rng": "unseeded RNG",
                "order": "nondeterministic iteration order",
            }[kind]
            out.append(
                Finding(
                    "DV704",
                    f"{fn.name}: {what} ({desc}) on the checkpoint "
                    f"publish/resume path — breaks bit-identical "
                    f"multi-rank resume",
                    fn.path,
                    line,
                )
            )
    return out


def _rule_dv705(
    funcs: dict[str, SpmdFn], res: _Resolver, exp: _ScheduleExpander
) -> list[Finding]:
    # Transitive may-mutate fixpoint.
    may_mutate: set[str] = {
        k
        for k, fn in funcs.items()
        if any(ev[0] == "S" for ev in fn.seq)
    }
    for _ in range(_FIXPOINT_ROUNDS * 4):
        grew = False
        for key, fn in funcs.items():
            if key in may_mutate:
                continue
            for call in fn.calls:
                if any(
                    t in may_mutate
                    for t in res.resolve_call(call.callee, fn)
                ):
                    may_mutate.add(key)
                    grew = True
                    break
        if not grew:
            break

    def branch_mutates(events: list[tuple], fn: SpmdFn) -> str | None:
        for ev in events:
            if ev[0] == "S":
                return ev[1]
            if ev[0] == "F":
                for t in res.resolve_call(ev[1], fn):
                    if t in may_mutate:
                        return f"{ev[1]}(...)"
        return None

    out: list[Finding] = []
    for fn in funcs.values():
        fenced = any(kind == "barrier" for kind, _ in exp.of_fn(fn.key))
        if fenced:
            continue
        for ti in fn.tainted_ifs:
            if ti.gate_branch is None:
                continue
            gate_events = ti.body if ti.gate_branch == "body" else ti.orelse
            effect = branch_mutates(gate_events, fn)
            if effect is None:
                continue
            out.append(
                Finding(
                    "DV705",
                    f"{fn.name}: rank-0-only side effect ({effect}) with "
                    f"no named barrier in the function's schedule — "
                    f"other ranks race past the mutation",
                    fn.path,
                    ti.line,
                )
            )
    return out


# ------------------------------------------------------------- entry point


def lint_spmd(
    paths: list[Path | str],
    package_root: Path | str | None = None,
    include_suppressed: bool = False,
) -> list[Finding]:
    """Run DV701–DV705 over files/directories.

    With ``include_suppressed=True``, findings a per-line suppression
    matched are *kept* and marked (``Finding.suppressed``) instead of
    dropped — the ``--json`` CI surface audits suppressions this way.
    """
    sources, trees, _ = parse_sources(paths, package_root)

    graph = CallGraph.build(trees)
    inv = _collect_inventory(graph, trees)
    defs = _collect_functions(trees)
    for key, d in defs.items():
        if d.cls is not None and key == f"{d.module}:{d.cls}.{d.name}":
            inv.methods.setdefault(d.name, []).append(key)
    res = _Resolver(graph, inv, defs)

    # Interprocedural return-taint fixpoint: re-walk until the map of
    # tainted-return functions stabilizes (process_identity() and kin).
    return_taint: dict[str, frozenset[str]] = {k: frozenset() for k in defs}
    funcs: dict[str, SpmdFn] = {}
    for _round in range(_FIXPOINT_ROUNDS):
        changed = False
        funcs = {}
        for key, d in defs.items():
            fn = SpmdFn(
                key=key,
                module=d.module,
                cls=d.cls,
                name=d.name,
                path=str(trees[d.module][0]),
                param_types=_param_types(d.node, inv),
            )
            walker = _TaintWalker(fn, d.node, res, return_taint)
            walker.run()
            fn.seq = _events_of(d.node.body)
            fn.return_taint = frozenset(walker.ret)
            funcs[key] = fn
            if fn.return_taint != return_taint[key]:
                return_taint[key] = fn.return_taint
                changed = True
        if not changed:
            break

    exp = _ScheduleExpander(funcs, res)
    findings: list[Finding] = []
    findings.extend(_rule_dv701_702(funcs, exp))
    findings.extend(_rule_dv703(funcs))
    findings.extend(_rule_dv704(funcs, res))
    findings.extend(_rule_dv705(funcs, res, exp))

    by_path: dict[str, str] = {
        str(p): sources[m] for m, (p, _t) in trees.items()
    }
    sup_cache = {
        path: suppressed_rules_by_line(src) for path, src in by_path.items()
    }
    out: list[Finding] = []
    for f in findings:
        if is_suppressed(f, sup_cache.get(f.path, {})):
            if include_suppressed:
                out.append(dataclasses.replace(f, suppressed=True))
        else:
            out.append(f)

    return unique_sorted(out)
