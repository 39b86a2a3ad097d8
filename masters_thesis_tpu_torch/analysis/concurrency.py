"""Concurrency lint over the port's host threads (CL501–CL505).

The port's copy of ``masters_thesis_tpu/analysis/concurrency.py``, over the
threads that feed the card: the serving fleet's scheduler, workers, boot
timers and monitor (``serve/``), the deadline queue, the run supervisor and
fleet supervisor (``resilience/``), the flight recorder's heartbeat and
signal handlers and the telemetry plane (``telemetry/``), the launcher's
watchers (``parallel/launch.py``), and what orders the card's graphs from
several threads (``utils/cuda_graph.py``, ``utils/counts.py``). From the
AST alone it builds a lock inventory, a thread-spawn graph and a
class-aware call graph, and holds:

- **CL501** lock-order inversion: a cycle in the acquires-while-holding
  graph (also through calls), or a re-acquire of a non-reentrant
  ``Lock``; bounded acquires never form edges.
- **CL502** unguarded shared state: an attribute of a concurrency-involved
  class read-modify-written outside any lock, or accessed without the lock
  that guards most of its other accesses (``__init__`` is exempt).
- **CL503** blocking call under a held lock: file I/O, ``subprocess``,
  ``time.sleep``, queue and event waits, thread joins, and the card's
  blocking calls: ``torch.cuda.synchronize``, ``.item()``, an event's or a
  stream's ``.synchronize()``, a CUDA graph's ``replay()``, and a capture
  (``capture_begin``, ``torch.cuda.graph``). ``cond.wait()`` on the held
  condition is the idiom and exempt. The one lock that orders every
  capture and replay of the process (``utils/cuda_graph.py``
  ``_GRAPH_LOCK``) holds a replay and a capture by design: PyTorch refuses
  a replay while another thread captures; those sites carry a suppression
  that says so.
- **CL504** non-signal-safe work (a blocking acquire, sleep, join, wait) in
  signal-handler-reachable code.
- **CL505** a non-daemon thread never joined, or a thread spawned in
  ``__init__`` with no join/stop path on its class.

Precision over recall: what the pass cannot resolve it does not flag.
``# mtt: disable=CL50x -- reason`` suppresses a deliberate exception; this
pass also reports reason-less suppressions (``SP001``) for the files it
reads. Stdlib only.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

from masters_thesis_tpu_torch.analysis.astlint import parse_sources
from masters_thesis_tpu_torch.analysis.callgraph import CallGraph, dotted_name
from masters_thesis_tpu_torch.analysis.findings import (
    Finding,
    is_suppressed,
    suppressed_rules_by_line,
    suppression_findings,
    unique_sorted,
)

# Constructors that create a lock-like object (value side of an
# inventory assignment), after import-alias resolution.
LOCK_CTORS = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "cond",  # default wraps an RLock -> reentrant
    "threading.Semaphore": "sem",
    "threading.BoundedSemaphore": "sem",
}
QUEUE_CTORS = {
    "queue.Queue", "queue.LifoQueue", "queue.PriorityQueue",
    "queue.SimpleQueue",
}
# Attrs holding these are synchronization plumbing, not shared *data*:
# an Event IS the cross-thread signal, so reading it unlocked is the
# entire point and CL502 must not group it with guarded state.
SYNC_CTORS = {"threading.Event", "threading.Barrier"}
THREAD_CTORS = {"threading.Thread", "threading.Timer"}
REENTRANT = {"rlock", "cond"}

# Method names too common to resolve by name alone (dict.get, list.append,
# str.join, set.add, Event.set, ... would all mis-bind).
AMBIGUOUS_METHOD_NAMES = {
    "get", "put", "update", "items", "keys", "values", "append", "pop",
    "add", "close", "join", "wait", "set", "clear", "copy", "extend",
    "remove", "insert", "sort", "read", "write", "open", "start", "run",
    "result", "acquire", "release", "notify", "notify_all", "is_set",
    "format", "strip", "split", "encode", "decode", "mkdir", "exists",
    "resolve", "touch", "unlink", "flush", "send", "recv", "name", "main",
}

# Direct blocking operations, by fully-resolved dotted name. Category
# "sync" can deadlock (CL503 + CL504); "io"/"compute" merely stall the
# lock (CL503 only).
BLOCKING_CALLS = {
    "time.sleep": ("time.sleep", "sync"),
    "os.system": ("os.system", "sync"),
    "os.waitpid": ("os.waitpid", "sync"),
    "subprocess.run": ("subprocess.run", "sync"),
    "subprocess.call": ("subprocess.call", "sync"),
    "subprocess.check_call": ("subprocess.check_call", "sync"),
    "subprocess.check_output": ("subprocess.check_output", "sync"),
    "open": ("open()", "io"),
    "os.replace": ("os.replace", "io"),
    "os.fsync": ("os.fsync", "io"),
    "shutil.copy": ("shutil.copy", "io"),
    "shutil.copytree": ("shutil.copytree", "io"),
    "shutil.move": ("shutil.move", "io"),
    # The card: a synchronisation, or a capture that waits for the device.
    "torch.cuda.synchronize": ("torch.cuda.synchronize", "compute"),
    "torch.cuda.graph": ("CUDA graph capture", "compute"),
}
# Blocking *method* names (matched on the final attribute); `.join` only
# fires on receivers that resolve to a known thread binding, `.get` only
# on known queue attrs (never dict.get), and `.wait` while holding the
# same condition is exempt — handled in _blocking_method().
BLOCKING_METHODS = {
    "read_text": ("file read", "io"),
    "write_text": ("file write", "io"),
    "read_bytes": ("file read", "io"),
    "write_bytes": ("file write", "io"),
    "communicate": ("process wait", "sync"),
    "predict": ("device compute", "compute"),
    "warmup": ("device compute", "compute"),
    "block_until_ready": ("device sync", "compute"),
    "item": ("device read (.item())", "compute"),
    "synchronize": ("device synchronisation", "compute"),
    "replay": ("CUDA graph replay", "compute"),
    "capture_begin": ("CUDA graph capture", "compute"),
}

# lock identity: ("C", class_name, attr) | ("M", module, name)
LockId = tuple[str, str, str]


@dataclasses.dataclass
class Acq:
    lock: LockId
    line: int
    held: tuple[LockId, ...]
    bounded: bool


@dataclasses.dataclass
class CallSite:
    callee: str
    line: int
    held: tuple[LockId, ...]


@dataclasses.dataclass
class Access:
    owner: str  # class name
    attr: str
    line: int
    held: tuple[LockId, ...]
    write: bool
    rmw: bool


@dataclasses.dataclass
class Block:
    desc: str
    category: str
    line: int
    held: tuple[LockId, ...]


@dataclasses.dataclass
class Spawn:
    target: str | None  # dotted call-target name, e.g. "self._worker_loop"
    daemon: bool | None  # None = not statically known
    line: int
    binding: tuple[str, str] | None  # (class, attr) the thread is stored on
    in_init: bool
    kind: str  # "Thread" | "Timer"


@dataclasses.dataclass
class ClassFacts:
    module: str
    name: str
    path: str
    locks: dict[str, str] = dataclasses.field(default_factory=dict)
    queues: set[str] = dataclasses.field(default_factory=set)
    thread_attrs: set[str] = dataclasses.field(default_factory=set)
    sync_attrs: set[str] = dataclasses.field(default_factory=set)
    attrs: set[str] = dataclasses.field(default_factory=set)
    spawns_threads: bool = False


@dataclasses.dataclass
class FuncFacts:
    key: str
    module: str
    cls: str | None
    name: str
    path: str
    param_types: dict[str, str]  # param -> analysed class name
    acquires: list[Acq] = dataclasses.field(default_factory=list)
    calls: list[CallSite] = dataclasses.field(default_factory=list)
    accesses: list[Access] = dataclasses.field(default_factory=list)
    blocking: list[Block] = dataclasses.field(default_factory=list)
    spawns: list[Spawn] = dataclasses.field(default_factory=list)
    handlers: list[tuple[str, int]] = dataclasses.field(default_factory=list)


class _Inventory:
    """Package-wide class/lock/queue/thread-attr inventory."""

    def __init__(self) -> None:
        self.classes: dict[str, ClassFacts] = {}  # class name -> facts
        self.methods: dict[str, list[str]] = {}  # method name -> func keys
        self.attr_owner: dict[str, str | None] = {}  # attr -> unique class

    def klass(self, module: str, name: str, path: str) -> ClassFacts:
        if name not in self.classes:
            self.classes[name] = ClassFacts(module, name, path)
        return self.classes[name]

    def note_attr(self, cls: str, attr: str) -> None:
        self.classes[cls].attrs.add(attr)
        if attr not in self.attr_owner:
            self.attr_owner[attr] = cls
        elif self.attr_owner[attr] != cls:
            self.attr_owner[attr] = None  # ambiguous across classes


def _ctor_fullname(node: ast.AST, imports: dict[str, str]) -> str | None:
    """Import-alias-resolved dotted name of a call target."""
    name = dotted_name(node)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    target = imports.get(head)
    if target is not None:
        return f"{target}.{rest}" if rest else target
    return name


@dataclasses.dataclass
class _FnDef:
    """One function definition with its *class* context.

    The shared ``callgraph.py`` indexes methods under their bare name
    (``module:__init__``), which collides across classes — fine for the
    jit-reachability pass it serves, fatal for lock attribution. This
    pass therefore enumerates functions itself: methods get
    ``module:Class.method`` keys and an explicit ``cls``; defs nested
    inside a method inherit its class (they close over ``self``).
    """

    key: str
    module: str
    cls: str | None
    name: str
    node: ast.FunctionDef


def _collect_functions(
    trees: dict[str, tuple[Path, ast.AST]],
) -> dict[str, _FnDef]:
    defs: dict[str, _FnDef] = {}

    def walk(node, module, quals: list[str], cls: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, module, quals + [child.name], child.name)
            elif isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                q = quals + [child.name]
                key = f"{module}:{'.'.join(q)}"
                defs[key] = _FnDef(key, module, cls, child.name, child)
                walk(child, module, q, cls)

    for module, (_path, tree) in trees.items():
        walk(tree, module, [], None)
    return defs


def _collect_inventory(
    graph: CallGraph, trees: dict[str, tuple[Path, ast.AST]]
) -> _Inventory:
    inv = _Inventory()
    bases: dict[str, list[str]] = {}
    for module, (path, tree) in trees.items():
        imports = graph.imports.get(module, {})
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            facts = inv.klass(module, node.name, str(path))
            bases[node.name] = [(dotted_name(b) or "").split(".")[-1]
                                for b in node.bases]
            for sub in ast.walk(node):
                targets: list[ast.AST] = []
                value: ast.AST | None = None
                if isinstance(sub, ast.Assign):
                    targets, value = sub.targets, sub.value
                elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)):
                    targets, value = [sub.target], sub.value
                for tgt in targets:
                    if not (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        continue
                    inv.note_attr(node.name, tgt.attr)
                    if isinstance(value, ast.Call):
                        full = _ctor_fullname(value.func, imports)
                        if full in LOCK_CTORS:
                            facts.locks[tgt.attr] = LOCK_CTORS[full]
                        elif full in QUEUE_CTORS:
                            facts.queues.add(tgt.attr)
                        elif full in THREAD_CTORS:
                            facts.thread_attrs.add(tgt.attr)
                        elif full in SYNC_CTORS:
                            facts.sync_attrs.add(tgt.attr)
    _inherit_plumbing(inv, bases)
    return inv


def _inherit_plumbing(inv: _Inventory, bases: dict[str, list[str]]) -> None:
    """A subclass's ``self.<lock>`` made by an analysed base class's
    ``__init__`` is that lock (the serving fleet's ``_stats_lock`` is its
    base's); so too its queues, threads and events."""
    for name, facts in inv.classes.items():
        seen: set[str] = set()
        stack = list(bases.get(name, []))
        while stack:
            base_name = stack.pop()
            base = inv.classes.get(base_name)
            if base is None or base_name in seen:
                continue
            seen.add(base_name)
            for attr, kind in base.locks.items():
                facts.locks.setdefault(attr, kind)
            facts.queues |= base.queues
            facts.thread_attrs |= base.thread_attrs
            facts.sync_attrs |= base.sync_attrs
            stack.extend(bases.get(base_name, []))


class _Resolver:
    """Class-aware call/lock resolution on top of the module-level graph."""

    def __init__(
        self, graph: CallGraph, inv: _Inventory, defs: dict[str, _FnDef]
    ):
        self.graph = graph
        self.inv = inv
        self.defs = defs

    def resolve_call(self, callee: str, fn: FuncFacts) -> list[str]:
        head, _, rest = callee.partition(".")
        last = callee.split(".")[-1]
        if not rest:
            # Bare name: the shared graph resolves through imports and
            # by_name; keep only hits that exist in *our* class-qualified
            # table (methods indexed under bare names drop out here).
            hits = self.graph.resolve(fn.module, None, callee)
            return [h for h in hits if h in self.defs]
        if head == "self" and fn.cls is not None:
            key = f"{fn.module}:{fn.cls}.{rest}"
            if "." not in rest and key in self.defs:
                return [key]
            return self._by_method_name(last)
        ann = fn.param_types.get(head)
        if ann is not None and "." not in rest:
            facts = self.inv.classes.get(ann)
            if facts is not None:
                key = f"{facts.module}:{ann}.{rest}"
                if key in self.defs:
                    return [key]
                return []
        hits = [
            h
            for h in self.graph.resolve(fn.module, None, callee)
            if h in self.defs
        ]
        if hits:
            return hits
        return self._by_method_name(last)

    def _by_method_name(self, name: str) -> list[str]:
        if name in AMBIGUOUS_METHOD_NAMES or name.startswith("__"):
            return []
        keys = self.inv.methods.get(name, [])
        return keys if len(keys) == 1 else []

    def lock_of(self, expr: ast.AST, fn: FuncFacts) -> LockId | None:
        name = dotted_name(expr)
        if name is None:
            return None
        parts = name.split(".")
        if len(parts) == 2:
            base, attr = parts
            if base == "self" and fn.cls is not None:
                facts = self.inv.classes.get(fn.cls)
                if facts is not None and attr in facts.locks:
                    return ("C", fn.cls, attr)
                return None
            ann = fn.param_types.get(base)
            if ann is not None:
                facts = self.inv.classes.get(ann)
                if facts is not None and attr in facts.locks:
                    return ("C", ann, attr)
            owner = self.inv.attr_owner.get(attr)
            if owner is not None and attr in self.inv.classes[owner].locks:
                return ("C", owner, attr)
            return None
        if len(parts) == 1:
            # Module-level lock: `_LOCK = threading.Lock()` at top level.
            mod_locks = _MODULE_LOCKS.get(fn.module, {})
            if parts[0] in mod_locks:
                return ("M", fn.module, parts[0])
        return None

    def lock_kind(self, lock: LockId) -> str:
        scope, owner, attr = lock
        if scope == "C":
            return self.inv.classes[owner].locks.get(attr, "lock")
        return _MODULE_LOCKS.get(owner, {}).get(attr, "lock")

    def attr_access_owner(
        self, node: ast.Attribute, fn: FuncFacts
    ) -> str | None:
        """Class owning ``<base>.<attr>`` for a Name base, else None."""
        if not isinstance(node.value, ast.Name):
            return None
        base = node.value.id
        if base == "self":
            return fn.cls
        ann = fn.param_types.get(base)
        if ann is not None and ann in self.inv.classes:
            return ann if node.attr in self.inv.classes[ann].attrs else None
        # Unique-attr fallback for untyped locals (`for r in replicas:`):
        # only within the owning class's own module — cross-module name
        # collisions ("state", "completed") would mis-attribute.
        owner = self.inv.attr_owner.get(node.attr)
        if owner is not None and self.inv.classes[owner].module == fn.module:
            return owner
        return None


_MODULE_LOCKS: dict[str, dict[str, str]] = {}


def _collect_module_locks(
    graph: CallGraph, trees: dict[str, tuple[Path, ast.AST]]
) -> None:
    _MODULE_LOCKS.clear()
    for module, (_path, tree) in trees.items():
        imports = graph.imports.get(module, {})
        locks: dict[str, str] = {}
        for node in ast.iter_child_nodes(tree):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                full = _ctor_fullname(node.value.func, imports)
                if full in LOCK_CTORS:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            locks[tgt.id] = LOCK_CTORS[full]
        _MODULE_LOCKS[module] = locks


# --------------------------------------------------------------- function walk


class _FunctionWalker:
    """One pass over a function body tracking the held-lock context.

    Held regions come from ``with <lock>:`` blocks plus two explicit
    bounded-acquire idioms (the shapes the signal-safe flight-recorder
    path uses)::

        got = self._lock.acquire(timeout=0.5)
        try: ...            # held if got
        finally:
            if got: self._lock.release()

        if not self._lock.acquire(blocking=False):
            return
        ...rest of function held...
    """

    def __init__(
        self, fn: FuncFacts, node: ast.FunctionDef, res: _Resolver,
        imports: dict[str, str],
    ):
        self.fn = fn
        self.node = node
        self.res = res
        self.imports = imports
        self._local_threads: dict[str, Spawn] = {}

    def run(self) -> None:
        self._stmts(self.node.body, ())

    # ------------------------------------------------------------- statements

    def _stmts(self, body: list[ast.stmt], held: tuple[LockId, ...]) -> None:
        i = 0
        while i < len(body):
            stmt = body[i]
            consumed = self._acquire_idiom(body, i, held)
            if consumed:
                i += consumed
                continue
            self._stmt(stmt, held)
            i += 1

    def _acquire_idiom(
        self, body: list[ast.stmt], i: int, held: tuple[LockId, ...]
    ) -> int:
        """Handle the two bounded-acquire idioms; returns #stmts consumed."""
        stmt = body[i]
        # got = lock.acquire(timeout=..); try: ... finally: ... release()
        if (
            isinstance(stmt, ast.Assign)
            and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr == "acquire"
        ):
            lock = self.res.lock_of(stmt.value.func.value, self.fn)
            if lock is not None and i + 1 < len(body) and isinstance(
                body[i + 1], ast.Try
            ):
                self._record_acquire(stmt.value, lock, held)
                tr = body[i + 1]
                self._stmts(tr.body, held + (lock,))
                self._stmts(tr.finalbody, held)
                for h in tr.handlers:
                    self._stmts(h.body, held + (lock,))
                self._stmts(tr.orelse, held + (lock,))
                return 2
        # if not lock.acquire(...): return   -> remainder of body is held
        if isinstance(stmt, ast.If) and isinstance(stmt.test, ast.UnaryOp):
            test = stmt.test
            if (
                isinstance(test.op, ast.Not)
                and isinstance(test.operand, ast.Call)
                and isinstance(test.operand.func, ast.Attribute)
                and test.operand.func.attr == "acquire"
                and any(isinstance(s, ast.Return) for s in stmt.body)
            ):
                lock = self.res.lock_of(test.operand.func.value, self.fn)
                if lock is not None:
                    self._record_acquire(test.operand, lock, held)
                    self._stmts(stmt.body, held)
                    self._stmts(body[i + 1:], held + (lock,))
                    return len(body) - i
        return 0

    def _stmt(self, stmt: ast.stmt, held: tuple[LockId, ...]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs analysed as their own functions
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = held
            for item in stmt.items:
                self._exprs(item.context_expr, inner, stmt)
                lock = self.res.lock_of(item.context_expr, self.fn)
                if lock is not None:
                    self.fn.acquires.append(
                        Acq(lock, stmt.lineno, inner, bounded=False)
                    )
                    inner = inner + (lock,)
            self._stmts(stmt.body, inner)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._exprs(stmt.test, held, stmt)
            self._stmts(stmt.body, held)
            self._stmts(stmt.orelse, held)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._exprs(stmt.iter, held, stmt)
            self._exprs(stmt.target, held, stmt)
            self._stmts(stmt.body, held)
            self._stmts(stmt.orelse, held)
            return
        if isinstance(stmt, ast.Try):
            self._stmts(stmt.body, held)
            for h in stmt.handlers:
                self._stmts(h.body, held)
            self._stmts(stmt.orelse, held)
            self._stmts(stmt.finalbody, held)
            return
        self._exprs(stmt, held, stmt)

    # ------------------------------------------------------------ expressions

    def _exprs(
        self, root: ast.AST, held: tuple[LockId, ...], stmt: ast.stmt
    ) -> None:
        rmw_attrs = self._rmw_attrs(stmt)
        stack = [root]
        while stack:
            node = stack.pop()
            if isinstance(
                node,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                 ast.ClassDef),
            ):
                continue
            if isinstance(node, ast.Call):
                self._call(node, held)
            if isinstance(node, ast.Attribute):
                self._attribute(node, held, rmw_attrs)
            stack.extend(ast.iter_child_nodes(node))

    def _rmw_attrs(self, stmt: ast.stmt) -> set[tuple[str | None, str]]:
        """(base-name, attr) pairs written read-modify-write by ``stmt``:
        AugAssign targets, and plain assigns whose target attr also appears
        in the value (the EWMA ``self.x = a*v + (1-a)*self.x`` shape)."""
        out: set[tuple[str | None, str]] = set()
        if isinstance(stmt, ast.AugAssign) and isinstance(
            stmt.target, ast.Attribute
        ):
            tgt = stmt.target
            if isinstance(tgt.value, ast.Name):
                out.add((tgt.value.id, tgt.attr))
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Attribute) and isinstance(
                    tgt.value, ast.Name
                ):
                    for sub in ast.walk(stmt.value):
                        if (
                            isinstance(sub, ast.Attribute)
                            and sub.attr == tgt.attr
                            and isinstance(sub.value, ast.Name)
                            and sub.value.id == tgt.value.id
                        ):
                            out.add((tgt.value.id, tgt.attr))
        return out

    def _attribute(
        self,
        node: ast.Attribute,
        held: tuple[LockId, ...],
        rmw_attrs: set[tuple[str | None, str]],
    ) -> None:
        owner = self.res.attr_access_owner(node, self.fn)
        if owner is None:
            return
        base = node.value.id if isinstance(node.value, ast.Name) else None
        write = isinstance(node.ctx, (ast.Store, ast.Del))
        rmw = (base, node.attr) in rmw_attrs
        self.fn.accesses.append(
            Access(owner, node.attr, node.lineno, held, write or rmw, rmw)
        )

    def _call(self, node: ast.Call, held: tuple[LockId, ...]) -> None:
        callee = dotted_name(node.func)
        full = _ctor_fullname(node.func, self.imports)
        # Thread spawn / signal registration.
        if full in THREAD_CTORS:
            self._spawn(node, full.rsplit(".", 1)[-1])
            return
        if full == "signal.signal" and len(node.args) >= 2:
            handler = dotted_name(node.args[1])
            if handler is not None:
                self.fn.handlers.append((handler, node.lineno))
        # Explicit .acquire() outside the recognised idioms still records
        # an acquisition event for the lock-order graph.
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "acquire"
        ):
            lock = self.res.lock_of(node.func.value, self.fn)
            if lock is not None:
                self._record_acquire(node, lock, held)
                return
        if callee is not None:
            self.fn.calls.append(CallSite(callee, node.lineno, held))
        blk = self._blocking(node, full, held)
        if blk is not None:
            self.fn.blocking.append(
                Block(blk[0], blk[1], node.lineno, held)
            )

    def _record_acquire(
        self, call: ast.Call, lock: LockId, held: tuple[LockId, ...]
    ) -> None:
        bounded = bool(call.args) or any(
            kw.arg in ("timeout", "blocking") for kw in call.keywords
        )
        self.fn.acquires.append(Acq(lock, call.lineno, held, bounded))

    def _spawn(self, node: ast.Call, kind: str) -> None:
        target: str | None = None
        daemon: bool | None = None
        for kw in node.keywords:
            if kw.arg == "target":
                target = dotted_name(kw.value)
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = bool(kw.value.value)
        if kind == "Timer" and target is None and len(node.args) >= 2:
            target = dotted_name(node.args[1])
        spawn = Spawn(
            target, daemon, node.lineno, None,
            in_init=self.fn.name == "__init__", kind=kind,
        )
        self.fn.spawns.append(spawn)
        if self.fn.cls is not None and self.fn.cls in self.res.inv.classes:
            self.res.inv.classes[self.fn.cls].spawns_threads = True

    def _blocking(
        self, node: ast.Call, full: str | None, held: tuple[LockId, ...]
    ) -> tuple[str, str] | None:
        if full in BLOCKING_CALLS:
            return BLOCKING_CALLS[full]
        if not isinstance(node.func, ast.Attribute):
            return None
        name = node.func.attr
        recv = node.func.value
        if name in BLOCKING_METHODS:
            return BLOCKING_METHODS[name]
        if name == "sleep":
            return ("sleep", "sync")
        if name == "wait":
            # cond.wait() while holding that same condition is the idiom.
            lock = self.res.lock_of(recv, self.fn)
            if lock is not None and lock in held:
                return None
            return ("wait()", "sync")
        if name == "join":
            if self._is_thread_receiver(recv):
                return ("thread join", "sync")
            return None
        if name == "get":
            attr = recv.attr if isinstance(recv, ast.Attribute) else None
            if attr is not None and any(
                attr in c.queues for c in self.res.inv.classes.values()
            ):
                return ("queue get", "sync")
            return None
        return None

    def _is_thread_receiver(self, recv: ast.AST) -> bool:
        name = dotted_name(recv)
        if name is None:
            return False
        last = name.split(".")[-1]
        if name in self._local_threads:
            return True
        return any(
            last in c.thread_attrs for c in self.res.inv.classes.values()
        )


# ------------------------------------------------------------------- bindings


def _bind_spawns(fn: FuncFacts, node: ast.FunctionDef, inv: _Inventory) -> None:
    """Attach storage bindings to spawn sites: ``self.X = Thread(...)``,
    ``obj.X = Thread(...)`` (annotated param), or a local var that is later
    stored on an attribute. Also notes locally-joined locals."""
    local_spawn: dict[str, Spawn] = {}
    spawn_by_line = {s.line: s for s in fn.spawns}
    for stmt in ast.walk(node):
        if isinstance(stmt, ast.Assign):
            spawn = None
            if isinstance(stmt.value, ast.Call):
                spawn = spawn_by_line.get(stmt.value.lineno)
            elif isinstance(stmt.value, ast.Name):
                spawn = local_spawn.get(stmt.value.id)
            if spawn is None:
                continue
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    local_spawn[tgt.id] = spawn
                elif isinstance(tgt, ast.Attribute) and isinstance(
                    tgt.value, ast.Name
                ):
                    base = tgt.value.id
                    cls = (
                        fn.cls if base == "self"
                        else fn.param_types.get(base)
                    )
                    if cls is not None:
                        spawn.binding = (cls, tgt.attr)
                        inv.classes[cls].thread_attrs.add(tgt.attr)
        # Local `t.join()` marks the spawn joined within this function.
        if (
            isinstance(stmt, ast.Call)
            and isinstance(stmt.func, ast.Attribute)
            and stmt.func.attr == "join"
            and isinstance(stmt.func.value, ast.Name)
            and stmt.func.value.id in local_spawn
        ):
            local_spawn[stmt.func.value.id].binding = ("<local>", "joined")


def _param_types(
    node: ast.FunctionDef, inv: _Inventory
) -> dict[str, str]:
    out: dict[str, str] = {}
    args = node.args
    for a in args.args + args.posonlyargs + args.kwonlyargs:
        if a.annotation is None:
            continue
        ann = dotted_name(a.annotation)
        if ann is not None and ann.split(".")[-1] in inv.classes:
            out[a.arg] = ann.split(".")[-1]
    return out


# ----------------------------------------------------------------- reachability


def _reachable(
    entries: list[str], funcs: dict[str, FuncFacts], res: _Resolver
) -> set[str]:
    seen: set[str] = set()
    work = [k for k in entries if k in funcs]
    while work:
        key = work.pop()
        if key in seen:
            continue
        seen.add(key)
        fn = funcs[key]
        for call in fn.calls:
            for tgt in res.resolve_call(call.callee, fn):
                if tgt in funcs and tgt not in seen:
                    work.append(tgt)
    return seen


def _resolve_target(
    target: str | None, fn: FuncFacts, res: _Resolver
) -> list[str]:
    if target is None:
        return []
    return res.resolve_call(target, fn)


def _fixpoint_summaries(
    funcs: dict[str, FuncFacts], res: _Resolver
) -> tuple[dict[str, set[LockId]], dict[str, set[tuple[str, str]]]]:
    """Transitive (may_acquire, may_block) per function."""
    resolved_calls = {
        key: [
            tgt
            for call in fn.calls
            for tgt in res.resolve_call(call.callee, fn)
            if tgt in funcs
        ]
        for key, fn in funcs.items()
    }
    may_acquire = {
        key: {a.lock for a in fn.acquires if not a.bounded}
        for key, fn in funcs.items()
    }
    may_block = {
        key: {(b.desc, b.category) for b in fn.blocking}
        for key, fn in funcs.items()
    }
    changed = True
    while changed:
        changed = False
        for key in funcs:
            for tgt in resolved_calls[key]:
                if not may_acquire[key].issuperset(may_acquire[tgt]):
                    may_acquire[key] |= may_acquire[tgt]
                    changed = True
                if not may_block[key].issuperset(may_block[tgt]):
                    may_block[key] |= may_block[tgt]
                    changed = True
    return may_acquire, may_block


def _lock_name(lock: LockId) -> str:
    scope, owner, attr = lock
    return f"{owner}.{attr}" if scope == "C" else f"{owner}:{attr}"


# ------------------------------------------------------------------ rule logic


def _rule_cl501(
    funcs: dict[str, FuncFacts],
    res: _Resolver,
    may_acquire: dict[str, set[LockId]],
) -> list[Finding]:
    edges: dict[tuple[LockId, LockId], tuple[str, int, str]] = {}
    findings: list[Finding] = []

    def add_edge(a: LockId, b: LockId, fn: FuncFacts, line: int, via: str):
        if a == b:
            if res.lock_kind(a) not in REENTRANT and not via:
                findings.append(
                    Finding(
                        "CL501",
                        f"non-reentrant lock {_lock_name(a)} re-acquired "
                        "while already held (self-deadlock)",
                        fn.path,
                        line,
                    )
                )
            return
        edges.setdefault((a, b), (fn.path, line, via))

    for key, fn in funcs.items():
        for acq in fn.acquires:
            if acq.bounded:
                continue
            for h in acq.held:
                add_edge(h, acq.lock, fn, acq.line, "")
        for call in fn.calls:
            if not call.held:
                continue
            for tgt in res.resolve_call(call.callee, fn):
                if tgt not in funcs:
                    continue
                for lock in may_acquire.get(tgt, ()):
                    for h in call.held:
                        add_edge(h, lock, fn, call.line, f"via {call.callee}")

    # Tarjan-free SCC via iterative Kosaraju on the tiny lock graph.
    adj: dict[LockId, set[LockId]] = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
    order: list[LockId] = []
    seen: set[LockId] = set()
    for start in adj:
        if start in seen:
            continue
        stack = [(start, iter(adj[start]))]
        seen.add(start)
        while stack:
            node, it = stack[-1]
            for nxt in it:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, iter(adj[nxt])))
                    break
            else:
                order.append(node)
                stack.pop()
    radj: dict[LockId, set[LockId]] = {n: set() for n in adj}
    for (a, b) in edges:
        radj[b].add(a)
    comp: dict[LockId, int] = {}
    for root in reversed(order):
        if root in comp:
            continue
        cid = len(comp)
        work = [root]
        while work:
            n = work.pop()
            if n in comp:
                continue
            comp[n] = cid
            work.extend(m for m in radj[n] if m not in comp)
    for (a, b), (path, line, via) in sorted(edges.items()):
        if comp.get(a) is not None and comp.get(a) == comp.get(b):
            suffix = f" ({via})" if via else ""
            findings.append(
                Finding(
                    "CL501",
                    f"lock-order inversion: {_lock_name(b)} acquired while "
                    f"holding {_lock_name(a)}{suffix}, and the reverse "
                    "order exists on another path",
                    path,
                    line,
                )
            )
    return findings


def _rule_cl502(
    funcs: dict[str, FuncFacts],
    inv: _Inventory,
    thread_reachable: set[str],
) -> list[Finding]:
    involved = {
        name
        for name, c in inv.classes.items()
        if c.spawns_threads or c.locks
    }
    for key in thread_reachable:
        fn = funcs.get(key)
        if fn is not None and fn.cls is not None:
            involved.add(fn.cls)

    # Group accesses by (class, attr), excluding the owner's __init__ and
    # lock/queue/thread plumbing attrs.
    groups: dict[tuple[str, str], list[tuple[FuncFacts, Access]]] = {}
    for key, fn in funcs.items():
        in_owner_init = fn.name == "__init__"
        for acc in fn.accesses:
            if acc.owner not in involved:
                continue
            facts = inv.classes[acc.owner]
            if (
                acc.attr in facts.locks
                or acc.attr in facts.queues
                or acc.attr in facts.thread_attrs
                or acc.attr in facts.sync_attrs
            ):
                continue
            if in_owner_init and fn.cls == acc.owner:
                continue
            groups.setdefault((acc.owner, acc.attr), []).append((fn, acc))

    # A class is *concurrent* when it spawns threads, or any of its own
    # methods — or any function touching its attributes — runs on a
    # spawned thread. Owning a lock alone marks it "involved" (analysed)
    # but not concurrent.
    reachable_classes = {
        funcs[k].cls for k in thread_reachable if k in funcs
    } - {None}

    findings: list[Finding] = []
    for (owner, attr), entries in sorted(groups.items()):
        writes = [(f, a) for f, a in entries if a.write]
        if not writes:
            continue
        concurrent = (
            inv.classes[owner].spawns_threads
            or owner in reachable_classes
            or any(f.key in thread_reachable for f, _ in entries)
        )
        if not concurrent:
            continue
        flagged: set[tuple[str, int]] = set()
        # (a) unguarded read-modify-write in a concurrent context.
        for f, a in writes:
            if a.rmw and not a.held:
                where = (f.path, a.line)
                if where in flagged:
                    continue
                flagged.add(where)
                findings.append(
                    Finding(
                        "CL502",
                        f"read-modify-write of {owner}.{attr} without a "
                        f"lock in {f.name}() — concurrent increments lose "
                        "updates",
                        f.path,
                        a.line,
                    )
                )
        # (b) a dominating lock guards the other accesses.
        by_lock: dict[LockId, int] = {}
        for _f, a in entries:
            for lock in a.held:
                by_lock[lock] = by_lock.get(lock, 0) + 1
        for lock, n in sorted(by_lock.items()):
            if n < 2 or n * 2 < len(entries):
                continue
            for f, a in entries:
                if lock in a.held or (f.path, a.line) in flagged:
                    continue
                flagged.add((f.path, a.line))
                kind = "written" if a.write else "read"
                findings.append(
                    Finding(
                        "CL502",
                        f"{owner}.{attr} {kind} in {f.name}() without "
                        f"{_lock_name(lock)}, which guards {n} of its "
                        f"{len(entries)} other accesses",
                        f.path,
                        a.line,
                    )
                )
            break  # one dominating lock is enough
    return findings


def _rule_cl503(
    funcs: dict[str, FuncFacts],
    res: _Resolver,
    may_block: dict[str, set[tuple[str, str]]],
) -> list[Finding]:
    findings: list[Finding] = []
    for key, fn in funcs.items():
        for b in fn.blocking:
            if b.held:
                findings.append(
                    Finding(
                        "CL503",
                        f"blocking {b.desc} while holding "
                        f"{_lock_name(b.held[-1])}",
                        fn.path,
                        b.line,
                    )
                )
        for call in fn.calls:
            if not call.held:
                continue
            for tgt in res.resolve_call(call.callee, fn):
                ops = may_block.get(tgt, set())
                if ops:
                    desc = ", ".join(sorted(d for d, _c in ops)[:3])
                    findings.append(
                        Finding(
                            "CL503",
                            f"call {call.callee}() while holding "
                            f"{_lock_name(call.held[-1])} may block "
                            f"({desc})",
                            fn.path,
                            call.line,
                        )
                    )
                    break
    return findings


def _rule_cl504(
    funcs: dict[str, FuncFacts],
    res: _Resolver,
    handler_entries: list[str],
) -> list[Finding]:
    reachable = _reachable(handler_entries, funcs, res)
    findings: list[Finding] = []
    for key in sorted(reachable):
        fn = funcs[key]
        for acq in fn.acquires:
            if not acq.bounded:
                findings.append(
                    Finding(
                        "CL504",
                        f"blocking acquire of {_lock_name(acq.lock)} in "
                        f"signal-handler-reachable {fn.name}() — if the "
                        "interrupted main-thread frame holds it, the "
                        "process self-deadlocks",
                        fn.path,
                        acq.line,
                    )
                )
        for b in fn.blocking:
            if b.category == "sync":
                findings.append(
                    Finding(
                        "CL504",
                        f"{b.desc} in signal-handler-reachable "
                        f"{fn.name}()",
                        fn.path,
                        b.line,
                    )
                )
    return findings


def _rule_cl505(
    funcs: dict[str, FuncFacts], inv: _Inventory
) -> list[Finding]:
    # Join inventory: (class, attr) pairs some function joins.
    joined_attrs: set[tuple[str, str]] = set()
    for fn in funcs.values():
        for call in fn.calls:
            parts = call.callee.split(".")
            if parts[-1] != "join" or len(parts) < 2:
                continue
            attr = parts[-2]
            if attr == "self" or attr in ("", "os", "path"):
                continue
            for cname, c in inv.classes.items():
                if attr in c.thread_attrs:
                    joined_attrs.add((cname, attr))
    findings: list[Finding] = []
    for fn in funcs.values():
        for spawn in fn.spawns:
            joined = (
                spawn.binding in joined_attrs
                or spawn.binding == ("<local>", "joined")
            )
            if spawn.daemon is not True and not joined:
                findings.append(
                    Finding(
                        "CL505",
                        f"non-daemon {spawn.kind} spawned in {fn.name}() "
                        "is never joined — interpreter shutdown will hang "
                        "on it (set daemon=True or join it on the stop "
                        "path)",
                        fn.path,
                        spawn.line,
                    )
                )
            elif spawn.in_init and not joined:
                findings.append(
                    Finding(
                        "CL505",
                        f"{spawn.kind} spawned in __init__ with no "
                        "join/stop path on the class — the object can "
                        "never be torn down deterministically",
                        fn.path,
                        spawn.line,
                    )
                )
    return findings


# ----------------------------------------------------------------- entry point


def lint_concurrency(
    paths: list[Path | str],
    package_root: Path | str | None = None,
    include_suppressed: bool = False,
) -> list[Finding]:
    """Run CL501–CL505 (+ the SP001 hygiene scan) over files/directories.

    ``include_suppressed=True`` keeps suppression-matched findings,
    marked via ``Finding.suppressed``, instead of dropping them — the
    ``--json`` CI surface audits the suppression inventory that way.
    """
    # A syntax error is the graph-path lint's finding (TL100).
    sources, trees, _ = parse_sources(paths, package_root)
    findings: list[Finding] = []

    graph = CallGraph.build(trees)
    _collect_module_locks(graph, trees)
    inv = _collect_inventory(graph, trees)
    defs = _collect_functions(trees)
    for key, d in defs.items():
        if d.cls is not None and key == f"{d.module}:{d.cls}.{d.name}":
            inv.methods.setdefault(d.name, []).append(key)
    res = _Resolver(graph, inv, defs)

    funcs: dict[str, FuncFacts] = {}
    for key, d in defs.items():
        fn = FuncFacts(
            key=key,
            module=d.module,
            cls=d.cls,
            name=d.name,
            path=str(trees[d.module][0]),
            param_types=_param_types(d.node, inv),
        )
        _FunctionWalker(
            fn, d.node, res, graph.imports.get(d.module, {})
        ).run()
        _bind_spawns(fn, d.node, inv)
        funcs[key] = fn

    # Thread entries: spawn targets + signal handlers.
    thread_entries: list[str] = []
    handler_entries: list[str] = []
    for fn in funcs.values():
        for spawn in fn.spawns:
            thread_entries.extend(_resolve_target(spawn.target, fn, res))
        for handler, _line in fn.handlers:
            keys = _resolve_target(handler, fn, res)
            handler_entries.extend(keys)
            thread_entries.extend(keys)
    thread_reachable = _reachable(thread_entries, funcs, res)
    may_acquire, may_block = _fixpoint_summaries(funcs, res)

    findings.extend(_rule_cl501(funcs, res, may_acquire))
    findings.extend(_rule_cl502(funcs, inv, thread_reachable))
    findings.extend(_rule_cl503(funcs, res, may_block))
    findings.extend(_rule_cl504(funcs, res, handler_entries))
    findings.extend(_rule_cl505(funcs, inv))

    # Suppression filtering + the SP001 hygiene scan, per module.
    by_path: dict[str, str] = {
        str(p): sources[m] for m, (p, _t) in trees.items()
    }
    out: list[Finding] = []
    sup_cache = {
        path: suppressed_rules_by_line(src) for path, src in by_path.items()
    }
    for f in findings:
        sup = sup_cache.get(f.path, {})
        if not is_suppressed(f, sup):
            out.append(f)
        elif include_suppressed:
            out.append(dataclasses.replace(f, suppressed=True))
    for path, src in sorted(by_path.items()):
        for f in suppression_findings(src, path):
            if not is_suppressed(f, sup_cache.get(path, {})):
                out.append(f)
            elif include_suppressed:
                out.append(dataclasses.replace(f, suppressed=True))

    return unique_sorted(out)
