"""Event-schema contract check (EC601–EC603).

The port's copy of ``masters_thesis_tpu/analysis/contracts.py``. The
telemetry stream is a wire protocol between code that never imports each
other: the emitters (``TelemetryRun.event``, ``EventSink.emit``, the serve,
fleet and supervisor ``_event`` wrappers, ``Tracer.emit_span``, the flight
recorder's ``record``) and the torch-free readers (``telemetry/report.py``,
``aggregate.py``, ``trace.py``, ``watch.py``, ``signals.py``, ``slo.py``).
Both sides are recovered from the AST:

- **Emitted shapes**: each call named ``emit``/``event``/``_event``/
  ``try_emit`` with a literal kind (or a module string constant) gives
  ``kind -> {field: types}``, each keyword typed from its expression; a
  ``**payload`` makes the kind dynamic (EC601 stands down for it);
  ``emit_span`` gives the span envelope; the sink's envelope keys are
  always there.
- **Consumed fields**: a variable is bound to a kind by ``if
  ev.get("kind") == "epoch":``, ``by_kind.get("epoch")``, a comprehension
  filtered on kind, ...; ``v.get("field")`` or ``v["field"]`` on it is a
  consumption, and ``float()``/``int()`` around it a numeric expectation.

Rules: **EC601** a field read under a kind that no emitter emits it under;
**EC602** two emit sites type a field differently, or a reader casts to a
number a field only ever emitted as a string; **EC603** drift against the
checked-in ``analysis/event_schema.json`` (regenerate with
``python -m masters_thesis_tpu_torch.analysis --emit-schema`` and review
the diff). What the extraction cannot prove it does not flag; ``# mtt:
disable=EC60x -- reason`` suppresses. Stdlib only.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path

from masters_thesis_tpu_torch.analysis.astlint import parse_sources
from masters_thesis_tpu_torch.analysis.findings import (
    Finding,
    is_suppressed,
    suppressed_rules_by_line,
)

EMIT_METHOD_NAMES = {"emit", "event", "_event", "try_emit"}

# Keys the sink injects on every event (telemetry/events.py
# RESERVED_KEYS) — always considered emitted.
ENVELOPE_KEYS = {
    "ts", "kind", "run", "seq", "host", "pid", "proc", "nproc", "attempt",
    "generation",
}

# Fields Tracer._emit writes for every span event; an ``emit_span`` call
# site contributes exactly these (its **attrs land inside "attrs").
SPAN_ENVELOPE = {
    "name": "str", "cat": "str", "span_id": "str", "parent_id": "str",
    "trace_id": "str", "start_ts": "number", "dur_s": "number",
    "status": "str", "ext": "bool", "attrs": "dict",
}

_NUMERIC = {"number", "bool"}
_TYPE_GROUPS = ("str", "number", "list", "dict")


def _type_group(t: str) -> str | None:
    if t in _NUMERIC:
        return "number"
    if t in _TYPE_GROUPS:
        return t
    return None  # null/unknown never conflict


def _expr_type(node: ast.AST, consts: dict[str, str]) -> str:
    if isinstance(node, ast.Constant):
        v = node.value
        if isinstance(v, bool):
            return "bool"
        if isinstance(v, (int, float)):
            return "number"
        if isinstance(v, str):
            return "str"
        if v is None:
            return "null"
        return "unknown"
    if isinstance(node, ast.JoinedStr):
        return "str"
    if isinstance(node, ast.Dict):
        return "dict"
    if isinstance(node, (ast.List, ast.Tuple, ast.Set, ast.ListComp)):
        return "list"
    if isinstance(node, ast.Compare):
        return "bool"
    if isinstance(node, ast.BoolOp):
        # `x or "default"` yields one of the operands, not a boolean.
        types = {
            t
            for v in node.values
            for t in (_expr_type(v, consts),)
            if t not in ("unknown", "null")
        }
        return types.pop() if len(types) == 1 else "unknown"
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return "bool"
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        if node.func.id in ("float", "int", "len", "round", "abs", "sum"):
            return "number"
        if node.func.id in ("str", "repr"):
            return "str"
        if node.func.id == "bool":
            return "bool"
        if node.func.id in ("list", "sorted", "tuple"):
            return "list"
        if node.func.id == "dict":
            return "dict"
    if isinstance(node, ast.Name):
        const = consts.get(node.id)
        if const is not None:
            return "str"  # module-level string constant
    return "unknown"


def _literal_kind(node: ast.AST, consts: dict[str, str]) -> str | None:
    """String-literal (or module string-constant) event kind, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def _module_str_consts(tree: ast.AST) -> dict[str, str]:
    out: dict[str, str] = {}
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Constant
        ) and isinstance(node.value.value, str):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = node.value.value
    return out


# ------------------------------------------------------------------- emitters


class EmittedSchema:
    def __init__(self) -> None:
        # kind -> field -> set of type names
        self.fields: dict[str, dict[str, set[str]]] = {}
        self.dynamic: set[str] = set()
        # (kind, field, type) -> first (path, line) witness
        self.sites: dict[tuple[str, str], list[tuple[str, int, str]]] = {}

    def note(
        self, kind: str, field: str, typ: str, path: str, line: int
    ) -> None:
        self.fields.setdefault(kind, {}).setdefault(field, set()).add(typ)
        self.sites.setdefault((kind, field), []).append((path, line, typ))

    def note_kind(self, kind: str) -> None:
        self.fields.setdefault(kind, {})


def _collect_emitters(
    trees: dict[str, tuple[Path, ast.AST]],
    consts_by_module: dict[str, dict[str, str]],
) -> EmittedSchema:
    schema = EmittedSchema()
    for module, (path, tree) in trees.items():
        consts = consts_by_module[module]
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = (
                func.attr if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else None
            )
            if name == "emit_span":
                schema.note_kind("span")
                for field, typ in SPAN_ENVELOPE.items():
                    schema.note(
                        "span", field, typ, str(path), node.lineno
                    )
                continue
            if name in EMIT_METHOD_NAMES and node.args:
                kind = _literal_kind(node.args[0], consts)
                if kind is None:
                    continue
                schema.note_kind(kind)
                for kw in node.keywords:
                    if kw.arg is None:  # **payload
                        schema.dynamic.add(kind)
                        continue
                    schema.note(
                        kind, kw.arg, _expr_type(kw.value, consts),
                        str(path), node.lineno,
                    )
            elif name == "record" and len(node.args) == 1 and isinstance(
                node.args[0], ast.Dict
            ):
                # flightrec-style `rec.record({"kind": "...", ...})`.
                d = node.args[0]
                keys = [
                    k.value
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                    else None
                    for k in d.keys
                ]
                if "kind" not in keys:
                    continue
                kind = None
                for k, v in zip(keys, d.values):
                    if k == "kind":
                        kind = _literal_kind(v, consts)
                if kind is None:
                    continue
                schema.note_kind(kind)
                for k, v in zip(keys, d.values):
                    if k is None:
                        schema.dynamic.add(kind)
                    elif k != "kind":
                        schema.note(
                            kind, k, _expr_type(v, consts),
                            str(path), node.lineno,
                        )
    return schema


# -------------------------------------------------------------------- readers


class Consumption:
    __slots__ = ("kind", "field", "expect", "path", "line")

    def __init__(self, kind, field, expect, path, line):
        self.kind, self.field = kind, field
        self.expect, self.path, self.line = expect, path, line


def _is_kind_map(name: str) -> bool:
    return "kind" in name


class _ReaderWalker:
    """Per-function kind-binding and consumption extraction.

    Flow handling is optimistic and scoped: ``if`` bodies get branch-local
    bindings, loops bind their element var for the body, comprehensions
    bind generator vars locally. Anything unresolvable is simply not
    attributed — precision over recall.
    """

    def __init__(self, path: str, consts: dict[str, str]):
        self.path = path
        self.consts = consts
        self.out: list[Consumption] = []

    def run(self, fn: ast.FunctionDef) -> list[Consumption]:
        env: dict[str, str] = {}  # dict-var -> kind
        lists: dict[str, str] = {}  # list-var -> kind
        sel: dict[str, str] = {}  # kind-selector var -> source dict var
        self._stmts(fn.body, env, lists, sel)
        return self.out

    # -- statements ------------------------------------------------------

    def _stmts(self, body, env, lists, sel) -> None:
        for stmt in body:
            self._stmt(stmt, env, lists, sel)

    def _stmt(self, stmt, env, lists, sel) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and (
            isinstance(stmt.targets[0], ast.Name)
        ):
            tgt = stmt.targets[0].id
            self._bind(tgt, stmt.value, env, lists, sel)
            self._expr(stmt.value, env, lists, sel)
            return
        if isinstance(stmt, ast.If):
            bound = self._kind_test(stmt.test, env, lists, sel)
            self._expr(stmt.test, env, lists, sel)
            if bound is not None:
                var, kind = bound
                inner = dict(env)
                inner[var] = kind
                self._stmts(stmt.body, inner, lists, sel)
            else:
                self._stmts(stmt.body, dict(env), dict(lists), dict(sel))
            self._stmts(stmt.orelse, env, lists, sel)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, env, lists, sel)
            inner = dict(env)
            if isinstance(stmt.target, ast.Name):
                kind = self._list_kind(stmt.iter, lists)
                if kind is not None:
                    inner[stmt.target.id] = kind
            self._stmts(stmt.body, inner, lists, sel)
            self._stmts(stmt.orelse, env, lists, sel)
            return
        if isinstance(stmt, (ast.While,)):
            self._expr(stmt.test, env, lists, sel)
            self._stmts(stmt.body, dict(env), dict(lists), dict(sel))
            self._stmts(stmt.orelse, env, lists, sel)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._expr(item.context_expr, env, lists, sel)
            self._stmts(stmt.body, env, lists, sel)
            return
        if isinstance(stmt, ast.Try):
            self._stmts(stmt.body, env, lists, sel)
            for h in stmt.handlers:
                self._stmts(h.body, env, lists, sel)
            self._stmts(stmt.orelse, env, lists, sel)
            self._stmts(stmt.finalbody, env, lists, sel)
            return
        for child in ast.iter_child_nodes(stmt):
            self._expr(child, env, lists, sel)

    # -- binding patterns ------------------------------------------------

    def _bind(self, tgt: str, value: ast.AST, env, lists, sel) -> None:
        # k = ev.get("kind")
        got = self._get_call(value)
        if got is not None:
            recv, key, _default = got
            if key == "kind" and isinstance(recv, ast.Name):
                sel[tgt] = recv.id
                return
        # xs = by_kind.get("epoch" [, []]) / by_kind["epoch"]
        kind = self._kind_map_lookup(value)
        if kind is not None:
            lists[tgt] = kind
            return
        # d = (by_kind.get("run_finished") or [None])[-1]
        if isinstance(value, ast.Subscript):
            base = value.value
            if isinstance(base, ast.BoolOp):
                for operand in base.values:
                    kind = self._kind_map_lookup(operand)
                    if kind is not None:
                        env[tgt] = kind
                        return
            kind = self._list_kind(base, lists)
            if kind is not None:
                env[tgt] = kind
                return
        # xs = [e for e in events if e.get("kind") == "epoch"]
        if isinstance(value, (ast.ListComp, ast.GeneratorExp)):
            kind = self._comp_kind(value, lists)
            if kind is not None:
                lists[tgt] = kind
                return
        # alias copies
        if isinstance(value, ast.Name):
            if value.id in lists:
                lists[tgt] = lists[value.id]
            if value.id in env:
                env[tgt] = env[value.id]

    def _kind_map_lookup(self, node: ast.AST) -> str | None:
        got = self._get_call(node)
        if got is not None:
            recv, key, _d = got
            if isinstance(recv, ast.Name) and _is_kind_map(recv.id):
                return key
        if isinstance(node, ast.Subscript) and isinstance(
            node.value, ast.Name
        ) and _is_kind_map(node.value.id):
            key = self._const_str(node.slice)
            if key is not None:
                return key
        return None

    def _comp_kind(self, comp, lists) -> str | None:
        """Kind of a single-generator comprehension over events filtered
        on kind, walking its interior consumptions along the way."""
        if len(comp.generators) != 1:
            return None
        gen = comp.generators[0]
        kind = self._list_kind(gen.iter, lists)
        var = gen.target.id if isinstance(gen.target, ast.Name) else None
        if kind is None and var is not None:
            for cond in gen.ifs:
                bound = self._kind_test(cond, {}, lists, {})
                if bound is not None and bound[0] == var:
                    kind = bound[1]
        if var is not None and kind is not None:
            inner = {var: kind}
            self._expr(comp.elt, inner, lists, {})
            for cond in gen.ifs:
                self._expr(cond, inner, lists, {})
        return kind

    def _list_kind(self, node: ast.AST, lists) -> str | None:
        if isinstance(node, ast.Name):
            return lists.get(node.id)
        kind = self._kind_map_lookup(node)
        if kind is not None:
            return kind
        if isinstance(node, ast.BoolOp):
            for operand in node.values:
                k = self._list_kind(operand, lists)
                if k is not None:
                    return k
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            return self._comp_kind(node, lists)
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Name
        ) and node.func.id in ("reversed", "sorted", "list"):
            if node.args:
                return self._list_kind(node.args[0], lists)
        return None

    def _kind_test(self, test, env, lists, sel) -> tuple[str, str] | None:
        """`ev.get("kind") == "K"` / `ev["kind"] == "K"` / `k == "K"`
        (k a kind-selector var) -> (dict var, kind)."""
        if not (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)
        ):
            if isinstance(test, ast.BoolOp) and isinstance(
                test.op, ast.And
            ):
                for operand in test.values:
                    bound = self._kind_test(operand, env, lists, sel)
                    if bound is not None:
                        return bound
            return None
        left, right = test.left, test.comparators[0]
        for a, b in ((left, right), (right, left)):
            kind = self._literal(b)
            if kind is None:
                continue
            got = self._get_call(a)
            if got is not None and got[1] == "kind" and isinstance(
                got[0], ast.Name
            ):
                return (got[0].id, kind)
            if isinstance(a, ast.Subscript) and isinstance(
                a.value, ast.Name
            ) and self._const_str(a.slice) == "kind":
                return (a.value.id, kind)
            if isinstance(a, ast.Name) and a.id in sel:
                return (sel[a.id], kind)
        return None

    # -- consumption -----------------------------------------------------

    def _expr(self, node: ast.AST, env, lists, sel, expect=None) -> None:
        if node is None or isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            return
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            self._comp_kind(node, lists)
            return
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) and node.func.id in (
                "float", "int"
            ) and len(node.args) == 1:
                self._expr(node.args[0], env, lists, sel, expect="number")
                return
            got = self._get_call(node)
            if got is not None:
                recv, key, default = got
                kind = self._recv_kind(recv, env, lists)
                if kind is not None and key != "kind":
                    self.out.append(
                        Consumption(
                            kind, key, expect, self.path, node.lineno
                        )
                    )
                self._expr(recv, env, lists, sel)
                if default is not None:
                    self._expr(default, env, lists, sel)
                return
        if isinstance(node, ast.Subscript):
            key = self._const_str(node.slice)
            if key is not None and key != "kind":
                kind = self._recv_kind(node.value, env, lists)
                if kind is not None:
                    self.out.append(
                        Consumption(
                            kind, key, expect, self.path, node.lineno
                        )
                    )
        for child in ast.iter_child_nodes(node):
            self._expr(child, env, lists, sel, expect)

    def _recv_kind(self, recv: ast.AST, env, lists) -> str | None:
        if isinstance(recv, ast.Name):
            return env.get(recv.id)
        # crash_events[-1].get("reason") — subscript of a kind list.
        if isinstance(recv, ast.Subscript):
            base_kind = self._list_kind(recv.value, lists)
            if base_kind is not None:
                return base_kind
        return None

    # -- small helpers ---------------------------------------------------

    def _get_call(self, node):
        """(receiver, literal key, default|None) for `x.get("k"[, d])`."""
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and node.args
        ):
            key = self._literal(node.args[0])
            if key is not None:
                default = node.args[1] if len(node.args) > 1 else None
                return (node.func.value, key, default)
        return None

    def _literal(self, node) -> str | None:
        return _literal_kind(node, self.consts)

    def _const_str(self, node) -> str | None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return None


def _collect_consumptions(
    trees: dict[str, tuple[Path, ast.AST]],
    consts_by_module: dict[str, dict[str, str]],
) -> list[Consumption]:
    out: list[Consumption] = []
    for module, (path, tree) in trees.items():
        consts = consts_by_module[module]
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(
                    _ReaderWalker(str(path), consts).run(node)
                )
    return out


# --------------------------------------------------------------------- schema


def build_schema(
    paths: list[Path | str], package_root: Path | str | None = None
) -> dict:
    """Emitted-event inventory as the lockfile JSON structure."""
    trees, consts, _sources = _parse(paths, package_root)
    emitted = _collect_emitters(trees, consts)
    kinds = {}
    for kind in sorted(emitted.fields):
        kinds[kind] = {
            "dynamic": kind in emitted.dynamic,
            "fields": {
                f: sorted(t for t in types)
                for f, types in sorted(emitted.fields[kind].items())
            },
        }
    return {"version": 1, "kinds": kinds}


def _parse(paths, package_root):
    sources, trees, _ = parse_sources(paths, package_root)
    consts = {m: _module_str_consts(t) for m, (_p, t) in trees.items()}
    return trees, consts, sources


# ---------------------------------------------------------------- entry point


def lint_contracts(
    paths: list[Path | str],
    package_root: Path | str | None = None,
    schema_path: Path | str | None = None,
    include_suppressed: bool = False,
) -> list[Finding]:
    """Run EC601–EC603 over files/directories.

    ``schema_path``: lockfile to diff against (EC603); ``None`` skips the
    drift check (used when linting ad-hoc paths rather than the package).
    ``include_suppressed=True`` keeps suppression-matched findings
    (marked ``Finding.suppressed``) for the ``--json`` CI surface.
    """
    trees, consts, sources = _parse(paths, package_root)
    emitted = _collect_emitters(trees, consts)
    consumed = _collect_consumptions(trees, consts)
    findings: list[Finding] = []

    # EC601 — consumed but never emitted.
    seen_601: set[tuple[str, str]] = set()
    for c in consumed:
        if c.field in ENVELOPE_KEYS or c.kind in emitted.dynamic:
            continue
        if (c.kind, c.field) in seen_601:
            continue
        if c.kind not in emitted.fields:
            seen_601.add((c.kind, c.field))
            findings.append(
                Finding(
                    "EC601",
                    f"reader consumes '{c.field}' of kind '{c.kind}', "
                    "but no emitter ever emits that kind",
                    c.path,
                    c.line,
                )
            )
        elif c.field not in emitted.fields[c.kind]:
            seen_601.add((c.kind, c.field))
            findings.append(
                Finding(
                    "EC601",
                    f"reader consumes field '{c.field}' of kind "
                    f"'{c.kind}', which no emitter site emits "
                    f"(emitted fields: "
                    f"{sorted(emitted.fields[c.kind]) or '(none)'})",
                    c.path,
                    c.line,
                )
            )

    # EC602a — emitter sites disagree on a field's type.
    for (kind, field), sites in sorted(emitted.sites.items()):
        groups = {}
        for path, line, typ in sites:
            g = _type_group(typ)
            if g is not None:
                groups.setdefault(g, (path, line, typ))
        if len(groups) > 1:
            detail = ", ".join(
                f"{typ} at {Path(path).name}:{line}"
                for _g, (path, line, typ) in sorted(groups.items())
            )
            path, line, _t = sites[0]
            findings.append(
                Finding(
                    "EC602",
                    f"emit sites disagree on the type of "
                    f"'{kind}.{field}': {detail}",
                    path,
                    line,
                )
            )

    # EC602b — reader numeric cast of a str-only field.
    seen_602: set[tuple[str, str]] = set()
    for c in consumed:
        if c.expect != "number" or (c.kind, c.field) in seen_602:
            continue
        types = emitted.fields.get(c.kind, {}).get(c.field)
        if types and all(_type_group(t) == "str" for t in types):
            seen_602.add((c.kind, c.field))
            findings.append(
                Finding(
                    "EC602",
                    f"reader casts '{c.kind}.{c.field}' to a number, but "
                    "every emit site emits it as str",
                    c.path,
                    c.line,
                )
            )

    # EC603 — lockfile drift.
    if schema_path is not None:
        findings.extend(
            _schema_drift(
                build_schema(paths, package_root), Path(schema_path)
            )
        )

    # Per-line suppressions.
    sup_by_path = {
        str(p): suppressed_rules_by_line(sources[m])
        for m, (p, _t) in trees.items()
    }
    out: list[Finding] = []
    for f in findings:
        if not is_suppressed(f, sup_by_path.get(f.path, {})):
            out.append(f)
        elif include_suppressed:
            out.append(dataclasses.replace(f, suppressed=True))
    return sorted(out, key=lambda f: (f.path, f.line, f.rule, f.message))


def _schema_drift(current: dict, schema_path: Path) -> list[Finding]:
    path = str(schema_path)
    if not schema_path.exists():
        return [
            Finding(
                "EC603",
                "event-schema lockfile missing — generate it with "
                "`python -m masters_thesis_tpu_torch.analysis --emit-schema`",
                path,
                0,
            )
        ]
    try:
        locked = json.loads(schema_path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        return [
            Finding("EC603", f"unreadable lockfile: {exc}", path, 0)
        ]
    findings: list[Finding] = []
    cur_kinds = current.get("kinds", {})
    old_kinds = locked.get("kinds", {})
    for kind in sorted(set(cur_kinds) - set(old_kinds)):
        findings.append(
            Finding(
                "EC603",
                f"new event kind '{kind}' is not in the lockfile "
                "(--emit-schema to accept)",
                path,
                0,
            )
        )
    for kind in sorted(set(old_kinds) - set(cur_kinds)):
        findings.append(
            Finding(
                "EC603",
                f"event kind '{kind}' is in the lockfile but no longer "
                "emitted (--emit-schema to accept the removal)",
                path,
                0,
            )
        )
    for kind in sorted(set(cur_kinds) & set(old_kinds)):
        cur_f = cur_kinds[kind].get("fields", {})
        old_f = old_kinds[kind].get("fields", {})
        for field in sorted(set(cur_f) - set(old_f)):
            findings.append(
                Finding(
                    "EC603",
                    f"'{kind}.{field}' emitted but not in the lockfile",
                    path,
                    0,
                )
            )
        for field in sorted(set(old_f) - set(cur_f)):
            findings.append(
                Finding(
                    "EC603",
                    f"'{kind}.{field}' in the lockfile but no longer "
                    "emitted",
                    path,
                    0,
                )
            )
        for field in sorted(set(cur_f) & set(old_f)):
            if sorted(cur_f[field]) != sorted(old_f[field]):
                findings.append(
                    Finding(
                        "EC603",
                        f"'{kind}.{field}' types changed: lockfile "
                        f"{sorted(old_f[field])} vs emitted "
                        f"{sorted(cur_f[field])}",
                        path,
                        0,
                    )
                )
    return findings
