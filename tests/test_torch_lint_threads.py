"""The port's concurrency lint (CL501–CL505) and event contract
(EC601–EC603), against the JAX passes.

The fixtures of ``tests/test_concurrency_lint.py`` are plain Python
(threads, locks, event emitters and readers): both packages' passes read the
same source, and must give the same rule ids at the same lines. Then the
port's own additions: torch's blocking calls under a lock (CL503), a lock a
base class makes (inherited by its subclasses), and the port's tree: clean
under both passes, every suppression with its reason, the checked-in
lockfile fresh, and its field types in agreement with the JAX lockfile's
where both packages emit a kind.
"""

from __future__ import annotations

import json
import textwrap
from pathlib import Path

import pytest

import masters_thesis_tpu
from masters_thesis_tpu.analysis.concurrency import (
    lint_concurrency as jax_lint_concurrency,
)
from masters_thesis_tpu.analysis.contracts import (
    lint_contracts as jax_lint_contracts,
)
from masters_thesis_tpu_torch.analysis import __main__ as cli
from masters_thesis_tpu_torch.analysis.concurrency import lint_concurrency
from masters_thesis_tpu_torch.analysis.contracts import (
    build_schema,
    lint_contracts,
)
from masters_thesis_tpu_torch.analysis.findings import (
    RULES,
    parse_suppressions,
    suppression_findings,
)

PACKAGE_ROOT = Path(__file__).resolve().parents[1] / "masters_thesis_tpu_torch"
LOCKFILE = PACKAGE_ROOT / "analysis" / "event_schema.json"
JAX_LOCKFILE = (Path(masters_thesis_tpu.__file__).parent / "analysis"
                / "event_schema.json")
#: Kinds only the JAX package emits: the on-disk cache's failed store and
#: the run metadata (neither ported).
JAX_ONLY_KINDS = {"cache_store_failed", "run_meta"}
#: Kinds only the port emits.
PORT_ONLY_KINDS: set[str] = set()

#: (name, pass, source): the fixtures of tests/test_concurrency_lint.py.
FIXTURES = [
    ("cl501_lock_order_inversion", "concurrency", """
import threading


class Pair:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def ab(self):
        with self._a:
            with self._b:
                pass

    def ba(self):
        with self._b:
            with self._a:
                pass
"""),
    ("cl501_interprocedural_cycle", "concurrency", """
import threading


class Pair:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def _inner_b(self):
        with self._b:
            pass

    def ab(self):
        with self._a:
            self._inner_b()

    def ba(self):
        with self._b:
            with self._a:
                pass
"""),
    ("cl501_no_cycle_no_finding", "concurrency", """
import threading


class Ordered:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def ab(self):
        with self._a:
            with self._b:
                pass

    def also_ab(self):
        with self._a:
            with self._b:
                pass
"""),
    ("cl501_rlock_reentry_ok", "concurrency", """
import threading


class Reent:
    def __init__(self):
        self._lock = threading.RLock()

    def outer(self):
        with self._lock:
            self.inner_op()

    def inner_op(self):
        with self._lock:
            pass
"""),
    ("cl502_unguarded_rmw_counter", "concurrency", """
import threading
import time


class Stats:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            self.count += 1
            time.sleep(0.01)

    def snapshot(self):
        with self._lock:
            return self.count
"""),
    ("cl502_guarded_counter_clean", "concurrency", """
import threading
import time


class Stats:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            with self._lock:
                self.count += 1
            time.sleep(0.01)

    def snapshot(self):
        with self._lock:
            return self.count
"""),
    ("cl502_single_threaded_class_not_flagged", "concurrency", """
class Tally:
    def __init__(self):
        self.n = 0

    def bump(self):
        self.n += 1
"""),
    ("cl502_event_attr_exempt", "concurrency", """
import threading


class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self.stop_event = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self.stop_event.is_set():
            pass

    def stop(self):
        with self._lock:
            self.stop_event.set()
"""),
    ("cl503_blocking_sleep_under_lock", "concurrency", """
import threading
import time


class Slow:
    def __init__(self):
        self._lock = threading.Lock()

    def slow(self):
        with self._lock:
            time.sleep(1.0)
"""),
    ("cl503_interprocedural", "concurrency", """
import threading
import time


class Slow:
    def __init__(self):
        self._lock = threading.Lock()

    def _io(self):
        time.sleep(0.5)

    def slow(self):
        with self._lock:
            self._io()
"""),
    ("cl503_condition_wait_exempt", "concurrency", """
import threading


class Q:
    def __init__(self):
        self._cond = threading.Condition()

    def pop(self):
        with self._cond:
            self._cond.wait(0.1)
"""),
    ("cl504_blocking_acquire_in_handler", "concurrency", """
import signal
import threading


class Rec:
    def __init__(self):
        self._lock = threading.Lock()
        signal.signal(signal.SIGTERM, self._on_signal)

    def _on_signal(self, signum, frame):
        self.dump()

    def dump(self):
        with self._lock:
            return 1
"""),
    ("cl504_bounded_acquire_ok", "concurrency", """
import signal
import threading


class Rec:
    def __init__(self):
        self._lock = threading.Lock()
        signal.signal(signal.SIGTERM, self._on_signal)

    def _on_signal(self, signum, frame):
        self.dump()

    def dump(self):
        if not self._lock.acquire(timeout=0.25):
            return None
        try:
            return 1
        finally:
            self._lock.release()
"""),
    ("cl505_nondaemon_never_joined", "concurrency", """
import threading


def fire_and_forget(work):
    t = threading.Thread(target=work)
    t.start()
"""),
    ("cl505_init_spawn_without_stop_path", "concurrency", """
import threading


class Daemonish:
    def __init__(self):
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        pass
"""),
    ("cl505_joined_thread_clean", "concurrency", """
import threading


class Clean:
    def __init__(self):
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        pass

    def close(self):
        self._t.join(timeout=1.0)
"""),
    ("suppression_silences_with_reason", "concurrency", """
import threading
import time


class Slow:
    def __init__(self):
        self._lock = threading.Lock()

    def slow(self):
        with self._lock:
            time.sleep(1.0)  # mtt: disable=CL503 -- test fixture
"""),
    ("bare_suppression_is_itself_a_finding", "concurrency", """
import threading
import time


class Slow:
    def __init__(self):
        self._lock = threading.Lock()

    def slow(self):
        with self._lock:
            time.sleep(1.0)  # mtt: disable=CL503
"""),
    ("ec601_consumed_never_emitted", "contracts", """
def emit_all(sink):
    sink.emit("epoch", epoch=1, wall_s=2.5)


def read_all(events):
    by_kind = {}
    for ev in events:
        by_kind.setdefault(ev.get("kind", "?"), []).append(ev)
    return [e.get("gpu_util") for e in by_kind.get("epoch", [])]
"""),
    ("ec601_satisfied_contract_clean", "contracts", """
def emit_all(sink):
    sink.emit("epoch", epoch=1, wall_s=2.5)


def read_all(events):
    by_kind = {}
    for ev in events:
        by_kind.setdefault(ev.get("kind", "?"), []).append(ev)
    return [e.get("wall_s") for e in by_kind.get("epoch", [])]
"""),
    ("ec601_dynamic_kind_exempt", "contracts", """
def emit_all(sink, payload):
    sink.emit("metrics", **payload)


def read_all(by_kind):
    return [e.get("whatever") for e in by_kind.get("metrics", [])]
"""),
    ("ec601_kind_guard_binding", "contracts", """
def emit_all(sink):
    sink.emit("epoch", epoch=1)


def read_all(events):
    for ev in events:
        if ev.get("kind") == "epoch":
            print(ev.get("missing_one"))
"""),
    ("ec602_emitter_type_conflict", "contracts", """
def emit_a(sink):
    sink.emit("epoch", wall_s=2.5)


def emit_b(sink):
    sink.emit("epoch", wall_s="fast")
"""),
    ("ec602_reader_numeric_cast_of_str", "contracts", """
def emit_all(sink):
    sink.emit("epoch", label="third")


def read_all(by_kind):
    return [float(e.get("label")) for e in by_kind.get("epoch", [])]
"""),
    ("ec_suppression", "contracts", """
def emit_all(sink):
    sink.emit("epoch", epoch=1)


def read_all(by_kind):
    return [e.get("gone") for e in by_kind.get("epoch", [])]  # mtt: disable=EC601 -- test fixture
"""),
]
PASSES = {
    "concurrency": (jax_lint_concurrency, lint_concurrency),
    "contracts": (jax_lint_contracts, lint_contracts),
}


def _run(lint, tmp_path: Path, name: str, source: str) -> list:
    root = tmp_path / name
    root.mkdir()
    (root / "fix.py").write_text(textwrap.dedent(source))
    return lint([root])


def _rule_lines(findings) -> list[tuple[str, int]]:
    return sorted({(f.rule, f.line) for f in findings})


@pytest.mark.parametrize("name,kind,source", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixture_gives_the_jax_rules_at_the_jax_lines(tmp_path, name, kind,
                                                     source):
    jax_lint, port_lint = PASSES[kind]
    want = _rule_lines(_run(jax_lint, tmp_path, "jax", source))
    got = _rule_lines(_run(port_lint, tmp_path, "torch", source))
    assert got == want, (name, got, want)


BLOCKING = {
    "synchronize": "torch.cuda.synchronize()",
    "item": "x.item()",
    "event": "done.synchronize()",
    "replay": "self.graph.replay()",
    "capture": "self.graph.capture_begin()",
    "graph_context": "torch.cuda.graph(self.graph)",
}


@pytest.mark.parametrize("call", BLOCKING.values(), ids=BLOCKING.keys())
def test_cl503_knows_the_cards_blocking_calls(tmp_path, call):
    source = f"""
        import threading
        import torch


        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self.graph = None

            def run(self, x, done):
                with self._lock:
                    {call}
        """
    findings = _run(lint_concurrency, tmp_path, "p", source)
    assert _rule_lines(findings) == [("CL503", 13)], findings


def test_a_base_class_lock_guards_its_subclasses_state(tmp_path):
    source = """
        import threading


        class Base:
            def __init__(self):
                self._stats_lock = threading.Lock()
                self._t = threading.Thread(target=self._run, daemon=True)

            def _run(self):
                pass

            def stop(self):
                self._t.join()


        class Fleet(Base):
            def __init__(self):
                super().__init__()
                self.deaths = 0
                self._w = threading.Thread(target=self.work, daemon=True)

            def work(self):
                with self._stats_lock:
                    self.deaths += 1

            def stats(self):
                with self._stats_lock:
                    return self.deaths

            def close(self):
                self._w.join()
        """
    assert _run(lint_concurrency, tmp_path, "p", source) == []


def test_unified_parser_spellings():
    src = ("a = 1  # mtt: disable=CL502 -- why\n"
           "b = 2  # tracelint: disable=TL101\n"
           "c = 3  # noqa: TL103\n"
           "d = 4  # noqa\n")
    sups = {s.line: s for s in parse_suppressions(src)}
    assert sups[1].spelling == "mtt" and sups[1].reason == "why"
    assert sups[1].rules == frozenset({"CL502"})
    assert sups[2].spelling == "tracelint" and sups[2].reason is None
    assert sups[3].spelling == "noqa" and 4 not in sups
    assert [f.line for f in suppression_findings(src, "x.py")] == [2]


def test_ec603_drift_and_regeneration(tmp_path):
    (tmp_path / "fix.py").write_text(
        "def emit_all(sink):\n    sink.emit('epoch', epoch=1, wall_s=2.5)\n")
    lock = tmp_path / "schema.json"
    assert any(f.rule == "EC603" and "missing" in f.message
               for f in lint_contracts([tmp_path], schema_path=lock))
    lock.write_text(json.dumps(build_schema([tmp_path])))
    assert not lint_contracts([tmp_path], schema_path=lock)
    (tmp_path / "fix.py").write_text(
        "def emit_all(sink):\n"
        "    sink.emit('epoch', epoch=1, wall_s=2.5, new_field=0)\n")
    assert any(f.rule == "EC603" and "new_field" in f.message
               for f in lint_contracts([tmp_path], schema_path=lock))


# ------------------------------------------------------------ the port


def _thread_paths() -> list[Path]:
    return [PACKAGE_ROOT / p for p in cli.CONCURRENCY_PATHS]


def test_port_threads_lint_clean():
    findings = lint_concurrency(_thread_paths(), package_root=PACKAGE_ROOT)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_graph_lock_findings_are_suppressed_with_their_reason():
    kept = lint_concurrency(_thread_paths(), package_root=PACKAGE_ROOT,
                            include_suppressed=True)
    graph = [f for f in kept if f.path.endswith("utils/cuda_graph.py")]
    assert sorted(f.rule for f in graph) == ["CL503", "CL503"]
    assert all(f.suppressed for f in kept)
    source = (PACKAGE_ROOT / "utils" / "cuda_graph.py").read_text()
    reasons = {s.line: s.reason for s in parse_suppressions(source)}
    assert all("orders every capture and replay" in reasons[f.line]
               for f in graph)


def test_port_contracts_clean_against_the_lockfile():
    findings = lint_contracts([PACKAGE_ROOT], package_root=PACKAGE_ROOT,
                              schema_path=LOCKFILE)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_every_suppression_in_the_port_has_a_reason_and_a_rule():
    for path in sorted(PACKAGE_ROOT.rglob("*.py")):
        source = path.read_text()
        assert suppression_findings(source, str(path)) == [], path
        for sup in parse_suppressions(source):
            if sup.spelling == "mtt":
                assert sup.rules and sup.rules <= set(RULES), (path, sup)


def test_emit_schema_reproduces_the_lockfile(tmp_path, monkeypatch, capsys):
    out = tmp_path / "event_schema.json"
    monkeypatch.setattr(cli, "LOCKFILE", out)
    assert cli.main(["--emit-schema"]) == 0
    assert out.read_text() == LOCKFILE.read_text()


def test_static_gate_exits_zero_on_the_port(capsys):
    assert cli.main(["--concurrency", "--contracts", "--spmd"]) == 0
    assert capsys.readouterr().out.strip() == "tracelint: no findings"
    assert cli.main(["--concurrency", "--contracts", "--spmd",
                     "--json"]) == 0
    kept = json.loads(capsys.readouterr().out)
    assert kept and all(f["suppressed"] for f in kept)


def _group(types: list[str]) -> set[str]:
    """Type groups that can disagree (null and unknown never do)."""
    return {{"bool": "number"}.get(t, t) for t in types} - {"null",
                                                           "unknown"}


def test_lockfile_agrees_with_the_jax_lockfile():
    port = json.loads(LOCKFILE.read_text())["kinds"]
    jax = json.loads(JAX_LOCKFILE.read_text())["kinds"]
    assert set(jax) - set(port) == JAX_ONLY_KINDS
    assert set(port) - set(jax) == PORT_ONLY_KINDS
    for kind in sorted(set(port) & set(jax)):
        pf, jf = port[kind]["fields"], jax[kind]["fields"]
        for field in sorted(set(pf) & set(jf)):
            p, j = _group(pf[field]), _group(jf[field])
            assert not p or not j or p & j, (kind, field, pf[field],
                                             jf[field])
