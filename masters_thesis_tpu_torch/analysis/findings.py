"""Finding records, the rule registry, per-line suppression and reports.

The port's copy of ``masters_thesis_tpu/analysis/findings.py``. Every rule
of the port's checks registers here: the graph-path lint (``TL1xx``,
``analysis/astlint.py``), the trainer preflight (``TA2xx``,
``analysis/traceaudit.py``), the serve preflight (``SV3xx``,
``serve/preflight.py``), the concurrency lint (``CL5xx``), the event
contract (``EC6xx``), the SPMD lint (``DV7xx``) and suppression hygiene
(``SP001``). Each id keeps the JAX package's number; a TL or TA rule reads
in its torch meaning: what breaks "one CUDA graph a step, with no host
read inside" on the card where the JAX rule guards "one compiled program,
no host transfer".

Suppression is one syntax for every pass::

    self._beats += 1  # mtt: disable=CL502 -- single-writer heartbeat counter

A reason after ``--`` is required: a suppression without one still
suppresses, but is itself reported as ``SP001``. ``# tracelint:
disable=...`` is read as the same thing, and ``# noqa: TL101`` with explicit
ids too (a bare ``# noqa`` swallows nothing). Stdlib only.
"""

from __future__ import annotations

import dataclasses
import json
import re

#: Rule id -> (title, category).
RULES: dict[str, tuple[str, str]] = {
    "TL101": (
        "host read inside a CUDA graph: float()/int()/bool()/.item()/"
        ".tolist() on a tensor in graph-reachable code",
        "capture-safety / transfer",
    ),
    "TL102": (
        "Python control flow on a tensor's value (if/while on a torch "
        "expression) in graph-reachable code: a host read, and a branch "
        "frozen at capture",
        "capture-safety / recapture",
    ),
    "TL103": (
        "random draw in graph-reachable code from the default generator "
        "(no generator=): a replay does not advance it as an eager call "
        "would",
        "correctness (random streams)",
    ),
    "TL104": (
        "float64/double dtype, or a switch that turns TF32 on or sets "
        "matmul precision below 'highest' (the port computes in f32)",
        "precision",
    ),
    "TL105": (
        "host transfer or synchronisation in graph-reachable code (.cpu(), "
        ".numpy(), .to('cpu'), torch.cuda.synchronize(), a blocking host "
        "copy, np.* on a tensor)",
        "transfer",
    ),
    "TA201": (
        "train step captured more than once (GraphedCall.captures > 1, or "
        "replays short of the steps run)",
        "recapture",
    ),
    "TA202": (
        "host synchronisation inside the replayed steps "
        "(torch.cuda.set_sync_debug_mode('error') raised)",
        "transfer",
    ),
    "TA203": (
        "a collective other than the gradient and metric all-reduces "
        "(a gather) in the training step",
        "sharding",
    ),
    "TA204": (
        "parameter dtypes changed through the steps, or metric sums not "
        "accumulated in float32",
        "precision",
    ),
    "TA205": (
        "the trainer preflight could not run to completion",
        "infrastructure",
    ),
    "TA206": (
        "not exactly one gradient all-reduce a training step",
        "sharding",
    ),
    "TA207": (
        "the stacked step (R replicas) captured more than once, or not "
        "exactly one [R, n] gradient all-reduce a step",
        "recapture / sharding",
    ),
    "SV301": (
        "a serve bucket captured more than once, or a capture after warm-up",
        "recapture",
    ),
    "SV302": (
        "implicit host synchronisation in the serve hot path",
        "transfer",
    ),
    "SV303": (
        "the serve preflight could not run to completion",
        "infrastructure",
    ),
    "SV304": (
        "a serve bucket's capture peaked past the card's memory",
        "memory",
    ),
    "SV306": (
        "the serving fleet did not survive an injected replica death",
        "availability",
    ),
    "SV307": (
        "stacked serving captured more than one graph a bucket, or a "
        "bucket's graph launched its forward more than once",
        "recapture",
    ),
    "SV308": (
        "a hot-swap under load captured, left a request unresolved, "
        "answered late or moved a sibling lane",
        "availability",
    ),
    "CL501": (
        "lock-order inversion: a cycle in the acquires-while-holding graph",
        "concurrency / deadlock",
    ),
    "CL502": (
        "unguarded shared state: an attribute of a thread-shared object "
        "read-modify-written, or accessed without the lock that guards its "
        "other accesses",
        "concurrency / race",
    ),
    "CL503": (
        "blocking call under a held lock (I/O, subprocess, sleep, queue "
        "waits, a device synchronisation, a graph's capture or replay)",
        "concurrency / latency",
    ),
    "CL504": (
        "non-signal-safe work in signal-handler-reachable code",
        "concurrency / deadlock",
    ),
    "CL505": (
        "thread lifecycle: a non-daemon thread never joined, or one spawned "
        "in __init__ with no stop/join path",
        "concurrency / lifecycle",
    ),
    "EC601": (
        "event field consumed by a reader but never emitted under that kind",
        "contract",
    ),
    "EC602": (
        "emitter/reader type disagreement for an event field",
        "contract",
    ),
    "EC603": (
        "event schema drift against analysis/event_schema.json (regenerate "
        "with --emit-schema and review the diff)",
        "contract",
    ),
    "DV701": (
        "rank-divergent control flow guards a collective: only one branch "
        "(or a divergent early exit) reaches it",
        "spmd / deadlock",
    ),
    "DV702": (
        "both branches of rank-divergent control flow reach collectives, in "
        "a different order or kind",
        "spmd / deadlock",
    ),
    "DV703": (
        "a host-divergent value flows into a collective operand or a tensor "
        "shape",
        "spmd / correctness",
    ),
    "DV704": (
        "nondeterminism on the checkpoint publish/resume path",
        "spmd / determinism",
    ),
    "DV705": (
        "rank-0-only side effect not fenced by a named barrier in the same "
        "function",
        "spmd / race",
    ),
    "SP001": (
        "suppression without justification: '# mtt: disable=<RULE>' needs a "
        "reason after ' -- '",
        "hygiene",
    ),
}

_DISABLE_RE = re.compile(
    r"#\s*(?P<spelling>mtt|tracelint):\s*disable"
    r"(?:\s*=\s*(?P<ids>[A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*))?"
    r"(?:\s*--\s*(?P<reason>\S.*?))?\s*$"
)
_NOQA_RE = re.compile(
    r"#\s*noqa:?\s*(?:=\s*)?(?P<ids>[A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)?"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    message: str
    path: str = "<trace>"
    line: int = 0
    #: A per-line suppression matched it: left out of text reports and exit
    #: codes; ``--json`` keeps it, marked.
    suppressed: bool = False

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        mark = " [suppressed]" if self.suppressed else ""
        return f"{loc}: {self.rule} {self.message}{mark}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One parsed per-line suppression comment."""

    line: int
    rules: frozenset[str] | None  # None: every rule on the line
    reason: str | None
    spelling: str  # "mtt" | "tracelint" | "noqa"


def parse_suppressions(source: str) -> list[Suppression]:
    """Every suppression comment of ``source``, one a line at most."""
    out: list[Suppression] = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        if "#" not in text:
            continue
        m = _DISABLE_RE.search(text)
        if m is not None:
            ids = m.group("ids")
            rules = (frozenset(p.strip() for p in ids.split(","))
                     if ids is not None else None)
            out.append(Suppression(lineno, rules, m.group("reason"),
                                   m.group("spelling")))
            continue
        m = _NOQA_RE.search(text)
        if m is not None and m.group("ids") is not None:
            out.append(Suppression(
                lineno, frozenset(p.strip() for p in m.group("ids").split(",")),
                None, "noqa"))
    return out


def suppressed_rules_by_line(source: str) -> dict[int, set[str] | None]:
    """Line -> suppressed rule ids (None: every rule)."""
    return {s.line: None if s.rules is None else set(s.rules)
            for s in parse_suppressions(source)}


def suppression_findings(source: str, path: str) -> list[Finding]:
    """``SP001`` for each ``mtt``/``tracelint`` suppression without a
    reason (``noqa`` is ruff's)."""
    out = []
    for sup in parse_suppressions(source):
        if sup.spelling in ("mtt", "tracelint") and not sup.reason:
            rules = ",".join(sorted(sup.rules)) if sup.rules else "<all>"
            out.append(Finding(
                "SP001", f"suppression of {rules} has no reason — write "
                "'# mtt: disable=<RULE> -- <why this is safe>'", path,
                sup.line))
    return out


def is_suppressed(finding: Finding,
                  suppressions: dict[int, set[str] | None]) -> bool:
    rules = suppressions.get(finding.line, ())
    return rules is None or finding.rule in rules


def unique_sorted(findings: list[Finding]) -> list[Finding]:
    """``findings`` by (path, line, rule), each (rule, path, line, message)
    once."""
    seen: set[tuple[str, str, int, str]] = set()
    out: list[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        key = (f.rule, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def format_report(findings: list[Finding], as_json: bool = False) -> str:
    if as_json:
        return json.dumps([dataclasses.asdict(f) for f in findings], indent=2)
    if not findings:
        return "tracelint: no findings"
    lines = [f.format() for f in findings]
    lines.append(f"tracelint: {len(findings)} finding(s)")
    return "\n".join(lines)
