"""The port's graph-path lint and trainer preflight, against the JAX passes.

Each fixture of ``tests/test_analysis.py`` runs through the JAX lint as it
is and through the port's lint translated into torch, line for line; both
must give the same rule ids at the same lines. The translation keeps each
JAX rule's bug class in its torch meaning:

==========================================  ================================
JAX fixture                                 torch fixture
==========================================  ================================
``import jax`` / ``import jax.numpy``       ``import torch`` / the
                                            ``GraphedCall`` import
``@jax.jit`` on ``def f``                   a comment line; ``GraphedCall(f,
                                            ...)`` appended at the end
``jnp.log``, ``jnp.any``, ``jnp.zeros``     ``torch.log``, ``torch.any``,
                                            ``torch.zeros``
TL101 ``float(x)``, ``x.item()``            the same (a host read)
TL102 ``if x > 0``, ``while jnp.any(..)``   ``if x > 0``, ``while
                                            torch.any(..)``
TL103 a PRNG key consumed twice / in a      a draw without ``generator=``
loop (``jax.random.normal(rng, ...)``)      in graph code (``torch.rand(4)``;
                                            the first, keyed draw becomes
                                            ``torch.randn(4, generator=rng)``)
TL103 clean: ``split``/``fold_in``          every draw takes ``generator=``
TL104 ``jnp.float64``, ``dtype="float64"``  ``torch.float64``,
                                            ``dtype="float64"``
TL104 ``jax_enable_x64``                    ``torch.set_default_dtype(
                                            torch.float64)``
TL105 ``jax.device_get(x)``,                ``x.cpu()``, ``np.asarray(x *
``np.asarray(x * 2)``                       2)``
==========================================  ================================

The rest holds the port's own tree clean, the CLI's exit codes, the audit
(TA201–TA207) on the CPU and the trainers' preflight.
"""

from __future__ import annotations

import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from masters_thesis_tpu.analysis import lint_paths as jax_lint_paths
from masters_thesis_tpu.analysis.findings import RULES as JAX_RULES
from masters_thesis_tpu.analysis.traceaudit import _synthetic_split
from masters_thesis_tpu_torch.analysis import Finding, format_report, lint_paths
from masters_thesis_tpu_torch.analysis import traceaudit as ta
from masters_thesis_tpu_torch.analysis.__main__ import main as cli_main
from masters_thesis_tpu_torch.analysis.findings import (
    RULES,
    is_suppressed,
    suppressed_rules_by_line,
)
from masters_thesis_tpu_torch.analysis.traceaudit import (
    PreflightError,
    run_stacked_trace_audit,
    run_trace_audit,
)
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.parallel.mesh import COLLECTIVES, DataMesh

PACKAGE_ROOT = Path(__file__).resolve().parents[1] / "masters_thesis_tpu_torch"
GRAPH = 'GraphedCall({}, device="cuda", name="{}")'
IMPORT = "from masters_thesis_tpu_torch.utils.cuda_graph import GraphedCall"

#: (name, JAX fixture, torch fixture): the fixtures of tests/test_analysis.py.
FIXTURES = [
    ("host_cast_in_jit", """
import jax

@jax.jit
def f(x):
    return float(x) + x.item()
""", f"""
import torch
{IMPORT}
# graphed below
def f(x):
    return float(x) + x.item()
{GRAPH.format("f", "f")}
"""),
    ("control_flow_on_tracer", """
import jax
import jax.numpy as jnp

@jax.jit
def f(x):
    if x > 0:
        return jnp.log(x)
    while jnp.any(x < 0):
        x = x + 1
    return x
""", f"""
import torch
{IMPORT}

# graphed below
def f(x):
    if x > 0:
        return torch.log(x)
    while torch.any(x < 0):
        x = x + 1
    return x
{GRAPH.format("f", "f")}
"""),
    ("key_reuse", """
import jax

def sample(rng):
    a = jax.random.normal(rng, (4,))
    b = jax.random.uniform(rng, (4,))
    return a + b
""", f"""
import torch

def sample(rng):
    a = torch.randn(4, generator=rng)
    b = torch.rand(4)
    return a + b
{IMPORT}
{GRAPH.format("sample", "s")}
"""),
    ("key_reuse_across_loop", """
import jax

def sample(rng):
    out = []
    for i in range(3):
        out.append(jax.random.normal(rng, (2,)))
    return out
""", f"""
import torch

def sample(rng):
    out = []
    for i in range(3):
        out.append(torch.randn(2))
    return out
{IMPORT}
{GRAPH.format("sample", "s")}
"""),
    ("split_resets_key_state", """
import jax

def sample(rng):
    a_rng, b_rng = jax.random.split(rng)
    a = jax.random.normal(a_rng, (4,))
    b = jax.random.uniform(b_rng, (4,))
    return a + b

def folded(rng, xs):
    out = []
    for i in range(3):
        step = jax.random.fold_in(rng, i)
        out.append(jax.random.normal(step, (2,)))
    return out
""", f"""
import torch

def sample(rng):
    a_rng, b_rng = rng, rng
    a = torch.randn(4, generator=a_rng)
    b = torch.rand(4, generator=b_rng)
    return a + b

def folded(rng, xs):
    out = []
    for i in range(3):
        step = rng
        out.append(torch.randn(2, generator=step))
    return out
{IMPORT}
{GRAPH.format("sample", "s")}
{GRAPH.format("folded", "f")}
"""),
    ("f64_literal", """
import jax.numpy as jnp

def widen(x):
    return jnp.asarray(x, dtype="float64") + jnp.zeros(3, jnp.float64)
""", """
import torch

def widen(x):
    return torch.as_tensor(x, dtype="float64") + torch.zeros(3, dtype=torch.float64)
"""),
    ("x64_enablement", """
import jax

jax.config.update("jax_enable_x64", True)
""", """
import torch

torch.set_default_dtype(torch.float64)
"""),
    ("host_transfer_in_jit", """
import jax
import numpy as np

@jax.jit
def f(x):
    y = np.asarray(x * 2)
    jax.device_get(x)
    return y
""", f"""
import torch
import numpy as np

# graphed below
def f(x):
    y = np.asarray(x * 2)
    x.cpu()
    return y
{IMPORT}
{GRAPH.format("f", "f")}
"""),
    ("host_code_not_flagged", """
import jax
import numpy as np

def readback(x):
    if x is None:
        return None
    host = np.asarray(jax.device_get(x))
    return float(host.sum())
""", """
import torch
import numpy as np

def readback(x):
    if x is None:
        return None
    host = np.asarray(x.cpu())
    return float(host.sum())
"""),
    ("reachability_through_calls", """
import jax

def helper(x):
    return float(x)

@jax.jit
def f(x):
    return helper(x)
""", f"""
import torch

def helper(x):
    return float(x)

# graphed below
def f(x):
    return helper(x)
{IMPORT}
{GRAPH.format("f", "f")}
"""),
    ("shape_breaks_taint", """
import jax

@jax.jit
def f(x):
    n = x.shape[0]
    if n > 4:
        return x[:4]
    return x
""", f"""
import torch

# graphed below
def f(x):
    n = x.shape[0]
    if n > 4:
        return x[:4]
    return x
{IMPORT}
{GRAPH.format("f", "f")}
"""),
    ("suppression_comment", """
import jax

@jax.jit
def f(x):
    return float(x)  # tracelint: disable=TL101
""", f"""
import torch

# graphed below
def f(x):
    return float(x)  # tracelint: disable=TL101
{IMPORT}
{GRAPH.format("f", "f")}
"""),
    ("bare_noqa_does_not_swallow", """
import jax

@jax.jit
def f(x):
    return float(x)  # noqa
""", f"""
import torch

# graphed below
def f(x):
    return float(x)  # noqa
{IMPORT}
{GRAPH.format("f", "f")}
"""),
    ("every_rule", """
import jax
import jax.numpy as jnp
import numpy as np

@jax.jit
def f(x, rng):
    if x > 0:
        y = float(x)
    a = jax.random.normal(rng, (2,))
    b = jax.random.normal(rng, (2,))
    np.log(x)
    return jnp.zeros(2, jnp.float64)
""", f"""
import torch
{IMPORT}
import numpy as np

# graphed below
def f(x, rng):
    if x > 0:
        y = float(x)
    a = torch.randn(2, generator=rng)
    b = torch.randn(2)
    np.log(x)
    return torch.zeros(2, dtype=torch.float64)
{GRAPH.format("f", "f")}
"""),
]


def _lint(lint, tmp_path: Path, name: str, source: str) -> list:
    path = tmp_path / name / "snippet.py"
    path.parent.mkdir()
    path.write_text(source)
    return lint([path])


def _rule_lines(findings) -> list[tuple[str, int]]:
    return sorted({(f.rule, f.line) for f in findings})


@pytest.mark.parametrize("name,jax_src,torch_src", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixture_gives_the_jax_rules_at_the_jax_lines(tmp_path, name,
                                                     jax_src, torch_src):
    want = _rule_lines(_lint(jax_lint_paths, tmp_path, "jax", jax_src))
    got = _rule_lines(_lint(lint_paths, tmp_path, "torch", torch_src))
    assert got == want, (name, got, want)
    assert {rule for rule, _ in got} <= set(RULES)


def test_the_port_registers_every_jax_rule_it_ports():
    ported = {r for r in JAX_RULES if r[:2] in ("TL", "TA", "CL", "EC", "DV",
                                                 "SP")}
    assert ported <= set(RULES)
    assert {"SV301", "SV302", "SV303", "SV304", "SV306", "SV307",
            "SV308"} <= set(RULES)


@pytest.mark.parametrize("source,rule", [
    ("def f(x):\n    return x.item()\n", "TL101"),
    ("def f(x):\n    if x.sum() > 0:\n        return x\n    return -x\n",
     "TL102"),
    ("def f(x):\n    return x + torch.randperm(4)\n", "TL103"),
    ("def f(x):\n    return x.uniform_()\n", "TL103"),
    ("def f(x):\n    return x.to('cpu')\n", "TL105"),
    ("def f(x):\n    torch.cuda.synchronize()\n    return x\n", "TL105"),
    ("def f(x):\n    return x + torch.tensor([1.0])\n", "TL105"),
    ("def f(x):\n    return x.numpy()\n", "TL105"),
])
def test_torch_rule_fires_in_a_graph_body_only(tmp_path, source, rule):
    graphed = f"import torch\n{IMPORT}\n{source}{GRAPH.format('f', 'f')}\n"
    assert rule in {f.rule for f in
                    _lint(lint_paths, tmp_path, "g", graphed)}
    host = f"import torch\n{source}"
    assert rule not in {f.rule for f in _lint(lint_paths, tmp_path, "h",
                                              host)}


def test_graph_seeds_follow_self_methods_partials_and_graph_blocks(tmp_path):
    source = textwrap.dedent(f"""
        import functools
        import torch
        {IMPORT}


        class Program:
            def __init__(self, graphed):
                self.step = GraphedCall(self._step, device="cuda", name="s")
                body = functools.partial(self._chunk, 1)
                self.chunk = GraphedCall(body, device="cuda", name="c")

            def _step(self, x):
                return x.item()

            def _chunk(self, n, x):
                return float(x)

            def host(self, x):
                return x.item()


        def record(graph, x):
            with torch.cuda.graph(graph):
                y = x.cpu()
            return y.item()


        class Net(torch.nn.Module):
            def forward(self, x):
                if x.max() > 1:
                    return x
                return -x
        """)
    findings = _lint(lint_paths, tmp_path, "p", source)
    lines = source.splitlines()
    got = sorted((f.rule, lines[f.line - 1].strip()) for f in findings)
    assert got == [
        ("TL101", "return float(x)"),
        ("TL101", "return x.item()"),
        ("TL102", "if x.max() > 1:"),
        ("TL105", "y = x.cpu()"),
    ]


def test_tf32_and_low_matmul_precision_are_tl104(tmp_path):
    source = ("import torch\n"
              "torch.backends.cuda.matmul.allow_tf32 = True\n"
              "torch.backends.cudnn.allow_tf32 = False\n"
              "torch.set_float32_matmul_precision('high')\n"
              "torch.set_float32_matmul_precision('highest')\n"
              "x = torch.ones(2).double()\n")
    findings = _lint(lint_paths, tmp_path, "p", source)
    assert _rule_lines(findings) == [("TL104", 2), ("TL104", 4),
                                     ("TL104", 6)]


def test_suppression_parser_reads_every_spelling():
    sup = suppressed_rules_by_line(
        "a = 1  # tracelint: disable=TL101, TL105\n"
        "b = 2  # tracelint: disable\n"
        "c = 3  # noqa: TL103\n"
        "d = 4  # mtt: disable=TL102 -- a reason\n")
    assert sup[1] == {"TL101", "TL105"} and sup[2] is None
    assert sup[3] == {"TL103"} and sup[4] == {"TL102"}
    assert is_suppressed(Finding("TL101", "m", "f", 1), sup)
    assert not is_suppressed(Finding("TL102", "m", "f", 1), sup)
    assert is_suppressed(Finding("TL102", "m", "f", 2), sup)


def test_port_tree_is_graph_clean():
    findings = lint_paths([PACKAGE_ROOT], package_root=PACKAGE_ROOT)
    assert findings == [], format_report(findings)


def test_port_graph_reaches_every_program_body_and_kernel_wrapper():
    from masters_thesis_tpu_torch.analysis.astlint import parse_sources
    from masters_thesis_tpu_torch.analysis.callgraph import CallGraph

    _, trees, _ = parse_sources([PACKAGE_ROOT], PACKAGE_ROOT)
    reached = CallGraph.build(trees).graph_functions()
    pkg = "masters_thesis_tpu_torch."
    for key in ("train.steps:TrainProgram._step",
                "train.steps:StreamProgram._step",
                "train.steps:StackedTrainProgram._step",
                "train.steps:EvalProgram._chunk",
                "serve.engine:_BucketProgram._forward",
                "serve.stacked:_StackedBucketProgram._forward",
                "models.lstm:LstmEncoder.forward",
                "ops.lstm_kernel:lstm_pair_recurrence",
                "ops.lstm_kernel:lstm_pair_ref",
                "ops.lstm_kernel:lstm_stack_ref",
                "ops.lstm_kernel:lstm_pair_fwd_cuda"):
        assert pkg + key in reached, key
    assert pkg + "train.steps:TrainProgram.begin_epoch" not in reached
    assert pkg + "train.steps:metric_means" not in reached


# ------------------------------------------------------------------- CLI


def test_cli_default_run_is_clean_on_the_cpu(capsys):
    assert cli_main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    facts = json.loads(out.splitlines()[0])["preflight"]
    assert facts["device"] == "cpu" and facts["all_reduces_per_step"] == 1.0
    assert facts["stacked"]["replicas"] == 2
    assert "TA201 not applicable on cpu" in out
    assert "TA202 not applicable on cpu" in out
    assert out.rstrip().endswith("tracelint: no findings")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
def test_cli_default_run_asks_for_the_card():
    # The audit runs on the card unless --device cpu is given: without one
    # the default run raises before it lints or audits anything.
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--skip-lint"])


def test_cli_planted_finding_exits_one(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(f"{IMPORT}\n\ndef f(x):\n    return float(x)\n\n"
                   f"{GRAPH.format('f', 'f')}\n")
    assert cli_main(["--device", "cpu", str(bad)]) == 1
    assert "TL101" in capsys.readouterr().out
    assert cli_main(["--device", "cpu", "--json", str(bad)]) == 1
    out = capsys.readouterr().out
    assert json.loads(out[out.index("\n") + 1:])[0]["rule"] == "TL101"


# ---------------------------------------------------------- trace audit


def test_synthetic_split_is_the_jax_audit_split():
    for n_factors in (1, 3):
        want = _synthetic_split(8, np.random.default_rng(0),
                                n_factors=n_factors)
        got = ta.synthetic_split(8, np.random.default_rng(0),
                                 n_factors=n_factors)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("spec", [
    None,
    ModelSpec(objective="nll", hidden_size=8, num_layers=2, dropout=0.2),
    ModelSpec(objective="mse", hidden_size=8, num_layers=1, dropout=0.0,
              n_factors=3, input_size=7),
], ids=["default", "nll_two_layers", "kfactor"])
def test_audit_is_clean_on_the_cpu(spec):
    facts: dict = {}
    findings = run_trace_audit(spec=spec, device="cpu", stacked_replicas=2,
                               facts=facts)
    assert findings == [], format_report(findings)
    assert facts["not_applicable"].keys() == {"TA201", "TA202"}
    assert facts["collectives"] == {"all_reduce_grad": facts["steps"]}
    assert facts["stacked"]["all_reduces_per_step"] == 1.0
    assert not torch.distributed.is_initialized()  # its group is left


def test_audit_reports_infrastructure_failure_as_ta205():
    class NotASpec:
        pass

    assert {f.rule for f in run_trace_audit(spec=NotASpec(),
                                            device="cpu")} == {"TA205"}
    assert {f.rule for f in run_stacked_trace_audit(
        spec=NotASpec(), device="cpu")} == {"TA205"}


def test_a_second_gradient_all_reduce_is_ta206(monkeypatch):
    real = DataMesh.all_reduce_mean_

    def twice(self, flat):
        COLLECTIVES.count("all_reduce_grad")
        return real(self, flat)

    monkeypatch.setattr(DataMesh, "all_reduce_mean_", twice)
    assert {f.rule for f in run_trace_audit(device="cpu")} == {"TA206"}
    assert {f.rule for f in run_stacked_trace_audit(device="cpu")} == {
        "TA207"}


def test_a_gather_in_the_step_is_ta203(monkeypatch):
    import torch.distributed as dist

    real = DataMesh.all_reduce_mean_

    def gathering(self, flat):
        dist.all_gather([torch.zeros_like(flat)] * self.world, flat)
        return real(self, flat)

    monkeypatch.setattr(DataMesh, "all_reduce_mean_", gathering)
    findings = run_trace_audit(device="cpu")
    assert {f.rule for f in findings} == {"TA203"}
    assert "all_gather" in findings[0].message


HOST_SYNC = ("CUDA error: operation not permitted when stream is capturing",
             "called a synchronizing CUDA operation")
NOT_HOST_SYNC = ("CUDA error: out of memory",
                 "NCCL error: unhandled system error",
                 "operation not supported during graph capture: aten::nonzero")


@pytest.mark.parametrize("cause,rule", [(m, "TA202") for m in HOST_SYNC]
                         + [(m, "TA205") for m in NOT_HOST_SYNC])
def test_only_a_host_sync_capture_failure_is_ta202(monkeypatch, cause, rule):
    # A capture fails with CaptureError("capturing <name> failed: ..."),
    # whatever the cause: only a host synchronisation is TA202; any other
    # cause means the audit could not run (TA205), and says why.
    from masters_thesis_tpu_torch.train import steps
    from masters_thesis_tpu_torch.utils.cuda_graph import CaptureError

    def failing(*args, **kwargs):
        try:
            raise RuntimeError(cause)
        except RuntimeError as err:
            raise CaptureError(f"capturing train_step failed: {err}") from err

    monkeypatch.setattr(steps, "train_step", failing)
    findings = run_trace_audit(device="cpu")
    assert [f.rule for f in findings] == [rule]
    assert cause in findings[0].message


def _raised_during(first: str, second: str, suppress: bool):
    try:
        try:
            raise RuntimeError(first)
        except RuntimeError:
            if suppress:
                raise RuntimeError(second) from None
            raise RuntimeError(second)
    except RuntimeError as err:
        return err


def test_is_host_sync_reads_the_chain():
    # A host read that fails and is then masked by another error is still
    # found; a suppressed context is not read, and an invalidated capture's
    # end (which follows any error inside it) is no host read by itself.
    read = "CUDA error: operation not permitted when stream is capturing"
    invalidated = ("CUDA error: operation failed due to a previous error "
                   "during capture")
    assert ta.is_host_sync(_raised_during(read, "out of memory", False))
    assert not ta.is_host_sync(_raised_during(read, "out of memory", True))
    assert not ta.is_host_sync(_raised_during(invalidated, "out of memory",
                                              False))
    assert not ta.is_host_sync(RuntimeError("capturing train_step failed: "
                                            "planted capture failure"))


def test_assert_trace_clean_raises_preflight_error(monkeypatch):
    monkeypatch.setattr(ta, "run_trace_audit",
                        lambda **kw: [Finding("TA201", "boom")])
    with pytest.raises(PreflightError) as exc_info:
        ta.assert_trace_clean()
    assert exc_info.value.findings[0].rule == "TA201"


# ------------------------------------------------------------ preflight


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from masters_thesis_tpu_torch.data.pipeline import bootstrap_synthetic

    root = tmp_path_factory.mktemp("preflight_data")
    bootstrap_synthetic(root, n_stocks=4, n_samples=1200, seed=0)
    return root


def _dm(data_dir):
    from masters_thesis_tpu_torch.data.pipeline import (
        FinancialWindowDataModule,
    )

    return FinancialWindowDataModule(data_dir, batch_size=4,
                                     lookback_window=10, target_window=5,
                                     stride=15)


def _kinds(run_dir: Path) -> list[dict]:
    return [json.loads(line) for line in
            (run_dir / "events.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("epoch_mode", ["scan", "stream"])
def test_trainer_preflight_writes_its_event_before_the_first_epoch(
        tmp_path, data_dir, epoch_mode):
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun
    from masters_thesis_tpu_torch.train.trainer import Trainer

    tel = TelemetryRun(tmp_path / "tel", run_id="preflight")
    trainer = Trainer(max_epochs=1, device="cpu", telemetry=tel,
                      preflight=True, epoch_mode=epoch_mode)
    trainer.fit(ModelSpec(objective="mse", hidden_size=8, num_layers=1),
                _dm(data_dir))
    tel.close()
    events = _kinds(tmp_path / "tel")
    kinds = [e["kind"] for e in events]
    assert kinds.index("preflight") < kinds.index("epoch")
    preflight = events[kinds.index("preflight")]
    if epoch_mode == "scan":
        assert preflight["status"] == "ok"
    else:
        assert preflight == dict(preflight, status="skipped",
                                 reason="epoch_mode=stream")


def test_failed_preflight_raises_before_any_epoch(tmp_path, data_dir,
                                                  monkeypatch):
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun
    from masters_thesis_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(ta, "run_trace_audit",
                        lambda **kw: [Finding("TA202", "planted host read")])
    tel = TelemetryRun(tmp_path / "tel", run_id="failed")
    trainer = Trainer(max_epochs=1, device="cpu", telemetry=tel,
                      preflight=True)
    with pytest.raises(PreflightError):
        trainer.fit(ModelSpec(objective="mse", hidden_size=8, num_layers=1),
                    _dm(data_dir))
    tel.close()
    events = _kinds(tmp_path / "tel")
    assert "epoch" not in [e["kind"] for e in events]
    failed = next(e for e in events if e["kind"] == "preflight")
    assert failed["status"] == "failed" and failed["rules"] == ["TA202"]


def test_stacked_trainer_preflight_audits_the_stacked_step(tmp_path,
                                                           data_dir):
    from masters_thesis_tpu_torch.telemetry.run import TelemetryRun
    from masters_thesis_tpu_torch.train.stacked import (
        ReplicaSpec,
        StackedTrainer,
    )

    tel = TelemetryRun(tmp_path / "tel", run_id="stacked")
    trainer = StackedTrainer(max_epochs=1, device="cpu", telemetry=tel,
                             preflight=True)
    trainer.fit(ModelSpec(objective="mse", hidden_size=8, num_layers=1),
                _dm(data_dir), [ReplicaSpec("a", 0, 1e-3),
                                ReplicaSpec("b", 1, 1e-4)])
    tel.close()
    events = _kinds(tmp_path / "tel")
    kinds = [e["kind"] for e in events]
    assert kinds.index("preflight") < kinds.index("epoch")
    preflight = events[kinds.index("preflight")]
    assert preflight["status"] == "ok" and preflight["stacked_replicas"] == 2
