"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on CUDA unless told to use the CPU."""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import masters_thesis_tpu_torch
from masters_thesis_tpu_torch import resolve_device
from masters_thesis_tpu_torch.models.lstm import LstmEncoder
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.ops import _build
from masters_thesis_tpu_torch.serve.engine import PredictEngine
from masters_thesis_tpu_torch.serve.server import PredictServer
from masters_thesis_tpu_torch.serve.stacked import StackedPredictEngine
from masters_thesis_tpu_torch.train.stacked import StackedTrainer

REPO = Path(__file__).resolve().parent.parent


def _port_modules() -> list[str]:
    pkg = masters_thesis_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
    ]


def test_port_imports_with_jax_blocked():
    modules = _port_modules() + ["chip_smoke"]
    for name in ("serve.server", "train.trainer", "train.checkpoint",
                 "train.flatparams", "train.logging", "data.pipeline",
                 "ops.losses", "ops.linalg", "evaluation", "config.compose",
                 "config.yaml_subset", "cli.train", "cli.test", "__main__",
                 "resilience.faults", "train.manifest", "data.fama_french",
                 "data.prefetch", "serve.spans", "serve.swap",
                 "serve.preflight", "serve.__main__", "serve.program_cache",
                 "analysis.findings",
                 "telemetry.registry", "telemetry.events", "telemetry.trace",
                 "telemetry.run", "telemetry.exposition",
                 "data.window_store", "native", "native.build",
                 "native.engine", "train.stacked", "serve.stacked",
                 "cli.stacked", "telemetry.flightrec", "telemetry.costs",
                 "telemetry.profiling", "telemetry.report",
                 "telemetry.quality", "telemetry.slo", "telemetry.__main__",
                 "resilience.backoff", "resilience.supervisor",
                 "resilience.__main__", "parallel", "parallel.mesh",
                 "parallel.launch", "utils.backend_probe", "utils.io",
                 "utils.cuda_graph", "train.steps", "models.objectives",
                 "telemetry.schedule", "telemetry.aggregate",
                 "resilience.fleetsup", "serve.fleet", "telemetry.watch",
                 "telemetry.signals", "utils.counts", "analysis",
                 "analysis.__main__", "analysis.astlint", "analysis.callgraph",
                 "analysis.concurrency", "analysis.contracts",
                 "analysis.spmd", "analysis.traceaudit", "viz", "viz.plots",
                 "telemetry.ledger", "utils.compilation_cache"):
        assert f"masters_thesis_tpu_torch.{name}" in modules
    # matplotlib is blocked too: the card's machine has none, and the
    # figure modules import it only where they draw.
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'yaml',\n"
        "             'masters_thesis_tpu', 'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        f"import importlib\nfor m in {modules!r}:\n    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'yaml', 'masters_thesis_tpu',\n"
        "        'matplotlib')\n"
        "       and sys.modules[m]]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_every_jax_module_has_a_counterpart():
    """Each module file of the JAX package has one of the same path in the
    port."""
    def files(root: Path) -> set[str]:
        return {str(p.relative_to(root)) for p in root.rglob("*.py")}

    missing = files(REPO / "masters_thesis_tpu") - files(
        REPO / "masters_thesis_tpu_torch")
    assert not missing, sorted(missing)


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ModelSpec(objective="mse", hidden_size=4, num_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LstmEncoder(hidden_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.build_module()
    state = spec.build_module(device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PredictEngine(spec, state, n_stocks=2, lookback=3)
    engine = PredictEngine(spec, state, n_stocks=2, lookback=3, device="cpu")
    assert engine.platform == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StackedTrainer(max_epochs=1)
    pair = ModelSpec(objective="mse", hidden_size=4, num_layers=2)
    lanes = [pair.build_module(device="cpu").state_dict()] * 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StackedPredictEngine(pair, lanes, n_stocks=2, lookback=3)
    stacked = StackedPredictEngine(pair, lanes, n_stocks=2, lookback=3,
                                   device="cpu")
    assert stacked.platform == "cpu" and stacked.num_lanes == 2
    assert PredictServer(engine).max_batch == engine.max_bucket
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(_build.NvccError, match="nvcc not found"):
        _build.build_all()


def test_build_covers_every_cuda_source(monkeypatch, tmp_path):
    names = {src.stem for src in _build.sources()}
    assert names == {"lstm_fwd", "lstm_bwd", "lstm_stack", "lstm_stack_bwd",
                     "lstm_tb", "lstm_fwd_bf16", "lstm_bwd_bf16",
                     "lstm_stack_bf16", "lstm_stack_bwd_bf16"}
    for src in _build.sources():
        lib = _build.library_path(src)
        assert lib.parent == _build.BUILD_DIR and src.stem in lib.name
    # The shared header is part of every library's name: editing it rebuilds.
    src = _build.CSRC_DIR / "lstm_bwd.cu"
    before = _build.library_path(src)
    for path in [src] + sorted(_build.CSRC_DIR.glob("*.cuh")):
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    assert _build.library_path(tmp_path / src.name) == before
    (tmp_path / "lstm_common.cuh").write_text("// changed\n")
    assert _build.library_path(tmp_path / src.name) != before


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_fleet_command_lines_import_no_torch():
    """The fleet supervisor and the fleet views read runs where no torch
    may be imported: both command lines' selfchecks with torch blocked."""
    code = (
        "import sys\n"
        "for name in ('torch', 'jax', 'jaxlib', 'flax', 'masters_thesis_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import masters_thesis_tpu_torch.resilience.fleetsup\n"
        "import masters_thesis_tpu_torch.telemetry.aggregate\n"
        "from masters_thesis_tpu_torch.telemetry.__main__ import main\n"
        "assert main(['postmortem', '--selfcheck']) == 0\n"
        "from masters_thesis_tpu_torch.resilience.__main__ import main\n"
        "assert main(['fleet', '--selfcheck']) == 0\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("MTT_FAULT_PLAN", "MTT_ATTEMPT")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "postmortem selfcheck ok" in proc.stdout
    assert "fleet selfcheck: 2 scenarios OK" in proc.stdout
