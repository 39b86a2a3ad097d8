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

REPO = Path(__file__).resolve().parent.parent


def _port_modules() -> list[str]:
    pkg = masters_thesis_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
    ]


def test_port_imports_with_jax_blocked():
    modules = _port_modules() + ["chip_smoke"]
    for name in ("serve.server", "train.trainer", "train.checkpoint",
                 "train.flatparams", "data.pipeline", "ops.losses",
                 "ops.linalg", "evaluation"):
        assert f"masters_thesis_tpu_torch.{name}" in modules
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'masters_thesis_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"import importlib\nfor m in {modules!r}:\n    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'masters_thesis_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


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
    assert names == {"lstm_fwd", "lstm_bwd", "lstm_stack", "lstm_tb"}
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
