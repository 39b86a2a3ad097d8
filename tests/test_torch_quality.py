"""The port's model-quality plane against the JAX package's, on the CPU.

The port's ``telemetry/quality.py`` is a copy of the JAX module: on the
same numpy inputs, made from a seed, its sketches, PSI, KS, shadow OLS,
golden windows, fingerprints (their JSON byte for byte), gate verdicts and
monitor scores are the JAX module's exactly. The fingerprint the port's
``Trainer`` writes at checkpoint time is held against JAX
``build_fingerprint`` over JAX ``forward_rows`` on the same weights
(carried across by ``models/convert.py``): its alpha and beta sketches
within 1e-5 abs (f32 forwards summed in another order). The swap gate
gives the JAX swapper's reason on a calm, a diverged and a malformed
candidate, and the serving monitor samples 1 in K delivered answers.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.serve import swap as jax_swap
from masters_thesis_tpu.serve.engine import PredictEngine as JaxEngine
from masters_thesis_tpu.telemetry import quality as jq
from masters_thesis_tpu.train.checkpoint import save_checkpoint as jax_save
from masters_thesis_tpu.train.steps import forward_rows as jax_forward_rows
from masters_thesis_tpu_torch.data.pipeline import (
    FinancialWindowDataModule,
    bootstrap_synthetic,
)
from masters_thesis_tpu_torch.models.convert import params_from_jax
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.serve.engine import PredictEngine
from masters_thesis_tpu_torch.serve.server import PredictServer
from masters_thesis_tpu_torch.serve.swap import CheckpointSwapper
from masters_thesis_tpu_torch.telemetry import quality as q
from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.telemetry.run import TelemetryRun
from masters_thesis_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from masters_thesis_tpu_torch.train.manifest import verify_checkpoint
from masters_thesis_tpu_torch.train.trainer import Trainer

K, T, F, H = 4, 8, 3, 8
REPO = Path(__file__).resolve().parent.parent


def _windows(n, n_stocks=6, lookback=32, n_features=3, scale=1.0,
             offset=0.0, seed=11):
    g = np.random.default_rng(seed)
    xs = g.standard_normal((n, n_stocks, lookback, n_features))
    return (xs * scale + offset).astype(np.float32)


# ------------------------------------------------------------ the copy


@pytest.mark.parametrize("seed", [0, 3])
def test_sketches_psi_and_ks_equal_the_jax_module(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(500)
    b = rng.standard_normal(300) * 1.7 + 0.4
    b[::37] = np.nan
    for values in (a, b):
        assert (q.StreamSketch.from_values(values).summary()
                == jq.StreamSketch.from_values(values).summary())
        ours, theirs = q.StreamSketch(), jq.StreamSketch()
        for chunk in np.array_split(values, 7):
            ours.update(chunk)
            theirs.update(chunk)
        assert ours.summary() == theirs.summary()
        assert (q.sketch_to_json(ours.summary())
                == jq.sketch_to_json(theirs.summary()))
    ref = q.StreamSketch.from_values(a).summary()
    live = q.StreamSketch.from_values(b).summary()
    assert q.psi(ref, live) == jq.psi(ref, live)
    assert q.ks(ref, live) == jq.ks(ref, live)


@pytest.mark.parametrize("n_features", [3, 7])
def test_shadow_ols_golden_windows_and_fingerprint_equal_the_jax_module(
        n_features):
    """n_features 7 is the K = 3 factor layout (a loading a factor)."""
    x = _windows(12, n_stocks=K, lookback=T, n_features=n_features)
    assert q.infer_factors(n_features) == jq.infer_factors(n_features)
    for got, want in zip(q.shadow_ols(x), jq.shadow_ols(x)):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(1)
    alpha = rng.normal(size=(12, K))
    beta = rng.normal(size=(12, K))
    assert q.shadow_error(x, alpha, beta) == jq.shadow_error(x, alpha, beta)
    np.testing.assert_array_equal(q.golden_windows(5, K, T, n_features, 4),
                                  jq.golden_windows(5, K, T, n_features, 4))
    gx = q.golden_windows(6, K, T, n_features, seed=0)
    golden = (gx, rng.normal(size=(6, K)), rng.normal(size=(6, K)))
    got = q.build_fingerprint(x, alpha, beta, golden=golden, golden_seed=0)
    want = jq.build_fingerprint(x, alpha, beta, golden=golden, golden_seed=0)
    assert q.fingerprint_to_json(got) == jq.fingerprint_to_json(want)


def _gate_case(kind):
    """(fingerprint, golden x, candidate alpha, beta, live) of a calm, a
    drifted, an OLS-disagreeing, an unfingerprinted far-from-live and a
    malformed candidate."""
    gx = q.golden_windows(16, K, T, F, seed=0)
    ga, gb = q.shadow_ols(gx)
    fp = q.build_fingerprint(gx, ga, gb, golden=(gx, ga, gb), golden_seed=0)
    live = {"sampled": 10, "alpha": q.StreamSketch.from_values(ga).summary(),
            "beta": q.StreamSketch.from_values(gb).summary(),
            "shadow_err": 0.0}
    if kind == "calm":
        return fp, gx, ga, gb, live
    if kind == "drifted":
        return fp, gx, ga * 50.0 + 5.0, gb * 50.0, live
    if kind == "shadow":
        # The fingerprint claims these outputs' sketches but a shadow
        # disagreement of 0: the budget falls to its floor.
        shifted = q.build_fingerprint(gx, ga + 3.0, gb,
                                      golden=(gx, ga + 3.0, gb), golden_seed=0)
        shifted["golden"]["shadow_err"] = 0.0
        return shifted, gx, ga + 3.0, gb, None
    if kind == "live_only":
        return None, gx, ga + 5.0, gb + 5.0, live
    return {"golden": {"shape": [16, K, T, F]}}, gx, ga, gb, None


@pytest.mark.parametrize("kind", ["calm", "drifted", "shadow", "live_only",
                                  "malformed"])
def test_quality_gate_gives_the_jax_verdicts(kind):
    fp, gx, ga, gb, live = _gate_case(kind)

    def verdict(module):
        try:
            return module.quality_gate(fp, gx, ga, gb, live=live)
        except Exception as exc:  # noqa: BLE001 -- compared as the swap does
            return type(exc).__name__

    got, want = verdict(q), verdict(jq)
    assert got == want
    expected = {"calm": True, "drifted": "quality_self",
                "shadow": "quality_shadow", "live_only": "quality_live",
                "malformed": "KeyError"}[kind]
    if expected is True:
        assert got[0] is True
    elif expected == "KeyError":
        assert got == "KeyError"
    else:
        assert got[1] == expected


def test_quality_monitor_scores_equal_the_jax_monitor():
    """The same reference and sample stream (an IID half then a shifted
    half) through both monitors: every sampled window's scores, the live
    summaries and the re-baseline after set_reference agree exactly."""
    ref_x = _windows(64, seed=11)
    ref = q.build_fingerprint(ref_x, *q.shadow_ols(ref_x))
    ours = q.QualityMonitor(ref, sample_every=2, min_samples=4)
    theirs = jq.QualityMonitor(ref, sample_every=2, min_samples=4)
    xs = np.concatenate([_windows(20, seed=12),
                         _windows(20, scale=2.0, offset=1.0, seed=13)])
    a, b = q.shadow_ols(xs)
    for i in range(len(xs)):
        assert ours.sample(xs[i], a[i], b[i]) == theirs.sample(xs[i], a[i], b[i])
    assert ours.live_summaries() == theirs.live_summaries()
    assert ours.last_scores() == theirs.last_scores()
    assert ours.last_scores()["input_breached"]
    ours.set_reference(None)
    theirs.set_reference(None)
    assert ours.live_summaries() == theirs.live_summaries() == {}


def test_read_fingerprint_reads_the_port_tree(tmp_path):
    """quality.json beside state.pt, inside a published tree covered by
    its manifest; a torn or doctored copy fails strict verification; the
    pair rotates to .prev with the next save; a missing or torn file reads
    as None."""
    x = _windows(8, n_stocks=K, lookback=T)
    fp = q.build_fingerprint(x, *q.shadow_ols(x))
    state = params_from_jax(_params(0))
    extra = {q.FINGERPRINT_FILENAME: q.fingerprint_to_json(fp)}
    tree = save_checkpoint(tmp_path, "best", state, spec=_spec(),
                           extra_files=extra)
    assert q.read_fingerprint(tree) == fp == jq.read_fingerprint(tree)
    manifest = json.loads((tree / "MANIFEST.json").read_text())
    assert q.FINGERPRINT_FILENAME in manifest["files"]
    assert verify_checkpoint(tree, require_manifest=True)
    save_checkpoint(tmp_path, "best", state, spec=_spec())
    assert q.read_fingerprint(tmp_path / "best.prev") == fp
    assert q.read_fingerprint(tmp_path / "best") is None
    (tmp_path / "best.prev" / q.FINGERPRINT_FILENAME).write_text('{"torn"')
    assert q.read_fingerprint(tmp_path / "best.prev") is None
    assert not verify_checkpoint(tmp_path / "best.prev", require_manifest=True)


# ---------------------------------------------- the trainer's fingerprint


def _jax_spec(hidden=H, layers=2):
    return JaxSpec(objective="mse", hidden_size=hidden, num_layers=layers,
                   dropout=0.0, kernel_impl="xla")


def _spec(hidden=H, layers=2, **kw):
    return ModelSpec(objective="mse", hidden_size=hidden, num_layers=layers,
                     dropout=0.0, **kw)


def _params(seed, hidden=H, layers=2):
    params = _jax_spec(hidden, layers).build_module().init(
        jax.random.key(seed), jnp.zeros((1, T, F), jnp.float32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _to_jax(state):
    """A port state dict as the flax tree ``params_from_jax`` reads."""
    tree = {}
    for name, value in state.items():
        head, _, leaf = name.partition(".")
        if leaf:
            tree.setdefault(head, {})["kernel" if leaf == "weight"
                                      else "bias"] = (
                value.numpy().T if leaf == "weight" else value.numpy())
        else:
            tree[name] = value.numpy()
    return tree


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("quality_data")
    bootstrap_synthetic(root, n_stocks=K, n_samples=1200, seed=0)
    return root


def _dm(data_dir):
    return FinancialWindowDataModule(data_dir, batch_size=4, lookback_window=T,
                                     target_window=5, stride=T + 5)


def _sketch_close(got, want):
    assert got["count"] == want["count"]
    for key in ("mean", "var", "min", "max"):
        assert got[key] == pytest.approx(want[key], abs=1e-5, rel=0), key
    np.testing.assert_allclose(got["quantiles"], want["quantiles"], atol=1e-5,
                               rtol=0)


def test_trainer_fingerprint_matches_jax_build_fingerprint(data_dir, tmp_path):
    """Trainer.fit with a checkpoint directory writes quality.json into
    best/ and last/ (manifest-covered) with a quality_fingerprint event a
    save; its sketches are JAX build_fingerprint over JAX forward_rows on
    the saved weights, within 1e-5."""
    tel = TelemetryRun(tmp_path / "tel", run_id="fp")
    trainer = Trainer(max_epochs=2, device="cpu", seed=0, telemetry=tel,
                      ckpt_dir=tmp_path / "ck")
    trainer.fit(_spec(learning_rate=1e-2), _dm(data_dir))
    tel.close()
    dm = _dm(data_dir)
    dm.setup("fit")
    qx = np.asarray(dm.val_arrays().x[:128], np.float32)
    gx = jq.golden_windows(32, *qx.shape[1:], seed=0)
    module = _jax_spec().build_module()
    for tag in ("best", "last"):
        tree = tmp_path / "ck" / tag
        assert verify_checkpoint(tree, require_manifest=True)
        manifest = json.loads((tree / "MANIFEST.json").read_text())
        assert q.FINGERPRINT_FILENAME in manifest["files"]
        got = q.read_fingerprint(tree)
        state, _, _, _ = restore_checkpoint(tmp_path / "ck", tag)
        params = _to_jax(state)

        def predict(x):
            a, b = jax_forward_rows(module, params, jnp.asarray(x))
            return np.asarray(a)[..., 0], np.asarray(b)[..., 0]

        a_v, b_v = predict(qx)
        a_g, b_g = predict(gx)
        want = jq.build_fingerprint(qx, a_v, b_v, golden=(gx, a_g, b_g),
                                    golden_seed=0)
        assert got["windows"] == want["windows"] == len(qx)
        assert got["golden"]["shape"] == want["golden"]["shape"] == [32, K, T, F]
        assert got["features"] == want["features"]
        for section in (got, got["golden"]):
            other = want if section is got else want["golden"]
            _sketch_close(section["alpha"], other["alpha"])
            _sketch_close(section["beta"], other["beta"])
    events = read_events(tmp_path / "tel" / "events.jsonl")
    saves = [e for e in events if e["kind"] == "checkpoint_saved"]
    prints = [e for e in events if e["kind"] == "quality_fingerprint"]
    assert len(prints) == len(saves) >= 3
    assert all(p["windows"] == len(qx) for p in prints)
    timed = next(e["metrics"] for e in reversed(events)
                 if e["kind"] == "metrics")["quality/fingerprint_s"]
    assert timed["count"] == len(saves) and timed["sum"] > 0


def test_a_failing_fingerprint_saves_without_it(data_dir, tmp_path,
                                                monkeypatch, capsys):
    """A fingerprint that raises prints one line a save and the checkpoint
    is published without quality.json, as the JAX trainer does."""
    import masters_thesis_tpu_torch.train.trainer as trainer_mod

    def boom(*args):
        raise RuntimeError("no sketch today")

    monkeypatch.setattr(trainer_mod, "fingerprint", boom)
    Trainer(max_epochs=1, device="cpu", ckpt_dir=tmp_path / "ck",
            enable_progress_bar=True).fit(_spec(), _dm(data_dir))
    out = capsys.readouterr().out
    assert "quality fingerprint failed for 'best': no sketch today" in out
    for tag in ("best", "last"):
        assert q.read_fingerprint(tmp_path / "ck" / tag) is None
        assert verify_checkpoint(tmp_path / "ck" / tag, require_manifest=True)


# --------------------------------------------------------- the swap gate


def _save_both(root, params, extra_files=None):
    jax_dir, port_dir = root / "jax", root / "port"
    meta = {"epoch": 1, "datamodule": {"lookback_window": T}}
    jax_save(jax_dir, "best", params, {}, _jax_spec(), meta=meta,
             extra_files=extra_files)
    save_checkpoint(port_dir, "best", params_from_jax(params), spec=_spec(),
                    meta=meta, extra_files=extra_files)
    return jax_dir, port_dir


def _honest_fingerprint(engine, params, scale=1.0):
    """The fingerprint a trainer would ship for ``params`` (its outputs on
    the seed-0 golden windows, times ``scale`` for a diverged claim)."""
    gx = q.golden_windows(8, K, T, F, seed=0)
    staged = engine.put_params(params_from_jax(params))
    ga, gb = (np.concatenate(parts) for parts in zip(
        *(engine.predict(gx[i:i + 4], params=staged) for i in (0, 4))))
    ga, gb = ga * scale + (scale - 1.0), gb * scale
    fp = q.build_fingerprint(gx, ga, gb, golden=(gx, ga, gb), golden_seed=0)
    return {q.FINGERPRINT_FILENAME: q.fingerprint_to_json(fp)}


@pytest.mark.parametrize("case", ["calm", "diverged", "live_only"])
def test_swap_quality_gate_gives_the_jax_swappers_reason(tmp_path, case):
    """The port's try_swap and the JAX swapper on the same candidates: an
    honest fingerprint commits (and re-baselines the monitor), one that
    claims outputs 50 times the candidate's is refused as quality_self,
    and with no fingerprint a candidate far from the live sketch is refused
    as quality_live; the serving answers stay put on a refusal."""
    _, live_port = _save_both(tmp_path / "live", _params(0))
    ours = PredictEngine.from_checkpoint(live_port, n_stocks=K, device="cpu",
                                         buckets=(1, 4))
    ours.warmup()
    cand = _params(7)
    if case == "live_only":
        cand["alpha_head"]["bias"] = cand["alpha_head"]["bias"] + 40.0
        extra = None
    else:
        extra = _honest_fingerprint(ours, cand,
                                    50.0 if case == "diverged" else 1.0)
    cand_jax, cand_port = _save_both(tmp_path / "cand", cand, extra)
    mon = q.QualityMonitor(None, sample_every=1, min_samples=2)
    jmon = jq.QualityMonitor(None, sample_every=1, min_samples=2)
    x = _windows(4, n_stocks=K, lookback=T)
    for i in range(4):
        a, b = ours.predict(x[i:i + 1])
        mon.sample(x[i], a[0], b[0])
        jmon.sample(x[i], a[0], b[0])
    theirs = JaxEngine.from_checkpoint(tmp_path / "live" / "jax", n_stocks=K,
                                       buckets=(1, 4))
    theirs.warmup()
    before = ours.predict(x)
    got = CheckpointSwapper(ours, quality_monitor=mon).try_swap(cand_port)
    want = jax_swap.CheckpointSwapper(theirs, quality_monitor=jmon).try_swap(
        cand_jax)
    assert got.reason == want.reason == {
        "calm": "committed", "diverged": "quality_self",
        "live_only": "quality_live"}[case]
    assert sorted(k for k in got.checks if k.startswith("quality_")) == sorted(
        k for k in want.checks if k.startswith("quality_"))
    if got.ok:
        assert mon.reference == q.read_fingerprint(cand_port / "best")
    else:
        for a, b in zip(ours.predict(x), before):
            np.testing.assert_array_equal(a, b)
        assert mon.reference is None


def test_server_samples_one_in_k_delivered_answers(tmp_path):
    """A PredictServer with a QualityMonitor hands it every delivered
    answer after the hand-back, the monitor keeps 1 in K, and a
    quality_sample event goes into the run's stream for each; without a
    monitor the answers are the same."""
    _, port_dir = _save_both(tmp_path / "live", _params(0))
    x = _windows(12, n_stocks=K, lookback=T)
    answers = {}
    for with_monitor in (True, False):
        engine = PredictEngine.from_checkpoint(port_dir, n_stocks=K,
                                               device="cpu", buckets=(1,))
        tel = TelemetryRun(tmp_path / f"tel{with_monitor}", run_id="serve")
        mon = (q.QualityMonitor(None, sample_every=3, min_samples=1,
                                telemetry=tel) if with_monitor else None)
        server = PredictServer(engine, telemetry=tel, quality_monitor=mon,
                               max_batch=1)
        server.start()
        try:
            got = [server.submit(x[i], deadline_s=30.0).result(timeout=60)
                   for i in range(len(x))]
        finally:
            server.stop()
            tel.close()
        answers[with_monitor] = [(r.status, *r.outputs) for r in got]
        samples = [e for e in read_events(tel.run_dir / "events.jsonl")
                   if e["kind"] == "quality_sample"]
        assert len(samples) == (4 if with_monitor else 0)
    for (s1, a1, b1), (s2, a2, b2) in zip(answers[True], answers[False]):
        assert s1 == s2 == "ok"
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(b1, b2)


# ---------------------------------------------------------------- the CLI


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch.telemetry", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120)


def test_quality_cli_on_a_run(tmp_path):
    """``quality --selfcheck`` passes; a run whose monitor breached with no
    alert exits 2 naming the contract, the same events with the alert
    exit 0; no root exits 1."""
    assert _cli("quality", "--selfcheck").returncode == 0
    assert _cli("quality", str(tmp_path / "missing")).returncode == 1
    ref_x = _windows(64, seed=11)
    for alerted in (False, True):
        tel = TelemetryRun(tmp_path / f"run{alerted}", run_id="q")
        mon = q.QualityMonitor(q.build_fingerprint(ref_x, *q.shadow_ols(ref_x)),
                               sample_every=1, min_samples=2, telemetry=tel)
        xs = _windows(12, seed=12)
        a, b = q.shadow_ols(xs)
        for i in range(len(xs)):
            mon.sample(xs[i], a[i] + 5.0, b[i])
        # An SLO engine was attached: the contract applies.
        tel.event("slo_snapshot", firing=[], ticks=1, events_seen=12)
        if alerted:
            tel.event("alert_fired", rule="shadow", slo_kind="shadow_disagreement",
                      value=5.0, threshold=0.5)
        tel.close()
        proc = _cli("quality", str(tel.run_dir), "--json")
        report = json.loads(proc.stdout)
        assert report["quality"]["samples"] == 12
        assert report["quality"]["breaches"]["shadow"] > 0
        assert proc.returncode == 2
        assert bool(report["violations"]) is not alerted
