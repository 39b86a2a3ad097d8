"""The port's run telemetry against the JAX package's on the CPU.

A toy ``Trainer.fit`` of each package with telemetry on (4 stocks x 1,200
samples of the synthetic DGP, lookback 10, target 5, stride 15, H=8, 2
layers, 2 epochs): the same event kinds carry the same payload keys, the
JAX report reads the port's stream with no violation, and the two reports
agree field for field. The port's reader against the JAX reader on the
same event lists (a training run, a supervised two-attempt run, a serving
run, a stacked run, a run that captured twice), text line for line. The
cost model against ``PERF.md`` §6's bound column, the profiler window, the
capture tracker, and the flight recorder (the JAX recorder's cases; a
SIGTERM to a child).

Exact where the arithmetic is the same. The exceptions, each named below:
the kinds only the JAX trainer writes here, the roofline fields that
follow from the peaks (the JAX table has CPU peaks, the port's only the
H100's), and the keys that have no meaning on one card, written as the JAX
trainer writes them on one device.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from masters_thesis_tpu.data.pipeline import (
    FinancialWindowDataModule as JaxDataModule,
)
from masters_thesis_tpu.data.pipeline import bootstrap_synthetic as jax_bootstrap
from masters_thesis_tpu.models.objectives import ModelSpec as JaxSpec
from masters_thesis_tpu.telemetry import flightrec as jax_flightrec
from masters_thesis_tpu.telemetry import report as jax_report
from masters_thesis_tpu.telemetry.__main__ import main as jax_cli
from masters_thesis_tpu.telemetry.events import read_events as jax_read_events
from masters_thesis_tpu.telemetry.profiling import (
    ProfilerWindow as JaxProfilerWindow,
)
from masters_thesis_tpu.telemetry.run import TelemetryRun as JaxTelemetryRun
from masters_thesis_tpu.train.trainer import Trainer as JaxTrainer
from masters_thesis_tpu_torch.data.pipeline import (
    FinancialWindowDataModule,
    bootstrap_synthetic,
)
from masters_thesis_tpu_torch.models.objectives import ModelSpec
from masters_thesis_tpu_torch.telemetry import costs, flightrec, report
from masters_thesis_tpu_torch.telemetry.__main__ import main as port_cli
from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.telemetry.run import (
    CaptureTracker,
    EpochRecorder,
    TelemetryRun,
)
from masters_thesis_tpu_torch.train.stacked import ReplicaSpec, StackedTrainer
from masters_thesis_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
WINDOWS = dict(lookback_window=10, target_window=5, stride=15)
HPARAMS = dict(objective="mse", hidden_size=8, num_layers=2, dropout=0.2,
               learning_rate=1e-3)
ENVELOPE = ("ts", "kind", "run", "seq", "host", "pid", "proc", "nproc",
            "attempt", "generation")
#: Kinds only the JAX trainer writes in this run: the gradient all-reduce
#: count (multi-device, ROADMAP queue 1 item 3) and device memory (the
#: port samples the card's allocator, and the CPU has none). Both write
#: the collective-schedule chain.
JAX_ONLY_KINDS = {"grad_sync", "memory"}
#: run_started keys with no meaning on one card, and the values the JAX
#: trainer writes for one device.
ONE_DEVICE = {"n_devices": 1, "strategy": "single_device",
              "distributed": {"process_index": None, "process_count": None,
                              "coordinator": None}}
#: Report fields that follow from the platform's peaks: the JAX table has
#: peaks for the CPU, the port's for the H100 only (n/a elsewhere).
PEAK_FIELDS = ("flops_utilization_pct", "bytes_utilization_pct", "regime",
               "nominal_peaks")


def _payload_keys(ev: dict) -> set:
    return {k for k in ev if k not in ENVELOPE}


def _without_peaks(rep: dict) -> dict:
    rep = dict(rep)
    if rep.get("utilization"):
        rep["utilization"] = {k: v for k, v in rep["utilization"].items()
                              if k not in PEAK_FIELDS}
    return rep


def _text_lines(rep: dict, render) -> list[str]:
    return [ln for ln in render(rep).splitlines()
            if not ln.startswith("utilization")]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The toy fit and test of each package with telemetry on."""
    root = tmp_path_factory.mktemp("fits")
    jax_bootstrap(root / "jax", n_stocks=4, n_samples=1200, seed=0)
    bootstrap_synthetic(root / "port", n_stocks=4, n_samples=1200, seed=0)
    jdm = JaxDataModule(root / "jax", batch_size=4, engine="python", **WINDOWS)
    jtel = JaxTelemetryRun(root / "jax_tel", run_id="jax")
    jtrainer = JaxTrainer(max_epochs=2, gradient_clip_val=5.0,
                          strategy="single_device", enable_progress_bar=False,
                          enable_model_summary=False, telemetry=jtel,
                          ckpt_dir=root / "jax_ck")
    want = jtrainer.fit(JaxSpec(**HPARAMS), jdm)
    jtrainer.test(JaxSpec(**HPARAMS), want.params, jdm)
    jtel.close()
    dm = FinancialWindowDataModule(root / "port", batch_size=4, **WINDOWS)
    tel = TelemetryRun(root / "port_tel", run_id="port")
    trainer = Trainer(max_epochs=2, gradient_clip_val=5.0, device="cpu",
                      telemetry=tel, ckpt_dir=root / "port_ck")
    got = trainer.fit(ModelSpec(**HPARAMS), dm)
    trainer.test(ModelSpec(**HPARAMS), got.state, dm)
    tel.close()
    return {"jax": root / "jax_tel", "port": root / "port_tel",
            "result": got, "root": root}


def test_event_kinds_carry_the_jax_payload_keys(fits):
    ours = read_events(fits["port"] / "events.jsonl")
    theirs = jax_read_events(fits["jax"] / "events.jsonl")
    our_kinds = {e["kind"] for e in ours}
    their_kinds = {e["kind"] for e in theirs}
    assert their_kinds - our_kinds == JAX_ONLY_KINDS
    assert our_kinds <= their_kinds
    for kind in our_kinds:
        mine = {frozenset(_payload_keys(e)) for e in ours if e["kind"] == kind}
        want = {frozenset(_payload_keys(e)) for e in theirs
                if e["kind"] == kind}
        if kind == "span":  # the same span names on both sides
            assert ({e["name"] for e in ours if e["kind"] == "span"}
                    == {e["name"] for e in theirs if e["kind"] == "span"})
        assert mine == want, kind
    started = next(e for e in ours if e["kind"] == "run_started")
    for key, value in ONE_DEVICE.items():
        assert started[key] == value
    assert started["platform"] == "cpu"
    saves = [e for e in ours if e["kind"] == "checkpoint_saved"]
    assert saves and all(e["wall_s"] > 0 for e in saves)


def test_a_cpu_run_reads_no_card_on_a_card_host(fits, tmp_path,
                                                monkeypatch):
    # A host with a card, where any read of the card fails the test: a
    # --device cpu run with telemetry on samples no card memory and opens
    # no CUDA context.
    def no_card(*args, **kwargs):
        raise AssertionError("a CPU run read the card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("mem_get_info", "memory_allocated", "max_memory_allocated",
                 "memory_stats", "_lazy_init", "init"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    dm = FinancialWindowDataModule(fits["root"] / "port", batch_size=4,
                                   **WINDOWS)
    tel = TelemetryRun(tmp_path / "tel", run_id="cpu")
    trainer = Trainer(max_epochs=1, gradient_clip_val=5.0, device="cpu",
                      telemetry=tel)
    trainer.fit(ModelSpec(**HPARAMS), dm)
    assert tel.sample_memory(0, "cpu") is None
    tel.close()
    kinds = {e["kind"] for e in read_events(tmp_path / "tel" / "events.jsonl")}
    assert "epoch" in kinds and "memory" not in kinds
    assert not torch.cuda.is_initialized()


def test_jax_report_reads_the_port_stream_and_agrees(fits):
    theirs = jax_report.summarize_path(fits["port"])
    ours = report.summarize_path(fits["port"])
    assert theirs["violations"] == [] and ours["violations"] == []
    assert _without_peaks(ours) == _without_peaks(theirs)
    assert ours["epochs"] == 2 and ours["compiles"]["train_epoch"] == 0
    assert ours["steps_per_sec"] == pytest.approx(
        fits["result"].steps_per_sec, rel=1e-12)
    # The analytic cost is there; on the CPU it has no peaks.
    util = ours["utilization"]
    assert util["source"] == "analytic" and util["flops_per_step"] > 0
    assert util["nominal_peaks"] is None and util["regime"] is None


def _supervised_streams(tmp_path) -> list[list[dict]]:
    """A supervised two-attempt run of the port's worker (SIGKILL in
    attempt 1): the supervisor's stream and the worker's."""
    from masters_thesis_tpu_torch.resilience.supervisor import (
        RunSupervisor,
        SupervisorConfig,
    )

    out = tmp_path / "w"
    env = dict(os.environ, PYTHONPATH=str(REPO), MTT_FAULT_PLAN=json.dumps(
        [{"point": "worker.epoch", "kind": "kill", "attempt": 1,
          "match": {"epoch": 1}}]))
    res = RunSupervisor(
        [sys.executable, "-m", "masters_thesis_tpu_torch.resilience",
         "worker", "--out", str(out), "--epochs", "3"],
        run_dir=out / "sup",
        cfg=SupervisorConfig(max_retries=2, backoff_s=0.05, backoff_factor=1.0,
                             term_grace_s=2.0, attempt_timeout_s=60.0,
                             retry_budget_s=120.0),
        env=env, watch_dir=out / "telemetry").run()
    assert res.ok and res.n_attempts == 2
    return [read_events(out / "sup" / "events.jsonl"),
            read_events(out / "telemetry" / "events.jsonl")]


def _serving_stream(tmp_path) -> list[dict]:
    """The stream of ``serve/__main__.py``'s breaker check: a server on its
    fake engine whose first two dispatches fail."""
    from masters_thesis_tpu_torch.serve.__main__ import _FakeEngine
    from masters_thesis_tpu_torch.serve.server import PredictServer

    tel = TelemetryRun(tmp_path / "serve", run_id="serve")
    engine = _FakeEngine(service_s=0.001)
    server = PredictServer(engine, telemetry=tel, breaker_threshold=2,
                           max_wait_s=0.001)
    server.start()
    engine.fail_next = 2
    window = np.zeros((2, 3, 1), np.float32)
    for _ in range(3):
        server.submit(window, deadline_s=5.0).result(timeout=10.0)
    server.submit(window, deadline_s=1e-9).result(timeout=10.0)  # shed
    server.stop()
    tel.close()
    return read_events(tmp_path / "serve" / "events.jsonl")


def _stacked_stream(fits, tmp_path) -> list[dict]:
    """A stacked toy fit of two replicas, the second diverging once."""
    from masters_thesis_tpu_torch.resilience import faults

    dm = FinancialWindowDataModule(fits["root"] / "port", batch_size=4,
                                   **WINDOWS)
    tel = TelemetryRun(tmp_path / "stacked", run_id="stacked")
    faults.install_plan(faults.FaultPlan.parse(json.dumps(
        [{"point": "stacked.replica_loss", "kind": "nan", "attempt": None,
          "match": {"epoch": 1, "replica": 1}}])))
    try:
        StackedTrainer(max_epochs=2, gradient_clip_val=5.0, device="cpu",
                       telemetry=tel, ckpt_dir=tmp_path / "ck").fit(
            ModelSpec(**HPARAMS), dm,
            [ReplicaSpec("s0", 0, 1e-3), ReplicaSpec("s1", 1, 1e-2)])
    finally:
        faults.clear_plan()
    tel.close()
    return read_events(tmp_path / "stacked" / "events.jsonl")


@pytest.mark.parametrize("stream", ["training", "supervisor", "supervised_child",
                                    "serving", "stacked"])
def test_reader_equals_the_jax_reader(fits, tmp_path, stream):
    if stream == "training":
        events = read_events(fits["port"] / "events.jsonl")
    elif stream == "serving":
        events = _serving_stream(tmp_path)
    elif stream == "stacked":
        events = _stacked_stream(fits, tmp_path)
    else:
        sup, child = _supervised_streams(tmp_path)
        events = sup if stream == "supervisor" else child
    ours = report.summarize_events(events)
    theirs = jax_report.summarize_events(events)
    assert _without_peaks(ours) == _without_peaks(theirs)
    assert (_text_lines(ours, report.render_text)
            == _text_lines(theirs, jax_report.render_text))
    if stream == "supervisor":
        assert ours["restarts"]["attempts"] == 2
        assert ours["restarts"]["lost_work_s"] > 0
        assert "restarts       : 1 (2 attempts)" in report.render_text(ours)
    if stream == "serving":
        assert ours["serve"]["clean_stop"] and ours["serve"]["shed"] == 1
    if stream == "stacked":
        reps = ours["replicas"]
        assert reps["count"] == 2 and reps["rollbacks"] == 1
        assert [r["name"] for r in reps["per_replica"]] == ["s0", "s1"]


def test_a_second_capture_is_a_violation_in_both(fits, tmp_path):
    events = read_events(fits["port"] / "events.jsonl")
    for ev in events:
        if ev["kind"] == "epoch":
            ev["compile_events"], ev["compiled"] = 1, True
        if ev["kind"] == "run_finished":
            ev["epoch_compiles"] = 2
    path = tmp_path / "events.jsonl"
    path.write_text("".join(json.dumps(ev) + "\n" for ev in events))
    ours = report.summarize_events(events)
    theirs = jax_report.summarize_events(events)
    assert ours["violations"] == theirs["violations"]
    assert len(ours["violations"]) == 1 and "recompile" in ours["violations"][0]
    assert port_cli(["summarize", str(path)]) == 2
    assert jax_cli(["summarize", str(path)]) == 2
    assert port_cli(["summarize", str(fits["port"])]) == 0


def test_summarize_cli_runs_without_torch(fits):
    code = ("import sys\n"
            "for m in ('torch', 'jax', 'masters_thesis_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from masters_thesis_tpu_torch.telemetry.__main__ import main\n"
            f"sys.exit(main(['summarize', {str(fits['port'])!r}]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    assert "contracts      : ok" in proc.stdout


# ---------------------------------------------------------------- costs

#: PERF.md section 6, the bound column (ms): (kernel, rows, T, depth).
BOUNDS = [
    ("lstm_fwd", 100, 60, 1, 0.00293), ("lstm_fwd", 800, 60, 1, 0.02348),
    ("lstm_fwd", 2048, 32, 1, 0.03205), ("lstm_fwd", 8192, 32, 1, 0.12821),
    ("lstm_fwd", 131072, 32, 1, 2.05133),
    ("lstm_bwd", 100, 60, 1, 0.00587), ("lstm_bwd", 800, 60, 1, 0.04695),
    ("lstm_bwd", 2048, 32, 1, 0.06410), ("lstm_bwd", 8192, 32, 1, 0.25642),
    ("lstm_wgrad_single", 2048, 32, 1, 0.03205),
    ("lstm_wgrad_single", 8192, 32, 1, 0.12821),
    ("lstm_tb_fwd", 100, 252, 1, 0.01232), ("lstm_tb_fwd", 800, 252, 1, 0.09860),
    ("lstm_tb_bwd", 100, 252, 1, 0.03697), ("lstm_tb_bwd", 800, 252, 1, 0.29579),
    ("lstm_pair_fwd_masked", 100, 60, 2, 0.00880),
    ("lstm_pair_fwd", 800, 60, 2, 0.07043),
    ("lstm_pair_bwd", 100, 60, 2, 0.01761), ("lstm_pair_bwd", 800, 60, 2, 0.14085),
    ("lstm_wgrad", 100, 60, 2, 0.00880), ("lstm_wgrad", 800, 60, 2, 0.07043),
    ("lstm_stack_fwd", 25, 60, 4, 0.00514),
    ("lstm_stack_fwd_masked", 200, 60, 4, 0.04108),
    ("lstm_stack_bwd", 25, 60, 4, 0.01027), ("lstm_stack_bwd", 200, 60, 4, 0.08216),
    ("lstm_wgrad_stack", 25, 60, 4, 0.00514),
    ("lstm_wgrad_stack", 200, 60, 4, 0.04108),
]


@pytest.mark.parametrize("name,rows,n_t,depth,want", BOUNDS)
def test_cost_model_gives_back_the_bound_column(name, rows, n_t, depth, want):
    flops, nbytes = costs.kernel_cost(name, rows, n_t, 64, n_layers=depth)
    ms, by = costs.bound_ms(flops, nbytes)
    assert f"{ms:.5f}" == f"{want:.5f}"
    assert by == "operations"


def test_cost_of_a_step_follows_the_grouping():
    small = ModelSpec(objective="mse", input_size=3, hidden_size=64,
                      num_layers=2, dropout=0.2)
    step = costs.cost_of_step(small, 100, 60, window_rows=100)
    assert step["kernels"] == {"lstm_pair_fwd_masked": 1, "lstm_pair_bwd": 1,
                               "lstm_wgrad": 1}
    kernel_flops = sum(costs.kernel_cost(k, 100, 60, 64, n_layers=2)[0]
                       for k in step["kernels"])
    assert step["flops"] > kernel_flops
    serve = costs.cost_of_step(small, 800, 60, window_rows=100, training=False)
    assert serve["kernels"] == {"lstm_pair_fwd": 1}
    long = costs.cost_of_step(small, 100, 252, window_rows=100)
    assert long["kernels"] == {"lstm_tb_fwd": 2, "lstm_tb_bwd": 2}


def test_utilization_is_none_safe_off_the_card():
    util = costs.utilization(1e9, 1e8, 10.0, "cpu", 1)
    assert util["achieved_flops_per_sec"] == 1e10
    assert util["flops_utilization_pct"] is None and util["regime"] is None
    assert costs.utilization(None, None, None, "cuda", 1)[
        "achieved_flops_per_sec"] is None
    assert costs.platform_peaks("cuda", "NVIDIA A100-SXM4-80GB") is None
    util = costs.utilization(67e9, 1e9, 10.0, "cuda", 1, device=costs.H100)
    assert util["flops_utilization_pct"] == pytest.approx(1.0)
    assert util["regime"] == "compute-bound"


# ------------------------------------------------------------ profiling


def test_profile_window_writes_one_trace_and_the_jax_event(fits, tmp_path,
                                                          monkeypatch):
    dm = FinancialWindowDataModule(fits["root"] / "port", batch_size=4,
                                   **WINDOWS)
    tel = TelemetryRun(tmp_path / "tel", run_id="prof")
    Trainer(max_epochs=2, gradient_clip_val=5.0, device="cpu", telemetry=tel,
            profile_steps=(1, 1)).fit(ModelSpec(**HPARAMS), dm)
    tel.close()
    traces = list((tmp_path / "tel" / "profile").iterdir())
    assert [p.name for p in traces] == ["trace_epochs_1_1.json"]
    assert json.loads(traces[0].read_text())["traceEvents"]
    windows = [e for e in read_events(tmp_path / "tel" / "events.jsonl")
               if e["kind"] == "profile_window"]

    class Sink:  # the JAX window's event, without a jax trace
        def event(self, kind, **payload):
            self.got = (kind, payload)

    sink = Sink()
    jax_window = JaxProfilerWindow((1, 1), tmp_path / "j", telemetry=sink)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    jax_window.active = True  # as if started: only its stop runs
    jax_window.maybe_stop(1, lambda: None)
    assert len(windows) == 1
    assert _payload_keys(windows[0]) - {"kind"} == set(sink.got[1])
    assert windows[0]["start_epoch"] == windows[0]["end_epoch"] == 1
    assert windows[0]["trace_dir"] == str(tmp_path / "tel" / "profile")


# --------------------------------------------------- recorder, captures


class _Graphed:
    """Stands in for a GraphedCall: its ``captures`` count."""

    def __init__(self):
        self.captures = 0


def test_capture_tracker_counts_captures(tmp_path):
    calls = [_Graphed(), _Graphed()]
    tracker = CaptureTracker(calls)
    assert tracker.poll() == 0
    calls[0].captures = 1
    assert tracker.poll() == 1 and tracker.poll() == 0
    calls[1].captures, calls[0].captures = 1, 2
    assert tracker.poll() == 2 and tracker.total == 3
    tel = TelemetryRun(tmp_path, run_id="rec")
    rec = EpochRecorder(tel, 4, span_parent=tel.tracer.start("trainer.fit"))
    rec.begin(0)
    rec.dispatched(compiles=1)
    rec.fenced(0.25)
    rec.begin(1)
    rec.dispatched(compiles=0)
    rec.fenced(0.5)
    rec.finish()
    tel.close()
    epochs = [e for e in read_events(tmp_path / "events.jsonl")
              if e["kind"] == "epoch"]
    assert [(e["epoch"], e["steps"], e["compiled"], e["device_s"])
            for e in epochs] == [(0, 4, True, 0.25), (1, 4, False, 0.5)]


# ------------------------------------------------------- flight recorder


def _quiet(module, tmp_path, **kwargs):
    """A recorder safe inside pytest: no signal handlers, no faulthandler
    takeover."""
    kwargs.setdefault("install_signal_handlers", False)
    kwargs.setdefault("enable_faulthandler", False)
    kwargs.setdefault("heartbeat_interval_s", 0.5)
    return module.FlightRecorder(tmp_path, **kwargs)


def test_ring_buffer_is_bounded(tmp_path):
    rec = _quiet(flightrec, tmp_path, ring_size=8)
    for i in range(100):
        rec.record({"kind": "epoch", "epoch": i})
    rec.dump("test")
    rec.close()
    dump = json.loads((tmp_path / "crashdump.json").read_text())
    assert [e["epoch"] for e in dump["ring"]] == list(range(92, 100))
    assert dump["state"]["last_epoch"]["epoch"] == 99


def test_dump_carries_stacks_state_and_scalars(tmp_path):
    rec = _quiet(flightrec, tmp_path, scalar_history=4)
    rec.beat(phase="epoch", epoch=7)
    rec.note(step=123, epoch_compiles=1)
    for i in range(10):
        rec.track_scalar("loss/total/train", float(i))
    dump = json.loads(rec.dump("signal:SIGTERM (test)").read_text())
    rec.close()
    assert dump["reason"] == "signal:SIGTERM (test)"
    assert dump["phase"] == "epoch" and dump["epoch"] == 7
    assert dump["state"]["step"] == 123
    assert dump["scalars"]["loss/total/train"] == [6.0, 7.0, 8.0, 9.0]
    flat = "\n".join(line for t in dump["threads"] for line in t["stack"])
    assert "test_dump_carries_stacks_state_and_scalars" in flat


def test_first_dump_per_reason_wins(tmp_path):
    rec = _quiet(flightrec, tmp_path)
    rec.note(marker="first")
    rec.dump("hang: test")
    rec.note(marker="second")
    rec.dump("hang: test")
    assert json.loads(rec.crashdump_path.read_text())["state"]["marker"] == "first"
    rec.dump("signal:SIGTERM")
    assert json.loads(rec.crashdump_path.read_text())["state"]["marker"] == "second"
    rec.close()


def test_hang_watchdog_dumps_without_progress(tmp_path):
    rec = _quiet(flightrec, tmp_path, heartbeat_interval_s=0.1,
                 hang_timeout_s=3.0)
    rec.beat(phase="epoch", epoch=0)
    deadline = time.monotonic() + 30.0
    while not rec.crashdump_path.exists() and time.monotonic() < deadline:
        time.sleep(0.1)
    rec.close()
    dump = json.loads(rec.crashdump_path.read_text())
    assert dump["reason"].startswith("hang") and dump["phase"] == "epoch"
    assert dump["age_since_beat_s"] > 3.0


def test_beats_reset_the_hang_latch(tmp_path):
    rec = _quiet(flightrec, tmp_path, heartbeat_interval_s=0.1,
                 hang_timeout_s=3.0)
    for _ in range(8):  # beat faster than the timeout, past it in all
        rec.beat(phase="epoch")
        time.sleep(0.5)
    rec.close()
    assert not rec.crashdump_path.exists()


def test_heartbeat_file_tracks_phase(tmp_path):
    rec = _quiet(flightrec, tmp_path)
    rec.beat(phase="epoch", epoch=3)
    rec.close()
    hb = json.loads((tmp_path / "heartbeat.json").read_text())
    assert hb["closed"] is True and hb["phase"] == "closed"
    assert hb["epoch"] == 3 and hb["beats"] == 1


def test_dump_and_heartbeat_keys_are_the_jax_recorders(tmp_path,
                                                       monkeypatch):
    """The same events, notes, scalars and collective schedule through both
    recorders: the same keys in ``crashdump.json`` and ``heartbeat.json``,
    and the same ``collective_schedule`` in both. Each side runs on a fresh
    schedule of the same two entries (fits earlier in this process filled
    the global ones)."""
    from masters_thesis_tpu.telemetry.schedule import CollectiveSchedule
    from masters_thesis_tpu_torch.telemetry import schedule

    for module, cls in ((jax_flightrec, CollectiveSchedule),
                        (flightrec, schedule.CollectiveSchedule)):
        chain = cls()
        chain.record("barrier", name="checkpoint.publish.last")
        chain.record("pmean", name="grads.flat", axes=("data",), step=1)
        monkeypatch.setattr(module, "GLOBAL_SCHEDULE", chain)
    files = {}
    for name, module in (("port", flightrec), ("jax", jax_flightrec)):
        rec = _quiet(module, tmp_path / name)
        rec.beat(phase="epoch", epoch=1)
        rec.record({"kind": "run_started", "platform": "cpu"})
        rec.record({"kind": "epoch", "epoch": 1})
        rec.note(epoch_compiles=1)
        rec.track_scalar("lr", 1e-3)
        rec.dump("hang: test")
        rec.close()
        files[name] = {f: json.loads((tmp_path / name / f).read_text())
                       for f in ("crashdump.json", "heartbeat.json")}
    for f in ("crashdump.json", "heartbeat.json"):
        assert set(files["port"][f]) == set(files["jax"][f]), f
        assert files["port"][f]["collective_schedule"] == \
            files["jax"][f]["collective_schedule"], f
        assert files["port"][f]["collective_schedule"]["n"] == 2
    assert files["port"]["crashdump.json"]["state"] == \
        files["jax"]["crashdump.json"]["state"]


def test_sigterm_leaves_a_signal_crashdump(tmp_path):
    code = (
        "import sys, time\n"
        "from masters_thesis_tpu_torch.telemetry.run import TelemetryRun\n"
        f"tel = TelemetryRun({str(tmp_path)!r}, run_id='child')\n"
        "rec = tel.attach_flight_recorder(heartbeat_interval_s=0.1)\n"
        "rec.beat(phase='epoch', epoch=2)\n"
        "while True:\n"
        "    time.sleep(0.1)\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code],
                            env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        deadline = time.monotonic() + 60.0
        while (not (tmp_path / "heartbeat.json").exists()
               and time.monotonic() < deadline):
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == -signal.SIGTERM
    dump = json.loads((tmp_path / "crashdump.json").read_text())
    assert dump["reason"] == "signal:SIGTERM"
    assert dump["phase"] == "epoch" and dump["epoch"] == 2
    kinds = [e["kind"] for e in read_events(tmp_path / "events.jsonl")]
    assert kinds == ["crashdump"]
