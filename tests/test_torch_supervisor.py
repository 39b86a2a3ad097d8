"""The port's run supervisor against the JAX package's on the CPU.

The supervisor scenarios of ``tests/test_resilience.py``
(``TestSupervisorPolicies``) run with each package's ``RunSupervisor`` and
its own simulated trainee (``python -m <package>.resilience worker``):
both give the same verdict, attempt count, classification kinds,
fingerprints across attempts, rollback ``lr_scale`` and work log.
``classify_exit`` of both packages on one table of evidence directories
gives the same ``Classification``; ``DecorrelatedBackoff`` with one seed
the same delays.

Then the real trainee: ``python -m masters_thesis_tpu_torch train --device
cpu`` at the toy shape of ``tests/test_torch_drivers.py`` under the port's
``resilience run``, killed, diverged and hung in attempt 1. Every
supervised run has an attempt timeout and a retry budget; no assertion
reads a wall-clock time.
"""

import functools
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from masters_thesis_tpu.resilience import backoff as jax_backoff
from masters_thesis_tpu.resilience import supervisor as jax_sup
from masters_thesis_tpu_torch.resilience import backoff, faults
from masters_thesis_tpu_torch.resilience import supervisor as port_sup
from masters_thesis_tpu_torch.telemetry.events import read_events
from masters_thesis_tpu_torch.telemetry.report import (
    render_text,
    summarize_path,
)
from masters_thesis_tpu_torch.train.checkpoint import load_checkpoint
from masters_thesis_tpu_torch.train.logging import read_records

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": ("masters_thesis_tpu", jax_sup),
            "port": ("masters_thesis_tpu_torch", port_sup)}
SCENARIOS = ("success", "deterministic", "retries_exhausted", "sigkill_resume",
             "divergence_rollback", "hang_watchdog", "attempt_events")


def _env(plan=None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in (faults.FAULT_PLAN_ENV, faults.ATTEMPT_ENV,
                        "MTT_LR_SCALE")}
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    if plan is not None:
        env[faults.FAULT_PLAN_ENV] = json.dumps(plan)
    return env


def _cfg(sup, **kw):
    defaults = dict(max_retries=3, backoff_s=0.05, backoff_factor=1.0,
                    term_grace_s=2.0, attempt_timeout_s=60.0,
                    retry_budget_s=180.0)
    defaults.update(kw)
    return sup.SupervisorConfig(**defaults)


@functools.cache
def _scenario(name: str, package: str, root: str) -> dict:
    """One scenario of ``TestSupervisorPolicies`` with ``package``'s
    supervisor and worker; what both packages must agree on."""
    pkg, sup = PACKAGES[package]
    out = Path(root) / f"{name}-{package}"
    worker = [sys.executable, "-m", f"{pkg}.resilience", "worker",
              "--out", str(out)]
    env, cfg, watch = _env(), _cfg(sup), out / "telemetry"
    if name == "success":
        cmd = [sys.executable, "-c", "print('fine')"]
    elif name == "deterministic":
        cmd = [sys.executable, "-c", "import sys; print('RuntimeError: boom', "
               "file=sys.stderr); sys.exit(3)"]
    elif name == "retries_exhausted":
        cmd = [sys.executable, "-c", "import os, sys; print('RuntimeError: "
               "boom-' + os.environ['MTT_ATTEMPT'], file=sys.stderr); "
               "sys.exit(9)"]
        cfg = _cfg(sup, max_retries=2)
    elif name == "sigkill_resume":
        cmd = worker + ["--mode", "ok", "--epochs", "4"]
        env = _env([{"point": "worker.epoch", "kind": "kill", "attempt": 1,
                     "match": {"epoch": 2}}])
    elif name == "divergence_rollback":
        cmd = worker + ["--mode", "nan", "--epochs", "4", "--at", "1"]
    elif name == "hang_watchdog":
        cmd = worker + ["--mode", "ok", "--epochs", "3"]
        env = _env([{"point": "worker.epoch", "kind": "hang", "attempt": 1,
                     "match": {"epoch": 1}}])
        cfg = _cfg(sup, hang_timeout_s=3.0)
    else:  # attempt_events
        cmd = [sys.executable, "-c", "import sys; sys.exit(1)"]
        cfg = _cfg(sup, max_retries=0)
    res = sup.RunSupervisor(cmd, run_dir=out / "sup", cfg=cfg, env=env,
                            watch_dir=watch).run()
    events = read_events(out / "sup" / "events.jsonl")
    log = out / "work.log"
    return {
        "ok": res.ok,
        "verdict": res.verdict,
        "n_attempts": res.n_attempts,
        "kinds": [a.classification.kind for a in res.attempts],
        "fingerprints_repeat": [
            a.classification.fingerprint is not None
            and a.classification.fingerprint
            == res.attempts[0].classification.fingerprint
            for a in res.attempts],
        "hang_killed": [a.hang_killed for a in res.attempts],
        "lost_work_zero": res.lost_work_s == 0.0,
        "rollbacks": [e["lr_scale"] for e in events if e["kind"] == "rollback"],
        "work_log": log.read_text().splitlines() if log.exists() else None,
        "event_kinds": sorted({e["kind"] for e in events if e["kind"] != "span"}),
        "finished_keys": [sorted(k for k in e if k not in ("ts", "seq", "pid",
                                                            "host", "run"))
                          for e in events if e["kind"] == "attempt_finished"],
    }


#: What ``TestSupervisorPolicies`` asserts of each scenario.
EXPECTED = {
    "success": dict(ok=True, verdict="completed", n_attempts=1,
                    lost_work_zero=True),
    "deterministic": dict(ok=False, verdict="deterministic", n_attempts=2,
                          fingerprints_repeat=[True, True]),
    "retries_exhausted": dict(verdict="retries_exhausted", n_attempts=3),
    "sigkill_resume": dict(ok=True, n_attempts=2,
                           kinds=["transient", "success"],
                           work_log=["1 0", "1 1", "2 2", "2 3"]),
    "divergence_rollback": dict(ok=True, n_attempts=2,
                                kinds=["divergence", "success"],
                                rollbacks=[0.5]),
    "hang_watchdog": dict(ok=True, n_attempts=2, hang_killed=[True, False],
                          kinds=["transient", "success"]),
    "attempt_events": dict(ok=False, n_attempts=1),
}


@pytest.fixture(scope="module")
def scenario_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("scenarios"))


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("name", SCENARIOS)
def test_supervisor_scenario(scenario_root, name, package):
    got = _scenario(name, package, scenario_root)
    for key, want in EXPECTED[name].items():
        assert got[key] == want, (key, got)
    if name == "attempt_events":
        assert "supervisor_verdict" in got["event_kinds"]
        assert {"ok", "lost_work_s"} <= set(got["finished_keys"][0])


@pytest.mark.parametrize("name", SCENARIOS)
def test_both_supervisors_agree(scenario_root, name):
    port = _scenario(name, "port", scenario_root)
    theirs = _scenario(name, "jax", scenario_root)
    assert port == theirs


# --------------------------------------------------------- classification


def _evidence(root: Path, case: str) -> tuple[Path, dict]:
    """An evidence directory and the ``_classify`` arguments of one row."""
    watch = root / case
    (watch / "run").mkdir(parents=True)
    kw = dict(rc=None, since=0.0, stderr="", hang_killed=False)
    if case == "sigkill":
        kw["rc"] = -9
    elif case == "sigterm_with_crashdump":
        kw["rc"] = 143
        kw["stderr"] = "Terminated\n"
        (watch / "run" / "crashdump.json").write_text(json.dumps(
            {"reason": "signal:SIGTERM", "ts": 10.0, "phase": "checkpoint",
             "epoch": 3}))
    elif case == "diverged":
        kw["rc"] = 0
        lines = [{"kind": "run_started", "ts": 1.0},
                 {"kind": "epoch", "epoch": 0, "ts": 2.0},
                 {"kind": "epoch", "epoch": 1, "ts": 3.0},
                 {"kind": "run_finished", "diverged": True, "ts": 4.0}]
        (watch / "run" / "events.jsonl").write_text(
            "".join(json.dumps(e) + "\n" for e in lines))
    elif case == "stale_heartbeat":
        kw["hang_killed"] = True
        (watch / "run" / "heartbeat.json").write_text(json.dumps(
            {"ts": 100.0, "last_beat_ts": 1.0, "phase": "epoch"}))
    elif case == "same_stderr":
        kw["rc"] = 3
        kw["stderr"] = "Traceback ...\nValueError: bad shape (3, 4)\n"
    elif case == "backend":
        kw["rc"] = 1
        kw["stderr"] = "RuntimeError: UNAVAILABLE: the device went away\n"
    return watch, kw


@pytest.mark.parametrize("case", ["sigkill", "sigterm_with_crashdump",
                                  "diverged", "stale_heartbeat", "same_stderr",
                                  "backend"])
def test_classification_equals_the_jax_one(tmp_path, case):
    got = {}
    for package, (_, sup) in PACKAGES.items():
        watch, kw = _evidence(tmp_path / package, case)
        runner = sup.RunSupervisor(["true"], run_dir=watch / "sup",
                                   watch_dir=watch)
        twice = [runner._classify(kw["rc"], kw["since"], kw["stderr"],
                                  hang_killed=kw["hang_killed"],
                                  timed_out=False) for _ in range(2)]
        got[package] = [vars(c) for c in twice]
    assert got["port"] == got["jax"]
    first, second = got["port"]
    assert first == second  # the same evidence, the same fingerprint
    want = {"sigkill": "transient", "sigterm_with_crashdump": "transient",
            "diverged": "divergence", "stale_heartbeat": "transient",
            "same_stderr": "transient", "backend": "transient"}[case]
    assert first["kind"] == want
    if case in ("same_stderr", "sigterm_with_crashdump"):
        assert first["fingerprint"] is not None
    if case == "diverged":
        assert first["diverged_epoch"] == 1


def test_a_dead_attempts_heartbeat_does_not_kill_the_next(tmp_path):
    """A heartbeat left stale in the watch dir by an earlier attempt, and a
    child that takes longer than ``hang_timeout_s`` to write its own (a
    process reaching the card): the port's supervisor lets it run; the JAX
    supervisor reads the stale one and kills the child as hung."""
    got = {}
    for package, (_, sup) in PACKAGES.items():
        watch = tmp_path / package / "telemetry"
        watch.mkdir(parents=True)
        stale = 1.0  # epoch seconds: long before this attempt
        (watch / "heartbeat.json").write_text(json.dumps(
            {"ts": stale, "last_beat_ts": stale, "phase": "epoch"}))
        res = sup.RunSupervisor(
            [sys.executable, "-c", "import time; time.sleep(4.5)"],
            run_dir=tmp_path / package / "sup",
            cfg=_cfg(sup, hang_timeout_s=3.0, max_retries=0),
            env=_env(), watch_dir=watch).run()
        got[package] = (res.verdict, [a.hang_killed for a in res.attempts])
    assert got["port"] == ("completed", [False])
    assert got["jax"] == ("retries_exhausted", [True])


def test_backoff_delays_equal_the_jax_ones():
    for base, cap, factor in ((0.5, 30.0, 2.0), (5.0, 300.0, 3.0),
                              (0.05, 1.0, 1.0)):
        ours = backoff.DecorrelatedBackoff(base, cap, factor,
                                           rng=random.Random(7))
        theirs = jax_backoff.DecorrelatedBackoff(base, cap, factor,
                                                 rng=random.Random(7))
        assert [ours.next() for _ in range(12)] == \
            [theirs.next() for _ in range(12)]


def test_port_supervisor_imports_no_torch():
    code = ("import sys\n"
            "for m in ('torch', 'jax', 'masters_thesis_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from masters_thesis_tpu_torch.resilience.__main__ import main\n"
            "sys.exit(main(['fleet', '--selfcheck']))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60, env=_env())
    assert proc.returncode == 0, proc.stderr
    assert "fleet selfcheck: 2 scenarios OK" in proc.stdout


# ------------------------------------------------- the probe before attempts

ENV_PROBE = ("import os; print(os.environ.get('JAX_PLATFORMS'), "
             "os.environ.get('CUDA_VISIBLE_DEVICES'))")


def test_a_wedged_probe_is_recorded_and_the_attempt_runs_on_the_card(
        tmp_path):
    """JAX ``test_resilience.py::TestWedgeFailover`` in the port's meaning,
    the JAX supervisor's ``cpu_fallback=False``: ONE probe attempt (the
    ``probe.attempt`` wedge), one ``degradation`` with ``fallback: null``
    and ``probe_attempts`` 1, then the attempt runs with the environment
    it was given (nothing pinned to the CPU), as the JAX supervisor's."""
    from masters_thesis_tpu.resilience import faults as jax_faults

    spec = dict(point="probe.attempt", kind="wedge", attempt=None)
    env = _env()
    env.pop("JAX_PLATFORMS")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    runs = {}
    for name, sup, plans, kw in (
            ("port", port_sup, faults, {}),
            ("jax", jax_sup, jax_faults, {"cpu_fallback": False})):
        plans.install_plan(plans.FaultPlan(faults=[plans.FaultSpec(**spec)]))
        t0 = time.monotonic()
        try:
            res = sup.RunSupervisor(
                [sys.executable, "-c", ENV_PROBE], run_dir=tmp_path / name,
                env=env, cfg=_cfg(sup, probe=True, probe_timeout_s=60.0,
                                  probe_cache=tmp_path / f"{name}.json",
                                  **kw)).run()
        finally:
            plans.clear_plan()
        runs[name] = (res, time.monotonic() - t0,
                      read_events(tmp_path / name / "events.jsonl"),
                      (tmp_path / name / "attempt_1.out").read_text().strip())
    for name, (res, seconds, events, out) in runs.items():
        assert seconds < 30.0, name  # one attempt, no budget burnt
        assert res.ok and res.n_attempts == 1, name
        assert not getattr(res, "degraded", False), name
        assert out == "None None", name  # the child's environment as given
        [d] = [e for e in events if e["kind"] == "degradation"]
        assert (d["fallback"], d["probe_attempts"]) == (None, 1), name
        started = [e for e in events if e["kind"] == "supervisor_started"]
        assert started[0]["probe"] is True, name
    port_d, jax_d = ([e for e in runs[n][2] if e["kind"] == "degradation"][0]
                     for n in ("port", "jax"))
    assert port_d["reason"] == jax_d["reason"].replace("lease", "card")


def test_the_run_command_line_takes_the_jax_probe_flags(tmp_path):
    """``run --probe --probe-timeout-s --probe-cache --no-cpu-fallback`` as
    the JAX command line has them, in a process that cannot import torch:
    the wedge is recorded and the attempt completes."""
    plan = [{"point": "probe.attempt", "kind": "wedge", "attempt": None}]
    code = ("import sys\n"
            "for m in ('torch', 'jax', 'masters_thesis_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from masters_thesis_tpu_torch.resilience.__main__ import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "run", "--run-dir", str(tmp_path / "sup"),
         "--probe", "--probe-timeout-s", "30", "--probe-cache",
         str(tmp_path / "probe.json"), "--no-cpu-fallback", "--backoff-s",
         "0.05", "--", sys.executable, "-c", "print('ran')"],
        capture_output=True, text=True, timeout=60, env=_env(plan))
    assert proc.returncode == 0, proc.stderr
    assert "verdict=completed attempts=1" in proc.stderr
    assert "no CPU fallback" in proc.stderr
    events = read_events(tmp_path / "sup" / "events.jsonl")
    assert [e["fallback"] for e in events if e["kind"] == "degradation"] == [
        None]
    assert json.loads((tmp_path / "probe.json").read_text())["ok"] is False


# ------------------------------------------------------ the real trainee

TOY = [
    "datamodule.n_stocks=4",
    "datamodule.n_samples=1200",
    "datamodule.lookback_window=10",
    "datamodule.target_window=5",
    "datamodule.stride=15",
    "model.hidden_size=8",
    "trainer.max_epochs=2",
]
RUN = ("FinancialLstm", "synthetic", "mse_small_lr0.0001_fast")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("data") / "toy"


def _train_cmd(data_dir, save_dir, *extra) -> list[str]:
    return [sys.executable, "-m", "masters_thesis_tpu_torch", "train",
            "--device", "cpu", *TOY, f"datamodule.data_dir={data_dir}",
            f"logger.save_dir={save_dir}", *extra]


def _env_one_thread(plan=None) -> dict:
    # One intra-op thread in every child: the unbroken and the resumed run
    # sum on the CPU in one order.
    return dict(_env(plan), OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def unbroken(data_dir, tmp_path_factory):
    save = tmp_path_factory.mktemp("unbroken")
    proc = subprocess.run(_train_cmd(data_dir, save), env=_env_one_thread(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return save.joinpath(*RUN)


def _supervised(tmp_path, data_dir, plan, *extra, sup_args=()) -> tuple:
    """``resilience run`` around the toy ``train`` with ``plan``; the
    supervisor's result, its run dir and the child's log dir."""
    save = tmp_path / "logs"
    log_dir = save.joinpath(*RUN)
    cmd = [sys.executable, "-m", "masters_thesis_tpu_torch.resilience", "run",
           "--run-dir", str(tmp_path / "sup"),
           "--watch-dir", str(log_dir / "telemetry"),
           "--ckpt-dir", str(log_dir / "checkpoints"),
           "--backoff-s", "0.1", "--backoff-factor", "1.0",
           "--attempt-timeout-s", "240", "--retry-budget-s", "600",
           "--quiet", *sup_args, "--",
           *_train_cmd(data_dir, save, "trainer.resume=auto", *extra)]
    proc = subprocess.run(cmd, env=_env_one_thread(plan), capture_output=True,
                          text=True, timeout=900)
    return proc, tmp_path / "sup", log_dir


def _summarize(log_dir) -> tuple[int, str]:
    proc = subprocess.run(
        [sys.executable, "-m", "masters_thesis_tpu_torch.telemetry",
         "summarize", str(log_dir / "telemetry")], env=_env(),
        capture_output=True, text=True, timeout=120)
    return proc.returncode, proc.stdout


def _attempts(sup_dir) -> list[dict]:
    return [e for e in read_events(sup_dir / "events.jsonl")
            if e["kind"] == "attempt_finished"]


def test_killed_train_completes_bit_for_bit(tmp_path, data_dir, unbroken):
    plan = [{"point": "trainer.epoch_dispatched", "kind": "kill",
             "attempt": 1, "match": {"epoch": 1}}]
    proc, sup_dir, log_dir = _supervised(tmp_path, data_dir, plan)
    assert proc.returncode == 0, proc.stderr
    assert "verdict=completed attempts=2" in proc.stderr
    attempts = _attempts(sup_dir)
    assert [a["classification"] for a in attempts] == ["transient", "success"]
    assert attempts[0]["rc"] == -9
    for tag in ("best", "last"):
        got = load_checkpoint(log_dir / "checkpoints", tag)
        want = load_checkpoint(unbroken / "checkpoints", tag)
        for name, value in want[0].items():
            assert torch.equal(got[0][name], value), (tag, name)
        for key in ("mu", "nu"):
            assert torch.equal(got[1][key], want[1][key]), (tag, key)
        assert got[1]["count"] == want[1]["count"]
        assert got[2:] == want[2:]
    code, text = _summarize(log_dir)
    assert code == 0, text
    assert "restarts       : 1 (2 attempts)" in text
    report = summarize_path(log_dir / "telemetry")
    assert report["restarts"]["resumed"] and report["epochs"] == 2


def test_diverged_train_rolls_back_at_half_the_rate(tmp_path, data_dir):
    plan = [{"point": "trainer.loss", "kind": "nan", "attempt": 1,
             "match": {"epoch": 1}}]
    proc, sup_dir, log_dir = _supervised(tmp_path, data_dir, plan)
    assert proc.returncode == 0, proc.stderr
    attempts = _attempts(sup_dir)
    assert [a["classification"] for a in attempts] == ["divergence", "success"]
    rollbacks = [e for e in read_events(sup_dir / "events.jsonl")
                 if e["kind"] == "rollback"]
    assert [e["lr_scale"] for e in rollbacks] == [0.5]
    out = (sup_dir / "attempt_2.out").read_text()
    assert "rollback: LR scaled by 0.5" in out
    rows = [r for r in read_records(log_dir) if "lr-Adam" in r]
    # epoch 0, epoch 1 (diverged, attempt 1), epoch 1 again (attempt 2).
    assert [r["step"] for r in rows] == [0, 1, 1]
    assert rows[2]["lr-Adam"] == pytest.approx(0.5 * rows[0]["lr-Adam"],
                                               rel=1e-12)
    code, text = _summarize(log_dir)
    assert code == 0, text
    assert "restarts       : 1 (2 attempts)" in text


def test_hung_train_leaves_a_hang_dump_and_completes(tmp_path, data_dir):
    plan = [{"point": "trainer.epoch_dispatched", "kind": "hang",
             "attempt": 1, "match": {"epoch": 1}}]
    proc, sup_dir, log_dir = _supervised(
        tmp_path, data_dir, plan, "trainer.hang_timeout_s=3",
        sup_args=("--hang-timeout-s", "5"))
    assert proc.returncode == 0, proc.stderr
    attempts = _attempts(sup_dir)
    assert [a["classification"] for a in attempts] == ["transient", "success"]
    assert "hang" in attempts[0]["reason"]
    dumps = [e for e in read_events(log_dir / "telemetry" / "events.jsonl")
             if e["kind"] == "crashdump"]
    # The watchdog's dump, then the one the supervisor's SIGTERM left.
    assert dumps[0]["reason"].startswith("hang")
    assert dumps[0]["phase"] == "epoch" and dumps[0]["epoch"] == 1
    assert {e["attempt"] for e in dumps} == {1}
    code, text = _summarize(log_dir)
    assert code == 0, text
    assert "restarts       : 1 (2 attempts)" in text
    assert render_text(summarize_path(log_dir / "telemetry")) in text
