"""Serve preflight: prove the predict hot path neither captures nor syncs.

Counterpart of ``masters_thesis_tpu/serve/preflight.py`` for one engine on
one device. It builds a hermetic engine (4 stocks, lookback 8, H=8, one
layer, seeded weights), warms every bucket, drives a steady window of
varied batch sizes and holds the serving contract:

- **SV301**: ``warmup`` captures exactly one CUDA graph per bucket on the
  card and none on the CPU, and ``compile_events`` grows by 0 over the
  steady window.
- **SV302**: the card's counterpart of ``transfer_guard("disallow")``. The
  steady window runs under ``torch.cuda.set_sync_debug_mode("error")``,
  which raises at any synchronising call PyTorch knows of: a copy from
  pageable memory, ``.to("cpu")``, ``.item()``, a stream synchronise
  (checked on the H100 with torch 2.11). A dispatch's one wait, for its
  own answers, is on a CUDA event recorded after ``non_blocking`` copies
  into pinned buffers, which the mode does not count. Skipped on the CPU,
  where nothing is asynchronous.
- **SV303**: the preflight could not run, or its answers are not finite.
- **SV304**: each bucket's peak of the card's allocator during its
  capture (``PredictEngine.capture_peak_bytes``) fits the card's memory
  (``torch.cuda.mem_get_info``'s total). Skipped on the CPU.
- **SV308**, for one engine: a ``CheckpointSwapper.try_swap`` that commits
  while a server carries steady load captures nothing new
  (``compile_events`` unchanged), resolves every request and delivers no
  answer late.
- **SV307** (stacked serving, a 2-layer pair at H=8): a
  ``StackedPredictEngine``'s ``warmup`` captures exactly one graph per
  bucket at every lane count (R = 1, 2, 4) on the card (none on the CPU),
  and each bucket's graph launches the replica-axis pair forward once
  whatever R: the lane count is a data dimension, never a program one
  (the JAX rule reads the compiled HLO for the same). The other groupings
  the lanes take, one layer and a 4-deep stack, at R = 2: one graph a
  bucket, each launching its group's replica-axis forward once.
- **SV308**, per lane: ``try_swap_lane`` on the last lane of the R = 4
  stack, committed while a server carries steady load, captures nothing,
  resolves every request, delivers no answer late, and leaves every
  sibling lane's answers on the golden batch bitwise as they were.
- **SV306**: a ``FleetServer`` of two replicas of the preflight engine on
  the preflight's device (the replicas share it; each factory names the
  device) survives an injected ``serve.replica_dispatch`` crash of ``r0``
  under traffic: the crash kills ``r0``, whose restart boots a second
  generation (on the card: captures its graphs while ``r1`` serves) and
  serves again within 10 s of the death, before the fleet stops; a replica
  survives, every request resolves explicitly and no ``ok`` answer comes
  late.

- **SV305** (``run_program_cache_preflight``): a cold engine warms up and
  closes into a ``ProgramCache``, then a warm engine boots from it. The
  warm engine must make no program (no capture on the card, no eager
  program on the CPU), hit the cache once a bucket, and answer bit for bit
  as the cold engine did. Failure to run is SV303, as in JAX.
"""

from __future__ import annotations

import tempfile
import threading
import time

import numpy as np
import torch

from masters_thesis_tpu_torch.analysis.findings import Finding

PREFLIGHT_STOCKS = 4
PREFLIGHT_LOOKBACK = 8
PREFLIGHT_FEATURES = 3
PREFLIGHT_BUCKETS = (1, 2, 4, 8)
PREFLIGHT_REQUESTS = 12
PREFLIGHT_LANES = (1, 2, 4)
#: Depths of the other stacked groupings held by SV307 at R = 2 (H=8 and
#: lookback 8 fuse up to 8 layers, so 4 layers are one 4-deep stack), and
#: the replica-axis forward each bucket's graph launches once.
PREFLIGHT_DEPTHS = {1: "lstm_fwd_stacked", 4: "lstm_stack_fwd_stacked"}


def _preflight_spec():
    from masters_thesis_tpu_torch.models.objectives import ModelSpec

    return ModelSpec(objective="mse", hidden_size=8, num_layers=1,
                     dropout=0.0)


def _state(spec, seed: int) -> dict:
    return spec.build_module(
        device="cpu", generator=torch.Generator().manual_seed(seed)
    ).state_dict()


def _engine(spec, state, device):
    from masters_thesis_tpu_torch.serve.engine import PredictEngine

    return PredictEngine(spec, state, n_stocks=PREFLIGHT_STOCKS,
                         lookback=PREFLIGHT_LOOKBACK,
                         n_features=PREFLIGHT_FEATURES,
                         buckets=PREFLIGHT_BUCKETS,
                         device=device)


def run_serve_preflight(device=None, requests: int = PREFLIGHT_REQUESTS
                        ) -> tuple[list[Finding], dict]:
    """Build a hermetic engine on ``device`` (the card unless told
    ``"cpu"``) and audit its hot path: ``(findings, facts)``, findings []
    when clean; ``facts`` holds what the rules measured (captures, each
    bucket's capture peak and the card's total bytes, the swap's verdict
    and counts)."""
    facts: dict = {}
    try:
        return _run(device, requests, facts), facts
    except Exception as exc:  # noqa: BLE001 — SV303 carries the cause
        return [Finding(rule="SV303", message="preflight could not run: "
                        f"{type(exc).__name__}: {exc}")], facts


def _run(device, requests, facts: dict) -> list[Finding]:
    findings: list[Finding] = []
    spec = _preflight_spec()
    engine = _engine(spec, _state(spec, 0), device)
    on_card = engine.device.type == "cuda"
    facts["device"] = str(engine.device)
    engine.warmup()
    facts["captures"] = engine.compile_events
    want = len(engine.buckets) if on_card and engine.graphed else 0
    if engine.compile_events != want:
        findings.append(Finding(
            rule="SV301",
            message=f"warmup captured {engine.compile_events} graphs for "
            f"{len(engine.buckets)} buckets {engine.buckets} on "
            f"{engine.device} (expected {want})"))

    if on_card:
        _, total = torch.cuda.mem_get_info(engine.device)
        facts["device_total_bytes"] = total
        facts["capture_peak_bytes"] = dict(engine.capture_peak_bytes)
        for b in engine.buckets:
            peak = engine.capture_peak_bytes.get(b)
            if peak is not None and peak > total:
                findings.append(Finding(
                    rule="SV304",
                    message=f"bucket {b} peaked at {peak} bytes during its "
                    f"capture, past the card's {total} bytes — this bucket "
                    "would run out of memory at its first request"))

    # Steady window: request sizes sweep every bucket boundary (exact fits
    # and pad-to-bucket), inputs made on the host beforehand.
    rng = np.random.default_rng(0)
    sizes = [1 + (i % engine.max_bucket) for i in range(requests)]
    k, t, f = engine.window_shape
    inputs = [rng.standard_normal((n, k, t, f)).astype(np.float32)
              for n in sizes]
    baseline = engine.compile_events
    answers = []
    if on_card:
        torch.cuda.synchronize(engine.device)
        torch.cuda.set_sync_debug_mode("error")
    try:
        for x in inputs:
            answers.append(engine.predict(x))
    except RuntimeError as exc:
        if not on_card:
            raise
        findings.append(Finding(
            rule="SV302",
            message=f"implicit host synchronisation in the serve hot path: "
            f"{exc}"))
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    delta = engine.compile_events - baseline
    facts["steady_requests"] = len(answers)
    facts["steady_new_captures"] = delta
    if delta:
        findings.append(Finding(
            rule="SV301",
            message=f"steady-state serving captured {delta} new graph(s) "
            f"over {requests} varied-size requests (expected 0)"))
    if not all(np.isfinite(a).all() and np.isfinite(b).all()
               for a, b in answers):
        findings.append(Finding(
            rule="SV303",
            message="preflight predictions are non-finite on random inputs "
            "(engine wiring is broken)"))
    findings += _swap_under_load(engine, spec, facts)
    findings += _stacked(engine.device, facts)
    findings += _fleet(spec, engine.device, facts)
    sv305, facts["program_cache"] = run_program_cache_preflight(
        device=engine.device)
    return findings + sv305


def _under_load(engine, spec, state: dict, swap, duration_s: float = 0.5,
                gap_s: float = 0.002) -> dict:
    """``swap(swapper, ckpt_dir)`` on a published ``best`` of ``state``
    while a server on ``engine`` carries steady load: the verdict, the
    requests, how many did not resolve, the server's stats and the new
    captures."""
    from masters_thesis_tpu_torch.serve.server import PredictServer
    from masters_thesis_tpu_torch.serve.swap import CheckpointSwapper
    from masters_thesis_tpu_torch.train.checkpoint import save_checkpoint

    k, t, f = engine.window_shape
    windows = np.random.default_rng(1).standard_normal(
        (16, k, t, f)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, "best", state, spec=spec,
                        meta={"epoch": 1,
                              "datamodule": {"lookback_window": t}})
        server = PredictServer(engine, max_wait_s=0.002)
        swapper = CheckpointSwapper(engine)
        pendings = []
        stop = threading.Event()

        def load() -> None:
            i = 0
            while not stop.is_set():
                pendings.append(server.submit(windows[i % len(windows)],
                                              deadline_s=2.0))
                i += 1
                time.sleep(gap_s)

        server.start()
        baseline = engine.compile_events
        feeder = threading.Thread(target=load, name="preflight-load")
        feeder.start()
        try:
            time.sleep(duration_s / 2)
            verdict = swap(swapper, tmp)
            time.sleep(duration_s / 2)
        finally:
            stop.set()
            feeder.join(timeout=10.0)
            unresolved = 0
            for p in pendings:
                try:
                    p.result(timeout=10.0)
                except TimeoutError:
                    unresolved += 1
            stats = server.stop()
    return {"verdict": verdict, "requests": len(pendings),
            "unresolved": unresolved, "stats": stats,
            "new_captures": engine.compile_events - baseline}


def _load_findings(what: str, run: dict) -> list[Finding]:
    """SV308's findings for one swap under load (``_under_load``)."""
    findings = []
    verdict, stats = run["verdict"], run["stats"]
    if not verdict.ok:
        findings.append(Finding(
            rule="SV308",
            message=f"the {what} under load was refused: {verdict.reason} "
            f"({verdict.detail})"))
    if run["new_captures"]:
        findings.append(Finding(
            rule="SV308",
            message=f"a {what} under load captured {run['new_captures']} new "
            "graph(s) — a swap is an in-place copy into the captured tensors "
            "and must never capture"))
    if run["unresolved"] or stats["late_deliveries"]:
        findings.append(Finding(
            rule="SV308",
            message=f"across the {what} {run['unresolved']} request(s) did "
            f"not resolve and {stats['late_deliveries']} ok answer(s) came "
            f"late (of {run['requests']})"))
    return findings


def _swap_under_load(engine, spec, facts: dict) -> list[Finding]:
    """SV308 for one engine: commit a swap while a server carries steady
    load."""
    run = _under_load(engine, spec, _state(spec, 1),
                      lambda swapper, tmp: swapper.try_swap(tmp, "best"))
    facts["swap"] = {"reason": run["verdict"].reason,
                     "requests": run["requests"],
                     "unresolved": run["unresolved"],
                     "new_captures": run["new_captures"],
                     "late_deliveries": run["stats"]["late_deliveries"],
                     "completed": run["stats"]["completed"]}
    return _load_findings("swap", run)


def _stacked_spec(num_layers: int = 2):
    from masters_thesis_tpu_torch.models.objectives import ModelSpec

    return ModelSpec(objective="mse", hidden_size=8, num_layers=num_layers,
                     dropout=0.0)


def _stacked_engine(spec, states, device):
    from masters_thesis_tpu_torch.serve.stacked import StackedPredictEngine

    engine = StackedPredictEngine(
        spec, states, n_stocks=PREFLIGHT_STOCKS, lookback=PREFLIGHT_LOOKBACK,
        n_features=PREFLIGHT_FEATURES, buckets=PREFLIGHT_BUCKETS,
        device=device)
    engine.warmup()
    return engine


def _graph_findings(engine, what: str, counter: str, facts: dict
                    ) -> list[Finding]:
    """SV307 for one warmed stacked engine: one capture a bucket on the
    card (none on the CPU), each bucket's graph one launch of ``counter``
    and nothing else."""
    on_card = engine.device.type == "cuda" and engine.graphed
    launches = {b: dict(p.run.launches) for b, p in engine._programs.items()
                if p.captured}
    facts[what] = {"captures": engine.compile_events, "launches": launches}
    findings = []
    want = len(engine.buckets) if on_card else 0
    if engine.compile_events != want:
        findings.append(Finding(
            rule="SV307",
            message=f"{what}: warmup captured {engine.compile_events} "
            f"graphs for {len(engine.buckets)} buckets (expected {want}: "
            "the lane count must not multiply programs)"))
    for b, counts in launches.items():
        if counts != {counter: 1}:
            findings.append(Finding(
                rule="SV307",
                message=f"{what}, bucket {b}: the graph launches {counts} "
                f"(expected one {counter} for all lanes)"))
    return findings


def _stacked(device, facts: dict) -> list[Finding]:
    """SV307 over lane counts and groupings, then SV308 for one lane of
    the largest pair stack."""
    findings: list[Finding] = []
    spec = _stacked_spec()
    states = [_state(spec, seed) for seed in range(max(PREFLIGHT_LANES) + 1)]
    facts["stacked"] = {}
    engine = None
    for lanes in PREFLIGHT_LANES:
        engine = _stacked_engine(spec, states[:lanes], device)
        findings += _graph_findings(engine, f"R{lanes}",
                                    "lstm_pair_fwd_stacked", facts["stacked"])
    facts["stacked_depths"] = {}
    for depth, counter in PREFLIGHT_DEPTHS.items():
        other = _stacked_spec(depth)
        findings += _graph_findings(
            _stacked_engine(other, [_state(other, seed) for seed in range(2)],
                            device),
            f"L{depth}", counter, facts["stacked_depths"])
    findings += _lane_swap_under_load(engine, spec, states[-1], facts)
    return findings


def _lane_swap_under_load(engine, spec, candidate: dict, facts: dict
                          ) -> list[Finding]:
    """SV308 for the last lane of a stacked engine: the swap under load,
    and the sibling lanes' golden answers bitwise as they were."""
    lane = engine.num_lanes - 1
    golden = engine.golden_batch(2, seed=5)
    before = engine.predict(golden)
    run = _under_load(engine, spec, candidate,
                      lambda swapper, tmp: swapper.try_swap_lane(lane, tmp,
                                                                 "best"))
    after = engine.predict(golden)
    siblings = all(np.array_equal(before[i][:, r], after[i][:, r])
                   for i in range(2) for r in range(engine.num_lanes)
                   if r != lane)
    facts["lane_swap"] = {"lane": lane, "reason": run["verdict"].reason,
                          "requests": run["requests"],
                          "unresolved": run["unresolved"],
                          "new_captures": run["new_captures"],
                          "late_deliveries": run["stats"]["late_deliveries"],
                          "siblings_bitwise": siblings,
                          "lanes": run["stats"]["lanes"]}
    findings = _load_findings("lane swap", run)
    if not siblings:
        findings.append(Finding(
            rule="SV308", message="a lane swap moved a sibling lane's answers"))
    return findings


#: SV306: the fleet's replicas, buckets and requests (the JAX rule's).
FLEET_REPLICAS = 2
FLEET_BUCKETS = (1, 2)
FLEET_REQUESTS = 24


def _wait_restart(fleet, name: str, timeout_s: float) -> bool:
    """Wait up to ``timeout_s`` for replica ``name``'s restart: True once a
    generation >= 2 of that replica has booted and gone live to serve (its
    own ``live_generation``, whatever it did after; never the fleet-wide
    death count), False when none did in time."""
    replica = fleet.replicas[name]
    deadline = time.monotonic() + timeout_s
    while True:
        if replica.live_generation >= 2:
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)


def _fleet(spec, device, facts: dict) -> list[Finding]:
    """SV306: two replicas on ``device``, ``r0`` crashed by an injected
    ``serve.replica_dispatch`` fault under traffic."""
    from masters_thesis_tpu_torch.ops import lstm_kernel as lk
    from masters_thesis_tpu_torch.resilience import faults
    from masters_thesis_tpu_torch.resilience.supervisor import (
        ReplicaRestartPolicy,
    )
    from masters_thesis_tpu_torch.serve.engine import PredictEngine
    from masters_thesis_tpu_torch.serve.fleet import FleetServer

    state = _state(spec, 0)
    before = dict(lk.LAUNCHES)

    def factory():
        return PredictEngine(spec, state, n_stocks=PREFLIGHT_STOCKS,
                             lookback=PREFLIGHT_LOOKBACK,
                             n_features=PREFLIGHT_FEATURES,
                             buckets=FLEET_BUCKETS, device=device)

    fleet = FleetServer({f"r{i}": factory for i in range(FLEET_REPLICAS)},
                        max_wait_s=0.003, hang_timeout_s=2.0,
                        restart_policy=ReplicaRestartPolicy(backoff_s=0.01))
    victim = "r0"
    plan = faults.FaultPlan(faults=[faults.FaultSpec(
        point="serve.replica_dispatch", kind="raise", attempt=None,
        match={"replica": victim})])
    windows = np.random.default_rng(0).standard_normal(
        (FLEET_REQUESTS, PREFLIGHT_STOCKS, PREFLIGHT_LOOKBACK,
         PREFLIGHT_FEATURES)).astype(np.float32)
    try:
        fleet.start()
        # Every replica gets the fastest forecast, so that the first batch
        # goes to the victim (the first replica wins a tie). Each forecast
        # is seeded from one timed warm-up batch: a slow one on the victim
        # alone would keep it idle, and its death untested, for the whole
        # run.
        forecast_s = min(r.service_model.batch_s
                         for r in fleet.replicas.values())
        for replica in fleet.replicas.values():
            replica.service_model.seed(forecast_s)
        faults.install_plan(plan)
        pendings = [fleet.submit(w, deadline_s=2.0) for w in windows]
        deadline = time.monotonic() + 10.0
        while (time.monotonic() < deadline
               and fleet.replicas[victim].state != "dead"):
            time.sleep(0.01)
        faults.clear_plan()
        restarted = _wait_restart(fleet, victim, timeout_s=10.0)
        unresolved = 0
        statuses: dict[str, int] = {}
        for p in pendings:
            try:
                status = p.result(timeout=10.0).status
            except TimeoutError:
                unresolved += 1
            else:
                statuses[status] = statuses.get(status, 0) + 1
        # Liveness before stop(): draining is the shutdown state, not a
        # failover outcome.
        survivors = [r.name for r in fleet._serving()]
        stats = fleet.stop()
    finally:
        faults.clear_plan()
    facts["fleet"] = {
        "requests": len(pendings), "statuses": statuses,
        "unresolved": unresolved, "survivors": survivors,
        "restarted": restarted,
        "deaths": stats["deaths"], "redispatched": stats["redispatched"],
        "late_deliveries": stats["late_deliveries"],
        "replicas": {n: {k: r[k] for k in ("state", "generation", "restarts",
                                            "completed", "boot_s")}
                     for n, r in stats["replicas"].items()},
        # The kernels the fleet's engines launched (none on the CPU).
        "launches": {k: n - before[k] for k, n in lk.LAUNCHES.items()
                     if n != before[k]}}
    findings = []
    if stats["deaths"] < 1:
        findings.append(Finding(
            rule="SV306", message="the injected dispatch crash never killed "
            f"the victim replica ({victim}): the preflight did not exercise "
            "failover"))
    if not restarted:
        findings.append(Finding(
            rule="SV306", message=f"the victim replica ({victim}) did not "
            "serve again at generation >= 2 within 10 s of its death: its "
            "restart never landed"))
    if not survivors:
        states = {n: r["state"] for n, r in stats["replicas"].items()}
        findings.append(Finding(
            rule="SV306", message="no serving replica survived a single "
            f"injected replica death (states: {states})"))
    if unresolved:
        findings.append(Finding(
            rule="SV306", message=f"{unresolved} request(s) were silently "
            "dropped after the replica death (every request must resolve "
            "explicitly: ok, shed, or rejected_late)"))
    if stats["late_deliveries"]:
        findings.append(Finding(
            rule="SV306", message=f"{stats['late_deliveries']} ok "
            "response(s) delivered past their deadline during failover (no "
            "late answers, fleet-wide)"))
    return findings


def run_program_cache_preflight(device=None,
                                buckets: tuple = PREFLIGHT_BUCKETS
                                ) -> tuple[list[Finding], dict]:
    """SV305: a warm boot from the program cache makes no program, hits
    once a bucket and answers bit for bit as the cold engine; ``(findings,
    facts)``, SV303 when it cannot run."""
    facts: dict = {}
    try:
        return _program_cache(device, buckets, facts), facts
    except Exception as exc:  # noqa: BLE001 — SV303 carries the cause
        return [Finding(rule="SV303", message="program-cache preflight "
                        f"could not run: {type(exc).__name__}: {exc}")], facts


def _program_cache(device, buckets: tuple, facts: dict) -> list[Finding]:
    from masters_thesis_tpu_torch.serve.engine import PredictEngine
    from masters_thesis_tpu_torch.serve.program_cache import ProgramCache

    spec = _preflight_spec()
    state = _state(spec, 0)
    cache = ProgramCache()

    def build():
        return PredictEngine(spec, state, n_stocks=PREFLIGHT_STOCKS,
                             lookback=PREFLIGHT_LOOKBACK,
                             n_features=PREFLIGHT_FEATURES, buckets=buckets,
                             device=device, program_cache=cache)

    try:
        cold = build()
        t0 = time.perf_counter()
        cold.warmup()
        cold_s = time.perf_counter() - t0
        x = cold.golden_batch(min(2, max(buckets)), seed=11)
        want = cold.predict(x)
        cold.close()
        warm = build()
        t0 = time.perf_counter()
        warm.warmup()
        warm_s = time.perf_counter() - t0
        got = warm.predict(x)
        warm.close()
    finally:
        cache.close()
    facts.update(cold_captures=cold.compile_events, cold_boot_s=cold_s,
                 warm_captures=warm.compile_events,
                 warm_programs_made=warm.programs_made,
                 warm_hits=warm.cache_hits, warm_boot_s=warm_s,
                 cache=cache.stats())
    findings = []
    if warm.programs_made:
        rejections = [e for e in cache.events
                      if e["kind"] == "cache_rejected"]
        findings.append(Finding(
            rule="SV305",
            message=f"warm-cache boot made {warm.programs_made} program(s) "
            f"({warm.compile_events} captured) for buckets {warm.buckets} "
            "(expected 0: every program must come from the cache); "
            f"rejections: {rejections or 'none'}"))
    if warm.cache_hits != len(warm.buckets):
        findings.append(Finding(
            rule="SV305",
            message=f"warm-cache boot hit the cache {warm.cache_hits} "
            f"time(s) for {len(warm.buckets)} buckets (expected one hit a "
            "bucket)"))
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        findings.append(Finding(
            rule="SV305",
            message="the cached programs do not answer bit for bit as the "
            "engine that gave them back"))
    return findings
