"""The quality plane's event folding, as the run report needs it.

A copy of ``quality_report`` and ``quality_violations`` from
``masters_thesis_tpu/telemetry/quality.py``: they fold the
``quality_sample``, ``swap_rejected`` and ``alert_*`` events of a stream
into the report's ``quality`` section and its wiring contract. The
sketches, the fingerprint written at checkpoint time and the serving
monitor are not ported (ROADMAP queue 1 item 5); no port run writes a
``quality_sample`` event yet, so the section stays None. Stdlib only.
"""

from __future__ import annotations


def quality_report(events) -> dict:
    """Fold a merged event stream into the quality section dict.

    Shared by ``report.summarize_events``, the watch console and the
    ``quality`` CLI verb. Input is an iterable of decoded event dicts.
    """
    samples = [e for e in events if e.get("kind") == "quality_sample"]
    out: dict = {"samples": len(samples)}
    if samples:
        last = samples[-1]
        out["last"] = {
            "sampled": last.get("sampled"),
            "scored": bool(last.get("scored")),
            "input_psi": last.get("input_psi"),
            "pred_psi": last.get("pred_psi"),
            "shadow_err": last.get("shadow_err"),
        }
        out["max"] = {
            "input_psi": max(float(e.get("input_psi") or 0.0) for e in samples),
            "pred_psi": max(float(e.get("pred_psi") or 0.0) for e in samples),
            "shadow_err": max(float(e.get("shadow_err") or 0.0) for e in samples),
        }
        out["breaches"] = {
            "input": sum(1 for e in samples if e.get("input_breached")),
            "prediction": sum(1 for e in samples if e.get("pred_breached")),
            "shadow": sum(1 for e in samples if e.get("shadow_breached")),
        }
    rejected = [
        e
        for e in events
        if e.get("kind") == "swap_rejected"
        and str(e.get("reason") or "").startswith("quality")
    ]
    if rejected:
        out["swaps_rejected_quality"] = len(rejected)
        out["last_rejection"] = {
            "tag": rejected[-1].get("tag"),
            "reason": rejected[-1].get("reason"),
        }
    fired = [
        e
        for e in events
        if e.get("kind") == "alert_fired"
        and e.get("slo_kind")
        in ("input_drift", "prediction_drift", "shadow_disagreement")
    ]
    if fired:
        out["alerts_fired"] = len(fired)
    return out


def quality_violations(events, quality: dict | None = None) -> list[str]:
    """Detector-wiring contract: sustained shadow breach must alert.

    Only meaningful when an SLO engine was actually attached (we see
    ``slo_snapshot`` or any ``alert_*`` traffic); a bare serve run with
    no monitor thread is not a violation.
    """
    quality = quality if quality is not None else quality_report(events)
    breaches = (quality.get("breaches") or {}).get("shadow", 0)
    if breaches < 3:
        return []
    slo_attached = any(
        e.get("kind") in ("slo_snapshot", "alert_fired", "alert_resolved")
        for e in events
    )
    if not slo_attached:
        return []
    shadow_alerts = any(
        e.get("kind") == "alert_fired"
        and e.get("slo_kind") == "shadow_disagreement"
        for e in events
    )
    if shadow_alerts:
        return []
    return [
        f"shadow-OLS disagreement breached on {breaches} sampled windows "
        "but no shadow_disagreement alert fired (detector wiring broken)"
    ]
