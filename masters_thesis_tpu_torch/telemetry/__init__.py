"""Telemetry of the port: the JSONL event log, the metrics registry, spans,
the ``/metrics`` endpoint and the perf ledger. Stdlib only at import
(``run`` reads the card's memory through torch when torch is already
imported).

The ledger's functions are exported as in the JAX package;
``knee_from_ledger`` is resolved on first use, because ``signals`` reaches
the quality plane, which imports numpy, and the ledger CLI must start
without it."""

from masters_thesis_tpu_torch.telemetry.ledger import (
    append_record,
    ledger_diff,
    ledger_record,
    read_ledger,
)

__all__ = [
    "append_record",
    "knee_from_ledger",
    "ledger_diff",
    "ledger_record",
    "read_ledger",
]


def __getattr__(name: str):
    if name == "knee_from_ledger":
        from masters_thesis_tpu_torch.telemetry.signals import knee_from_ledger

        return knee_from_ledger
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
