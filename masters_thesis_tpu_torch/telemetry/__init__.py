"""Telemetry of the port: the JSONL event log, the metrics registry, spans
and the ``/metrics`` endpoint. Stdlib only at import (``run`` reads the
card's memory through torch when torch is already imported)."""
