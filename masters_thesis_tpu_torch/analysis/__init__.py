"""The port's analysis passes: what keeps its performance contract.

The port's counterpart of ``masters_thesis_tpu/analysis``. A training
step, an evaluation chunk and a serving bucket are each one CUDA graph with
no host read inside; one lock orders every capture and replay of a
process; each step all-reduces its gradient once. Those break silently,
so each has a pass:

- the graph-path lint (``astlint.py`` over ``callgraph.py``'s
  graph-reachability; TL101–TL105);
- the trainer preflight (``traceaudit.py``; TA201–TA207), which runs the
  real training step, and which ``Trainer(preflight=True)`` runs before
  ``fit``;
- the serve preflight's rules (``serve/preflight.py``; SV3xx);
- the concurrency lint (``concurrency.py``; CL501–CL505), the event
  contract (``contracts.py``, ``event_schema.json``; EC601–EC603) and the
  SPMD lint (``spmd.py``; DV701–DV705).

``findings.py`` holds the rule registry and the one suppression syntax
(``# mtt: disable=<ID> -- reason``). Every pass but the preflight is
stdlib only, and importing this package imports no torch. CLI:
``python -m masters_thesis_tpu_torch.analysis`` (exit 1 on a finding).
"""

from masters_thesis_tpu_torch.analysis.astlint import lint_paths
from masters_thesis_tpu_torch.analysis.findings import (
    RULES,
    Finding,
    format_report,
)

__all__ = ["Finding", "RULES", "format_report", "lint_paths"]
