"""Finding records and their report.

The port's copy of the part of ``masters_thesis_tpu/analysis/findings.py``
that the serve preflight needs: :class:`Finding` and
:func:`format_report` (text, or ``--json``). The rule registry, the
suppression comments and the other passes are not ported; the SV rules
are described in ``serve/preflight.py``. Stdlib only.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    message: str
    path: str = "<trace>"
    line: int = 0

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.rule} {self.message}"


def format_report(findings: list[Finding], as_json: bool = False) -> str:
    if as_json:
        return json.dumps(
            [dataclasses.asdict(f) for f in findings], indent=2
        )
    if not findings:
        return "tracelint: no findings"
    lines = [f.format() for f in findings]
    lines.append(f"tracelint: {len(findings)} finding(s)")
    return "\n".join(lines)
