"""Shared finding formatting for the port's gates — the port of
``repro/analysis/report.py``.

``tools/check_programs_torch.py`` (contract and lint findings) prints
every problem through :func:`format_finding`, so the output has one
shape: a stable uppercase tag, ``file:line`` provenance when known, and,
under ``GITHUB_ACTIONS``, a ``::error`` workflow command so CI renders
each finding as an annotation on the offending line.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = ["Finding", "format_finding", "emit"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One reportable problem from any gate."""
    tag: str                       # e.g. CONTRACT-VIOLATION, LINT
    message: str
    file: Optional[str] = None
    line: Optional[int] = None
    rule: Optional[str] = None     # rule / check name, shown as a title

    @property
    def location(self) -> str:
        if not self.file:
            return ""
        return f"{self.file}:{self.line}" if self.line else self.file


def format_finding(f: Finding, *, github: Optional[bool] = None) -> str:
    """Render one finding.

    Plain mode::

        CONTRACT-VIOLATION src/x.py:42 [NoHostSync] item() in ials_train

    GitHub mode (``github=True``, or auto-detected from the
    ``GITHUB_ACTIONS`` env var) emits a workflow command that the Actions
    runner turns into a file:line annotation::

        ::error file=src/x.py,line=42,title=NoHostSync::[CONTRACT-...] ...
    """
    if github is None:
        github = os.environ.get("GITHUB_ACTIONS") == "true"
    if github:
        props = []
        if f.file:
            props.append(f"file={f.file}")
        if f.line:
            props.append(f"line={f.line}")
        props.append(f"title={f.rule or f.tag}")
        # workflow commands terminate the message at a newline
        msg = f.message.replace("\n", " ")
        return f"::error {','.join(props)}::[{f.tag}] {msg}"
    parts = [f.tag]
    loc = f.location
    if loc:
        parts.append(loc)
    if f.rule:
        parts.append(f"[{f.rule}]")
    parts.append(f.message)
    return " ".join(parts)


def emit(findings, *, github: Optional[bool] = None) -> int:
    """Print every finding; return the count (0 = clean)."""
    n = 0
    for f in findings:
        print(format_finding(f, github=github))
        n += 1
    return n
