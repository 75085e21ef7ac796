"""Structured compiler diagnostics for the Calyx path.

Every static check in the verifier (``core.verify``), the Verilog text
lint (``verilog.lint_diagnostics``), and the simulators' runtime raises
speak one vocabulary: a :class:`Diagnostic` with a stable ``RV0xx`` error
code, a severity, a human message, the pipeline *stage* that produced it,
and a *provenance chain* — outermost-to-innermost locations (control-tree
path -> group -> micro-op -> netlist state/wire) so a finding at any
layer can be traced back to the construct that lowered it.

The code space is grouped by family:

* ``RV00x`` — IR well-formedness (dangling references, unreachable
  groups, malformed control nodes).
* ``RV01x`` — dataflow over the stamped micro-op schedules (SSA temp
  discipline, register def-use/liveness, write races).
* ``RV02x`` — static re-proofs of the hardware disciplines the
  simulators enforce dynamically (one-access-per-cycle memory ports,
  single-owner shared pools, modulo-II reservation soundness).
* ``RV03x`` — netlist-level structure (multi-driven nets, combinational
  loops, FSM reachability, index-register resolution).
* ``RV04x`` — emitted-SystemVerilog text lint.

Severities: ``error`` findings are miscompiles — the pipeline refuses to
hand the artifact to the next stage (:class:`VerificationError`);
``warning`` findings are suspicious but sound (dead cells/groups — the
elimination pass in ``core.verify`` consumes exactly these); ``info`` is
reporting only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

ERROR = "error"
WARNING = "warning"
INFO = "info"

#: code -> (one-line title, default severity).  The single source of the
#: error-code table in the README; ``tests/test_core_verify.py`` checks
#: every code here fires on its negative-corpus fixture.
CODES: Dict[str, Tuple[str, str]] = {
    # -- RV00x: IR well-formedness -------------------------------------
    "RV001": ("dangling cell reference", ERROR),
    "RV002": ("unused cell", WARNING),
    "RV003": ("control references undefined group", ERROR),
    "RV004": ("group unreachable from the control tree", WARNING),
    "RV005": ("if-node missing its lowered condition", ERROR),
    "RV006": ("malformed repeat node", ERROR),
    "RV007": ("group carries no micro-ops", ERROR),
    "RV008": ("access to undeclared memory", ERROR),
    "RV009": ("unbound loop variable in address/condition", ERROR),
    # -- RV01x: micro-op dataflow --------------------------------------
    "RV010": ("temp read before definition", ERROR),
    "RV011": ("register read before any write", ERROR),
    "RV012": ("dead register write", WARNING),
    "RV013": ("register write-write race", ERROR),
    "RV014": ("temp defined more than once", ERROR),
    # -- RV02x: static hardware-discipline proofs ----------------------
    "RV020": ("memory port conflict (one access per cycle)", ERROR),
    "RV021": ("shared pool cell owned by concurrent arms", ERROR),
    "RV022": ("unsound initiation interval", ERROR),
    "RV023": ("pipelined loop with loop-carried memory dependence", ERROR),
    # -- RV03x: netlist structure --------------------------------------
    "RV030": ("multi-driven net", ERROR),
    "RV031": ("combinational loop", ERROR),
    "RV032": ("unreachable FSM state", WARNING),
    "RV033": ("dangling FSM transition", ERROR),
    "RV034": ("loop variable unresolvable on the controller chain", ERROR),
    # -- RV04x: SystemVerilog text lint --------------------------------
    "RV040": ("delay control in emitted Verilog", ERROR),
    "RV041": ("initial block outside memory init", ERROR),
    "RV042": ("multi-driver net in emitted Verilog", ERROR),
    # -- RV05x: observability (perf-counter bank) ----------------------
    "RV050": ("perf counter references unknown group or unit", ERROR),
    "RV051": ("perf counter address map malformed", ERROR),
    "RV052": ("profiled netlist counter bank incomplete", ERROR),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding, traceable through the lowering layers."""
    code: str                       # stable RV0xx identifier
    message: str
    severity: str = ""              # defaults to the code's registry entry
    stage: str = ""                 # pipeline boundary that produced it
    provenance: Tuple[str, ...] = ()  # outermost -> innermost location

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if not self.severity:
            object.__setattr__(self, "severity", CODES[self.code][1])
        elif self.severity not in (ERROR, WARNING, INFO):
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def title(self) -> str:
        return CODES[self.code][0]

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def where(self) -> str:
        return " > ".join(self.provenance)

    def format(self) -> str:
        loc = f" [{self.where()}]" if self.provenance else ""
        stage = f" ({self.stage})" if self.stage else ""
        return f"{self.code} {self.severity}{stage}: {self.message}{loc}"


def diag(code: str, message: str, *, stage: str = "",
         provenance: Iterable[str] = (),
         severity: str = "") -> Diagnostic:
    """Build a :class:`Diagnostic` with the registry's default severity."""
    return Diagnostic(code=code, message=message, severity=severity,
                      stage=stage, provenance=tuple(provenance))


class VerificationError(RuntimeError):
    """A stage boundary rejected its artifact (error-severity findings).

    Carries the full :class:`DiagnosticReport` so callers (the lint CLI,
    tests) can render the structured findings, not just the message.
    """

    def __init__(self, report: "DiagnosticReport"):
        self.report = report
        errs = report.errors()
        head = "; ".join(d.format() for d in errs[:3])
        more = f" (+{len(errs) - 3} more)" if len(errs) > 3 else ""
        super().__init__(
            f"stage {report.stage!r}: {len(errs)} error-severity "
            f"diagnostic(s): {head}{more}")


@dataclasses.dataclass
class DiagnosticReport:
    """All findings of one verification pass at one stage boundary."""
    stage: str
    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    wall_us: float = 0.0            # verifier wall-clock for this pass

    def add(self, d: Diagnostic) -> None:
        if not d.stage:
            d = dataclasses.replace(d, stage=self.stage)
        self.diagnostics.append(d)

    def extend(self, ds: Iterable[Diagnostic]) -> None:
        for d in ds:
            self.add(d)

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self.diagnostics)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    def by_code(self) -> Dict[str, List[Diagnostic]]:
        out: Dict[str, List[Diagnostic]] = {}
        for d in self.diagnostics:
            out.setdefault(d.code, []).append(d)
        return out

    @property
    def ok(self) -> bool:
        """True when no error-severity finding was recorded."""
        return not self.errors()

    def raise_if_errors(self) -> None:
        if not self.ok:
            raise VerificationError(self)

    def summary(self) -> str:
        ne, nw = len(self.errors()), len(self.warnings())
        return (f"{self.stage}: {ne} error(s), {nw} warning(s), "
                f"{len(self.diagnostics)} finding(s) "
                f"in {self.wall_us:.0f}us")

    def table(self) -> str:
        """Render the findings as a fixed-width diagnostic table."""
        return render_table([self])


def render_table(reports: Iterable["DiagnosticReport"]) -> str:
    """One table over several stage reports (the ``--verify`` CLI view)."""
    rows: List[Tuple[str, str, str, str, str]] = []
    for rep in reports:
        for d in rep:
            rows.append((d.code, d.severity, d.stage or rep.stage,
                         d.message, d.where()))
    if not rows:
        stages = ", ".join(r.stage for r in reports) or "-"
        return f"no findings (stages: {stages})"
    headers = ("code", "severity", "stage", "message", "provenance")
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = min(max(widths[i], len(cell)), 56)

    def fmt(row: Tuple[str, ...]) -> str:
        return "  ".join(
            (c[:53] + "..." if len(c) > 56 else c).ljust(widths[i])
            for i, c in enumerate(row)).rstrip()

    lines = [fmt(headers), fmt(tuple("-" * w for w in widths))]
    lines += [fmt(row) for row in rows]
    return "\n".join(lines)


class _Timer:
    """Context manager stamping ``wall_us`` onto a report."""

    def __init__(self, report: DiagnosticReport):
        self.report = report

    def __enter__(self) -> DiagnosticReport:
        self._t0 = time.perf_counter()
        return self.report

    def __exit__(self, *exc) -> None:
        self.report.wall_us = (time.perf_counter() - self._t0) * 1e6


def timed_report(stage: str) -> _Timer:
    """``with timed_report("post-lower") as rep: ...`` — stamps wall_us."""
    return _Timer(DiagnosticReport(stage))
