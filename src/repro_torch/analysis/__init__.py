"""Program contracts of the port — the port of ``repro/analysis``.

Two passes over the port's programs and source tree:

* **program contracts** (``walker`` + ``contracts`` + ``recompile``):
  an op recorder with source provenance (the counterpart of the
  reference's jaxpr walker), declarative ``ContractRule``s over what a
  program does when it runs (no host sync, dtype round-trip, a
  ring-resident collect, the round's sync budget, CUDA-graph capture on
  a card, zero steady-state compiles), and the program registry in
  ``programs`` that builds the loop driver's pieces for every registered
  scenario;
* **repo lint** (``lint``): AST rules on key discipline, host RNG and
  clocks, and host reads of tensors inside the programs.

Entry point: ``tools/check_programs_torch.py``. Finding formatting lives
in ``report``.
"""
from repro_torch.analysis import walker  # noqa: F401
from repro_torch.analysis.report import Finding, format_finding  # noqa: F401
