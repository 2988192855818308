"""Static and traced analysis over the port's programs and its source
(counterpart of ``repro/analysis``).

Two rule registries, one shape:

* :data:`PROGRAM_RULES` (``analysis.rules``) run over
  :class:`ProgramArtifacts` -- one traced run of each spec-built train
  step and serving decode tick (``analysis.program``), read by
  ``analysis.trace`` (ATen operations, kernel ops, float64 sites, the
  storages written in place) and ``analysis.collectives`` (the
  collectives the meshes issued, with their logical axes).
  ``analysis.report`` serializes the census and diffs it against the
  committed golden (``src/repro_torch/analysis/programs.json``) -- see
  ``torch_lint_programs.py``.
* :data:`SOURCE_RULES` (``analysis.ast_rules``) run over
  ``src/repro_torch`` source text -- see ``torch_check_no_globals.py``.
"""
from .ast_rules import (SOURCE_RULES, SourceFile, SourceRule,  # noqa: F401
                        check_source)
from .collectives import (COLLECTIVE_PRIMITIVES,  # noqa: F401
                          ExplicitCollective, record_collectives,
                          summed_elements)
from .program import (ProgramArtifacts, artifacts_for_spec,  # noqa: F401
                      decode_artifacts, train_artifacts, train_run)
from .report import (collect, compare, direction_for, dumps,  # noqa: F401
                     extract_metrics, program_report, tolerance_for)
from .rules import (PROGRAM_RULES, SCALAR_MAX, Rule,  # noqa: F401
                    Violation, run_rules)
from .trace import (F64_SITES, ProgramRun, ProgramTrace,  # noqa: F401
                    trace_program)
