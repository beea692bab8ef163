"""Contract checks of the serving stack (port of ``repro/analysis``).

Three rule layers over one registry (:mod:`repro_torch.analysis.registry`):

* :mod:`repro_torch.analysis.trace_rules` -- checks on what one serving
  call does (its aten ops, synchronizing calls, peak memory and device
  kernels): no dense score-matrix buffer, no row gather on a fused path,
  no host sync in the step, a launch budget, swaps without a copy;
* :mod:`repro_torch.analysis.protocol_rules` -- the Scorer / Index /
  host-tier contracts (state structure stable across streaming and index
  refreshes, a leafless host store, -1 id padding, static index config);
* :mod:`repro_torch.analysis.source_rules` -- AST lint (isinstance
  dispatch on hot paths, host syncs in the serving step's bodies).

``assert_rules(subject, rules)`` is the single entry point tests use;
``python -m repro_torch.analysis.run audit`` sweeps the serving matrix and
writes ``ANALYSIS_torch.json``.
"""
from repro_torch.analysis.registry import (Rule, RuleResult, assert_rules,
                                           failures, results_to_json,
                                           run_rules)

__all__ = ["Rule", "RuleResult", "assert_rules", "failures",
           "results_to_json", "run_rules"]
