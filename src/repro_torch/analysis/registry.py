"""Rule registry: the ONE definition of every contract the port audits
(port of ``repro/analysis/registry.py``).

A :class:`Rule` states one invariant (a forbidden buffer shape, a state
tree that must survive a refresh, a banned source construct) and checks
it against a *subject* -- a :class:`~repro_torch.analysis.trace_rules.
StepTrace` of one serving call, a :class:`~repro_torch.analysis.
protocol_rules.ProtocolContext`, or a :class:`~repro_torch.analysis.
source_rules.SourceTree`. Tests and ``analysis/run.py audit`` share the
same rule instances, so a contract is written once and enforced
everywhere.

``assert_rules(subject, rules)`` is the test-facing entry point;
``run_rules`` is the audit-facing one that collects :class:`RuleResult`
rows for the audit's JSON (``results_to_json``: the reference's
``ANALYSIS.json`` layout).
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple

__all__ = ["Rule", "RuleResult", "run_rules", "failures", "assert_rules",
           "results_to_json"]


class RuleResult(NamedTuple):
    """One rule evaluated against one subject. ``evidence`` carries the
    matched shapes / sync counts / offending source lines -- enough to act
    on a failure without re-running the audit."""

    rule: str
    target: str
    passed: bool
    evidence: str = ""
    skipped: bool = False
    family: str = ""


class Rule:
    """Base: subclasses set ``name``/``family``/``contract`` and implement
    ``check(subject) -> RuleResult`` via the ``_pass``/``_fail``/``_skip``
    helpers. ``contract`` is the sentence a table of the rules renders."""

    name: str = "Rule"
    family: str = ""
    contract: str = ""

    def check(self, subject) -> RuleResult:
        raise NotImplementedError

    def _pass(self, evidence: str = "") -> RuleResult:
        return RuleResult(self.name, "", True, evidence, False, self.family)

    def _fail(self, evidence: str) -> RuleResult:
        return RuleResult(self.name, "", False, evidence, False, self.family)

    def _skip(self, evidence: str) -> RuleResult:
        return RuleResult(self.name, "", True, evidence, True, self.family)


def run_rules(subject, rules: Iterable[Rule],
              target: str = "") -> List[RuleResult]:
    """Evaluate every rule against one subject; stamp ``target`` (the
    audit-matrix cell, e.g. ``ivf/gleanvec-sorted``) onto each result."""
    out = []
    for rule in rules:
        res = rule.check(subject)
        if target and not res.target:
            res = res._replace(target=target)
        out.append(res)
    return out


def failures(results: Iterable[RuleResult]) -> List[RuleResult]:
    return [r for r in results if not r.passed and not r.skipped]


def assert_rules(subject, rules: Iterable[Rule],
                 target: str = "") -> List[RuleResult]:
    """Run ``rules`` against ``subject`` and raise ``AssertionError``
    listing every violation. ``subject`` may be a ``(fn, *args)`` tuple --
    it is run once under :meth:`~repro_torch.analysis.trace_rules.
    StepTrace.of` -- or any rule-family subject passed through as-is."""
    from repro_torch.analysis import trace_rules

    if isinstance(subject, tuple) and subject and callable(subject[0]):
        subject = trace_rules.StepTrace.of(subject[0], *subject[1:],
                                           label=target)
    results = run_rules(subject, rules, target=target)
    bad = failures(results)
    if bad:
        lines = [f"  {r.rule}[{r.target or '-'}]: {r.evidence}"
                 for r in bad]
        raise AssertionError("contract violation(s):\n" + "\n".join(lines))
    return results


def results_to_json(results: Iterable[RuleResult], **extra) -> dict:
    """The audit's JSON payload (the reference's ``ANALYSIS.json`` layout:
    one top-level tag + a flat ``results`` list of dict rows)."""
    results = list(results)
    rows = [r._asdict() for r in results]
    n_fail = len(failures(results))
    n_skip = sum(1 for r in results if r.skipped)
    return {
        "analysis": "audit",
        "passed": n_fail == 0,
        "counts": {"passed": len(rows) - n_fail - n_skip,
                   "failed": n_fail, "skipped": n_skip},
        **extra,
        "results": rows,
    }
