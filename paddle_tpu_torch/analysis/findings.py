"""Finding/report model shared by every lint pass (the port's copy of
``paddle_tpu/analysis/findings.py``; the trace guard is its one user).

A Finding is one hazard at one location: ``rule`` names the check,
``severity`` ranks it, ``where`` points at the source (user frame for
jaxpr rules, file:line for AST rules, function key for the trace
guard), and ``graph`` names the linted program so the same rule firing
in two graphs stays two findings. ``key()`` is the stable identity the
baseline matches on — deliberately line-number-free for jaxpr findings
(tracing moves lines; the hazard is per-graph-per-rule-per-detail).
"""
from __future__ import annotations

import dataclasses
import json


class Severity:
    ERROR = "error"      # correctness hazard (would be wrong/crash on chip)
    WARNING = "warning"  # perf hazard (runs, but slower than the hw allows)
    INFO = "info"        # worth knowing; never gates

    _ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

    @classmethod
    def rank(cls, s):
        return cls._ORDER.get(s, 99)


@dataclasses.dataclass
class Finding:
    rule: str
    severity: str
    message: str
    graph: str = ""       # linted program name ("llama_fwd", "decode_step"…)
    where: str = ""       # provenance: file:line or function key
    detail: str = ""      # stable discriminator (var/dtype/axis/param name)

    def key(self):
        """Baseline identity: everything except the free-text message."""
        return f"{self.rule}|{self.graph}|{self.detail}"

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: d.get(k, "") for k in
                      ("rule", "severity", "message", "graph", "where",
                       "detail")})

    def __str__(self):
        loc = f" [{self.where}]" if self.where else ""
        g = f" ({self.graph})" if self.graph else ""
        return f"{self.severity.upper()} {self.rule}{g}: {self.message}{loc}"


class Report:
    """An ordered collection of findings with merge/serialize helpers."""

    def __init__(self, findings=None):
        self.findings = list(findings or [])

    def add(self, finding):
        self.findings.append(finding)

    def extend(self, findings):
        self.findings.extend(findings)

    def sorted(self):
        return sorted(
            self.findings,
            key=lambda f: (Severity.rank(f.severity), f.rule, f.graph,
                           f.detail),
        )

    def by_rule(self):
        out = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out

    def counts(self):
        out = {}
        for f in self.findings:
            out[f.severity] = out.get(f.severity, 0) + 1
        return out

    def to_json(self, indent=1):
        return json.dumps(
            {"findings": [f.to_dict() for f in self.sorted()],
             "counts": self.counts()},
            indent=indent,
        )

    def __len__(self):
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)
