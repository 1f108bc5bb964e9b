"""Declarative SLO rules over registry snapshots.

Counterpart of ``distributed_embeddings_tpu/obs/slo.py``, copied. A rule
is data, not code, checked into a JSON file (the port's tier-1 rule file
is ``tools/slo_tier1.json`` in this package):

    {"name": "trained-every-step", "metric": "train/steps",
     "op": ">=", "threshold": 8}
    {"name": "serve-p99", "metric": "serve/request_seconds:p99_ms",
     "op": "<=", "threshold": 250, "window": 5, "severity": "warning"}

``metric`` addresses a snapshot entry by its flat registry key
(`obs.registry.metric_key` form, labels included); a ``:field`` suffix
selects a histogram summary field (``p50_ms``/``p95_ms``/``p99_ms``/
``mean_ms``/``max_ms``/``count``). ``window=N`` evaluates the rule over
the last N snapshots of a sequence (e.g. the parsed lines of a
`MetricRegistry.export_jsonl` file): the rule must hold in EVERY snapshot
of the window; a single snapshot is a window of one.

An absent metric is a violation by default (an SLO over a signal that
never materialized must fail loudly, not pass vacuously);
``"if_present": true`` opts a rule out of that.

Violations come back as `Finding`s, the shape of the JAX package's
``analysis.passes.Finding`` (its static-analysis findings are ROADMAP
Queue A15d; the port keeps its own copy of the dataclass), with stable
content-derived ids (``slo:<name>``).
"""

import dataclasses
import json
import operator
from typing import Dict, List, Optional, Sequence, Union

__all__ = ["Finding", "load_rules", "validate_rule", "metric_value",
           "evaluate_rules", "summarize"]


@dataclasses.dataclass
class Finding:
    """One rule violation (the JAX ``analysis.passes.Finding``'s
    fields)."""

    pass_name: str
    fid: str                      # stable id, allowlist key
    severity: str                 # 'error' | 'warning'
    message: str
    func: str = ""                # what the finding anchors to
    line: int = 0                 # display only, NOT in fid
    op: str = ""                  # op mnemonic involved

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_OPS = {"<": operator.lt, "<=": operator.le, "==": operator.eq,
        "!=": operator.ne, ">=": operator.ge, ">": operator.gt}

_HIST_FIELDS = ("count", "mean_ms", "p50_ms", "p95_ms", "p99_ms",
                "max_ms")


def validate_rule(rule: dict) -> dict:
    """Shape-check one rule; returns it. Fails LOUDLY at load time —
    a malformed rule that silently never fires is a gate that cannot
    gate."""
    for field in ("name", "metric", "op", "threshold"):
        if field not in rule:
            raise ValueError(f"SLO rule missing {field!r}: {rule}")
    if rule["op"] not in _OPS:
        raise ValueError(
            f"SLO rule {rule['name']!r}: op {rule['op']!r} not in "
            f"{sorted(_OPS)}")
    if not isinstance(rule["threshold"], (int, float)):
        raise ValueError(
            f"SLO rule {rule['name']!r}: threshold must be a number")
    window = rule.get("window", 1)
    if not (isinstance(window, int) and window >= 1):
        raise ValueError(
            f"SLO rule {rule['name']!r}: window must be an int >= 1")
    sev = rule.get("severity", "error")
    if sev not in ("error", "warning"):
        raise ValueError(
            f"SLO rule {rule['name']!r}: severity {sev!r} not in "
            "('error', 'warning')")
    if not isinstance(rule.get("if_present", False), bool):
        raise ValueError(
            f"SLO rule {rule['name']!r}: if_present must be a bool")
    return rule


def load_rules(path: str) -> List[dict]:
    """Load + validate a JSON rule file: either a bare list of rules or
    ``{"rules": [...]}`` (room for future file-level fields)."""
    with open(path) as f:
        doc = json.load(f)
    rules = doc["rules"] if isinstance(doc, dict) else doc
    if not isinstance(rules, list):
        raise ValueError(f"{path}: expected a rule list")
    return [validate_rule(r) for r in rules]


def metric_value(snapshot: dict, metric: str) -> Optional[float]:
    """Resolve a rule's metric address against one snapshot; None when
    absent. Counters/gauges resolve by flat key; histograms need a
    ``:field`` suffix (addressing a histogram without one is a rule
    bug, raised not hidden)."""
    name, _, field = metric.partition(":")
    for section in ("counters", "gauges"):
        if name in snapshot.get(section, {}):
            if field:
                raise ValueError(
                    f"metric {metric!r}: field suffix on a {section[:-1]}"
                    " (only histograms have summary fields)")
            return float(snapshot[section][name])
    hist = snapshot.get("histograms", {}).get(name)
    if hist is not None:
        if not field:
            raise ValueError(
                f"metric {metric!r} is a histogram: address a summary "
                f"field ({', '.join(_HIST_FIELDS)})")
        if field not in hist:
            raise ValueError(
                f"metric {metric!r}: no field {field!r} in "
                f"{sorted(hist)}")
        return float(hist[field])
    return None


def evaluate_rules(rules: Sequence[dict],
                   snapshots: Union[dict, Sequence[dict]]) -> List[Finding]:
    """Evaluate every rule; return one Finding per violated (or
    unresolvable) rule.

    `snapshots` is one snapshot dict or an ordered sequence (oldest
    first); each rule reads its last ``window`` snapshots and must hold
    in all of them. A metric missing from any windowed snapshot is a
    violation — an SLO over a signal that never materialized must fail
    loudly, not vacuously pass — unless the rule opts out with
    ``"if_present": true`` (see module docstring).
    """
    if isinstance(snapshots, dict):
        snapshots = [snapshots]
    snapshots = list(snapshots)
    if not snapshots:
        raise ValueError("evaluate_rules needs at least one snapshot")
    findings: List[Finding] = []
    for rule in rules:
        rule = validate_rule(dict(rule))
        window = snapshots[-int(rule.get("window", 1)):]
        op = _OPS[rule["op"]]
        optional = bool(rule.get("if_present", False))
        worst: Optional[float] = None
        missing = False
        for snap in window:
            v = metric_value(snap, rule["metric"])
            if v is None:
                if optional:
                    # if_present: absent snapshots are skipped, but the
                    # rule still gates every snapshot where the metric
                    # DID materialize — a breach observed before the
                    # subsystem went quiet must not be silenced
                    continue
                missing = True
                break
            if not op(v, rule["threshold"]) and (
                    worst is None or abs(v - rule["threshold"])
                    > abs(worst - rule["threshold"])):
                worst = v
        if missing:
            findings.append(Finding(
                pass_name="slo", fid=f"slo:{rule['name']}:absent",
                severity=rule.get("severity", "error"),
                message=(f"SLO {rule['name']!r}: metric "
                         f"{rule['metric']!r} absent from snapshot"),
                func=rule["metric"], op=rule["op"]))
        elif worst is not None:
            findings.append(Finding(
                pass_name="slo", fid=f"slo:{rule['name']}",
                severity=rule.get("severity", "error"),
                message=(f"SLO {rule['name']!r}: {rule['metric']} = "
                         f"{worst:g}, want {rule['op']} "
                         f"{rule['threshold']:g} over window of "
                         f"{len(window)}"),
                func=rule["metric"], op=rule["op"]))
    return findings


def summarize(findings: Sequence[Finding]) -> Dict[str, object]:
    """The ``{"count", "ids"}`` bundle a run's record embeds."""
    return {"count": len(findings),
            "ids": sorted({f.fid for f in findings})}
