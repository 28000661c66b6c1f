"""Prometheus text exposition of the telemetry snapshot.

The port's own copy of ``rafiki_tpu/obs/prom.py``: the same snapshot
renders to the same bytes in both packages.

``GET /metrics?format=prom`` on both web apps renders the SAME
registry snapshot the JSON endpoint serves — one source of truth, two
encodings. Mapping:

* counters            -> ``# TYPE rafiki_<name> counter``
* gauges              -> ``# TYPE rafiki_<name> gauge``
* histogram summaries -> Prometheus *summary*: ``{quantile="0.5|0.9|0.99"}``
  series plus ``_sum``/``_count``
* span aggregates     -> ``rafiki_span_seconds_total{name="..."}`` /
  ``rafiki_span_count{name="..."}``
* collectors          -> numeric leaves flattened to gauges
  (``rafiki_program_cache_hits``); non-numeric leaves dropped —
  Prometheus has no string samples.

Output is deterministic (sorted names) so the exposition is
golden-file testable. Stdlib-only formatter: no prometheus_client
dependency, the text format is ~20 lines of spec.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

PREFIX = "rafiki"

_SAN_RE = re.compile(r"[^a-zA-Z0-9_]")
_QUANTILES = (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99"))
#: Snapshot keys that are NOT collectors.
_STRUCTURAL = {"ts", "counters", "gauges", "histograms", "spans"}


def _san(name: str) -> str:
    out = _SAN_RE.sub("_", name)
    return out if not out[:1].isdigit() else "_" + out


def _fmt(v: Any) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _esc(label: str) -> str:
    return label.replace("\\", "\\\\").replace('"', '\\"')


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _flatten(prefix: str, value: Any, out: Dict[str, float]) -> None:
    if _is_num(value):
        out[prefix] = value
    elif isinstance(value, dict):
        for k, v in value.items():
            _flatten(f"{prefix}_{_san(str(k))}", v, out)
    # strings / None / bools / lists: no Prometheus representation


def to_prometheus(snapshot: Dict[str, Any]) -> str:
    """Render a ``telemetry.snapshot()`` dict as Prometheus text
    exposition format (version 0.0.4)."""
    lines: List[str] = []

    for name in sorted(snapshot.get("counters", {})):
        metric = f"{PREFIX}_{_san(name)}"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {_fmt(snapshot['counters'][name])}")

    for name in sorted(snapshot.get("gauges", {})):
        metric = f"{PREFIX}_{_san(name)}"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {_fmt(snapshot['gauges'][name])}")

    for name in sorted(snapshot.get("histograms", {})):
        summary = snapshot["histograms"][name]
        metric = f"{PREFIX}_{_san(name)}"
        lines.append(f"# TYPE {metric} summary")
        for key, q in _QUANTILES:
            if summary.get(key) is not None:
                lines.append(
                    f'{metric}{{quantile="{q}"}} {_fmt(summary[key])}')
        lines.append(f"{metric}_sum {_fmt(summary.get('sum', 0.0))}")
        lines.append(f"{metric}_count {_fmt(summary.get('count', 0))}")

    spans = snapshot.get("spans", {})
    if spans:
        lines.append(f"# TYPE {PREFIX}_span_seconds_total counter")
        for name in sorted(spans):
            lines.append(
                f'{PREFIX}_span_seconds_total{{name="{_esc(name)}"}} '
                f"{_fmt(spans[name].get('total_s', 0.0))}")
        lines.append(f"# TYPE {PREFIX}_span_count counter")
        for name in sorted(spans):
            lines.append(
                f'{PREFIX}_span_count{{name="{_esc(name)}"}} '
                f"{_fmt(spans[name].get('count', 0))}")

    flat: Dict[str, float] = {}
    for key in sorted(snapshot):
        if key in _STRUCTURAL:
            continue
        _flatten(f"{PREFIX}_{_san(key)}", snapshot[key], flat)
    for metric in sorted(flat):
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {_fmt(flat[metric])}")

    return "\n".join(lines) + "\n"
