"""Lightweight process-wide metrics.

The reference's observability is log lines + debug wrappers (reference:
serde/serde.py:30-72, connector/base_connector.py:73-113 — kept here as
the timing wrappers in storage/serde/serde.py). This module adds what
those can't: aggregate counters/histograms a serving deployment can
scrape, exposed as a Prometheus text endpoint on the API server
(``GET /metrics``).

Thread-safe; zero external deps; negligible hot-path cost (one lock'd
float add per event).
"""

import threading
from collections import defaultdict
from typing import Dict, Optional, Tuple

_lock = threading.Lock()
_counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = \
    defaultdict(float)
_summaries: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                 Tuple[int, float, float]] = {}


def _key(name: str, labels: Optional[Dict[str, str]]):
    return (name, tuple(sorted((labels or {}).items())))


def inc(name: str, value: float = 1.0,
        labels: Optional[Dict[str, str]] = None) -> None:
    with _lock:
        _counters[_key(name, labels)] += value


def observe(name: str, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
    """Record one observation (tracks count / sum / max)."""
    k = _key(name, labels)
    with _lock:
        n, s, mx = _summaries.get(k, (0, 0.0, float("-inf")))
        _summaries[k] = (n + 1, s + value, max(mx, value))


def snapshot() -> Dict[str, float]:
    """Flat {metric{labels}: value} view (tests / debugging)."""
    out = {}
    with _lock:
        for (name, labels), v in _counters.items():
            out[_fmt_name(name, labels)] = v
        for (name, labels), (n, s, mx) in _summaries.items():
            out[_fmt_name(name + "_count", labels)] = n
            out[_fmt_name(name + "_sum", labels)] = s
            out[_fmt_name(name + "_max", labels)] = mx
    return out


def reset() -> None:
    with _lock:
        _counters.clear()
        _summaries.clear()


def _fmt_name(name: str, labels) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


def prometheus_text() -> str:
    lines = []
    with _lock:
        for (name, labels), v in sorted(_counters.items()):
            lines.append(f"{_fmt_name(name, labels)} {v}")
        for (name, labels), (n, s, mx) in sorted(_summaries.items()):
            lines.append(f"{_fmt_name(name + '_count', labels)} {n}")
            lines.append(f"{_fmt_name(name + '_sum', labels)} {s}")
            lines.append(f"{_fmt_name(name + '_max', labels)} {mx}")
    return "\n".join(lines) + "\n"
