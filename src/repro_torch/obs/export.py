"""Exporters for traces and metrics.

* :func:`render_trace` — a compact per-query tree for terminal display
  (``Engine.execute(..., profile=True)`` then ``render_trace(res.trace)``).
* :func:`prometheus_text` — the classic ``# TYPE`` + series-per-line text
  exposition of a :class:`~repro_torch.obs.metrics.MetricsRegistry`, served by
  ``launch/serve.py`` as its ``/metrics``-style dump.
"""

from __future__ import annotations

from typing import Any, List, Optional

from .metrics import Histogram, MetricsRegistry, metric_key
from .trace import Span

__all__ = ["render_trace", "prometheus_text"]


def _fmt_val(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    if isinstance(v, (list, tuple)) and len(v) > 8:
        return f"[{', '.join(str(x) for x in v[:8])}, ...x{len(v)}]"
    return str(v)


def _fmt_attrs(span: Span, max_items: int = 6) -> str:
    if not span.attrs:
        return ""
    items = list(span.attrs.items())
    shown = "  ".join(f"{k}={_fmt_val(v)}" for k, v in items[:max_items])
    more = f"  +{len(items) - max_items} attrs" if len(items) > max_items \
        else ""
    return f"  {shown}{more}"


def render_trace(span: Optional[Span], max_attrs: int = 6) -> str:
    """Compact per-query trace tree, one span per line::

        query 35.62ms  key=... backend=host
        ├─ parse 0.08ms
        ├─ plan 0.21ms  backend=host enum=frontier cached=False
        ...
    """
    if span is None:
        return "(no trace: run with profile=True)"
    lines: List[str] = []

    def walk(s: Span, prefix: str, connector: str) -> None:
        lines.append(f"{prefix}{connector}{s.name} "
                     f"{s.duration_s * 1e3:.2f}ms{_fmt_attrs(s, max_attrs)}")
        child_prefix = prefix
        if connector:
            child_prefix += "│  " if connector.startswith("├") else "   "
        for i, c in enumerate(s.children):
            last = i == len(s.children) - 1
            walk(c, child_prefix, "└─ " if last else "├─ ")

    walk(span, "", "")
    return "\n".join(lines)


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus-style text exposition (sorted, stable).

    Histograms emit the full conformant family — cumulative ``_bucket``
    series ending in the mandatory ``le="+Inf"`` (equal to ``_count``),
    plus ``_sum`` and ``_count`` — and additionally ``_quantile`` gauge
    lines carrying the bucket-interpolated p50/p95/p99 estimates, so a
    scrape-less consumer (the CI artifact, a log line) gets latency
    quantiles without doing ``histogram_quantile`` itself.  Label values
    are exposition-escaped by :func:`~repro_torch.obs.metrics.metric_key`."""
    lines: List[str] = []
    metrics = sorted(registry, key=lambda m: (m.name, m.labels))
    seen_type = set()
    for m in metrics:
        if m.name not in seen_type:
            lines.append(f"# TYPE {m.name} {m.kind}")
            seen_type.add(m.name)
        if isinstance(m, Histogram):
            cum = 0
            for b, c in zip(m.buckets, m.bucket_counts):
                cum += c
                labels = m.labels + (("le", f"{b:g}"),)
                lines.append(f"{metric_key(m.name + '_bucket', labels)} "
                             f"{cum}")
            cum += m.bucket_counts[-1]
            labels = m.labels + (("le", "+Inf"),)
            lines.append(f"{metric_key(m.name + '_bucket', labels)} {cum}")
            lines.append(f"{metric_key(m.name + '_sum', m.labels)} "
                         f"{m.total:g}")
            lines.append(f"{metric_key(m.name + '_count', m.labels)} "
                         f"{m.count}")
            qname = m.name + "_quantile"
            for q in (0.5, 0.95, 0.99):
                v = m.quantile(q)
                if v is None:          # empty histogram: no quantile family
                    continue
                if qname not in seen_type:
                    lines.append(f"# TYPE {qname} gauge")
                    seen_type.add(qname)
                labels = m.labels + (("quantile", f"{q:g}"),)
                lines.append(f"{metric_key(qname, labels)} {v:g}")
        else:
            v = m.value
            lines.append(f"{m.key()} {v:g}" if isinstance(v, float)
                         else f"{m.key()} {v}")
    return "\n".join(lines) + ("\n" if lines else "")
