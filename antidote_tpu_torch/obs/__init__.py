"""Observability: the metrics registry, the error monitor, the prometheus
exposition over HTTP, and timing spans — AntidoteDB's stats layer
(``antidote_stats_collector``, ``antidote_error_monitor`` and the
``/metrics`` listener)."""

from antidote_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NetMetrics,
    NodeMetrics,
    install_error_monitor,
    net_metrics,
)
from antidote_tpu_torch.obs.server import MetricsServer
from antidote_tpu_torch.obs.trace import Timer, trace_span

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NetMetrics",
    "NodeMetrics",
    "MetricsServer",
    "net_metrics",
    "Timer",
    "install_error_monitor",
    "trace_span",
]
