from .metrics import MetricsHub, render_gauges

__all__ = ["MetricsHub", "render_gauges"]
