from .metrics import MetricsRegistry, global_metrics  # noqa: F401
