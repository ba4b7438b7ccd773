"""The closed ``tpu_market_*`` metric-family table (a copy of the JAX
package's ``market/metrics.py``).

Every family the capacity arbiter emits, as a plain string; each has
its HELP text in ``obs/metrics.py:HELP_TEXTS``. The arbiter's
:class:`~..obs.metrics.MetricsHub` renders under :data:`MARKET_PREFIX`,
beside ``tpu_workload_*`` and ``tpu_router_*``.
"""

from __future__ import annotations

MARKET_PREFIX = "tpu_market"

# gauge families the arbiter emits through the hub (full exposed names)
MARKET_GAUGE_FAMILIES = (
    "tpu_market_exchange_rate",
    "tpu_market_serving_pressure",
    "tpu_market_training_value",
    "tpu_market_trades",
    "tpu_market_returns",
    "tpu_market_slices_lent",
)
