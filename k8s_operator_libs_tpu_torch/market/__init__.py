"""The training/serving capacity market (a port of the JAX package's
``market/``).

:class:`CapacityArbiter` preempts a training slice to serving when
serving pressure outprices the slice's marginal goodput, and returns it
when the pressure falls, each decision stamped on the slice's nodes
first (the ``tpu.dev/market.*`` keys of ``wire.py``). ``demand.py``
holds the two inputs the arbiter takes from outside: the router
binary's ``/lanes`` (:class:`HTTPLaneDemand`) and the trainer's goodput
ledger (:func:`ledger_goodput`).
"""

from .arbiter import (LEGAL_OWNERS, OWNER_LABELS, PHASES, PREEMPTING,
                      RETURNING, SERVING, TRAINING, CapacityArbiter,
                      ManagedSlice, MarketConfig, marginal_goodput)
from .demand import HTTPLaneDemand, ledger_goodput
from .metrics import MARKET_GAUGE_FAMILIES, MARKET_PREFIX

__all__ = [
    "CapacityArbiter", "HTTPLaneDemand", "LEGAL_OWNERS", "ManagedSlice",
    "MARKET_GAUGE_FAMILIES", "MARKET_PREFIX", "MarketConfig",
    "OWNER_LABELS", "PHASES", "PREEMPTING", "RETURNING", "SERVING",
    "TRAINING", "ledger_goodput", "marginal_goodput",
]
