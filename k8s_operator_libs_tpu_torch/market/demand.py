"""The arbiter's inputs from outside the process, and the arbiter the
operator binary builds from its config.

A copy of the market parts of the JAX package's ``cmd/operator.py``:
``HTTPLaneDemand``, the demand adapter over a router's ``GET /lanes``;
the goodput pricing of ``build_market``, which prices a training slice
by the trainer's goodput ledger (:func:`ledger_goodput`); and
:func:`build_market` itself, which wires a :class:`CapacityArbiter` from
the ``market:`` section that ``operator.py:load_market`` parsed.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Callable

from .arbiter import (CapacityArbiter, ManagedSlice, MarketConfig,
                      marginal_goodput)


class HTTPLaneDemand:
    """The arbiter's demand adapter over a remote router binary
    (``router.py``): one ``/lanes`` fetch per call. Errors surface to the
    arbiter, which prices an unreachable router as zero lane pressure
    (the SLO burn signal, when wired, still stands)."""

    def __init__(self, router_url: str, timeout: float = 5.0):
        self.url = router_url.rstrip("/") + "/lanes"
        self.timeout = timeout
        self._last = None

    def _fetch(self):
        with urllib.request.urlopen(self.url,
                                    timeout=self.timeout) as resp:
            self._last = json.loads(resp.read().decode())["data"]
        return self._last

    def lane_depths(self):
        data = self._fetch()
        return {lane: stats.get("queued", 0)
                for lane, stats in (data.get("lanes") or {}).items()}

    def lane_stats(self):
        data = self._last or self._fetch()
        return data.get("lanes")

    def admitting_count(self):
        data = self._last or self._fetch()
        return int(data.get("admitting") or 0)


def ledger_goodput(ledger_path: str, slices: int) -> Callable[[], float]:
    """``goodput_fn`` for the arbiter: the marginal goodput of one of
    ``slices`` slices, from the summary of the trainer's goodput ledger
    at ``ledger_path`` (``obs/goodput.py``), read anew at each call. A
    broken or missing ledger prices as 0.0."""
    from ..obs.goodput import read_ledger, summarize

    def goodput_fn():
        try:
            return marginal_goodput(summarize(read_ledger(ledger_path)),
                                    max(1, slices))
        except Exception:  # exc: allow — goodput is an advisory pricing input; a broken ledger prices as 0.0
            return 0.0
    return goodput_fn


def build_market(section, client, slo_engine, hub, recorder, clock):
    """``market:`` section → a wired CapacityArbiter: ``slices`` are the
    managed supply, ``routerUrl`` the lane demand (none without it),
    ``goodputLedger`` the slice price, ``config`` the
    :class:`MarketConfig`."""
    supply = [ManagedSlice(str(s["id"]), [str(n) for n in s["nodes"]])
              for s in section["slices"]]
    demand = (HTTPLaneDemand(section["routerUrl"])
              if section.get("routerUrl") else None)
    ledger_path = section.get("goodputLedger")
    goodput_fn = (ledger_goodput(ledger_path, len(supply))
                  if ledger_path else None)
    return CapacityArbiter(
        supply, client=client, demand=demand, slo_engine=slo_engine,
        goodput_fn=goodput_fn, recorder=recorder, metrics=hub,
        clock=clock,
        config=MarketConfig.from_dict(section.get("config") or {}))
