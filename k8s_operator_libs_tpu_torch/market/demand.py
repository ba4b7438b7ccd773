"""The arbiter's inputs from outside the process: the router binary's
lane demand and the trainer's goodput.

A copy of the two parts of the JAX package's ``cmd/operator.py`` that
the market needs without the operator: ``HTTPLaneDemand``, the demand
adapter over a router's ``GET /lanes``, and the goodput pricing of its
``build_market``, which prices a training slice by the trainer's goodput
ledger (:func:`ledger_goodput`).
"""

from __future__ import annotations

import json
import urllib.request
from typing import Callable

from .arbiter import marginal_goodput


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
