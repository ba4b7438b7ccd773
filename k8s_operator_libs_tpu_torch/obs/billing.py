"""Per-tenant cost attribution over the usage meter's account.

A copy of the JAX package's ``obs/billing.py``; the port imports nothing
of that package.

The :class:`UsageMeter` (:mod:`.usage`) says *where* every capacity
second went; this module says *who pays* and *what it was worth*:

- serving seconds are split per lane and priced by the lane's weight —
  the same weights the router's weighted-fair queue already encodes —
  and per-lane served tokens fold in when the caller has a router to
  ask;
- training seconds split into goodput vs badput using the trainer's own
  goodput ledger (:func:`.goodput.summarize` over its JSONL), so a
  slice-hour burned re-warming after a preemption is priced as badput,
  not product;
- everything else (maintenance, quarantine, market transitions, frozen
  or idle capacity) lands on the ``fleet-overhead`` tenant — waste has
  an owner too.

The headline, ``fleet_goodput_fraction``::

    (serving seconds + training seconds x training goodput fraction)
        / capacity seconds

Durability: every settled tick appends one record to a rotated JSONL
ledger (the trace sinks' discipline — size cap, one ``.1`` generation,
``sort_keys`` compact dumps, so same-seed replays are byte-identical).
Records carry the running totals, so a restarted or failed-over leader
resumes the account from the ledger tail (:meth:`UsageLedger.tail`)
plus the cluster state it re-reads anyway. The append path re-opens the
file per record: several standby candidates may hold the same path and
a rotation by one must never strand another's file handle.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

from ..utils.clock import Clock, RealClock
from .trace import DEFAULT_MAX_LOG_BYTES

logger = logging.getLogger(__name__)

LEDGER_BASENAME = "usage.jsonl"

# Lane price weights, mirroring serving.router.LANE_WEIGHTS by VALUE
# (obs may not import serving — ARC001). Callers that own a router pass
# the live table; this literal is the documented default contract.
DEFAULT_LANE_WEIGHTS = {"interactive": 4.0, "batch": 2.0,
                        "best-effort": 1.0}

# Tenant name for every non-productive usage kind.
OVERHEAD_TENANT = "fleet-overhead"


class UsageLedger:
    """Durable rotated JSONL account of settled usage ticks.

    Unlike the goodput ledger this keeps no open handle: append opens,
    writes one flushed line, closes. One write per reconcile tick makes
    that cheap, and it keeps every leadership candidate's view of the
    shared path coherent through rotations.
    """

    def __init__(self, path: str,
                 max_bytes: int = DEFAULT_MAX_LOG_BYTES):
        self.path = path
        self._max_bytes = int(max_bytes)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    def append(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, separators=(",", ":"), sort_keys=True)
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = 0
        if (self._max_bytes > 0 and size > 0
                and size + len(line) + 1 > self._max_bytes):
            os.replace(self.path, self.path + ".1")
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(line + "\n")
            fh.flush()

    def tail(self) -> Optional[Dict[str, Any]]:
        """Last settled record, looking through the live file then the
        rotated generation — the failover/restart resume point."""
        for path in (self.path, self.path + ".1"):
            record = self._tail_of(path)
            if record is not None:
                return record
        return None

    @staticmethod
    def _tail_of(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                last = None
                for line in fh:
                    if line.strip():
                        last = line
        except OSError:
            return None
        if not last:
            return None
        try:
            record = json.loads(last)
        except ValueError:
            logger.warning("usage ledger %s tail is garbled; starting a "
                           "fresh account", path)
            return None
        return record if isinstance(record, dict) else None

    def read(self) -> list:
        """Every record, rotated generation first (goodput.read_ledger
        discipline)."""
        out = []
        for path in (self.path + ".1", self.path):
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            out.append(json.loads(line))
                        except ValueError:
                            continue
            except OSError:
                continue
        return out


class BillingEngine:
    """Prices usage records and seals them into the ledger.

    ``goodput_path`` points at the trainer's goodput ledger when one is
    on shared disk; its :func:`~.goodput.summarize` fraction splits
    training seconds into goodput/badput. The summary is re-read only
    when the file changes (mtime+size), so a quiet fleet pays nothing
    per tick. Without it training prices at parity (fraction 1.0).
    """

    def __init__(self, ledger: UsageLedger,
                 clock: Optional[Clock] = None,
                 lane_weights: Optional[Dict[str, float]] = None,
                 goodput_path: Optional[str] = None):
        self.ledger = ledger
        self.clock = clock or RealClock()
        self.lane_weights = dict(lane_weights or DEFAULT_LANE_WEIGHTS)
        self.goodput_path = goodput_path
        self._goodput_stamp: Optional[Any] = None
        self._goodput_summary: Optional[Dict[str, Any]] = None
        # cumulative value account, resumed from the ledger tail
        self._tenants: Dict[str, Dict[str, float]] = {}
        self._resumed = False

    # ------------------------------------------------------------ resume

    def tail(self) -> Optional[Dict[str, Any]]:
        return self.ledger.tail()

    def _resume(self) -> None:
        self._resumed = True
        tail = self.ledger.tail()
        if not tail:
            return
        for tenant, fields in (tail.get("tenants") or {}).items():
            self._tenants[tenant] = {k: float(v)
                                     for k, v in fields.items()}

    def standby(self) -> None:
        """Drop the in-memory tenant account; the next settle re-resumes
        from the ledger tail (see :meth:`UsageMeter.standby`)."""
        self._resumed = False
        self._tenants = {}

    # ----------------------------------------------------------- pricing

    def _goodput(self) -> Optional[Dict[str, Any]]:
        if not self.goodput_path:
            return None
        try:
            st = os.stat(self.goodput_path)
            stamp = (st.st_mtime_ns, st.st_size)
        except OSError:
            return self._goodput_summary
        if stamp != self._goodput_stamp:
            from .goodput import read_ledger, summarize
            try:
                self._goodput_summary = summarize(
                    read_ledger(self.goodput_path))
            except Exception:  # exc: allow — a half-written trainer ledger must never fail the fleet account; keep the last summary
                logger.warning("could not summarize goodput ledger %s",
                               self.goodput_path, exc_info=True)
            else:
                self._goodput_stamp = stamp
        return self._goodput_summary

    def training_goodput_fraction(self) -> float:
        summary = self._goodput()
        if not summary or summary.get("total_s", 0) <= 0:
            return 1.0
        return float(summary.get("goodput_fraction") or 0.0)

    def settle(self, record: Dict[str, Any],
               lane_tokens: Optional[Dict[str, int]] = None
               ) -> Dict[str, Any]:
        """Fold value signals into one usage tick and append it to the
        durable ledger. Returns the sealed record."""
        if not self._resumed:
            self._resume()
        elapsed = float(record.get("elapsed_s", 0.0))
        gf = self.training_goodput_fraction()
        for kind, lanes in (record.get("counts") or {}).items():
            for lane, n in lanes.items():
                seconds = float(n) * elapsed
                if kind == "serving":
                    tenant = self._tenant(f"serving/{lane}")
                    weight = self.lane_weights.get(lane, 1.0)
                    tenant["seconds"] += seconds
                    tenant["cost"] += weight * seconds
                elif kind == "training":
                    tenant = self._tenant("training")
                    tenant["seconds"] += seconds
                    tenant["goodput_s"] += seconds * gf
                    tenant["badput_s"] += seconds * (1.0 - gf)
                    tenant["cost"] += seconds * gf
                else:
                    tenant = self._tenant(OVERHEAD_TENANT)
                    tenant["seconds"] += seconds
                    tenant["cost"] += seconds
        for lane, tokens in (lane_tokens or {}).items():
            tenant = self._tenant(f"serving/{lane}")
            weight = self.lane_weights.get(lane, 1.0)
            tenant["tokens"] = tenant.get("tokens", 0.0) + float(tokens)
            tenant["token_cost"] = (tenant.get("token_cost", 0.0)
                                    + weight * float(tokens))
        record = dict(record)
        record["tenants"] = {t: dict(f)
                             for t, f in sorted(self._tenants.items())}
        record["fleet_goodput_fraction"] = self.fleet_goodput_fraction()
        self.ledger.append(record)
        return record

    def _tenant(self, name: str) -> Dict[str, float]:
        tenant = self._tenants.get(name)
        if tenant is None:
            tenant = {"seconds": 0.0, "cost": 0.0}
            if name == "training":
                tenant["goodput_s"] = 0.0
                tenant["badput_s"] = 0.0
            self._tenants[name] = tenant
        return tenant

    # ---------------------------------------------------------- headline

    def fleet_goodput_fraction(self) -> float:
        """Cumulative: productive seconds (training discounted by its
        goodput fraction) over every second any tenant was billed."""
        total = sum(t["seconds"] for t in self._tenants.values())
        if total <= 0:
            return 1.0
        productive = 0.0
        for name, tenant in self._tenants.items():
            if name.startswith("serving/"):
                productive += tenant["seconds"]
            elif name == "training":
                productive += tenant.get("goodput_s", tenant["seconds"])
        return productive / total

    def summary(self) -> Dict[str, Any]:
        if not self._resumed:
            self._resume()
        return {
            "tenants": {t: dict(f)
                        for t, f in sorted(self._tenants.items())},
            "fleet_goodput_fraction": self.fleet_goodput_fraction(),
            "lane_weights": dict(self.lane_weights),
            "ledger_path": self.ledger.path,
        }
