"""A deterministic replica runtime with no model, for the router's tests.

A copy of the JAX package's ``serving/sim.py``. The router's properties
(exactly-once delivery, admission legality, drain handoff, stream
integrity across live migration) are bookkeeping, not tokens, so a
campaign or a unit test can drive the router without a batcher.
:class:`SimReplicaRuntime` has the surface of :class:`~.pool.
BatcherRuntime` (the drain, handoff, stream and migration semantics of
``models/serve.py`` and the ``tpu_workload_serve_*`` gauge names in its
metrics text) over a host model: a request with ``max_new`` tokens emits
``tokens_per_step`` tokens per step, and its output is :func:`sim_tokens`,
a function of the prompt, so "token-identical whichever replica served
it" stays checkable across a mid-generation migration (``export_slot`` /
``adopt_slot`` move the generated-so-far cursor between replicas).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# Sim migration payloads carry the same wire version the real KV payload
# does (models/paged.py:KV_WIRE_VERSION), spelled as a literal so this
# module imports no torch; tests/test_torch_serving.py pins equality.
SIM_WIRE_VERSION = 1


def sim_tokens(prompt, max_new: int) -> List[int]:
    """The sim model's full decode: prompt + a deterministic tail (any
    two replicas given the same request produce the same tokens)."""
    prompt = [int(t) for t in prompt]
    basis = sum(prompt) % 997
    return prompt + [(basis + 31 * i) % 32000 for i in range(max_new)]


class AdoptError(ValueError):
    """This replica rejects the migration payload (version mismatch, no
    free slot, draining/failed, or a forced test rejection) — the router
    falls back to re-prefill-from-prompt, never a loss."""


class _SimRequest:
    def __init__(self, rid: int, prompt, max_new: int):
        self.rid = rid
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.tail = sim_tokens(self.prompt, self.max_new)[len(self.prompt):]
        self.generated: List[int] = []
        self.streamed = 0


class SimReplicaRuntime:
    # mirrors ContinuousBatcher.payload_version (see module docstring)
    payload_version = SIM_WIRE_VERSION

    def __init__(self, max_slots: int = 4, tokens_per_step: int = 4):
        self.max_slots = max_slots
        self.tokens_per_step = max(1, tokens_per_step)
        self._queue: List[_SimRequest] = []
        self._running: Dict[int, _SimRequest] = {}
        self._done: Dict[int, List[int]] = {}
        self._stream_tail: Dict[int, List[int]] = {}
        self._next_rid = 0
        self._draining = False
        self._failed = False
        self.steps = 0
        # test/e2e hook: the next N adopt_slot calls are refused (forces
        # the router's degraded re-prefill fallback path)
        self.reject_adoptions = 0

    # ----------------------------------------------------------- surface

    def submit(self, prompt, max_new: int) -> int:
        if self._draining:
            raise RuntimeError("server is draining; submit to a peer")
        if self._failed:
            raise RuntimeError("server failed; submit to a peer")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_SimRequest(rid, prompt, max_new))
        return rid

    def poll(self) -> Dict[int, List[int]]:
        if self._failed:
            return {}
        out, self._done = self._done, {}
        return out

    def poll_stream(self) -> Dict[int, List[int]]:
        """Same contract as ``ContinuousBatcher.poll_stream``: tokens
        generated since the last call, per request, each exactly once
        and in order (retired requests surface their final tail)."""
        if self._failed:
            return {}
        out: Dict[int, List[int]] = {}
        tails, self._stream_tail = self._stream_tail, {}
        out.update(tails)
        for rid, req in self._running.items():
            if len(req.generated) > req.streamed:
                out.setdefault(rid, []).extend(
                    req.generated[req.streamed:])
                req.streamed = len(req.generated)
        return out

    def drain(self) -> None:
        self._draining = True

    def handoff(self) -> List[Tuple[int, List[int], int]]:
        if not self._draining:
            raise RuntimeError("handoff() before drain() would drop a "
                               "live queue")
        out = [(r.rid, list(r.prompt), r.max_new) for r in self._queue]
        self._queue.clear()
        return out

    # ---------------------------------------------------- live migration

    def export_slot(self, rid: int) -> dict:
        """The sim twin of ``ContinuousBatcher.export_slot``: freeze one
        in-flight request and hand its state (generated-so-far cursor in
        place of the paged blocks) to a peer. The request leaves this
        replica immediately."""
        if self._failed:
            raise RuntimeError("server failed; nothing to export")
        req = self._running.pop(rid)
        self._stream_tail.pop(rid, None)
        return {
            "version": SIM_WIRE_VERSION,
            "kind": "sim",
            "prompt": list(req.prompt),
            "max_new": req.max_new,
            "generated": list(req.generated),
            "sampler": {"kind": "greedy"},
        }

    def adopt_slot(self, payload: dict) -> int:
        if self._draining:
            raise RuntimeError("server is draining; adopt on a peer")
        if self._failed:
            raise RuntimeError("server failed; adopt on a peer")
        if self.reject_adoptions > 0:
            self.reject_adoptions -= 1
            raise AdoptError("adoption refused (forced rejection)")
        if payload.get("version") != SIM_WIRE_VERSION:
            raise AdoptError(
                f"payload wire version {payload.get('version')!r}; this "
                f"replica speaks {SIM_WIRE_VERSION}")
        if payload.get("kind") != "sim":
            raise AdoptError(f"payload kind {payload.get('kind')!r} is "
                             f"not adoptable by a sim replica")
        if len(self._running) >= self.max_slots:
            raise AdoptError("no free slot to adopt into")
        rid = self._next_rid
        self._next_rid += 1
        req = _SimRequest(rid, payload["prompt"], payload["max_new"])
        req.generated = [int(t) for t in payload["generated"]]
        # continuation must match the donor's decode exactly — the sim
        # model is deterministic on the prompt, so splicing the cursor
        # IS token-identity
        req.streamed = len(req.generated)
        self._running[rid] = req
        return rid

    @property
    def idle(self) -> bool:
        if self._draining:
            return not self._running
        return not self._queue and not self._running

    @property
    def busy(self) -> bool:
        """True while any request is mid-generation."""
        return bool(self._running)

    def alive(self) -> bool:
        return not self._failed

    def fail(self) -> None:
        """The replica process dies: in-flight work is lost, results are
        never delivered, submits are refused."""
        self._failed = True
        self._running.clear()
        self._done.clear()
        self._stream_tail.clear()

    def step(self, n: int = 1) -> None:
        if self._failed:
            return
        for _ in range(max(1, n)):
            self.steps += 1
            while (self._queue and len(self._running) < self.max_slots
                   and not self._draining):
                req = self._queue.pop(0)
                self._running[req.rid] = req
            finished = []
            for rid, req in self._running.items():
                take = min(self.tokens_per_step,
                           req.max_new - len(req.generated))
                if take > 0:
                    req.generated.extend(
                        req.tail[len(req.generated):
                                 len(req.generated) + take])
                if len(req.generated) >= req.max_new:
                    finished.append(rid)
            for rid in finished:
                req = self._running.pop(rid)
                if len(req.generated) > req.streamed:
                    self._stream_tail.setdefault(rid, []).extend(
                        req.generated[req.streamed:])
                    req.streamed = len(req.generated)
                self._done[rid] = req.prompt + req.generated

    # ----------------------------------------------------------- metrics

    def metrics_text(self) -> str:
        """Minimal exposition carrying exactly the backpressure gauges
        :meth:`~.pool.ReplicaPool.scrape` consumes, under the same names
        a real ``cmd/serve.py`` /metrics scrape returns."""
        gauges = {
            "tpu_workload_serve_queue_depth": len(self._queue),
            "tpu_workload_serve_slots_busy": len(self._running),
            "tpu_workload_serve_slots_total": self.max_slots,
            "tpu_workload_serve_draining": 1 if self._draining else 0,
            "tpu_workload_serve_failed": 1 if self._failed else 0,
            "tpu_workload_serve_up": 0 if self._failed else 1,
        }
        return "\n".join(f"{name} {value}"
                         for name, value in sorted(gauges.items())) + "\n"
