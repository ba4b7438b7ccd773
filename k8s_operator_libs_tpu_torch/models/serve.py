"""Continuous batching over the paged KV cache.

Port of ``ContinuousBatcher`` from the JAX package's ``models/serve.py``,
speculative draft mode included. A fixed fleet of
``max_slots`` decode slots shares one block pool; per-slot table rows and
lengths keep slots independent, so admitting or retiring one request never
touches another's cache. Block accounting is a host-side free list.

``step(n)`` admits queued requests (one prefill each, the prompt padded to
a power-of-two bucket capped at the slot capacity) and then runs ``n``
single-token forward steps over EVERY slot, reading the ``n`` next-token
rows back once at the end. Idle slots are stepped too: they park at the
aligned shared-prefix boundary with table rows on the scratch block, so
their writes land where no live read looks. On the card each decode step
runs the paged-decode kernel once per layer.

In draft mode (``draft="self-int8"`` or a ``(params, cfg, forward)``
triple) each ``step`` is one speculative round instead: ``spec_k + 1``
single-token draft steps over every slot (each through the paged-decode
kernel on the card), one ``(spec_k + 1)``-token target verify (the
gathered attention path), per-slot greedy acceptance, and the rewind of
each slot's length on the host. The draft keeps its own pools behind the
same table and lengths. Outputs are the non-speculative batcher's tokens
for any draft: the target's verify is authoritative.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.clock import RealClock
from .llama import LlamaConfig
from .paged import (DEFAULT_BLOCK_SIZE, KV_WIRE_VERSION, KVPayloadError,
                    PagedKVCache, _forward_paged, export_slot_kv,
                    import_slot_kv)
from .quant import _forward_paged_quant, quantize_params, stream_bytes
from .speculative import accept_counts

Params = Dict[str, Any]

_RATIO_BUCKETS = (0.1, 0.25, 0.5, 0.625, 0.75, 0.875, 0.95, 1.0)
_TOKEN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray          # [Tp] int32
    max_new: int
    slot: int = -1
    generated: Optional[List[int]] = None
    submit_t: float = 0.0
    streamed: int = 0           # generated tokens already handed out


def _bucket(n: int, floor: int = 16) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class ContinuousBatcher:
    """Greedy continuous-batching server over one model replica, on the
    device its parameters live on.

        srv = ContinuousBatcher(params, cfg, max_slots=8)
        rid = srv.submit(prompt_ids, max_new_tokens=64)
        while not srv.idle:
            srv.step()
        tokens = srv.poll()[rid]

    ``shared_prefix`` (int tokens) is a system prompt every request
    shares: its whole blocks are prefilled once into pool blocks every
    table row references read-only; the sub-block remainder rides each
    request's own prefill. ``metrics`` (a MetricsHub, duck-typed),
    ``tracer`` (``span(name, **attrs)`` context manager) and ``clock``
    are the reference's hooks, with the same metric names.

    ``forward(params, tokens, cache, cfg)`` overrides the paged forward
    (default :func:`~.paged._forward_paged`). ``draft`` turns on
    speculative decoding (see the module docstring): ``"self-int8"``
    drafts with the target's own weights in int8, or pass ``(params,
    cfg, forward)`` for an explicit draft model (``forward`` None for
    the paged forward); ``spec_k`` is the speculation depth."""

    payload_version = KV_WIRE_VERSION

    def __init__(self, params: Params, cfg: LlamaConfig, max_slots: int = 8,
                 capacity_per_slot: int = 512,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 shared_prefix=None, forward=None, metrics=None, tracer=None,
                 clock=None, draft=None, spec_k: int = 4):
        self.params = params
        self.cfg = cfg
        self._forward = forward or _forward_paged
        self.device = params["embed"].device
        self.max_slots = max_slots
        self.block_size = block_size
        self.blocks_per_slot = -(-capacity_per_slot // block_size)
        self.capacity = self.blocks_per_slot * block_size
        # decode accounting: single-token forward steps run (each runs one
        # decode attention per layer), host seconds spent in them up to
        # the readback, and request tokens they produced
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        # draft mode: rounds run and draft tokens confirmed in them
        self.spec_rounds = 0
        self.spec_accepted = 0

        if shared_prefix is None:
            shared_prefix = np.zeros((0,), np.int32)
        shared_prefix = np.asarray(shared_prefix, np.int32).reshape(-1)
        n_pb = len(shared_prefix) // block_size
        self._prefix_blocks = n_pb
        self._prefix_aligned = n_pb * block_size
        self._prefix_rem = shared_prefix[self._prefix_aligned:]
        self._slot_limit = self._prefix_aligned + self.capacity

        L, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        n_blocks = n_pb + max_slots * self.blocks_per_slot + 1  # + scratch
        self._scratch = n_blocks - 1
        shape = (L, n_blocks, block_size, KV, Dh)
        self._k = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self._v = torch.zeros(shape, dtype=cfg.dtype, device=self.device)

        # draft mode: the draft's own pools behind the SAME table and
        # lengths, so admission, retirement and recycling stay one path
        self._spec = None
        self._draft_stream_bytes = 0
        if draft is not None:
            if spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if draft == "self-int8":
                dparams, dcfg, dfwd = (quantize_params(params), cfg,
                                       _forward_paged_quant)
            else:
                dparams, dcfg, dfwd = draft
                dfwd = dfwd or _forward_paged
            dshape = (dcfg.n_layers, n_blocks, block_size, dcfg.n_kv_heads,
                      dcfg.head_dim)
            self._dk = torch.zeros(dshape, dtype=dcfg.dtype,
                                   device=self.device)
            self._dv = torch.zeros(dshape, dtype=dcfg.dtype,
                                   device=self.device)
            self._spec = {"params": dparams, "cfg": dcfg, "fwd": dfwd,
                          "k": int(spec_k)}
            self._draft_stream_bytes = stream_bytes(dparams)

        self._stream_bytes = stream_bytes(params)
        # host mirrors, uploaded with each device call. Row layout:
        # [prefix blocks 0..n_pb) | private blocks, scratch when free]
        self._table = np.full((max_slots, n_pb + self.blocks_per_slot),
                              self._scratch, np.int32)
        self._table[:, :n_pb] = np.arange(n_pb, dtype=np.int32)[None, :]
        # idle slots park at the aligned prefix boundary, NOT zero: a
        # stepped idle slot at position 0 would write into shared prefix
        # block 0; at the boundary it writes into its scratch-backed row
        self._lengths = np.full((max_slots,), self._prefix_aligned,
                                np.int32)
        self._free_blocks = list(range(n_pb, n_blocks - 1))
        self._free_slots = list(range(max_slots))

        self._queue: List[_Request] = []
        self._running: Dict[int, _Request] = {}
        self._done: Dict[int, np.ndarray] = {}
        self._next_rid = 0
        self._draining = False
        self._last_tok = np.zeros((max_slots,), np.int32)
        self._streaming = False
        self._stream_tail: Dict[int, List[int]] = {}
        self._stream_emitted = 0

        self._metrics = metrics
        self._tracer = tracer
        self._clock = clock or RealClock()
        self._submitted = 0
        self._completed = 0
        if metrics is not None:
            metrics.set_gauge("serve_slots_total", max_slots)
            metrics.set_gauge("serve_draining", 0)
        if n_pb:
            self._prefill_shared_prefix(shared_prefix[:self._prefix_aligned])

    def _fwd(self, tokens, cache):
        return self._forward(self.params, tokens, cache, self.cfg)

    def _dfwd(self, tokens, cache):
        spec = self._spec
        return spec["fwd"](spec["params"], tokens, cache, spec["cfg"])

    def _tensor(self, arr) -> torch.Tensor:
        """A device COPY of a host mirror (on the CPU ``as_tensor`` would
        alias the numpy array the host keeps mutating)."""
        return torch.tensor(np.asarray(arr), device=self.device)

    def _prefill_shared_prefix(self, tokens: np.ndarray) -> None:
        """One forward over the aligned prefix writes its K/V into the
        shared blocks (the draft's too); the logits are discarded."""
        table = self._tensor(np.arange(self._prefix_blocks,
                                       dtype=np.int32)[None])
        zero = torch.zeros((1,), dtype=torch.int32, device=self.device)
        prompt = self._tensor(tokens)[None]
        self._fwd(prompt, PagedKVCache(k=self._k, v=self._v, table=table,
                                       lengths=zero))
        if self._spec is not None:
            self._dfwd(prompt, PagedKVCache(k=self._dk, v=self._dv,
                                            table=table, lengths=zero))

    # ------------------------------------------------------------ device

    @torch.no_grad()
    def _decode(self, n: int) -> np.ndarray:
        """``n`` single-token steps over every slot; returns the [n, slots]
        next-token matrix with ONE readback at the end."""
        table = self._tensor(self._table)
        lengths = self._tensor(self._lengths)
        toks = self._tensor(self._last_tok)
        rows = []
        for _ in range(n):
            cache = PagedKVCache(k=self._k, v=self._v, table=table,
                                 lengths=lengths)
            logits, cache = self._fwd(toks[:, None], cache)
            toks = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            lengths = cache.lengths
            rows.append(toks)
            self.decode_steps += 1
        return torch.stack(rows).cpu().numpy()   # the step's one sync

    @torch.no_grad()
    def _prefill(self, slot: int, padded: np.ndarray, length: int) -> int:
        """One request's prompt (padded to its bucket) as a batch of one
        over the shared pool: its table row confines every write to its
        own blocks. Returns the greedy next token after ``length``."""
        cache = PagedKVCache(
            k=self._k, v=self._v, table=self._tensor(self._table[slot])[None],
            lengths=torch.full((1,), self._prefix_aligned,
                               dtype=torch.int32, device=self.device))
        prompt = self._tensor(padded)[None]
        logits, _ = self._fwd(prompt, cache)
        if self._spec is not None:
            # the draft's rows of the prompt, same table row and
            # positions; its logits are not needed
            self._dfwd(prompt, dataclasses.replace(cache, k=self._dk,
                                                   v=self._dv))
        return int(torch.argmax(logits[0, length - 1]))

    @torch.no_grad()
    def _spec_round(self):
        """One speculative round over every slot: k + 1 draft steps (the
        last writes the final proposal's draft row; its own proposal is
        discarded), one (k+1)-token target verify, per-slot greedy
        acceptance. Returns (slab [slots, k+1], counts [slots]) with one
        readback: each slot's accepted drafts, then the target's token
        at its acceptance index."""
        kk = self._spec["k"]
        table = self._tensor(self._table)
        lengths = self._tensor(self._lengths)
        last = self._tensor(self._last_tok)
        tok, props = last, []
        for _ in range(kk + 1):
            cache = PagedKVCache(k=self._dk, v=self._dv, table=table,
                                 lengths=lengths)
            logits, cache = self._dfwd(tok[:, None], cache)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            lengths = cache.lengths
            props.append(tok)
        drafts = torch.stack(props[:kk], dim=1)                 # [S, k]
        window = torch.cat([last[:, None], drafts], dim=1)      # [S, k+1]
        cache = PagedKVCache(k=self._k, v=self._v, table=table,
                             lengths=self._tensor(self._lengths))
        v_logits, _ = self._fwd(window, cache)
        # greedy[:, i] is the target's pick after window[:, :i+1]
        greedy = torch.argmax(v_logits, dim=-1).to(torch.int32)
        acc = accept_counts(drafts == greedy[:, :kk])           # [S]
        slab = torch.where(
            torch.arange(kk + 1, device=self.device)[None, :] < acc[:, None],
            torch.nn.functional.pad(drafts, (0, 1)),
            torch.gather(greedy, 1, acc[:, None].long()))
        both = torch.cat([slab, acc[:, None].to(torch.int32)], dim=1)
        both = both.cpu().numpy()                    # the round's one sync
        self.spec_rounds += 1
        return both[:, :kk + 1], both[:, kk + 1]

    def snapshot(self):
        """(cache, last tokens [slots, 1]) as the next decode step reads
        them: the live pools, this step's table and lengths on the device.
        Running a forward over it rewrites the same K/V rows, so two runs
        (kernel, then plain) see the same cache."""
        cache = PagedKVCache(k=self._k, v=self._v,
                             table=self._tensor(self._table),
                             lengths=self._tensor(self._lengths))
        return cache, self._tensor(self._last_tok)[:, None]

    # ------------------------------------------------------------- public

    def submit(self, prompt, max_new_tokens: int) -> int:
        if self._draining:
            raise RuntimeError("server is draining; submit to a peer")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        private = len(self._prefix_rem) + len(prompt) + max_new_tokens
        if private > self.capacity:
            raise ValueError(
                f"prefix remainder {len(self._prefix_rem)} + prompt "
                f"{len(prompt)} + max_new {max_new_tokens} exceeds "
                f"slot capacity {self.capacity}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid, prompt, max_new_tokens,
                                    submit_t=self._clock.now()))
        self._submitted += 1
        self._refresh_gauges()
        return rid

    @property
    def idle(self) -> bool:
        if self._draining:
            return not self._running
        return not self._queue and not self._running

    def drain(self) -> None:
        """Stop admitting work; in-flight requests run to completion."""
        self._draining = True
        if self._metrics is not None:
            self._metrics.set_gauge("serve_draining", 1)

    def handoff(self):
        """(rid, prompt, max_new_tokens) of every request never admitted;
        only valid after :meth:`drain`. Empties the queue."""
        if not self._draining:
            raise RuntimeError("handoff() before drain() would drop a "
                               "live queue")
        out = [(r.rid, r.prompt, r.max_new) for r in self._queue]
        self._queue.clear()
        if self._metrics is not None:
            self._metrics.set_gauge("serve_requests_handed_off", len(out))
        self._refresh_gauges()
        return out

    def poll(self) -> Dict[int, np.ndarray]:
        """Completed request id -> prompt + generated tokens; each result
        is returned once."""
        out, self._done = self._done, {}
        return out

    def poll_stream(self) -> Dict[int, List[int]]:
        """Request id -> tokens generated since the last call, each once
        and in order; the first call arms streaming."""
        self._streaming = True
        out: Dict[int, List[int]] = {}
        tails, self._stream_tail = self._stream_tail, {}
        out.update(tails)
        for rid, req in self._running.items():
            n = len(req.generated) if req.generated else 0
            if n > req.streamed:
                out.setdefault(rid, []).extend(
                    int(t) for t in req.generated[req.streamed:n])
                req.streamed = n
        if self._metrics is not None and out:
            self._stream_emitted += sum(len(t) for t in out.values())
            self._metrics.set_gauge("stream_emitted_tokens",
                                    self._stream_emitted)
            self._metrics.set_gauge(
                "stream_backlog_tokens",
                sum(len(r.generated or []) - r.streamed
                    for r in self._running.values()))
        return out

    # ------------------------------------------------------ live migration

    def export_slot(self, rid: int) -> dict:
        """Quiesce one in-flight request at the step boundary and return
        its migration payload (KV, prompt, generated tokens, pending last
        token, greedy sampler). The request leaves this server and its
        slot and blocks recycle at once. ``KeyError`` if not running.
        In draft mode the draft pools stay behind: the peer's draft
        starts cold for the slot, which lowers its acceptance, not its
        tokens."""
        req = self._running.pop(rid)
        s = req.slot
        kv = export_slot_kv(self._k, self._v, self._table[s],
                            int(self._lengths[s]),
                            start=self._prefix_aligned)
        payload = {
            "version": KV_WIRE_VERSION,
            "kind": "batcher",
            "prompt": [int(t) for t in req.prompt],
            "max_new": int(req.max_new),
            "generated": [int(t) for t in (req.generated or [])],
            "last_token": int(self._last_tok[s]),
            "sampler": {"kind": "greedy"},
            "kv": kv,
        }
        self._release(s)
        self._stream_tail.pop(rid, None)
        if self._metrics is not None:
            self._metrics.set_gauge("serve_slots_busy", len(self._running))
        return payload

    def adopt_slot(self, payload: dict) -> int:
        """Restore an :meth:`export_slot` payload (from either package)
        into a free slot and continue decoding where the donor stopped.
        Returns the new local request id; raises :class:`KVPayloadError`
        when this replica cannot absorb it."""
        if self._draining:
            raise RuntimeError("server is draining; adopt on a peer")
        if payload.get("version") != KV_WIRE_VERSION:
            raise KVPayloadError(
                f"payload wire version {payload.get('version')!r}; this "
                f"replica speaks {KV_WIRE_VERSION}")
        if payload.get("kind") != "batcher":
            raise KVPayloadError(
                f"payload kind {payload.get('kind')!r} is not adoptable "
                f"by a batcher replica")
        if payload.get("sampler", {}).get("kind") != "greedy":
            raise KVPayloadError("only greedy sampler state is "
                                 "adoptable at this wire version")
        generated = [int(t) for t in payload["generated"]]
        length = int(payload["kv"]["length"])
        remaining = int(payload["max_new"]) - len(generated)
        if (length - self._prefix_aligned) + remaining > self.capacity:
            raise KVPayloadError(
                f"{length - self._prefix_aligned} restored + {remaining}"
                f" remaining tokens exceed slot capacity {self.capacity}")
        if not self._free_slots:
            raise KVPayloadError("no free slot to adopt into")
        if len(self._free_blocks) < self.blocks_per_slot:
            raise KVPayloadError("no free pages to adopt into")
        slot = self._claim()
        try:
            _, _, _, _, length = import_slot_kv(
                self._k, self._v, self._table[slot], payload["kv"],
                start=self._prefix_aligned)
        except Exception:
            # a rejected adoption must not leak the slot or its pages
            self._release(slot)
            raise
        self._lengths[slot] = length
        self._last_tok[slot] = int(payload["last_token"])
        self._streaming = True
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, np.asarray(payload["prompt"], np.int32),
                       int(payload["max_new"]), slot=slot,
                       submit_t=self._clock.now())
        req.generated = generated
        req.streamed = len(generated)
        self._running[rid] = req
        self._submitted += 1
        self._refresh_gauges()
        return rid

    def step(self, n: int = 1) -> None:
        """Admit queued requests into free slots (prefill), then advance
        every slot ``n`` decode ticks with one readback. A request that
        reaches max_new mid-chunk retires there; its extra rows lie past
        its length and the next occupant overwrites them."""
        if n < 1:
            raise ValueError("step(n) needs n >= 1")
        if self._tracer is not None:
            with self._tracer.span("serve-step", chunk=n) as span:
                self._step_inner(n, span)
        else:
            self._step_inner(n, None)

    def _step_inner(self, n: int, span) -> None:
        t0 = self._clock.now()
        while self._queue and self._free_slots and not self._draining:
            self._admit(self._queue.pop(0))
        if span is not None:
            span.set("running", len(self._running))
            span.set("queued", len(self._queue))
        if self._metrics is not None:
            self._metrics.observe(
                "serve_slot_occupancy_ratio",
                len(self._running) / self.max_slots,
                buckets=_RATIO_BUCKETS)
            total_private = self.max_slots * self.blocks_per_slot
            self._metrics.observe(
                "serve_kv_page_utilization_ratio",
                (total_private - len(self._free_blocks)) / total_private,
                buckets=_RATIO_BUCKETS)
            self._refresh_gauges()
        if not self._running:
            return
        # every running slot is written n rows, so cap the chunk at the
        # tightest remaining capacity: writes stay inside each table row
        # (there is no compiled-program cache to reuse, unlike the
        # reference, so the chunk simply shrinks to the cap)
        cap = min(self._slot_limit - int(self._lengths[r.slot])
                  for r in self._running.values())
        if self._spec is not None and cap >= self._spec["k"] + 1:
            self._step_spec_round(span, t0)
            return
        # (draft mode falls through when a slot is within k rows of its
        # capacity: the (k+1)-wide window no longer fits its table row,
        # so the step runs plain ticks. The draft cache misses those
        # rows, so that slot's acceptance drops until it turns over;
        # tokens do not change, the target decides either way.)
        n = min(n, cap)
        if span is not None:
            span.set("ticks", n)
        t_dev = self._clock.now()
        toks = self._decode(n)
        decode_s = max(0.0, self._clock.now() - t_dev)
        self.decode_seconds += decode_s
        if self._metrics is not None:
            self._metrics.observe("serve_inter_token_seconds", decode_s / n)
            if self._stream_bytes:
                self._metrics.set_gauge(
                    "weight_stream_gbs",
                    round(self._stream_bytes * n
                          / max(decode_s, 1e-9) / 1e9, 3))
        finished = []
        for rid, req in self._running.items():
            s = req.slot
            # iteration i writes the token that entered it: last_tok for
            # i = 0, then each iteration's own output
            for i in range(n):
                written = (self._last_tok[s] if i == 0 else toks[i - 1, s])
                req.generated.append(int(written))
                self._lengths[s] += 1
                self.decode_tokens += 1
                if len(req.generated) >= req.max_new:
                    finished.append(rid)
                    break
            else:
                self._last_tok[s] = toks[n - 1, s]
        for rid in finished:
            self._retire(self._running.pop(rid))
        if self._metrics is not None:
            self._metrics.observe("serve_step_duration_seconds",
                                  max(0.0, self._clock.now() - t0))
            self._refresh_gauges()

    def _step_spec_round(self, span, t0) -> None:
        """One speculative round. Per slot the tokens appended are the
        pending last token plus that slot's accepted drafts; the target's
        token at the acceptance index becomes the new pending token. The
        device wrote k + 1 rows past each slot's length; the host advances
        lengths over the confirmed ones only, so the rejected rows lie
        past ``lengths`` and the next round overwrites them."""
        kk = self._spec["k"]
        if span is not None:
            span.set("spec_k", kk)
        t_dev = self._clock.now()
        slab, acc = self._spec_round()
        decode_s = max(0.0, self._clock.now() - t_dev)
        self.decode_seconds += decode_s
        finished = []
        emitted = 0
        for rid, req in self._running.items():
            s = req.slot
            a = int(acc[s])
            self.spec_accepted += a
            if self._metrics is not None:
                self._metrics.observe("spec_accept_ratio", a / kk,
                                      buckets=_RATIO_BUCKETS)
            round_toks = ([int(self._last_tok[s])]
                          + [int(t) for t in slab[s, :a]])
            for tok in round_toks:
                req.generated.append(tok)
                self._lengths[s] += 1
                emitted += 1
                if len(req.generated) >= req.max_new:
                    finished.append(rid)
                    break
            else:
                self._last_tok[s] = int(slab[s, a])
        self.decode_tokens += emitted
        if self._metrics is not None and self._running:
            per_slot = emitted / len(self._running)
            self._metrics.observe("serve_inter_token_seconds",
                                  decode_s / max(per_slot, 1.0))
            if self._stream_bytes:
                # one target verify stream + k + 1 draft streams per round
                bytes_round = (self._stream_bytes
                               + (kk + 1) * self._draft_stream_bytes)
                self._metrics.set_gauge(
                    "weight_stream_gbs",
                    round(bytes_round / max(decode_s, 1e-9) / 1e9, 3))
        for rid in finished:
            self._retire(self._running.pop(rid))
        if self._metrics is not None:
            self._metrics.observe("serve_step_duration_seconds",
                                  max(0.0, self._clock.now() - t0))
            self._refresh_gauges()

    # ------------------------------------------------------------ internal

    def _refresh_gauges(self) -> None:
        if self._metrics is None:
            return
        self._metrics.set_gauge("serve_slots_busy", len(self._running))
        self._metrics.set_gauge("serve_queue_depth", len(self._queue))
        self._metrics.set_gauge("serve_requests_submitted", self._submitted)
        self._metrics.set_gauge("serve_requests_completed", self._completed)

    def _claim(self) -> int:
        """A free slot with its private blocks."""
        slot = self._free_slots.pop(0)
        blocks = [self._free_blocks.pop(0)
                  for _ in range(self.blocks_per_slot)]
        self._table[slot, self._prefix_blocks:] = np.asarray(blocks,
                                                             np.int32)
        return slot

    def _release(self, slot: int) -> None:
        """Free the slot's PRIVATE blocks (the shared-prefix columns stay)
        and park it at the prefix boundary."""
        self._free_blocks.extend(
            int(b) for b in self._table[slot, self._prefix_blocks:])
        self._table[slot, self._prefix_blocks:] = self._scratch
        self._lengths[slot] = self._prefix_aligned
        self._free_slots.append(slot)

    def _admit(self, req: _Request) -> None:
        t_admit = self._clock.now()
        slot = self._claim()
        eff_prompt = (np.concatenate([self._prefix_rem, req.prompt])
                      if len(self._prefix_rem) else req.prompt)
        Tp = len(eff_prompt)
        # cap at capacity: a power-of-two bucket above a non-power-of-two
        # capacity would pad past the slot's table row; submit() keeps
        # Tp < capacity, so every padded position lands in the slot's own
        # blocks and the length rewind below discards the pad rows
        bucket = min(_bucket(Tp), self.capacity)
        padded = np.zeros((bucket,), np.int32)
        padded[:Tp] = eff_prompt
        nxt = self._prefill(slot, padded, Tp)
        self._lengths[slot] = self._prefix_aligned + Tp
        self._last_tok[slot] = nxt
        req.slot = slot
        req.generated = []
        self._running[req.rid] = req
        if self._metrics is not None:
            # the prefill's token readback synchronized the device, so the
            # first token exists here: TTFT = queue wait + prefill
            self._metrics.observe("serve_queue_wait_seconds",
                                  max(0.0, t_admit - req.submit_t))
            self._metrics.observe("serve_ttft_seconds",
                                  max(0.0, self._clock.now() - req.submit_t))

    def _retire(self, req: _Request) -> None:
        if self._streaming and len(req.generated) > req.streamed:
            # park the final tokens for the next poll_stream
            self._stream_tail.setdefault(req.rid, []).extend(
                int(t) for t in req.generated[req.streamed:])
            req.streamed = len(req.generated)
        self._done[req.rid] = np.concatenate(
            [req.prompt, np.asarray(req.generated, np.int32)])
        self._completed += 1
        if self._metrics is not None:
            self._metrics.observe(
                "serve_request_latency_seconds",
                max(0.0, self._clock.now() - req.submit_t))
            self._metrics.observe("serve_generated_tokens",
                                  len(req.generated),
                                  buckets=_TOKEN_BUCKETS)
        self._release(req.slot)
