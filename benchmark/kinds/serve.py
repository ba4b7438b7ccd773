"""Open-loop serving: the port's ``ServingRuntime`` driven in-process.

Set-up builds the runtime over weights made from the seed, warms every
prefill bucket the mix can send and the decode chunk, and then starts
the arrivals ``ramp_s`` before the window opens. A submitting thread
hands each request to the runtime when it is due (``stream=True``),
waiting for the runtime's lock as a front end's handler does; the calling
thread polls the runtime's stream buffers under the same lock, stamping
every token with the host clock when it first sees it. Arrivals go on past the window's close
until every request due in the window has two tokens (or ``tail_s``
passes). Then the runtime stops, the program's state is freed, and a
sample of the finished requests, the longest among them, goes through the
plain reference: every served token is held against the reference's best
logit at its position.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from typing import Dict, List

import numpy as np

from .. import traffic
from ..models import port_config
from ..reference.model import Matmul, sequence_logits
from ..devtrace import DeviceTrace
from ..harness import log
from ..weights import make_layer, make_params, make_slab


def _buckets(mix: Dict, capacity: int) -> List[int]:
    """Every prefill length the batcher pads a prompt of the mix to."""
    out, b = [], 16
    while b < mix["prompt"]["min"]:
        b *= 2
    while True:
        out.append(min(b, capacity))
        if b >= mix["prompt"]["max"] or b >= capacity:
            return out
        b *= 2


def _counters(rt) -> Dict[str, float]:
    """The program's counters the per-layer metrics read (call under the
    runtime's lock)."""
    def hist(name):
        h = rt.hub.get_histogram(name)
        series = list(h.series.values()) if h is not None else []
        return (sum(total for _, total in series),
                sum(sum(counts) for counts, _ in series))

    ttft, queue_wait = (hist("serve_ttft_seconds"),
                        hist("serve_queue_wait_seconds"))
    return {"decode_steps": rt.srv.decode_steps,
            "decode_seconds": rt.srv.decode_seconds,
            "ttft_sum": ttft[0], "ttft_count": ttft[1],
            "queue_wait_sum": queue_wait[0],
            "queue_wait_count": queue_wait[1],
            "queue_depth": rt.hub.gauge("serve_queue_depth") or 0.0,
            "slots_busy": rt.hub.gauge("serve_slots_busy") or 0.0}


class _Client:
    """Submits the mix's requests on time, from a thread of its own, and
    records what streams back (:meth:`poll`, from the calling thread).

    The two are apart so that a request that comes due while a step holds
    the runtime's lock waits for that lock itself, as a front end's
    handler does, and is not held back behind a poll."""

    def __init__(self, rt, reqs: List[Dict], clock, t_open: float):
        self.rt, self.reqs, self.clock, self.t_open = rt, reqs, clock, t_open
        self.next = 0                          # requests handed over
        self.submitted: "queue.SimpleQueue[Dict]" = queue.SimpleQueue()
        self.open: Dict[int, Dict] = {}        # rid -> request
        self.done: List[Dict] = []
        self.polls: List[Dict] = []            # one per poll that saw steps
        self.depths: List[tuple] = []          # (time, queued, slots busy)
        self.last = None
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._submit_loop,
                                        name="bench-submit", daemon=True)

    def now(self) -> float:
        return self.clock() - self.t_open

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
        if self.error is not None:
            raise self.error

    def _submit_loop(self) -> None:
        try:
            self._submit_due()
        except BaseException as exc:  # raised again by stop()
            self.error = exc

    def _submit_due(self) -> None:
        while self.next < len(self.reqs) and not self._stop.is_set():
            req = self.reqs[self.next]
            wait = req["due"] - self.now()
            if wait > 0:
                self._stop.wait(wait)
                continue
            got = self.rt.submit(req["prompt"], req["max_new"], stream=True)
            if got is None:
                req["refused"] = True
            else:
                req["rid"], req["times"] = got[0], []
                self.submitted.put(req)
            self.next += 1

    def poll(self) -> Dict[str, float]:
        with self.rt.lock:
            return self.poll_locked()

    def poll_locked(self) -> Dict[str, float]:
        """Read every new token and finished request (the runtime's lock
        held); returns the counters as of this poll."""
        rt = self.rt
        t = self.now()
        while True:
            try:
                req = self.submitted.get_nowait()
            except queue.Empty:
                break
            self.open[req["rid"]] = req
        counters = _counters(rt)
        self.depths.append((t, counters["queue_depth"],
                            counters["slots_busy"]))
        news = []
        for rid, req in self.open.items():
            buf = rt.streams.get(rid)
            if buf is None:
                continue
            seen = len(req["times"])
            toks = [ev for ev in buf[seen:] if "token" in ev]
            if toks:
                news.append((req, len(toks), seen))
                req["times"].extend([t] * len(toks))
        finished = [rid for rid in self.open if rid in rt.results]
        for rid in finished:
            req = self.open.pop(rid)
            req["tokens"] = rt.results.pop(rid)
            rt.events.pop(rid, None)
            rt.streams.pop(rid, None)
            self.done.append(req)
        if self.last is not None:
            steps = counters["decode_steps"] - self.last["decode_steps"]
            if steps > 0 and news:
                self.polls.append({
                    "t": t, "steps": steps,
                    "decode_seconds": counters["decode_seconds"]
                    - self.last["decode_seconds"],
                    "token_steps": sum(k for _, k, _ in news),
                    "visible": sum(
                        k * (len(r["prompt"]) + have + 1) + k * (k - 1) // 2
                        for r, k, have in news)})
        self.last = counters
        return counters


def start_runtime(cell, params):
    """The port's runtime over ``params``, every prefill bucket of the mix
    and the decode chunk warmed."""
    import torch

    from k8s_operator_libs_tpu_torch.models.moe import moe_paged_forward
    from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub
    from k8s_operator_libs_tpu_torch.server import ServingRuntime

    d, mix = cell.dims, cell.mix
    rt = ServingRuntime(params, port_config(d), max_slots=mix["slots"],
                        capacity=mix["capacity"], block_size=mix["block"],
                        chunk=mix["chunk"], hub=MetricsHub())
    calls = []
    if d.family == "moe":
        # the runtime takes no forward hook: its batcher's is set before
        # the first request, through a wrapper that counts the warm-up's
        # calls, so that a batcher that no longer calls it fails here
        if not hasattr(rt.srv, "_forward"):
            rt.stop()
            raise RuntimeError("the batcher has no _forward to set")

        def counted(*args, **kwargs):
            calls.append(1)
            return moe_paged_forward(*args, **kwargs)

        rt.srv._forward = counted
    try:
        warm_rng = np.random.default_rng(0)
        waits = []
        for b in _buckets(mix, rt.srv.capacity - mix["chunk"] - 1):
            prompt = warm_rng.integers(0, d.vocab, size=b, dtype=np.int32)
            waits.append(rt.submit(prompt, mix["chunk"] + 1))
        for rid, ev in waits:
            if not ev.wait(600):
                raise RuntimeError("warm-up request did not finish")
            rt.result(rid)
        if cell.device.type == "cuda":
            torch.cuda.synchronize()
        if d.family == "moe":
            if not calls:
                raise RuntimeError("the batcher's warm-up never called "
                                   "moe_paged_forward")
            rt.srv._forward = moe_paged_forward
    except BaseException:
        rt.stop()
        raise
    return rt


def drive(cell, rt, reqs: List[Dict]):
    """The open loop over ``reqs`` from the ramp to the run's end; returns
    (the window's counters and marks, the client)."""
    import torch

    mix, dev = cell.mix, cell.device
    clock = time.perf_counter
    t_open = clock() + mix["ramp_s"]
    client = _Client(rt, reqs, clock, t_open)
    window: Dict = {}
    prof, prof_from, prof_until = None, None, None
    if cell.trace:
        prof_from = cell.seconds * mix["trace_from"]
    client.start()
    try:
        while True:
            now = client.now()
            if "open" not in window and now >= 0:
                window["open"] = client.poll()
                window["setup_s"] = clock() - cell.t_process
            # the profiled span starts and ends between two chunks: every
            # token of the chunks inside it is read inside it
            if prof_from is not None and prof is None and now >= prof_from:
                with rt.lock:
                    window["prof_open"] = client.poll_locked()
                    window["prof_polls"] = [len(client.polls)]
                    prof = DeviceTrace(torch, dev)
                    prof.start()
                # the span's length counts from the profiler's start, which
                # can itself take seconds
                prof_until = client.now() + mix["trace_s"]
            if prof is not None and "prof_close" not in window \
                    and now >= prof_until:
                with rt.lock:
                    prof.stop()
                    window["prof_close"] = client.poll_locked()
                    window["prof_polls"].append(len(client.polls))
            if "close" not in window and now >= cell.seconds:
                window["close"] = client.poll()
                window["memory_peak_bytes"] = (
                    torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
            if "close" in window:
                late = [r for r in reqs
                        if 0 <= r["due"] < cell.seconds
                        and not r.get("refused")
                        and len(r.get("times", [])) < 2
                        and "tokens" not in r]
                if not late or now >= cell.seconds + mix["tail_s"]:
                    break
            client.poll()
            time.sleep(mix["poll_s"])
        if prof is not None and "prof_close" not in window:
            # the run ended inside the span: it closes with the run
            with rt.lock:
                prof.stop()
                window["prof_close"] = client.poll_locked()
                window["prof_polls"].append(len(client.polls))
    finally:
        client.stop()
    window["trace"] = prof
    return window, client


def run(cell) -> Dict:
    import torch

    d, mix, dev = cell.dims, cell.mix, cell.device
    params = make_params(d, cell.seed, dev)
    rt = start_runtime(cell, params)
    log("weights made, buckets warmed; arrivals start")
    reqs = traffic.serve_requests(mix, cell.seed, d.vocab,
                                  cell.seconds + mix["tail_s"])
    try:
        window, client = drive(cell, rt, reqs)
    finally:
        rt.stop()
    prof = window.pop("trace")
    end = client.now()
    in_window = [r for r in reqs[:client.next]
                 if 0 <= r["due"] < cell.seconds]
    record = {
        "kind": "serve", "dims": d, "mix": mix,
        "window_s": float(cell.seconds), "end_s": end,
        "setup_s": window["setup_s"],
        "memory_peak_bytes": window["memory_peak_bytes"],
        "requests": [{"due": r["due"], "prompt_len": len(r["prompt"]),
                      "max_new": r["max_new"], "times": r.get("times", []),
                      "refused": bool(r.get("refused"))}
                     for r in in_window],
        "tokens_in_window": sum(
            1 for r in reqs[:client.next] for t in r.get("times", [])
            if 0 <= t < cell.seconds),
        "counters": window,
        "polls": client.polls,
        "trace": prof,
    }
    record["attempted"] = len(in_window)
    record["failed"] = sum(1 for r in in_window
                           if r.get("refused") or not r.get("times"))

    log(f"window closed; run ends at {end:.2f} s: {len(client.done)} "
        f"finished, {record['failed']} of {record['attempted']} due in "
        f"the window without a token, peak "
        f"{record['memory_peak_bytes'] / 1e9:.2f} GB")
    finished = client.done
    del rt, client, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    record["checks"] = _check_outputs(cell, finished)
    return record


def _check_outputs(cell, finished: List[Dict]) -> Dict:
    """The served tokens of a sample of the finished requests drawn from
    the seed (the longest among them) against the reference: the gaps by
    which their logits lie below the reference's best, each statistic the
    cell's limits name beside its limit."""
    import torch

    mix, d = cell.mix, cell.dims
    sizes = [len(r["tokens"]) - len(r["prompt"]) for r in finished]
    picked = traffic.sample(cell.seed, list(range(len(finished))), sizes,
                            mix["check_tokens"], mix["check_requests"])
    served = sum(sizes[i] for i in picked)
    out = {"served_tokens_checked": (float(served),
                                     float(mix["check_tokens_min"]),
                                     "at_least")}
    if served < mix["check_tokens_min"]:
        return out
    seqs = [torch.as_tensor(np.asarray(finished[i]["tokens"], np.int64))
            for i in picked]
    starts = [len(finished[i]["prompt"]) - 1 for i in picked]
    stats = reference_gaps(cell, seqs, starts)
    log(f"reference done over {len(seqs)} requests, {served} tokens: "
        f"{stats}")
    for name, limit in cell.limits.items():
        out[name] = (stats["program"][name], limit, "at_most")
    if cell.control:
        cell.control_reading = stats
        cell.control_checks = dict(out, **{
            name: (stats["control"][name], limit, "at_most")
            for name, limit in cell.limits.items()})
    return out


def reference_gaps(cell, seqs: List, starts: List[int]) -> Dict[str, Dict]:
    """Gap statistics (:func:`gap_stats`) of the served tokens against the
    float32 reference (``program``); when the cell asks for the control,
    also of the tokens that the float8 reference puts first (``control``)
    and, as a witness of what bf16 rounding alone moves, of those the
    reference with bf16 operands puts first (``bf16``)."""
    import torch

    d, dev = cell.dims, cell.device

    def head():
        return {n: make_slab(d, cell.seed, n, -1, dev, torch.float32)
                for n in ("embed", "final_norm", "lm_head")}

    def layer(i):
        return make_layer(d, cell.seed, i, dev)

    ref = sequence_logits(d, layer, head(), seqs, starts, Matmul("fp32"))
    served = [s[st + 1:].to(dev) for s, st in zip(seqs, starts)]
    out = {"program": gap_stats(ref, served)}
    if cell.control:
        for precision, name in (("fp8", "control"), ("bf16", "bf16")):
            low = sequence_logits(d, layer, head(), seqs, starts,
                                  Matmul(precision))
            out[name] = gap_stats(ref, [lo.argmax(-1) for lo in low])
    return out


def gap_stats(ref: List, picked: List) -> Dict[str, float]:
    """At every position, the reference's best logit less the logit of the
    token picked there: the widest (``max_logit_gap``), the mean
    (``mean_logit_gap``) and the share of positions where the pick is not
    the reference's best (``off_best_share``)."""
    import torch

    gaps = torch.cat([
        logits.max(-1).values - logits.gather(1, tok[:, None])[:, 0]
        for logits, tok in zip(ref, picked)])
    return {"max_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean()),
            "off_best_share": float((gaps > 0).float().mean())}
