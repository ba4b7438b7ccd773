"""Training: the port's ``make_train_step`` on a seeded deck of batches.

Set-up builds one train state over weights made from the seed (bf16
weights, gradients and moments, remat, the mix's AdamW recipe) and drives
it through its first ``compare_steps`` steps with the window's own call
and feed: these steps warm every kernel, and the state after them is
read for the output check (each step's loss, each leaf's first moment
after step 1, each leaf's distance from its initial value after the
last). The same state then runs on through the window, one step per
deck batch, each step ending in a synchronize, until ``--seconds`` have
passed. A traced run profiles the window's first ``trace_steps`` steps.
After the window the state is freed and the plain reference follows the
same steps in float32 from the same seeded weights and batches.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Callable, Dict, List, Optional

from .. import traffic
from ..models import leaf_names, port_config
from ..reference.train import train_steps
from ..devtrace import DeviceTrace
from ..harness import log
from ..weights import initial_of, leaf_of, make_params


def make_step(cell, params):
    """(train_step, state) of the port over ``params`` (used in place)."""
    from k8s_operator_libs_tpu_torch.parallel import fsdp

    recipe = cell.mix["optimizer"]
    opt = fsdp.ClippedAdamW(lr=recipe["lr"])
    opt.b1, opt.b2, opt.eps = recipe["b1"], recipe["b2"], recipe["eps"]
    opt.weight_decay, opt.max_norm = recipe["weight_decay"], recipe["clip"]
    cfg = port_config(cell.dims, remat=cell.mix["remat"])
    state = fsdp.TrainState(params=params, opt_state=opt.init(params),
                            step=0)
    return fsdp.make_train_step(cfg, optimizer=opt), state


def program_readings(cell, step: Callable, state, deck,
                     feed: Optional[Callable] = None):
    """Drive the state through the compared steps; returns (state,
    readings): ``loss`` per step, ``grad`` (each leaf's first moment after
    step 1 over 1 - b1: its gradient as the optimizer took it) and
    ``change`` (each leaf's distance from its initial value after the
    last compared step). ``feed(batch)`` stands between the deck and the
    step (the identity by default)."""
    import torch

    d, dev = cell.dims, cell.device
    feed = feed or (lambda b: b)
    names = leaf_names(d)
    b1 = cell.mix["optimizer"]["b1"]
    out: Dict = {"loss": [], "grad": {}, "change": {}}
    for i in range(cell.mix["compare_steps"]):
        state, m = step(state, feed(deck[i]))
        out["loss"].append(float(m["loss"]))
        if i == 0:
            for n in names:
                mu = leaf_of(state.opt_state.mu, n)
                out["grad"][n] = float(torch.linalg.vector_norm(
                    mu.float())) / (1 - b1)
    for n in names:
        p0 = initial_of(d, cell.seed, n, dev).float()
        out["change"][n] = float(torch.linalg.vector_norm(
            leaf_of(state.params, n).float() - p0))
    return state, out


def reference_readings(cell, deck, precision: str = "fp32") -> Dict:
    """The plain reference's readings of the compared steps, from the
    seed's weights in float32."""
    import torch

    d, dev = cell.dims, cell.device
    params = {}
    for n in leaf_names(d):
        params[n] = initial_of(d, cell.seed, n, dev).float()
    batches = [deck[i] for i in range(cell.mix["compare_steps"])]
    out = train_steps(d, params, batches, cell.mix["optimizer"], precision,
                      initial=lambda n: initial_of(d, cell.seed, n,
                                                   dev).float())
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a reading is compared by: the widest relative gap of a
    step's loss, of a leaf's first-gradient norm and of a leaf's change
    norm. A leaf's gap is measured against the reference's norm of that
    leaf or of the median leaf, whichever is larger; a leaf whose
    reference gradient is under a thousandth of the median leaf's moves
    by round-off alone and is left out of the change."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                    ref["loss"]))

    def worst(key: str, keep: List[str]) -> float:
        med = statistics.median(ref[key][n] for n in keep)
        return max(abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med)
                   for n in keep)

    raw = ref["raw_grad"]
    med_raw = statistics.median(raw.values())
    moving = [n for n in raw if raw[n] >= 1e-3 * med_raw]
    return {"loss_gap": loss, "grad_gap": worst("grad", list(raw)),
            "change_gap": worst("change", moving)}


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each number the cell's limits name, beside its limit."""
    return {k: (numbers[k], limit, "at_most") for k, limit in limits.items()}


def run(cell) -> Dict:
    import torch

    d, mix, dev = cell.dims, cell.mix, cell.device
    params = make_params(d, cell.seed, dev)
    deck = traffic.train_deck(mix, cell.seed, d.vocab, dev)
    step, state = make_step(cell, params)
    del params
    log("weights and state made")
    state, prog = program_readings(cell, step, state, deck)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - cell.t_process
    log(f"compared steps done: losses {prog['loss']}; window opens")

    tokens = mix["batch"] * mix["seq"]
    times: List[float] = []
    prof = None
    i = mix["compare_steps"]
    t_open = time.perf_counter()
    while True:
        traced = cell.trace and len(times) < mix["trace_steps"]
        if traced and prof is None:
            prof = DeviceTrace(torch, dev)
            prof.start()
        t0 = time.perf_counter()
        state, m = step(state, deck[i % mix["deck_batches"]])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if prof is not None and len(times) == mix["trace_steps"]:
            prof.stop()
        i += 1
        if time.perf_counter() - t_open >= cell.seconds \
                and len(times) >= mix["min_steps"] + (
                    mix["trace_steps"] if cell.trace else 0):
            break
    window_s = time.perf_counter() - t_open
    final_loss = float(m["loss"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    retries = (torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
               if dev.type == "cuda" else 0)
    del state, step, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"window closed: {len(times)} steps in {window_s:.3f} s, peak "
        f"{peak / 1e9:.2f} GB, {retries} allocation retries")

    record = {"kind": "train", "dims": d, "mix": mix, "setup_s": setup_s,
              "window_s": window_s, "step_times": times,
              "traced_steps": mix["trace_steps"] if cell.trace else 0,
              "tokens_per_step": tokens, "memory_peak_bytes": peak,
              "trace": prof, "attempted": len(times),
              "failed": 0 if final_loss == final_loss else len(times)}
    ref = reference_readings(cell, deck)
    numbers = compare(prog, ref)
    log(f"reference done: losses {ref['loss']}; {numbers}")
    record["checks"] = checks(numbers, cell.limits)
    if cell.control:
        cell.control_reading = compare(
            reference_readings(cell, deck, "fp8"), ref)
        cell.control_checks = checks(cell.control_reading, cell.limits)
    return record
