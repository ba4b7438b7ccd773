#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``k8s_operator_libs_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit: ``python3 chip_smoke.py``. It needs no network and exits
non-zero, printing no result, when there is no GPU or no port beside it.

Phases, each fatal on failure:

1. Device and build: the card's name and power limit (``nvidia-smi``),
   then the port's CUDA source built with ``nvcc``.
2. Kernels against their plain PyTorch versions at the Llama-3-8B decode
   attention shape (H 32, KV 8, Dh 128, block 16, 4 sequences of capacity
   1024, ragged lengths 0/17/300/1023, a shuffled table, NaN in every
   dead block): A-K4 on bf16 pools, A-K5 on int8 pools. Times with CUDA
   events on a cold L2: kernel, plain version, byte bound, and
   ``F.scaled_dot_product_attention`` over the gathered view as a
   yardstick (the port never calls it).
3. Serving at full size: Llama-3-8B, all 32 layers in bf16, weights seeded
   on the card, behind the port's HTTP server (4 slots, capacity 1024,
   block 16, chunk 4); 4 concurrent ``/generate`` requests with ragged
   prompts. The A-K4 launch count must be 32 x the decode steps run, and
   one decode step's logits through the kernel and through the plain
   version must agree. Prints the weight bytes a decode step streams and
   the floor they set at the card's memory rate.
4. Token parity in fp32 at Llama-3-8B width, 2 layers: the batcher's
   greedy tokens (through A-K4) against the contiguous ``generate``
   (plain), and ``paged_generate(kv_int8=True)`` through A-K5 against the
   same call with the plain version.

The line before last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense tensor-core peak

BS, CAPACITY, SLOTS, CHUNK, MAX_NEW = 16, 1024, 4, 4, 32
PROMPT_LENS = (24, 100, 300, 700)
KERNEL_LENGTHS = (0, 17, 300, 1023)
SOURCE = "k8s_operator_libs_tpu_torch/csrc/paged_decode.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ timing

def time_cold_ms(torch, fn, iters=25):
    """Median device time of ``fn`` between two CUDA events, the L2 flushed
    before each call (a decode step streams far more than the 50 MB L2
    between two attention calls). A spin kernel first lets the host
    enqueue flush, events and ``fn`` before the device reaches them."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


# ------------------------------------------------------------------ phases

def phase_build():
    from k8s_operator_libs_tpu_torch.ops import build
    path, secs, compiler_log = build.build("paged_decode")
    log(f"phase 1: built paged_decode in {secs:.1f} s -> {path.name}")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def kernel_case(torch, int8, seed=0):
    """The Llama-3-8B decode-attention inputs of one batcher step."""
    import numpy as np
    H, KV, Dh, MB = 32, 8, 128, CAPACITY // BS
    B = len(KERNEL_LENGTHS)
    NB = B * MB + 1
    gen = np.random.default_rng(seed)
    table = gen.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    live = {int(table[b, m]) for b in range(B)
            for m in range(KERNEL_LENGTHS[b] // BS + 1)}
    dead = sorted(set(range(NB)) - live)
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = torch.randn((2, NB, BS, KV, Dh), generator=g, device="cuda")
    q = torch.randn((B, 1, H, Dh), generator=g,
                    device="cuda").to(torch.bfloat16)
    ks = vs = None
    if int8:
        s = f.abs().amax(-1).clamp_min(1e-12) / 127.0
        pools = torch.clamp(torch.round(f / s[..., None]), -127,
                            127).to(torch.int8)
        s[:, dead] = float("nan")
        ks, vs = s[0].contiguous(), s[1].contiguous()
    else:
        pools = f.to(torch.bfloat16)
        pools[:, dead] = float("nan")
    k, v = pools[0].contiguous(), pools[1].contiguous()
    tbl = torch.as_tensor(table, device="cuda")
    lengths = torch.as_tensor(np.asarray(KERNEL_LENGTHS, np.int32),
                              device="cuda")
    return (q, k, v, tbl, lengths, ks, vs), live


def bound_ms(q, k_pool, n_live_blocks, lengths, int8):
    """Least time for one call: every byte the function needs read once
    (q, the visible K/V rows t <= len and their scales, the live table
    entries, the lengths), the output written once, against the
    operations over the matching peak."""
    B, _, H, Dh = q.shape
    KV = k_pool.shape[2]
    row = KV * Dh * k_pool.element_size()
    scale_row = KV * 4 if int8 else 0
    keys = sum(int(n) + 1 for n in lengths)                 # visible rows
    nbytes = (2 * q.numel() * q.element_size()              # q in, out
              + keys * 2 * (row + scale_row)                # K and V
              + n_live_blocks * 4 + B * 4)                  # table, lengths
    flops = 4 * H * Dh * keys
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_kernels(torch):
    import torch.nn.functional as F

    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn
    results = {}
    for name, int8 in (("paged_decode", False), ("paged_decode_int8", True)):
        args, live = kernel_case(torch, int8)
        q, k, v, table, lengths, ks, vs = args
        got = attn.paged_decode_cuda(*args)
        torch.cuda.synchronize()
        ref = attn.paged_decode_plain(*args)
        check(torch.isfinite(got).all().item(),
              f"{name}: non-finite output (a dead block leaked)")
        err = (got.float() - ref.float()).abs()
        # one bf16 rounding of the output (2^-8 relative) plus fp32
        # summation order, scaled by max(1, |plain|)
        tol = 1e-2
        ok = (err <= tol * ref.float().abs().clamp_min(1.0)).all().item()
        max_err = float(err.max())
        log(f"phase 2: {name} max_abs_err {max_err:.3e} "
            f"(tolerance {tol} x max(1, |plain|)) "
            f"{'ok' if ok else 'FAILED'}")
        check(ok, f"{name} disagrees with its plain version")

        B = q.shape[0]
        MB = table.shape[1]
        cap = MB * BS
        view_k = k[table.long()].reshape(B, cap, 8, 128)
        view_v = v[table.long()].reshape(B, cap, 8, 128)
        if int8:
            view_k = (view_k.float() * ks[table.long()].reshape(
                B, cap, 8)[..., None])
            view_v = (view_v.float() * vs[table.long()].reshape(
                B, cap, 8)[..., None])
        view_k = torch.nan_to_num(view_k.to(torch.bfloat16))
        view_v = torch.nan_to_num(view_v.to(torch.bfloat16))
        kq = view_k.permute(0, 2, 1, 3).contiguous()        # [B, KV, cap, D]
        vq = view_v.permute(0, 2, 1, 3).contiguous()
        qq = q.permute(0, 2, 1, 3).contiguous()             # [B, H, 1, D]
        mask = (torch.arange(cap, device="cuda")[None, :]
                <= lengths.long()[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(qq, kq, vq,
                                                  attn_mask=mask,
                                                  enable_gqa=True)

        try:
            lib = library()
        except TypeError:           # no enable_gqa: repeat K/V heads
            kq = kq.repeat_interleave(4, dim=1)
            vq = vq.repeat_interleave(4, dim=1)
            lib = library()
        lib_err = float((lib.permute(0, 2, 1, 3).float()
                         - ref.float()).abs().max())
        ms = time_cold_ms(torch, lambda: attn.paged_decode_cuda(*args))
        plain_ms = time_cold_ms(torch, lambda: attn.paged_decode_plain(*args))
        library_ms = time_cold_ms(torch, library)
        b_ms, bound_by = bound_ms(q, k, len(live), KERNEL_LENGTHS, int8)
        log(f"phase 2: {name} ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} (sdpa max diff {lib_err:.2e}) "
            f"bound_ms {b_ms:.5f} ({bound_by}) -> {b_ms / ms:.1%} of bound")
        results[name] = {"max_abs_err": max_err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": bound_by, "library_ms": library_ms}
    return results


def post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def hist(hub, name):
    h = hub.get_histogram(name)
    if h is None:
        return 0.0, 0
    total = sum(t for _, t in h.series.values())
    return total, h.count()


def phase_serve(torch):
    import numpy as np

    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          init_params)
    from k8s_operator_libs_tpu_torch.models.paged import _forward_paged
    from k8s_operator_libs_tpu_torch.models.quant import stream_bytes
    from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub
    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn
    from k8s_operator_libs_tpu_torch.server import ServingRuntime, make_server

    cfg = LlamaConfig.llama3_8b()
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 3: Llama-3-8B bf16, {cfg.n_layers} layers, weights seeded "
        f"on the card in {time.monotonic() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    weight_bytes = stream_bytes(params)
    floor_ms = weight_bytes / H100_BYTES_PER_S * 1e3
    log(f"phase 3: a decode step streams {weight_bytes} weight bytes "
        f"(every leaf but the embedding): floor {floor_ms:.3f} ms at "
        f"{H100_BYTES_PER_S:.3g} B/s")
    hub = MetricsHub()
    rt = ServingRuntime(params, cfg, max_slots=SLOTS, capacity=CAPACITY,
                        block_size=BS, chunk=CHUNK, hub=hub)
    httpd = make_server(rt, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    srv = rt.srv
    try:
        code, body = post(base + "/generate",
                          {"tokens": list(range(1, 9)), "max_new": 4})
        check(code == 200 and len(body["tokens"]) == 12, "warm-up failed")
        gen = np.random.default_rng(0)
        prompts = [gen.integers(0, cfg.vocab_size, size=n).tolist()
                   for n in PROMPT_LENS]
        with rt.lock:
            attn.reset_launch_counts()
            srv.decode_steps = 0
            srv.decode_seconds = 0.0
            srv.decode_tokens = 0
            ttft0 = hist(hub, "serve_ttft_seconds")
        results = [None] * len(prompts)
        errors = []

        def call(i):
            try:
                results[i] = post(base + "/generate",
                                  {"tokens": prompts[i], "max_new": MAX_NEW})
            except Exception as exc:   # reported below as a failed phase
                errors.append(f"request {i}: {exc!r}")

        t_req = time.monotonic()
        callers = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for c in callers:
            c.start()
        for c in callers:
            c.join()
        wall = time.monotonic() - t_req
        with rt.lock:
            launches = dict(attn.LAUNCHES)
            steps = srv.decode_steps
            dec_s, dec_tok = srv.decode_seconds, srv.decode_tokens
            ttft1 = hist(hub, "serve_ttft_seconds")
        check(not errors, "; ".join(errors))
        for p, (code, body) in zip(prompts, results):
            check(code == 200, f"/generate returned {code}")
            check(len(body["tokens"]) == len(p) + MAX_NEW
                  and body["tokens"][:len(p)] == p,
                  "a response has the wrong length or prompt")
        check(steps > 0, "no decode step ran")
        check(launches["paged_decode"] == cfg.n_layers * steps,
              f"A-K4 launched {launches['paged_decode']} times over "
              f"{steps} decode steps of {cfg.n_layers} layers")
        ttft = (ttft1[0] - ttft0[0]) / max(1, ttft1[1] - ttft0[1])
        stats = {"launches": launches["paged_decode"], "decode_steps": steps,
                 "ttft_mean_s": ttft, "ms_per_decode_step":
                 1e3 * dec_s / steps, "decode_tokens_per_s": dec_tok / dec_s,
                 "wall_s": wall,
                 "tokens_per_s_end_to_end": len(prompts) * MAX_NEW / wall,
                 "weight_stream_bytes": weight_bytes,
                 "weight_stream_floor_ms": floor_ms}
        log(f"phase 3: 4 concurrent requests (prompts {PROMPT_LENS}, "
            f"max_new {MAX_NEW}) all 200 in {wall:.2f} s; A-K4 launches "
            f"{launches['paged_decode']} = {cfg.n_layers} x {steps} decode "
            f"steps")
        log(f"phase 3: mean TTFT {ttft * 1e3:.1f} ms, "
            f"{stats['ms_per_decode_step']:.2f} ms per decode step "
            f"({SLOTS} slots), decode {stats['decode_tokens_per_s']:.1f} "
            f"tokens/s, end to end {stats['tokens_per_s_end_to_end']:.1f} "
            f"generated tokens/s")
    finally:
        httpd.shutdown()
        httpd.server_close()
        rt.stop()
        server.join(timeout=30)

    # one decode step on the same cache, through the kernel and the plain
    # version: the forward rewrites identical K/V rows, so both read the
    # same cache
    for p in prompts:
        srv.submit(np.asarray(p, np.int32), 8)
    srv.step(1)
    cache, toks = srv.snapshot()
    check(int((cache.lengths > 0).sum()) == SLOTS, "slots not all running")
    with torch.no_grad():
        lk, _ = _forward_paged(params, toks, cache, cfg)
        lp, _ = _forward_paged(params, toks, cache, cfg,
                               decode_attn=attn.paged_decode_plain)
    torch.cuda.synchronize()
    check(torch.isfinite(lk).all().item(), "non-finite decode logits")
    diff = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    # 32 layers of bf16 activations: the kernel and the plain version
    # round attention outputs to bf16 independently (1 ulp = 2^-8
    # relative); allow 5% of the largest logit
    tol = 0.05 * scale
    log(f"phase 3: decode logits kernel vs plain max diff {diff:.4f} "
        f"(tolerance {tol:.4f} = 5% of max |logit| {scale:.2f})")
    check(diff <= tol, "decode logits through the kernel disagree")
    stats["logit_max_diff"] = diff
    stats.update(profile_decode(torch, srv, CHUNK))
    del params, srv, rt, cache, lk, lp
    return stats


def profile_decode(torch, srv, n):
    """Where one batcher chunk of ``n`` decode ticks spends the card's
    time: ``torch.profiler`` kernel times (device busy, its share of the
    host wall, the paged-decode kernel's share) and the top kernels. The
    profiler slows the host, so the wall here is above the unprofiled
    ms per step; this is a breakdown, not a timing."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        srv.step(n)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels.append((us / 1e3, evt.count, evt.key))
    busy = sum(ms for ms, _, _ in kernels)
    if not busy:
        log("phase 3: profile: no device time recorded (not measured)")
        return {}
    attn_ms = sum(ms for ms, _, key in kernels if "paged_decode" in key)
    log(f"phase 3: profile of one {n}-tick chunk: wall {wall_ms:.2f} ms "
        f"(profiled), device busy {busy:.2f} ms, idle share "
        f"{1 - busy / wall_ms:.1%}; paged_decode kernel {attn_ms:.2f} ms "
        f"= {attn_ms / busy:.1%} of busy")
    for ms, count, key in sorted(kernels, reverse=True)[:8]:
        log(f"  {ms:8.3f} ms  x{count:<5d} {key[:90]}")
    return {"profile_wall_ms": wall_ms, "profile_busy_ms": busy,
            "profile_attention_ms": attn_ms}


def first_mismatch(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def logit_gap(torch, params, cfg, prefix):
    """Top-2 logit gap of the contiguous (plain) forward after ``prefix``."""
    from k8s_operator_libs_tpu_torch.models.generate import (
        _forward_cached, init_cache)
    prefix_t = torch.as_tensor([prefix], device="cuda")
    cache = init_cache(cfg, 1, len(prefix), device="cuda")
    logits, _ = _forward_cached(params, prefix_t, cache, cfg)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def phase_parity(torch):
    import numpy as np

    from k8s_operator_libs_tpu_torch.models.generate import generate
    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          init_params)
    from k8s_operator_libs_tpu_torch.models.paged import paged_generate
    from k8s_operator_libs_tpu_torch.models.serve import ContinuousBatcher
    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cuda")
    gen = np.random.default_rng(1)
    prompts = [gen.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    failures = []

    # (a) the batcher through A-K4 against the contiguous plain decode
    attn.reset_launch_counts()
    srv = ContinuousBatcher(params, cfg, max_slots=SLOTS,
                            capacity_per_slot=CAPACITY, block_size=BS)
    rids = [srv.submit(p, MAX_NEW) for p in prompts]
    out = {}
    while not srv.idle:
        srv.step(CHUNK)
        out.update(srv.poll())
    launches_k4 = attn.LAUNCHES["paged_decode"]
    check(launches_k4 == cfg.n_layers * srv.decode_steps > 0,
          f"A-K4 launched {launches_k4} times over {srv.decode_steps} "
          f"steps")
    for rid, p in zip(rids, prompts):
        ref = generate(params, torch.as_tensor(p[None]), cfg,
                       max_new_tokens=MAX_NEW)[0].cpu().numpy()
        got = out[rid]
        i = first_mismatch(got.tolist(), ref.tolist())
        if i is not None:
            gap = logit_gap(torch, params, cfg, ref[:i].tolist())
            failures.append(f"batcher prompt {len(p)}: token {i - len(p)} "
                            f"differs ({got[i]} vs {ref[i]}), plain top-2 "
                            f"logit gap there {gap:.3e}")
    log(f"phase 4a: batcher (A-K4, {launches_k4} launches) vs contiguous "
        f"generate (plain), fp32, 4 prompts x {MAX_NEW} tokens: "
        f"{'identical' if not failures else 'MISMATCH'}")

    # (b) paged_generate(kv_int8) through A-K5 against the plain version
    B, Tp = len(prompts), max(PROMPT_LENS)
    padded = np.zeros((B, Tp), np.int32)
    for b, p in enumerate(prompts):
        padded[b, :len(p)] = p
    plens = torch.as_tensor(np.asarray(PROMPT_LENS, np.int32))
    prompt_t = torch.as_tensor(padded)
    attn.reset_launch_counts()
    got = paged_generate(params, prompt_t, cfg, max_new_tokens=MAX_NEW,
                         prompt_lengths=plens, block_size=BS,
                         kv_int8=True).cpu().numpy()
    launches_k5 = attn.LAUNCHES["paged_decode_int8"]
    check(launches_k5 == cfg.n_layers * (MAX_NEW - 1),
          f"A-K5 launched {launches_k5} times, expected "
          f"{cfg.n_layers * (MAX_NEW - 1)}")
    ref = paged_generate(params, prompt_t, cfg, max_new_tokens=MAX_NEW,
                         prompt_lengths=plens, block_size=BS, kv_int8=True,
                         decode_attn=attn.paged_decode_plain).cpu().numpy()
    mism = []
    for b in range(B):
        i = first_mismatch(got[b, Tp:].tolist(), ref[b, Tp:].tolist())
        if i is not None:
            mism.append(f"int8 paged_generate row {b}: token {i} differs "
                        f"({got[b, Tp + i]} vs {ref[b, Tp + i]})")
    failures += mism
    log(f"phase 4b: paged_generate(kv_int8) A-K5 ({launches_k5} launches) "
        f"vs plain, fp32: {'identical' if not mism else 'MISMATCH'}")
    for f in failures:
        log(f"phase 4: {f}")
    check(not failures, "token parity failed")
    return {"launches_int8": launches_k5}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import k8s_operator_libs_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True).stdout.strip()
        check(bool(smi), "nvidia-smi printed nothing")
        log(smi)
        phase_build()
        kernels = phase_kernels(torch)
        serve = phase_serve(torch)
        torch.cuda.empty_cache()
        parity = phase_parity(torch)
    except (SmokeFailure, subprocess.SubprocessError, OSError,
            RuntimeError, ValueError) as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    rows = []
    for name, replaces, launches in (
            ("paged_decode", "k8s_operator_libs_tpu/ops/attention.py:734",
             serve["launches"]),
            ("paged_decode_int8",
             "k8s_operator_libs_tpu/ops/attention.py:828",
             parity["launches_int8"])):
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"serving": {key: (round(v, 6) if isinstance(v, float)
                                        else v)
                                  for key, v in serve.items()}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
