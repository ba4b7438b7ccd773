#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``k8s_operator_libs_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit: ``python3 chip_smoke.py``. It needs no network and exits
non-zero, printing no result, when there is no GPU or no port beside it.

Phases, each fatal on failure:

1. Device and build: the card's name and power limit (``nvidia-smi``),
   then the port's CUDA sources built with one ``nvcc`` each, all at once,
   with each kernel's registers and spills. The tensor-core flash kernels
   (``flash_attention_tc.cu``: A-K1, A-K2, A-K3 for bf16/fp16) and the
   paged-decode split and merge kernels must spill nothing, and the
   flash ones, where ``cuobjdump`` is installed, hold ``HGMMA``
   instructions.

   Which units run what: the flash forward and backward in bf16/fp16 run
   on the tensor cores (``wgmma``, ``flash_attention_tc.cu``); in fp32
   on the FMA units (``flash_attention.cu``: TF32 would break fp32
   parity); paged decode (A-K4, A-K5, ``paged_decode.cu``) on the FMA
   units, each sequence's live blocks split over many CTAs whose partial
   softmaxes a second kernel merges (flash-decoding): it is bound by
   bytes, not operations.
2. Kernels against their plain PyTorch versions. Paged decode (A-K4 on
   bf16 pools, A-K5 on int8 pools) at the Llama-3-8B decode attention
   widths (H 32, KV 8, Dh 128, block 16, a shuffled table, NaN in every
   dead block) at two shapes: the serving shape of phase 3 (4 sequences
   of capacity 1024, lengths 0/17/300/1023) and a full batch (32
   sequences of capacity 4096, lengths drawn from seed 0), each element
   within 1e-2 x max(1, |plain|), the same bits on a second call; at the
   serving shape the tolerance must reject three planted faults of the
   longest sequence (a skipped live block, a dropped split, a merge
   without its e^(m_i - M) rescale). Flash attention (A-K1 forward, A-K2
   dq, A-K3 dk/dv; on the tensor cores for bf16, on the FMA kernels for
   fp32, each forward's route checked) at four shapes: the training shape
   below (B 2, T 2048, H 32, KV 8, Dh 128, bf16, causal), T 1000
   non-causal, H 12 / KV 4 / Dh 64, and fp32, then at the ranks' own
   shapes of phases 9 and 10 (``FLASH_CASES``); every element of out,
   dq, dk and dv within a tolerance relative to its own
   row, lse within a tolerance in nats, and each tolerance shown to
   reject a kernel that skipped one tile (``planted_faults``). Times at
   the main shapes with CUDA events on a cold L2: kernel, plain version,
   bound, and ``F.scaled_dot_product_attention`` as a yardstick (the port
   never calls it); the whole backward (the delta pass, A-K2 and A-K3)
   beside SDPA's autograd backward.
3. Serving at full size: Llama-3-8B, all 32 layers in bf16, weights seeded
   on the card, behind the port's HTTP server (4 slots, capacity 1024,
   block 16, chunk 4); 4 concurrent ``/generate`` requests with ragged
   prompts. The A-K4 launch count must be 32 x the decode steps run, and
   one decode step's logits through the kernel and through the plain
   version must agree. Prints the weight bytes a decode step streams and
   the floor they set at the card's memory rate.
   3b. Speculative serving on the same weights: a replica with the
   self-int8 draft (the weights quantized to int8, k 4) streams phase 3's
   four requests over SSE. Each stream must be gapless and end in its
   own tokens, the tokens must equal phase 3's up to the first position
   whose plain top-2 logit gap is under ``SPEC_GAP_EPS`` (a bf16 verify
   at T = k + 1 rounds other than a T = 1 step), and A-K4 must launch
   rounds x (k + 1) x 32 times. Prints the acceptance, ms per round,
   confirmed tokens per round per slot, ``weight_stream_gbs`` and the ms
   of one draft step, one target decode step and one verify.
   3c. Live migration over HTTP: two replicas at full size (one set of
   weights shared in the process); a stream from A is frozen after a
   few tokens, ``/drain`` arms A's drain hold (A's stepper then runs
   free and must stay held), ``/export`` must answer 200, B ``/adopt``s
   and the rest is read from B's ``/stream``. The spliced stream must be
   gapless and equal B's undisturbed run, and both hops' ``/trace``
   carry one trace id.
   3d. The serving tier in-process: three ``serving.BatcherRuntime``
   replicas over phase 3's weights (its slots, capacity and block) on
   three in-script nodes, under the port's ``ReplicaPool`` and
   ``RequestRouter``. Phase 3's four prompts stream in the interactive
   lane; once every replica has streamed 4 tokens the batch and
   best-effort lanes arrive (12 requests, 32 new tokens each) and node
   A's upgrade-state label turns ``cordon-required``. The router's own
   drain watch must drain A: its streams live-migrate to B and C (KV
   export, adoption), its never-admitted requests are placed again, no
   admission lands on A after it. A fresh replica then takes A back and
   serves 4 new prompts. Every request completes exactly once, every
   stream is gapless, ``check_invariants`` is empty at every tick, at
   least one live migration and no re-prefill fallback, tokens equal
   phase 3's (``generate``'s for the new prompts) by 3b's near-tie rule,
   and A-K4 launches 32 x the decode steps of all the replicas. Prints
   ms per router tick, TTFT per lane, ms per decode step per replica and
   each migration's export and adopt ms and KV bytes. Its fp32 twin:
   two replicas at Llama-3-8B width, 2 layers, one drain, every
   request's tokens equal to the contiguous ``generate``'s.
   3e. The router binary and the capacity market: the port's
   ``router.main`` (``python -m k8s_operator_libs_tpu_torch.router``)
   with ``--kubeconfig`` to the port's ``FakeAPIServer`` over a port
   ``FakeCluster`` (nodes A, B and C, read and patched through the
   port's ``LiveClient``) in front of two replicas over phase 3's
   weights.
   Phase 3's prompts stream through its ``/generate`` in the three lanes;
   A freezes, node A's upgrade-state label turns ``cordon-required``, and
   the binary's ticker must drain A (``/healthz`` 503, the drain intent
   on the node) while its relay splices A's streams onto B by
   ``/export``, ``/adopt`` and ``/stream``: >= 1 live migration and no
   fallback, every stream gapless, tokens by 3b's near-tie rule. Then a
   burst of requests kept in flight on B makes the port's
   ``CapacityArbiter`` (demand: ``HTTPLaneDemand`` over the binary's
   ``/lanes``; goodput: a constant stand-in, no trainer runs here)
   preempt the slice on node C: its grant starts a third replica there
   and registers it by ``POST /register``, and at least one request
   completes on it; when the burst ends the arbiter returns the slice,
   C drained through the router. The market's decisions must be
   preempt, grant, return, returned, node C's owner label, lease and
   decision annotations the wire contract's, every request delivered
   once (burst tokens against a batched ``generate`` by the near-tie
   rule), no router tick failed, the ticker joined at shutdown, and A-K4
   launches 32 x the decode steps of the three replicas. Prints ms per
   router tick, ``tpu_router_proxy_overhead_seconds`` p50/p99, TTFT per
   lane through the router, export and adopt ms and KV bytes over HTTP,
   ms per decode step per replica and the arbiter's decisions with their
   exchange rates.
   3f. A rolling NVIDIA driver upgrade under the port's operator:
   three replicas over phase 3's weights on nodes gpu-a, gpu-b and gpu-c
   of the port's ``FakeCluster`` (GFD labels: H100, 8 GPUs, each node
   its own upgrade group), the driver DaemonSet at v1 with one pod per
   node and one serve pod per node (``job=serve``, one
   ``nvidia.com/gpu``). Phase 3's prompts are submitted and the
   DaemonSet is bumped to v2; then each iteration is one
   ``GPUOperator.reconcile()`` (its ``ClusterUpgradeStateManager`` with
   the GPU grouper and deletion filter, max_parallel_upgrades 1,
   max_unavailable 1, wait for ``job=serve``, drain forced, pod
   deletion; fleet health, the stuck detectors, the usage meter and the
   SLO stack's scrape and evaluation; host wall timed), after the
   replicas' histograms are scraped into the operator's tsdb, then the
   DaemonSet controller's step, the router's tick and one step of every
   replica, with a new 64-token prompt every 4 iterations up to 16
   requests. A drained replica's serve pod completes (the wait-for-jobs
   gate); a node back at ``upgrade-done`` and uncordoned gets a new
   serve pod and replica. All three nodes must reach ``upgrade-done``
   with their driver pods at v2, each node's journey annotation in the
   state order the JAX package's state machine gives on this schedule,
   at most one node in progress and at least 2 admitting replicas at
   every iteration, every default objective evaluated at every tick with
   no tick phase failing, health acting on nothing, the serving TTFT
   objective reading the replicas' first tokens, ``check_invariants``
   empty at every tick, no admission on a cordoned node, every request
   delivered once and gapless, >= 2 live migrations and no fallback,
   tokens by 3b's near-tie rule, and A-K4 launches 32 x the decode
   steps of all the replicas. Prints the rollout wall seconds, seconds
   per node and per state from the journeys, ms per operator tick, per
   router tick and per decode step per replica, each migration's export
   and adopt ms and KV bytes, and the TTFT objective's reading.
   3g. Fleet health on the same rig, on the host's clock: 6 prompts in
   flight, then gpu-b's driver pod crash-loops (not ready, 12
   restarts). The operator must quarantine gpu-b (label, taint, cordon),
   the router drain its replica for ``quarantined`` with >= 1 live
   migration and no fallback, no admission land on gpu-b, the repair be
   injected once for gpu-b's group and ride the upgrade pipeline, the
   driver pod come back with a new uid and ready, the quarantine lift
   with one repair attempt on record and no taint, the ``FleetHealth``
   events say "Quarantined", "slice-atomic repair" and "Quarantine
   lifted", and the respawned replica take a request; every request
   delivered once, gapless, tokens by the near-tie rule, and A-K4
   launches 32 x the decode steps. Prints when each step happened and
   ms per operator tick.
   3h. The operator binary's leader handover on the same rig: its
   ``FakeCluster`` behind the port's ``FakeAPIServer``; the in-process
   operator is no longer called. Two ``operator.main`` instances in
   threads (``python -m k8s_operator_libs_tpu_torch.operator`` with
   ``--watch --leader-elect --profile --ensure-crds crds --interval
   0.1``, identities op-a and op-b, one component: the driver DaemonSet
   under 3f's policy) reach it over HTTP through the informer cache and
   the resilient client. op-a leads, op-b stands by (``/healthz`` 200,
   ``tpu_operator_leader 0``); the driver is bumped to v3 with new
   prompts in flight; each iteration is 3f's serving turn without the
   in-process reconcile. Once one node is upgrade-done at v3 and a
   second has left upgrade-done past admission (in progress), op-a's
   stop event is set: it finishes its tick and releases the lease, op-b
   takes over mid-journey and finishes. All
   three nodes must reach upgrade-done with drivers at v3, each node's
   new journey in 3f's order, at most one node in progress and at least
   2 admitting replicas at every iteration, the lease's holder changing
   once, op-a's and op-b's reconciles never overlapping, the new
   leader's ``/metrics`` at ``tpu_operator_leader 1``, its ``/profile``
   reporting apiserver calls by verb and kind, the breaker never open,
   the CRDs bootstrapped, no error logged, every request once and
   gapless with >= 2 live migrations and no fallback, tokens by the
   near-tie rule and A-K4 launches 32 x the decode steps. Prints the
   handover seconds (op-a's stop to op-b's first reconcile), the
   rollout wall, seconds per node and per state, each instance's ms per
   tick and apiserver calls per tick, and ms per decode step per
   replica. The fp32 twin of 3f, 3g and 3h: three replicas at
   Llama-3-8B width, 2 layers, the same schedules, every request's
   tokens equal to the contiguous ``generate``'s.
4. Token parity in fp32 at Llama-3-8B width, 2 layers: the batcher's
   greedy tokens (through A-K4) against the contiguous ``generate``
   (plain), and ``paged_generate(kv_int8=True)`` through A-K5 against the
   same call with the plain version. 4c: the speculative batcher (its
   draft steps through A-K4) against the plain batcher, and
   ``paged_quantized_generate(kv_int8=True)`` (int8 weights and KV)
   through A-K5 against the same call with the plain version.
5. Training at full width: Llama-3-8B width cut to 8 layers (the 32 need
   ~64 GB for parameters, gradients and two moments alone), bf16, remat,
   B 2 x T 2048, seeded weights; one warm-up and 5 timed steps on one
   batch. A-K1, A-K2 and A-K3 must each launch 8 times per step (remat
   does not re-run the forward kernel), every launch on the tensor cores,
   and the loss must fall. Prints ms per step, tokens/s, the model-FLOP
   share of the bf16 peak, peak memory and a ``torch.profiler`` breakdown
   of one step.
6. Training parity: one step's loss and gradients through the kernels
   against the plain attention (fp32, Llama-3-8B width, 2 layers); then
   the CLI (``train.main``, ``small``, seq 512, batch 4) checkpointed at
   step 2, drained at step 3 and resumed to step 6 must reach the step-6
   loss of an uninterrupted run; its goodput ledger (on by default) must
   hold every badput phase, whose seconds it prints.
   6b. The trainer under the operator: a ``CheckpointingTrainer`` at
   Llama-3-8B width cut to 1 layer (bf16, remat, B 2 x T 2048, batches
   from a numpy seed, the goodput ledger on) on node gpu-t of a port
   ``FakeCluster`` of two nodes (GPU Feature Discovery's labels for this
   card, one GPU each, no clique) with the NVIDIA driver DaemonSet at v1,
   a ``job=train`` pod on gpu-t and an in-process ``GPUOperator`` (3f's
   policy, waiting for ``job=train``; health, the default objectives and
   usage). 2 steps; the DaemonSet goes to v2; one operator tick after each
   step until the trainer, whose drain signal is "gpu-t is cordoned",
   drain-saves at step s; one forward of step s+1's batch on the saved
   state keeps its loss; the pod completes; ticks until gpu-t is back; a
   fresh trainer resumes and takes 2 steps; ticks until both nodes are
   upgrade-done at v2. The chaos harness's budget, journey,
   alert-transition, event-dedup and attribution invariants hold at every
   tick. Checked: the resume at s+1, the ledger's steps 1 to s+2 once
   each, step s+1's loss bit-equal to the kept one, A-K1-3 once per step
   each on ``wgmma``, one attribution window on gpu-t's journey whose
   phases (drain save, restore, the three journey segments among them)
   sum to it within 1e-6 s, the status CLI's ``--goodput`` split equal to
   it, its table view exiting 3 in flight and 0 at the end. Prints ms per
   step before and after the resume, the drain save's fetch and write,
   the restore and the first step after it, the window's split and
   ``downtime_summary``, each beside the card's name and power limit.
7. MoE serving: ``MoEConfig.llama3_8b`` (Llama-3-8B attention, eight
   SwiGLU experts of d_ff 14336, top-2) cut to 16 layers, bf16, weights
   seeded on the card, on the continuous batcher with
   ``forward=moe_paged_forward`` (phase 3's slots, capacity, block, chunk
   and prompts). A-K4 must launch 16 x the decode steps; one decode
   step's logits through the kernel and the plain version agree within
   phase 3's bound; a decode chunk makes no copy of a tensor the size of
   an expert's weight. Prints ms per decode step against the weight
   stream's floor, TTFT and a profile of one chunk. 7b: fp32 at 2
   layers, the MoE batcher's greedy tokens (A-K4) equal ``moe_generate``'s
   (contiguous cache, plain attention).
8. MoE training: the same width at 2 layers, bf16, remat, B 2 x T 2048,
   through ``make_train_step_from_loss(moe_reference_loss)``: A-K1, A-K2
   and A-K3 launch twice per step each, all on the tensor cores; the loss
   falls; the aux term is positive. Prints ms per step, tokens/s, the
   model-FLOP share of dense dispatch (all eight experts), peak memory and
   a profile of one step. 8b: one step's loss and every gradient through
   the kernels against plain attention (fp32, 2 layers, B 2 x T 512); then
   ``train.main --model moe_tiny`` (bf16, Dh 32 on the tensor cores) with
   the goodput ledger, ``--metrics-textfile`` and ``--profile``,
   checkpointed at 2, drained at 3 and resumed to 6, must reach the
   step-6 loss of an uninterrupted run; prints the ledger's checkpoint,
   restore and drain seconds and the trace sizes.

9. Multi-process training on the one card (``parallel/launch.py``
   starts the ranks; several ranks share the card over gloo, whose
   collectives go through host memory, since NCCL refuses two ranks on
   one device: every time here is labelled "gloo host-staged, one card,
   not an interconnect figure"). 9a: sequence parallelism at Llama-3-8B
   width, 2 layers, bf16, remat, B 1 x T 8192 over 2 ranks, ring then
   Ulysses: one step's loss and every gradient against the one-rank step
   on the same weights and tokens (run first in rank 0, then freed to the
   host), the flash launches per rank (ring r + 1 per layer on rank r,
   Ulysses 1, all ``wgmma``), ms per step, peak memory and the bytes of
   each collective kind per step (with what they would take at NVLink's
   rate, a reckoning); then fp32 at T 1024 against the plain attention.
   9b: FSDP over 2 ranks, 1 layer, B 2 x T 2048: loss and gradients
   against the one-rank step, each rank's parameters and moments at most
   1/2 of the one-rank state + 1%, launches, ms per step, peak memory.
   9c: the same SP and FSDP steps through an NCCL group of one rank.
   9d: ``train.main --parallel fsdp`` on ``small`` at 2 ranks,
   checkpointed at 2, drained at 3 (signalled on rank 0), resumed at 1
   rank to step 6, against an uninterrupted run. Ranks start as few
   times as the work allows: two gloo ranks run 9a, 9b, 9d's 2-rank run,
   then phase 10's 2-rank work (10a, 10c, 10e's ep runs); one NCCL rank
   runs 9c, then 10d's paths, then 11b's re-formation; phases 10 and 11
   check their results. Each timed step's warm-up is the parity pass of
   the same loss just before it.
10. Pipeline, 3-D and expert parallelism at Llama-3-8B width on the one
   card over gloo, as phase 9, each step held against its one-rank step
   (run first in rank 0, then freed to the host) by phase 9's bounds,
   every gradient leaf gathered to rank 0. 10a: GPipe over 2 ranks, 2
   layers, M 4, B 4 x T 2048: (L/S)(S + M - 1) = 5 launches of each
   flash kernel per rank (bubble ticks compute on zeros, as the
   reference's do), ms per step, bytes per collective kind, peak. 10b:
   stage 2 x tensor 2 on 4 ranks, 2 layers, M 2, B 2 x T 2048: 3
   launches of each per rank at 16/4 heads, each rank at most 1/4 of the
   layer stacks and 1/2 of embed/lm_head + 1%, and the step without the
   replicate before the column-parallel matmuls (a planted fault) must
   read over the gradient bound. 10c: the MoE (8 experts, top-2, 1
   layer) over 2 ranks: dense dispatch and lossless a2a (aux off)
   against the one-rank steps, every gradient in fp32 (B 2 x T 512) and
   the loss in bf16 (B 2 x T 2048); the (token, expert) pairs dropped at
   capacity factor 2.0 and two a2a optimizer steps there, the loss
   falling. 10d: each path through an NCCL group of one rank against the
   same path with no process group, every collective it uses called.
   10e: ``train.main``: ``small --parallel 3d`` at 4 ranks drained at 3
   and resumed at 1 rank; ``moe_tiny --parallel 3d`` at 4 ranks for 3
   steps, its loss falling; ``moe_tiny --parallel ep --moe-dispatch
   a2a`` at 2 ranks drained and resumed, against uninterrupted runs. Its
   4-rank runs go last in 10b's ranks, its 2-rank ones in 10a/10c's
   (phase 9's).

11. The elastic trainer (``train/harness.py``, ``elastic=True``) at
   Llama-3-8B width, 1 layer, bf16, remat, B 4 x T 2048, on the one
   card over gloo as phase 9. 11a: FSDP at 4 ranks for steps 1-2; a
   reclaim whose survivors exclude rank 0 (the checkpoint writer and the
   ledger move to the new rank 0); steps 3-4 at 2 ranks; a grow back to
   4, its 2 joiners started by ``launch.Job`` when the notice is given;
   steps 5-6. Checked: steps 1-6 once each, the same loss on every rank
   of a step, 2 resizes and 4 members on every survivor, the reclaimed
   ranks ended cleanly, one ledger run with a 4 -> 2 ``degraded``
   record, two drain saves and two restores and no unavailability
   window, each rank at most 1/n of the state + 1% after each restore,
   1 launch of A-K1-3 per rank and step on ``wgmma``. Then, in the
   grown group, a cold start from the grow's checkpoint (step 4) takes
   steps 5-6: its losses and every parameter must be within the
   reference's bounds (rel 1e-5, atol 1e-6) of the elastic run's, and a
   planted resize that re-initializes both moments must not be. Prints ms
   per step at each membership, each resize's drain-save and restore
   seconds, the time from each notice to the next step, peak memory and
   launches per rank. 11b: a reclaim that keeps the one member of an
   NCCL group re-forms it (the communicator destroyed and re-created);
   the steps must equal those of a run without it. 11c: the native token
   loader (``native=True``, built with ``g++``) against numpy for every
   step of 11a, whole and sharded; a ``CheckpointUploader`` mirrors 11a's
   saves while it trains; after it, a one-rank restore from the mirror
   equals one from the local directory.

12. One rank per GPU under the operator, and tensor-parallel decoding,
   on the one card over gloo as phase 9. 12a: the port's GPU scheduler
   (``gpu/scheduler.py``) places a workload on two in-script nodes that
   GPU Feature Discovery's labels call this card's product with 2 GPUs
   each: one pod per node requesting both, a headless Service, an env
   with ``LOCAL_WORLD_SIZE`` 2. The four processes started from the
   pods' env (``LOCAL_RANK`` 0 and 1 each, the coordinator at localhost)
   join one gloo group through ``cluster_env``: ranks 0-3, world 4, each
   named ``<pod>.<service>/cuda:<local rank>``. They take FSDP at
   Llama-3-8B width, 1 layer, bf16, remat, B 4 x T 2048: one step's
   loss and every gradient against the one-rank step within phase 9's
   bounds, then 1 optimizer step (2 before phase 3g), the same loss on
   every rank, 1 launch of A-K1-3 per rank and step on ``wgmma``; ms per
   step per rank. 12b: ``make_tp_generate`` over 2 tensor ranks at
   Llama-3-8B width, 8 layers (32 before phase 3f, 16 before 3g), bf16
   (each rank half of every block's heads and FFN columns, the
   embedding and lm_head whole), phase 3's prompts, 32
   greedy tokens each: the tokens equal the one-rank ``generate``'s (run
   first, then freed) up to the first position whose top-2 logit gap is
   under ``SPEC_GAP_EPS`` (the sums' order may flip a near-tie in bf16);
   its fp32 twin at 2 layers token for token. Prints ms per decode step
   per rank and one rank's alone (two points: 32 tokens less 2), the
   bytes each decode step sums per rank, weights held and peak memory.

After every phase (and after 3, 3b and 3c inside phase 3), and at the
end of every rank that runs a token loader or the training CLI, no
thread of a serving runtime (``serve-stepper``, ``serve-drain``), a
checkpoint uploader (``ckpt-uploader``) or a token loader
(``tokenloader-prefetch``) may still be alive: the port names them
through ``utils/threads.py``, and ``threads.live_threads`` finds a leaked
one by name, which the run then fails naming the phase.

Phases run in the order 1, 2, 3, 4, 7, 5, 6, 8, 9, 10, 11, 12, each with
its wall seconds. At the end it prints ``{"kernels": [...]}``, then the serving and
training numbers and the card's name, each on a line of its own; the last
line is ``{"ok": true, "device": {...}}``.
"""

import json
import logging
import math
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense tensor-core peak

BS, CAPACITY, SLOTS, CHUNK, MAX_NEW = 16, 1024, 4, 4, 32
PROMPT_LENS = (24, 100, 300, 700)
# phase 3b: speculation depth; a bf16 verify at T = k + 1 rounds other than
# a T = 1 decode step (phase 3 read 0.0781 between two roundings of one
# step's logits; bf16 logits near 5 lie on a 2^-5 grid, so 0.25 is 8 of
# its steps), so 3b's tokens must equal phase 3's up to the first position
# whose plain top-2 logit gap is under SPEC_GAP_EPS, and where they first
# differ that gap must be under SPEC_GAP_EPS too
SPEC_K, SPEC_GAP_EPS = 4, 0.25
# phase 3c: prompt length, tokens, and the tokens A decodes before /drain
MIGRATE_PROMPT, MIGRATE_NEW, MIGRATE_AFTER = 200, 24, 6
KERNEL_LENGTHS = (0, 17, 300, 1023)
FULL_BATCH, FULL_CAPACITY = 32, 4096     # phase 2's full-batch shape
SOURCES = ("paged_decode", "flash_attention", "flash_attention_tc")
# kernels that must spill nothing and run on the tensor cores (phase 1)
TENSOR_CORE_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                       "flash_bwd_dkv_tc_kernel")
# kernels that must spill nothing (phase 1)
NO_SPILL_KERNELS = TENSOR_CORE_KERNELS + ("paged_decode_split_kernel",
                                          "paged_decode_merge_kernel")
# paged decode: one bf16 rounding of the output (2^-8 relative) plus fp32
# summation order, scaled by max(1, |plain|)
PAGED_TOL = 1e-2
PORT = "k8s_operator_libs_tpu_torch"
REFERENCE = PORT.removesuffix("_torch")      # the JAX package it ports
CSRC = PORT + "/csrc/{}.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# the port's workload threads, named through its utils/threads.py: none
# may outlive the phase (or rank) that started it
WORKLOAD_THREADS = ("serve-stepper", "serve-drain", "ckpt-uploader",
                    "tokenloader-prefetch")
# the thread checks made in this process and the seconds they took
THREAD_CHECKS = {"n": 0, "s": 0.0}


def check_threads_stopped(where):
    """Fail, naming ``where`` and the thread, if a serving runtime's
    stepper or drain, a checkpoint uploader or a token loader's prefetch
    thread is still alive once ``where`` stopped its components."""
    from k8s_operator_libs_tpu_torch.utils import threads
    t0 = time.monotonic()
    left = [h.name for prefix in WORKLOAD_THREADS
            for h in threads.live_threads(prefix)]
    THREAD_CHECKS["n"] += 1
    THREAD_CHECKS["s"] += time.monotonic() - t0
    check(not left, f"{where}: thread(s) still alive after it stopped its "
                    f"components: {', '.join(left)}")


def rank_name():
    """``rank <r>`` of the process group this process is in, else its
    pid."""
    import os

    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return f"rank {dist.get_rank()}"
    return f"pid {os.getpid()}"


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
    """Build every CUDA source at once: one nvcc per source, started
    together. Fails if a tensor-core or paged-decode kernel spills or, where
    cuobjdump is installed, a tensor-core kernel holds no HGMMA (wgmma)
    instruction."""
    import shutil

    from k8s_operator_libs_tpu_torch.ops import build
    built = build.build_all(SOURCES)
    for name, (path, secs, compiler_log) in built.items():
        log(f"phase 1: built {name} in {secs:.1f} s -> {path.name}")
        kernel = spills = ""
        for line in compiler_log.splitlines():
            if "Compiling entry function" in line:
                # the template instance, without the anonymous namespace
                kernel = re.sub(r"^_ZN.*?_cu_[0-9a-f]{8}\d+", "",
                                line.split("'")[1])[:64]
            elif "spill" in line:
                spills = line.strip()
                if any(k in kernel for k in NO_SPILL_KERNELS):
                    check(" 0 bytes spill stores, 0 bytes spill loads" in
                          line, f"{kernel} spills: {spills}")
            elif "registers" in line:
                log(f"  ptxas: {kernel}: {line.split(':', 1)[1].strip()}; "
                    f"{spills}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).is_file():
        log("phase 1: no cuobjdump: HGMMA not checked")
        return
    sass = subprocess.run([cuobjdump, "-sass",
                           str(built["flash_attention_tc"][0])],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    hgmma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split(":", 1)[1].strip()
            hgmma[fn] = 0
        elif fn and "HGMMA" in line:
            hgmma[fn] += 1
    for k in TENSOR_CORE_KERNELS:
        counts = [n for f, n in hgmma.items() if k in f]
        check(counts and min(counts) > 0,
              f"{k}: an instance without HGMMA in its SASS ({counts})")
        log(f"phase 1: {k}: {len(counts)} instances, HGMMA instructions "
            f"per instance {min(counts)}-{max(counts)} (cuobjdump -sass)")


def kernel_case(torch, int8, lengths, capacity, seed=0):
    """The Llama-3-8B decode-attention inputs of one batcher step over
    sequences of ``capacity`` at ``lengths``."""
    import numpy as np
    H, KV, Dh, MB = 32, 8, 128, capacity // BS
    B = len(lengths)
    NB = B * MB + 1
    gen = np.random.default_rng(seed)
    table = gen.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    live = {int(table[b, m]) for b in range(B)
            for m in range(lengths[b] // BS + 1)}
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
    lens = torch.as_tensor(np.asarray(lengths, np.int32), device="cuda")
    return (q, k, v, tbl, lens, ks, vs), live


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


def paged_reading(got, ref):
    """The largest share of its tolerance (|kernel - plain| <= PAGED_TOL x
    max(1, |plain|)) that an element of ``got`` uses: at most 1 passes."""
    err = (got.float() - ref.float()).abs()
    return float((err / (PAGED_TOL * ref.float().abs().clamp_min(1.0)))
                 .max())


def paged_faults(attn, args, split_blocks):
    """What the check would read had the kernel, on the longest sequence,
    skipped its middle live block, dropped its middle live split, or
    merged its splits without the e^(m_i - M) rescale: {fault: change of
    the plain output}, from the plain split partials of this case's own
    data."""
    q, k, v, table, lengths, ks, vs = args
    B, _, H, Dh = q.shape
    MB = table.shape[1]
    visible = attn.visible_keys(lengths, MB, BS)
    parts = attn.split_partials(q, k, v, table, visible, split_blocks, ks,
                                vs)
    sound = attn.merge_partials(*parts)
    b = int(lengths.argmax())
    n_live = min(int(lengths[b]) // BS + 1, MB)
    mid = n_live // 2
    skip = visible.clone()
    skip[b, mid * BS:(mid + 1) * BS] = False
    m, l, acc = (x.clone() for x in parts)
    i = (n_live - 1) // split_blocks // 2
    m[b, :, :, i] = float("-inf")
    l[b, :, :, i] = 0.0
    acc[b, :, :, i] = 0.0
    m0, l0, acc0 = parts
    faults = {
        "skipped block": attn.merge_partials(*attn.split_partials(
            q, k, v, table, skip, split_blocks, ks, vs)),
        "dropped split": attn.merge_partials(m, l, acc),
        "merge without rescale": (acc0.sum(-2)
                                  / l0.sum(-1).clamp_min(1e-30)[..., None]),
    }
    return {name: (f - sound).reshape(B, 1, H, Dh)
            for name, f in faults.items()}


def phase_kernels(torch):
    import numpy as np
    import torch.nn.functional as F

    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    full = tuple(int(x) for x in np.random.default_rng(0).integers(
        0, FULL_CAPACITY, FULL_BATCH))
    results = {}
    for shape, lengths, capacity in (("serving", KERNEL_LENGTHS, CAPACITY),
                                     ("full_batch", full, FULL_CAPACITY)):
        MB = capacity // BS
        split_blocks, n_split = attn.split_plan(len(lengths), 8, MB, BS, sms)
        live_ctas = 8 * sum(-(-min(n // BS + 1, MB) // split_blocks)
                            for n in lengths)
        log(f"phase 2: paged decode, {shape} shape: {len(lengths)} sequences "
            f"of capacity {capacity}, mean length "
            f"{sum(lengths) / len(lengths):.1f}; split {split_blocks} blocks "
            f"x {n_split} on {sms} SMs: {live_ctas} live CTAs")
        for name, int8 in (("paged_decode", False),
                           ("paged_decode_int8", True)):
            args, live = kernel_case(torch, int8, lengths, capacity)
            q, k, v, table, lens, ks, vs = args
            got = attn.paged_decode_cuda(*args)
            torch.cuda.synchronize()
            ref = attn.paged_decode_plain(*args)
            check(torch.isfinite(got).all().item(),
                  f"{name}: non-finite output (a dead block leaked)")
            max_err = float((got.float() - ref.float()).abs().max())
            reading = paged_reading(got, ref)
            check(reading <= 1.0, f"{name} ({shape}) disagrees with its "
                                  f"plain version: reads {reading:.3f}")
            check(torch.equal(attn.paged_decode_cuda(*args), got),
                  f"{name} ({shape}): other bits on a second call")
            faults = ""
            if shape == "serving":
                for fault, change in paged_faults(attn, args,
                                                  split_blocks).items():
                    r = paged_reading(got.float() + change, ref)
                    check(r > 1.0, f"{name}: the tolerance would pass a "
                                   f"{fault} (reads {r:.3f})")
                    faults += f", {fault} {r:.3g}"
            log(f"phase 2: {name} ({shape}) max_abs_err {max_err:.3e}, "
                f"{reading:.3f} of the tolerance ({PAGED_TOL} x max(1, "
                f"|plain|)){faults}; same bits on a second call; ok")

            B = q.shape[0]
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
            kq = view_k.permute(0, 2, 1, 3).contiguous()    # [B, KV, cap, D]
            vq = view_v.permute(0, 2, 1, 3).contiguous()
            del view_k, view_v
            qq = q.permute(0, 2, 1, 3).contiguous()         # [B, H, 1, D]
            mask = (torch.arange(cap, device="cuda")[None, :]
                    <= lens.long()[:, None])[:, None, None, :]

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
            plain_ms = time_cold_ms(torch,
                                    lambda: attn.paged_decode_plain(*args),
                                    iters=10)
            library_ms = time_cold_ms(torch, library)
            b_ms, bound_by = bound_ms(q, k, len(live), lengths, int8)
            log(f"phase 2: {name} ({shape}) ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} library_ms {library_ms:.4f} (sdpa max diff "
                f"{lib_err:.2e}) bound_ms {b_ms:.5f} ({bound_by}) -> "
                f"{b_ms / ms:.1%} of bound, {ms / library_ms:.2f}x sdpa")
            key = name if shape == "serving" else f"{name}_{shape}"
            results[key] = {"max_abs_err": max_err, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": b_ms,
                            "bound_by": bound_by, "library_ms": library_ms}
            del args, got, ref, lib, kq, vq, q, k, v, ks, vs
    return results


# ------------------------------------------------------------ flash kernels

# phase 9's shapes: its ranks share the one card (see phase_multiprocess).
# 9a and 10a-10b are cut from Llama-3-8B's 32 layers to 2 (4 before phase
# 12 joined; 10a-10b's two stages need two), and 9b, 10c, 11 and 12a to 1
# (2 before phase 3d joined): a step's gloo-staged bytes, and with them
# its time, grow with the layers, and what these phases check (the
# collectives, their transposes, each rank's shards) is the same at any
# depth
MP_RANKS = 2
SP_LAYERS, SP_B, SP_T = 2, 1, 8192          # 9a, bf16
SP32_B, SP32_T = 2, 1024                    # 9a, fp32 against plain
FSDP_LAYERS, FSDP_B, FSDP_T = 1, 2, 2048    # 9b
# phase 10's (see phase_pp_tp_ep): pipeline (stages, microbatches), 3-D
# (stage 2 x tensor 2, microbatches), experts (MoE 8 experts, top-2)
PP_LAYERS, PP_S, PP_M, PP_B, PP_T = 2, 2, 4, 4, 2048         # 10a
TD_LAYERS, TD_S, TD_TP, TD_M, TD_B, TD_T = 2, 2, 2, 2, 2, 2048  # 10b
EP_LAYERS, EP_RANKS, EP_B, EP_T, EP_CF = 1, 2, 2, 2048, 2.0   # 10c
# 10c holds every gradient leaf in fp32: in bf16 a rank's experts' partial
# outputs are rounded before their psum (as the reference's are), and a
# one-ulp change in a layer's output flips near-tied top-k choices in the
# next, which moves every gradient (on the CPU, tiny MoE, 0.19 of a leaf's
# max against 1e-7 in fp32)
EP32_T = 512

# (label, B, T, H, KV, Dh, dtype, causal, dlse, row). ``dlse`` draws a
# random cotangent of lse, as the ring's merge gives each chunk; ``row``
# is the suffix of the kernels-line rows that carry the case's
# measurements ("": the training main path's, phase 5), None for a case
# that is only checked. Then phase 9's calls at Llama-3-8B width: the
# ring's earlier key chunk (full) and its own chunk (diagonal), B 1 x
# T/n; Ulysses' whole T at H/n heads and KV/n K/V heads; an FSDP rank's
# B/n rows (also a pipeline microbatch's and an a2a expert rank's, phase
# 10). Last, phase 10's tensor-parallel rank: a microbatch at H/2 and
# KV/2 heads.
FLASH_CASES = (
    ("llama3_8b", 2, 2048, 32, 8, 128, "bfloat16", True, False, ""),
    ("T1000_full", 1, 1000, 32, 8, 128, "bfloat16", False, False, None),
    ("small_G3", 2, 512, 12, 4, 64, "bfloat16", True, False, None),
    ("fp32", 1, 512, 32, 8, 128, "float32", True, False, None),
    ("ring_full", SP_B, SP_T // MP_RANKS, 32, 8, 128, "bfloat16", False,
     True, "_sp_ring_full"),
    ("ring_diagonal", SP_B, SP_T // MP_RANKS, 32, 8, 128, "bfloat16", True,
     True, "_sp_ring_diagonal"),
    ("ulysses", SP_B, SP_T, 32 // MP_RANKS, 8 // MP_RANKS, 128, "bfloat16",
     True, False, "_sp_ulysses"),
    ("fsdp_rank", FSDP_B // MP_RANKS, FSDP_T, 32, 8, 128, "bfloat16", True,
     False, "_fsdp"),
    ("tp_rank", TD_B // TD_M, TD_T, 32 // TD_TP, 8 // TD_TP, 128,
     "bfloat16", True, False, "_tp"),
)
# Each element is held to |kernel - plain| <= atol * row + rtol * |plain|,
# row being the RMS of the plain tensor's row (the Dh values of one head
# at one position; floored at 1e-2 of the whole tensor's RMS for rows
# that vanish, as dq's first causal row does). lse is held in nats.
# fp32: summation order and exp2f's 2 ulp. bf16: the kernels round
# q * scale * log2e to bf16 (the constant too, 2^-9 relative), P before
# P V and dS before dS K, as the TPU kernels do and the plain version does
# not. The backward is held on the forward's own out and lse.
# (rtol, atol) of out, dq, dk, dv; then lse's tolerance in nats
FLASH_TOL = {"float32": (1e-4, 1e-4, 1e-4),
             "bfloat16": (4e-2, 4e-2, 2.5e-2)}
FLASH_NAMES = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
TILE = 64                       # the kernels' K/V tile


def flash_inputs(torch, B, T, H, KV, Dh, dtype, dlse, seed=0):
    """q, k, v, dO of ``dtype``, and an fp32 cotangent of lse [B * KV,
    H / KV, T] or None."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(s, generator=g, device="cuda").to(dt)
                   for s in ((B, T, H, Dh), (B, T, KV, Dh), (B, T, KV, Dh),
                             (B, T, H, Dh)))
    cot = (torch.randn((B * KV, H // KV, T), generator=g, device="cuda")
           if dlse else None)
    return q, k, v, do, cot


def flash_bounds(B, T, H, KV, Dh, causal, elem):
    """Least time of each kernel: the larger of its flops over the bf16
    tensor-core peak (forward 4, dq 6, dkv 8 x B*H*Dh*sum_visible) and the
    bytes it must move (each input read once, each output written once)
    over the memory rate."""
    visible = T * (T + 1) // 2 if causal else T * T
    per = B * H * Dh * visible
    q_bytes = B * T * H * Dh * elem
    kv_bytes = B * T * KV * Dh * elem
    row_bytes = B * H * T * 4                   # one fp32 lse or delta row
    work = {"flash_forward": (4 * per, q_bytes + 2 * kv_bytes + q_bytes
                              + row_bytes),
            "flash_bwd_dq": (6 * per, 3 * q_bytes + 2 * kv_bytes
                             + 2 * row_bytes),
            "flash_bwd_dkv": (8 * per, 2 * q_bytes + 4 * kv_bytes
                              + 2 * row_bytes)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def flash_reading(got, want, dtype, name):
    """The largest share of its tolerance that an element of ``got`` uses
    (see FLASH_TOL): at most 1 passes."""
    rtol, atol, lse_tol = FLASH_TOL[dtype]
    err = (got.float() - want.float()).abs()
    if name == "lse":
        return float(err.max()) / lse_tol
    want = want.float()
    row = want.square().mean(-1, keepdim=True).sqrt()
    row = row.clamp_min(1e-2 * float(want.square().mean().sqrt()))
    return float((err / (atol * row + rtol * want.abs())).max())


def planted_faults(q, k, v, do, out, lse, causal, dlse=None):
    """What each check would read had a kernel dropped one tile, on this
    case's own data: {name: (index, change of the plain value)}. In out,
    lse and dq the last query tile (batch 0, the G heads of K/V head 0)
    skips one K/V tile of its range: the one below the diagonal when
    causal, the ragged tail otherwise. In dk and dv that K/V tile skips
    the first 32 query rows of the last tile (one A-K3 chunk). ``dlse``
    enters dS as the backward's does: P (dP - (delta - dlse))."""
    _, T, H, Dh = q.shape
    G = H // k.shape[2]
    scale = 1.0 / math.sqrt(Dh)
    r0 = TILE * ((T - 1) // TILE)
    j0 = r0 - TILE if causal else r0
    rows, keys = slice(r0, T), slice(j0, min(j0 + TILE, T))
    qr, dor, outr = (x[0, rows, :G].float().transpose(0, 1)
                     for x in (q, do, out))                 # [G, R, Dh]
    kj, vj = k[0, keys, 0].float(), v[0, keys, 0].float()   # [J, Dh]
    p = (qr @ kj.T * scale - lse[0, :, rows, None]).exp()    # [G, R, J]
    mass = p.sum(-1, keepdim=True)
    delta = (dor * outr).sum(-1, keepdim=True)
    if dlse is not None:
        delta = delta - dlse[0, :, rows, None]
    ds = p * (dor @ vj.T - delta)
    chunk = slice(0, 32)
    return {
        "out": ((0, rows, slice(0, G)),
                ((outr - p @ vj) / (1 - mass) - outr).transpose(0, 1)),
        "lse": ((0, slice(None), rows), (-mass[..., 0]).log1p()),
        "dq": ((0, rows, slice(0, G)), -(ds @ kj * scale).transpose(0, 1)),
        "dk": ((0, keys, 0), -(ds[:, chunk].transpose(1, 2)
                               @ qr[:, chunk]).sum(0) * scale),
        "dv": ((0, keys, 0), -(p[:, chunk].transpose(1, 2)
                               @ dor[:, chunk]).sum(0)),
    }


def lse_sees_a_tile(T, causal, dtype):
    """Whether lse's tolerance can see one skipped tile of the planted
    fault: its share of the last row's keys (a share m moves lse by
    -log(1 - m) ~ m nats) must reach the tolerance. At T 4096 a tile is
    1/64 of the row, 0.016 nats, under bf16's 0.025; out, dq, dk and dv
    still see it."""
    ragged = T % TILE if not causal and T % TILE else TILE
    return ragged / T >= FLASH_TOL[dtype][2]


def check_flash_case(torch, fa, case):
    """One FLASH_CASES entry: the forward, then ``flash_backward`` with the
    case's lse cotangent, against their plain versions, each element
    within its tolerance, and each planted fault outside it. Returns the
    tensors the timing needs and the max abs errors."""
    label, B, T, H, KV, Dh, dtype, causal, with_dlse, _ = case
    q, k, v, do, dlse = flash_inputs(torch, B, T, H, KV, Dh, dtype,
                                     with_dlse)
    fa.reset_launch_counts()
    out, lse = fa.flash_forward_cuda(q, k, v, causal)
    route = "fma" if dtype == "float32" else "wgmma"
    check(fa.ROUTE_LAUNCHES == {"wgmma": 0, "fma": 0, route: 1},
          f"{label}: the {dtype} forward took routes {fa.ROUTE_LAUNCHES}")
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, causal, dlse)
    check(fa.ROUTE_LAUNCHES == {"wgmma": 0, "fma": 0, route: 3},
          f"{label}: the {dtype} backward took routes {fa.ROUTE_LAUNCHES}")
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.reference_attention_with_lse(q, k, v, causal)
    ref = fa.flash_backward_plain(q, k, v, out, lse, do, causal, dlse)
    got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    want = {"out": ref_out, "lse": ref_lse, "dq": ref[0], "dk": ref[1],
            "dv": ref[2]}
    del ref
    faults = planted_faults(q, k, v, do, ref_out, ref_lse, causal, dlse)
    lse_sees = lse_sees_a_tile(T, causal, dtype)
    errs, readings = {}, {}
    for name in got:
        check(bool(torch.isfinite(got[name]).all()),
              f"{label}: non-finite {name}")
        errs[name] = float((got[name].float() - want[name].float())
                           .abs().max())
        sound = flash_reading(got[name], want[name], dtype, name)
        idx, change = faults[name]
        bad = got[name].float().clone()
        bad[idx] += change
        fault = flash_reading(bad, want[name], dtype, name)
        del bad
        readings[name] = (sound, fault)
        check(sound <= 1.0, f"{label}: {name} reads {sound:.3f} of its "
                            f"tolerance (max abs err {errs[name]:.3e})")
        check(fault > 1.0 or (name == "lse" and not lse_sees),
              f"{label}: the tolerance of {name} would pass a skipped tile "
              f"(reads {fault:.3f})")
    rtol, atol, lse_tol = FLASH_TOL[dtype]
    log(f"phase 2: flash {label} (B {B} T {T} H {H} KV {KV} Dh {Dh} "
        f"{dtype} {'causal' if causal else 'full'}"
        f"{', lse cotangent' if with_dlse else ''}) max abs err "
        + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f"; share of the tolerance (rtol {rtol}, atol {atol} x row "
        f"RMS; lse {lse_tol} nats), kernel / planted fault: "
        + " ".join(f"{n} {a:.3f}/{b:.3g}" for n, (a, b)
                   in readings.items())
        + ("" if lse_sees else f" (lse: one tile is {TILE}/{T} of a row, "
           f"under the tolerance; out, dq, dk, dv see it)") + " ok")
    del want, got
    return (q, k, v, do, dlse, out, lse, ref_out), errs


def phase_flash(torch):
    import torch.nn.functional as F

    from k8s_operator_libs_tpu_torch.ops import attention as fa
    results = {}
    for case in FLASH_CASES:
        label, B, T, H, KV, Dh, dtype, causal, with_dlse, row = case
        (q, k, v, do, dlse, out, lse, ref_out), errs = check_flash_case(
            torch, fa, case)
        if row is None:
            continue
        delta = fa.attention_delta(out, do, KV)
        if dlse is not None:
            delta = delta - dlse.reshape(delta.shape)

        if row == "":
            # the kernels are deterministic (the resume check relies on it)
            dq, (dk, dv) = (fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                 causal),
                            fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                  causal))
            again = fa.flash_forward_cuda(q, k, v, causal)
            same = (torch.equal(again[0], out)
                    and torch.equal(again[1], lse)
                    and torch.equal(fa.flash_bwd_dq_cuda(
                        q, k, v, do, lse, delta, causal), dq)
                    and all(torch.equal(a, b) for a, b in zip(
                        fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                              causal), (dk, dv))))
            check(same, "flash kernels are not deterministic")
            del again, dq, dk, dv

        qh, kh, vh, doh = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        kr, vr = (x.repeat_interleave(H // KV, dim=1) for x in (kh, vh))
        lib_in = [x.detach().requires_grad_() for x in (qh, kr, vr)]
        lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=causal)
        lib_err = float((lib_out.detach().transpose(1, 2).float()
                         - ref_out.float()).abs().max())
        bounds = flash_bounds(B, T, H, KV, Dh, causal, q.element_size())
        timed = {
            "flash_forward": (
                lambda: fa.flash_forward_cuda(q, k, v, causal),
                lambda: fa.reference_attention_with_lse(q, k, v, causal),
                lambda: F.scaled_dot_product_attention(
                    qh, kr, vr, is_causal=causal)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal),
                None, None),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                              causal),
                None, None),
        }
        bwd_plain_ms = time_cold_ms(torch, lambda: fa.flash_backward_plain(
            q, k, v, out, lse, do, causal, dlse), iters=10)
        bwd_lib_ms = time_cold_ms(torch, lambda: torch.autograd.grad(
            lib_out, lib_in, doh, retain_graph=True))
        for name, (kernel, plain, library) in timed.items():
            ms = time_cold_ms(torch, kernel)
            plain_ms = (time_cold_ms(torch, plain, iters=10) if plain
                        else bwd_plain_ms)
            library_ms = time_cold_ms(torch, library) if library \
                else bwd_lib_ms
            b_ms, bound_by = bounds[name]
            err = (max(errs["out"], errs["lse"]) if name == "flash_forward"
                   else errs["dq"] if name == "flash_bwd_dq"
                   else max(errs["dk"], errs["dv"]))
            results[name + row] = {"max_abs_err": err, "ms": ms,
                                   "plain_ms": plain_ms, "bound_ms": b_ms,
                                   "bound_by": bound_by,
                                   "library_ms": library_ms}
            log(f"phase 2: {name}{row} ({label}) ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
                f"{b_ms:.5f} ({bound_by}) -> {b_ms / ms:.2%} of bound")
        log(f"phase 2: flash {label} plain/library: the backward's plain_ms "
            f"is flash_backward_plain (dq, dk, dv together"
            f"{', with the lse cotangent' if dlse is not None else ''}) and "
            f"its library_ms the autograd backward of "
            f"F.scaled_dot_product_attention over K/V repeated to {H} heads "
            f"(sdpa forward max diff {lib_err:.2e}"
            f"{'; no lse cotangent: SDPA takes none' if dlse is not None else ''}"
            f"); both are yardsticks the port never calls")
        if row == "":
            delta_ms = time_cold_ms(torch, lambda: fa.attention_delta(
                out, do, KV))
            # delta reads dO and out once and writes one fp32 per row
            delta_bound = ((2 * out.numel() * out.element_size()
                            + B * H * T * 4) / H100_BYTES_PER_S * 1e3)
            whole = (delta_ms + results["flash_bwd_dq"]["ms"]
                     + results["flash_bwd_dkv"]["ms"])
            results["backward"] = {"delta_ms": delta_ms,
                                   "delta_bound_ms": delta_bound,
                                   "whole_ms": whole,
                                   "library_ms": bwd_lib_ms}
            log(f"phase 2: attention_delta (plain PyTorch) ms "
                f"{delta_ms:.4f} bound_ms {delta_bound:.5f} (bytes) -> "
                f"{delta_bound / delta_ms:.2%} of bound")
            log(f"phase 2: whole backward: delta {delta_ms:.4f} + A-K2 "
                f"{results['flash_bwd_dq']['ms']:.4f} + A-K3 "
                f"{results['flash_bwd_dkv']['ms']:.4f} = {whole:.4f} ms vs "
                f"SDPA's autograd backward {bwd_lib_ms:.4f} ms (its own "
                f"preprocessing included): {whole / bwd_lib_ms:.2f}x")
        del lib_in, lib_out, q, k, v, do, dlse, out, lse, ref_out, delta
        torch.cuda.empty_cache()
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
    del srv, rt, cache, lk, lp
    check_threads_stopped("phase 3")
    plain_tokens = [body["tokens"] for _, body in results]
    stats.update(phase_spec_serve(torch, params, cfg, prompts, plain_tokens))
    check_threads_stopped("phase 3b")
    stats.update(phase_migrate(torch, params, cfg))
    check_threads_stopped("phase 3c")
    stats.update(timed("phase 3d", phase_fleet, torch, params, cfg, prompts,
                       plain_tokens))
    stats.update(timed("phase 3e", phase_router, torch, params, cfg, prompts,
                       plain_tokens))
    upgrade = timed("phase 3f", phase_upgrade, torch, params, cfg, prompts,
                    plain_tokens)
    rig = upgrade.pop("rig")
    stats.update(upgrade)
    stats.update(timed("phase 3g", phase_health, torch, params, cfg, rig))
    stats.update(timed("phase 3h", phase_handover, torch, params, cfg, rig))
    del params, rig
    stats.update(timed("phase 3d fp32", phase_fleet_fp32, torch))
    stats.update(timed("phase 3f-3h fp32", phase_upgrade_fp32, torch))
    return stats


class SSEReader(threading.Thread):
    """Reads one SSE response to its end: ``events`` in order, ``error``
    if the read failed."""

    def __init__(self, url, body=None):
        super().__init__(daemon=True)
        data = None if body is None else json.dumps(body).encode()
        self.req = urllib.request.Request(
            url, data=data, method="POST" if data is not None else "GET")
        self.events = []
        self.error = None
        self.start()

    def run(self):
        try:
            with urllib.request.urlopen(self.req, timeout=900) as resp:
                for raw in resp:
                    line = raw.strip()
                    if line.startswith(b"data: "):
                        self.events.append(json.loads(line[6:]))
        except Exception as exc:   # reported by the phase that reads it
            self.error = repr(exc)

    def tokens(self):
        return [e for e in self.events if "token" in e]

    def finish(self, what):
        self.join(timeout=900)
        check(self.error is None and not self.is_alive(),
              f"{what}: stream failed ({self.error})")
        return self


def get(url, timeout=120):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def get_text(url, timeout=120):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def get_code(url, timeout=120):
    """(status, body text) of a GET that may answer with an error."""
    try:
        return get_text(url, timeout)
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def serve_http(rt):
    """(httpd, thread, base url) of a port replica on a free port."""
    from k8s_operator_libs_tpu_torch.server import make_server
    httpd = make_server(rt, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def close_http(httpd, thread, rt):
    httpd.shutdown()
    httpd.server_close()
    rt.stop()
    thread.join(timeout=30)


def top2_gaps(torch, params, cfg, tokens, n_prompt):
    """Top-2 logit gap of the contiguous (plain) forward before each
    generated token of ``tokens``: gap[j] is taken at the position that
    predicts tokens[n_prompt + j]."""
    from k8s_operator_libs_tpu_torch.models.generate import (
        _forward_cached, init_cache)
    seq = torch.as_tensor([tokens[:-1]], device="cuda")
    cache = init_cache(cfg, 1, seq.shape[1], device="cuda")
    with torch.no_grad():
        logits, _ = _forward_cached(params, seq, cache, cfg)
    top = torch.topk(logits[0, n_prompt - 1:], 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def step_ms(torch, fn, iters=5):
    """Host wall ms of one synchronized call of ``fn`` (median)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def phase_spec_serve(torch, params, cfg, prompts, plain_tokens):
    """Phase 3b: phase 3's requests streamed through a speculative replica
    (self-int8 draft, k SPEC_K) over the same weights."""
    from k8s_operator_libs_tpu_torch.models.paged import (PagedKVCache,
                                                          _forward_paged)
    from k8s_operator_libs_tpu_torch.models.quant import _forward_paged_quant
    from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub
    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn
    from k8s_operator_libs_tpu_torch.server import ServingRuntime

    hub = MetricsHub()
    t0 = time.monotonic()
    rt = ServingRuntime(params, cfg, max_slots=SLOTS, capacity=CAPACITY,
                        block_size=BS, chunk=CHUNK, hub=hub,
                        draft="self-int8", spec_k=SPEC_K)
    srv = rt.srv
    log(f"phase 3b: self-int8 draft quantized and pools allocated in "
        f"{time.monotonic() - t0:.1f} s; the draft streams "
        f"{srv._draft_stream_bytes} weight bytes per step against the "
        f"target's {srv._stream_bytes}")
    httpd, thread, base = serve_http(rt)
    try:
        warm = SSEReader(base + "/generate", {"tokens": list(range(1, 9)),
                                              "max_new": 8, "stream": True})
        warm.finish("warm-up")
        check(warm.events[-1].get("done"), "speculative warm-up failed")
        with rt.lock:
            attn.reset_launch_counts()
            srv.spec_rounds = srv.spec_accepted = srv.decode_steps = 0
            srv.decode_seconds = 0.0
            srv.decode_tokens = 0
            acc0 = hist(hub, "spec_accept_ratio")
        t_req = time.monotonic()
        readers = [SSEReader(base + "/generate",
                             {"tokens": p, "max_new": MAX_NEW,
                              "stream": True}) for p in prompts]
        for i, r in enumerate(readers):
            r.finish(f"speculative request {i}")
        wall = time.monotonic() - t_req
        with rt.lock:
            launches = attn.LAUNCHES["paged_decode"]
            rounds, plain_steps = srv.spec_rounds, srv.decode_steps
            dec_s, dec_tok = srv.decode_seconds, srv.decode_tokens
            acc1 = hist(hub, "spec_accept_ratio")
            gbs = hub.gauge("weight_stream_gbs")
    finally:
        close_http(httpd, thread, rt)
    gaps_log = []
    for i, (p, r, plain) in enumerate(zip(prompts, readers, plain_tokens)):
        toks = r.tokens()
        check([e["seq"] for e in toks] == list(range(MAX_NEW)),
              f"speculative stream {i} is not gapless: "
              f"{[e['seq'] for e in toks]}")
        got = p + [e["token"] for e in toks]
        check(r.events[-1] == {"done": True, "tokens": got},
              f"speculative stream {i}: done tokens differ from the stream")
        gaps = top2_gaps(torch, params, cfg, plain, len(p))
        ok, what, _ = near_tie_verdict(got, plain, gaps, len(p))
        check(ok, f"speculative request {i} against phase 3's: {what}")
        gaps_log.append(f"prompt {len(p)}: {what}, min gap "
                        f"{min(gaps):.4f}")
    check(rounds > 0 and plain_steps == 0,
          f"{rounds} speculative rounds and {plain_steps} plain decode "
          f"steps ran")
    check(launches == rounds * (SPEC_K + 1) * cfg.n_layers,
          f"A-K4 launched {launches} times over {rounds} rounds of "
          f"{SPEC_K + 1} draft steps x {cfg.n_layers} layers")
    slot_rounds = acc1[1] - acc0[1]
    accept = (acc1[0] - acc0[0]) / max(1, slot_rounds)
    per_slot = dec_tok / max(1, slot_rounds)
    ms_round = 1e3 * dec_s / rounds
    log(f"phase 3b: 4 streamed requests (prompts {PROMPT_LENS}, max_new "
        f"{MAX_NEW}) through /generate stream, all gapless in "
        f"{wall:.2f} s; A-K4 launches {launches} = {rounds} rounds x "
        f"{SPEC_K + 1} draft steps x {cfg.n_layers} layers")
    log(f"phase 3b: mean acceptance {accept:.4f} of {SPEC_K} drafts, "
        f"{ms_round:.2f} ms per round, {per_slot:.3f} confirmed tokens per "
        f"round per slot, weight_stream_gbs {gbs} (target + "
        f"{SPEC_K + 1} x draft bytes per round)")
    for line in gaps_log:
        log(f"phase 3b: tokens vs phase 3: {line}")

    # one draft step, one target decode step and one verify on the
    # pools of four running slots
    srv = rt.srv
    for p in prompts:
        srv.submit(p, 8)
    srv.step(1)
    cache, toks = srv.snapshot()
    dcache = PagedKVCache(k=srv._dk, v=srv._dv, table=cache.table,
                          lengths=cache.lengths)
    window = toks.repeat(1, SPEC_K + 1)
    dparams = srv._spec["params"]
    with torch.no_grad():
        ms_draft = step_ms(torch, lambda: _forward_paged_quant(
            dparams, toks, dcache, cfg))
        ms_target = step_ms(torch, lambda: _forward_paged(
            params, toks, cache, cfg))
        ms_verify = step_ms(torch, lambda: _forward_paged(
            params, window, cache, cfg))
    log(f"phase 3b: one draft step (int8 weights, A-K4) {ms_draft:.2f} ms, "
        f"one target decode step (bf16, A-K4) {ms_target:.2f} ms, one "
        f"{SPEC_K + 1}-token verify {ms_verify:.2f} ms (host wall, "
        f"synchronized, {SLOTS} slots)")
    del srv, rt, cache, dcache, dparams
    return {"spec_launches": launches, "spec_rounds": rounds,
            "spec_mean_accept": accept, "spec_ms_per_round": ms_round,
            "spec_tokens_per_round_per_slot": per_slot,
            "spec_weight_stream_gbs": gbs, "spec_wall_s": wall,
            "spec_ms_draft_step": ms_draft,
            "spec_ms_target_step": ms_target,
            "spec_ms_verify": ms_verify}


class GatedBatcher:
    """A batcher that freezes after ``left`` more steps (None: never).
    Frozen, it reads as idle, so the runtime's stepper sleeps with its
    lock free for the HTTP handlers; everything else goes through."""

    def __init__(self, srv, left):
        self.srv = srv
        self.left = left

    def __getattr__(self, name):
        return getattr(self.srv, name)

    @property
    def idle(self):
        return self.left == 0 or self.srv.idle

    def step(self, n=1):
        if self.left is not None:
            self.left -= 1
        return self.srv.step(n)


def phase_migrate(torch, params, cfg):
    """Phase 3c: two port replicas over the same weights; a stream from
    replica A is drained, exported, adopted by B and read on, over HTTP,
    and must equal B's undisturbed run of the same request."""
    import numpy as np

    from k8s_operator_libs_tpu_torch.server import ServingRuntime

    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=MIGRATE_PROMPT).tolist()
    reps = []
    for _ in range(2):
        rt = ServingRuntime(params, cfg, max_slots=SLOTS, capacity=CAPACITY,
                            block_size=BS, chunk=1, drain_hold_s=60.0)
        reps.append((rt,) + serve_http(rt))
    (rt_a, *http_a), (rt_b, *http_b) = reps
    base_a, base_b = http_a[-1], http_b[-1]
    # A's batcher freezes after MIGRATE_AFTER steps
    gate = rt_a.srv = GatedBatcher(rt_a.srv, MIGRATE_AFTER)
    try:
        code, body = post(base_b + "/generate",
                          {"tokens": prompt, "max_new": MIGRATE_NEW})
        check(code == 200, f"undisturbed run on B returned {code}")
        want = body["tokens"]
        t0 = time.monotonic()
        donor = SSEReader(base_a + "/generate",
                          {"tokens": prompt, "max_new": MIGRATE_NEW,
                           "stream": True})
        while len(donor.tokens()) < MIGRATE_AFTER:
            check(donor.is_alive() and time.monotonic() - t0 < 600,
                  f"the donor stream stopped: {donor.events} "
                  f"{donor.error}")
            time.sleep(0.01)
        rid = donor.events[0]["rid"]
        code, body = post(base_a + "/drain", {})
        check(code == 200, f"/drain returned {code}")
        # let A's stepper go: the drain hold must keep the request still
        gate.left = None
        time.sleep(0.5)
        held_tokens = len(donor.tokens())
        t_exp = time.monotonic()
        code, body = post(base_a + "/export", {"rid": rid})
        check(code == 200, f"/export returned {code}, not 200")
        payload = body["data"]
        t_adopt = time.monotonic()
        code, body = post(base_b + "/adopt", payload)
        check(code == 200, f"/adopt returned {code}")
        t_done = time.monotonic()
        new_rid = body["data"]["rid"]
        rest = SSEReader(f"{base_b}/stream?rid={new_rid}")
        rest.finish("stream on B")
        donor.finish("stream on A")
        _, trace_a = get(f"{base_a}/trace?rid={rid}")
        _, trace_b = get(f"{base_b}/trace?rid={new_rid}")
    finally:
        for rt, httpd, thread, _ in reps:
            close_http(httpd, thread, rt)
    check(held_tokens == MIGRATE_AFTER,
          f"the drain hold let A decode on ({held_tokens} tokens)")
    check(donor.events[-1] == {"detached": True},
          f"A's stream ended with {donor.events[-1]}")
    spliced = donor.tokens() + rest.tokens()
    check([e["seq"] for e in spliced] == list(range(MIGRATE_NEW)),
          f"spliced stream seqs {[e['seq'] for e in spliced]}")
    check(prompt + [e["token"] for e in spliced] == want,
          "the spliced stream differs from B's undisturbed run")
    check(rest.events[-1] == {"done": True, "tokens": want},
          "B's final event is not the undisturbed tokens")
    ta, tb = trace_a["data"], trace_b["data"]
    check(ta["trace_id"] == tb["trace_id"] and tb["hop"] == ta["hop"] + 1,
          f"trace ids {ta['trace_id']} / {tb['trace_id']}, hops "
          f"{ta['hop']} / {tb['hop']}")
    kv_bytes = sum(len(payload["kv"][k]["b64"]) * 3 // 4
                   for k in ("k", "v"))
    log(f"phase 3c: two replicas (Llama-3-8B, all {cfg.n_layers} layers, "
        f"one set of weights shared in this process), prompt "
        f"{MIGRATE_PROMPT}, max_new {MIGRATE_NEW}: A drained after "
        f"{MIGRATE_AFTER} tokens, held while its stepper ran free; /export "
        f"200 in {1e3 * (t_adopt - t_exp):.1f} ms ({kv_bytes} KV bytes), "
        f"/adopt 200 in {1e3 * (t_done - t_adopt):.1f} ms; spliced stream "
        f"gapless 0..{MIGRATE_NEW - 1} and identical to B's undisturbed "
        f"run; trace {ta['trace_id']} on both hops (hop {ta['hop']} -> "
        f"{tb['hop']})")
    return {"migrate_export_ms": 1e3 * (t_adopt - t_exp),
            "migrate_adopt_ms": 1e3 * (t_done - t_adopt),
            "migrate_kv_bytes": kv_bytes}


# phase 3d: the serving tier. Node names; tokens streamed per replica
# before node A's drain; the requests sent to the respawned replica on A
# (new prompts of FLEET_NEW_LEN tokens, so no shared-prefix affinity
# pins them to B or C); the fp32 twin's layers
FLEET_NODES = ("fleet-a", "fleet-b", "fleet-c")
FLEET_DRAIN_AFTER, FLEET_NEW_LEN, FLEET32_LAYERS = 4, 64, 2
FLEET_MAX_TICKS = 2000


class FleetCluster:
    """The nodes phase 3d's replicas stand on: the client surface the
    port's pool and router take (``direct``, ``get_node``, ``list_nodes``,
    ``patch_node_metadata``). Nodes are Ready and schedulable. Phase 3d
    writes the upgrade-state label by hand, to hold the router's drain
    watch alone; phase 3f's labels come from the port's upgrade state
    machine on the port's ``FakeCluster`` instead."""

    def __init__(self, names):
        import types
        self.nodes = {n: types.SimpleNamespace(
            metadata=types.SimpleNamespace(name=n, labels={},
                                           annotations={}),
            spec=types.SimpleNamespace(unschedulable=False, taints=[]),
            is_ready=lambda: True) for n in names}

    def direct(self):
        return self

    def get_node(self, name):
        return self.nodes[name]

    def list_nodes(self):
        return list(self.nodes.values())

    def patch_node_metadata(self, name, labels=None, annotations=None):
        meta = self.nodes[name].metadata
        for have, patch in ((meta.labels, labels),
                            (meta.annotations, annotations)):
            for k, v in (patch or {}).items():
                if v is None:
                    have.pop(k, None)
                else:
                    have[k] = v
        return self.nodes[name]


def near_tie_verdict(got, want, gaps, n_prompt):
    """The rule for two bf16 decodes of one prompt (3b, 3d, 12b): the
    tokens agree up to the first position whose plain top-2 logit gap
    (``gaps``, one per generated token of ``want``) is under
    SPEC_GAP_EPS, and where they first differ that gap is under it too.
    Returns (ok, what to log, index of the first differing token)."""
    small = next((j for j, g in enumerate(gaps) if g < SPEC_GAP_EPS),
                 len(gaps))
    i_diff = first_mismatch(got[n_prompt:], want[n_prompt:])
    ok = (len(got) == len(want) and (
        i_diff is None or (i_diff >= small and gaps[i_diff] < SPEC_GAP_EPS)))
    what = ("identical" if i_diff is None else
            f"first differs at token {i_diff} (gap there "
            f"{gaps[i_diff]:.4f})") + (
        f", first gap < {SPEC_GAP_EPS} at token "
        f"{small if small < len(gaps) else 'none'}")
    return ok, what, i_diff


def fleet_runtime_class(records):
    """The port's ``BatcherRuntime`` with each export and adoption timed
    (host wall around the call, the card synchronized) and its KV bytes
    recorded in ``records``. A subclass, not a wrapper: a bound method
    kept on the instance would hold it in a reference cycle, and phase 5
    checks that the serving phases leave nothing on the card."""
    import torch

    from k8s_operator_libs_tpu_torch.models.paged import kv_payload_nbytes
    from k8s_operator_libs_tpu_torch.serving import BatcherRuntime

    class TimedRuntime(BatcherRuntime):
        def __init__(self, *args, fleet_hub=None, **kw):
            if fleet_hub is not None:
                kw["hub"] = tee_hub_class()(fleet_hub)
            super().__init__(*args, **kw)

        def export_slot(self, rid):
            t0 = time.monotonic()
            payload = super().export_slot(rid)
            torch.cuda.synchronize()
            records.append({"op": "export", "ms": 1e3 * (time.monotonic()
                                                         - t0),
                            "kv_bytes": kv_payload_nbytes(payload["kv"]),
                            "tokens": len(payload["generated"])})
            return payload

        def adopt_slot(self, payload):
            t0 = time.monotonic()
            rid = super().adopt_slot(payload)
            torch.cuda.synchronize()
            records.append({"op": "adopt", "ms": 1e3 * (time.monotonic()
                                                        - t0),
                            "kv_bytes": kv_payload_nbytes(payload["kv"])})
            return rid

    return TimedRuntime


def tee_hub_class():
    """A replica's own ``MetricsHub`` that also records every histogram
    sample (the batcher's TTFT among them) into the fleet's hub, as a
    scrape summed over replicas would see them; the replica's gauges and
    counters, which its pool reads back, stay its own."""
    from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub

    class TeeHub(MetricsHub):
        def __init__(self, fleet_hub):
            super().__init__()
            self.fleet_hub = fleet_hub

        def observe(self, name, value, labels=None, buckets=None):
            super().observe(name, value, labels, buckets)
            self.fleet_hub.observe(name, value, labels, buckets)

    return TeeHub


class Fleet:
    """Port replicas on ``nodes`` under the port's pool and router, the
    nodes read through ``client`` (``FleetCluster`` when none is given).
    ``tick()`` is one iteration of the serving loop: the router's tick
    (timed), its invariants against the nodes, then one step of every
    live replica (the router does not step them). With ``serving_hub``,
    every replica's histograms are also recorded there."""

    def __init__(self, params, cfg, nodes, records, client=None,
                 component="libtpu", serving_hub=None):
        from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub
        from k8s_operator_libs_tpu_torch.serving import (ReplicaPool,
                                                         RequestRouter)
        self.params, self.cfg = params, cfg
        self.cluster = FleetCluster(nodes) if client is None else client
        self.pool = ReplicaPool(client=self.cluster, component=component)
        self.hub = MetricsHub()
        self.router = RequestRouter(self.pool, metrics=self.hub)
        self.runtime_class = fleet_runtime_class(records)
        self.batchers = []          # every replica's batcher, in order
        self.batcher_ids = []       # and its replica's id
        self.generation = {}
        self.tick_ms = []
        self.assigned = []          # (tick, rid, replica id, node)
        self._logged = 0            # of the router's assignments list
        self.submitted_t, self.first_t = {}, {}
        self.ticks = 0
        self.serving_hub = serving_hub
        for node in nodes:
            self.spawn(node)

    def spawn(self, node):
        from k8s_operator_libs_tpu_torch.serving import Replica
        g = self.generation[node] = self.generation.get(node, 0) + 1
        runtime = self.runtime_class(self.params, self.cfg, max_slots=SLOTS,
                                     capacity_per_slot=CAPACITY,
                                     block_size=BS,
                                     fleet_hub=self.serving_hub)
        self.batchers.append(runtime.srv)
        self.batcher_ids.append(f"{node}-g{g}")
        return self.pool.register(Replica(f"{node}-g{g}", node, runtime))

    def submit(self, prompt, lane):
        rid = self.router.submit(prompt, MAX_NEW, lane=lane)
        self.submitted_t[rid] = time.monotonic()
        self._log_assignments()
        return rid

    def _log_assignments(self):
        """Log the placements the router made since the last call (its
        list restarts at each tick and also takes submits' placements)."""
        made = self.router.assignments_this_tick
        self.assigned.extend((self.ticks,) + a for a in made[self._logged:])
        self._logged = len(made)

    def set_state(self, node, state):
        self.cluster.patch_node_metadata(
            node, labels={self.pool.keys.state_label: state})

    def nodes(self):
        return {n.metadata.name: n
                for n in self.cluster.direct().list_nodes()}

    def streamed_by(self, replica_id):
        return sum(1 for req in self.router.requests.values()
                   for _seq, rep in req.stream_log if rep == replica_id)

    def tick(self):
        self.ticks += 1
        self._logged = 0
        t0 = time.monotonic()
        self.router.tick()
        self.tick_ms.append(1e3 * (time.monotonic() - t0))
        self._log_assignments()
        bad = self.router.check_invariants(self.nodes())
        check(not bad, f"router invariants at tick {self.ticks}: {bad}")
        now = time.monotonic()
        for rid, req in self.router.requests.items():
            if req.stream and rid not in self.first_t:
                self.first_t[rid] = now
        for replica in list(self.pool.replicas.values()):
            if not replica.failed:
                replica.runtime.step()
        check(self.ticks < FLEET_MAX_TICKS,
              f"the fleet did not finish in {FLEET_MAX_TICKS} ticks")

    def decode_steps(self):
        return sum(b.decode_steps for b in self.batchers)

    def check_delivery(self, tag):
        """Every request completed exactly once; every stream gapless and
        equal to its delivered tokens; no failed replica."""
        r = self.router
        check(r.outstanding == 0, f"{tag}: {r.outstanding} outstanding")
        check(sorted(r.completed_counts) == sorted(r.requests)
              and all(c == 1 for c in r.completed_counts.values()),
              f"{tag}: deliveries {r.completed_counts}")
        check(not r.stream_violations, f"{tag}: {r.stream_violations}")
        for rid, req in r.requests.items():
            check([s for s, _ in req.stream_log] == list(range(MAX_NEW))
                  and req.tokens[len(req.prompt):] == req.stream,
                  f"{tag}: request {rid}'s stream is not gapless or differs "
                  f"from its tokens")
        check(not any(rep.failed for rep in self.pool.replicas.values()),
              f"{tag}: a replica failed")


def phase_fleet(torch, params, cfg, prompts, plain_tokens):
    """Phase 3d: three port replicas under the port's router; node A's
    upgrade-state label turns cordon-required mid-stream, the router
    drains A (in-flight streams live-migrate, queued requests are placed
    again), a fresh replica takes A back and serves new traffic."""
    import numpy as np

    from k8s_operator_libs_tpu_torch.models.generate import generate
    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn
    from k8s_operator_libs_tpu_torch.serving import LANES
    from k8s_operator_libs_tpu_torch.upgrade import UpgradeState

    t_phase = time.monotonic()
    records = []
    attn.reset_launch_counts()
    fleet = Fleet(params, cfg, FLEET_NODES, records)
    router = fleet.router
    node_a = FLEET_NODES[0]
    old_a = fleet.pool.replicas[f"{node_a}-g1"]
    which = {}                               # rid -> (lane, prompt index)
    for k, p in enumerate(prompts):
        which[fleet.submit(p, LANES[0])] = (LANES[0], k)
    # the first lane streams on every replica; then the other two lanes
    # arrive and node A enters the upgrade pipeline before A steps again:
    # A holds two streams in flight and four requests never admitted
    while min(fleet.streamed_by(r.id) for r in fleet.pool.replicas.values()
              ) < FLEET_DRAIN_AFTER:
        fleet.tick()
    for lane in LANES[1:]:
        for k, p in enumerate(prompts):
            which[fleet.submit(p, lane)] = (lane, k)
    a_load = sum(1 for t, rid, rep, node in fleet.assigned
                 if rep == old_a.id)
    fleet.set_state(node_a, UpgradeState.CORDON_REQUIRED)
    drain_tick = fleet.ticks + 1
    fleet.tick()
    check(old_a.draining and old_a.drain_reason == "upgrade:cordon-required",
          f"A did not drain on the label (reason {old_a.drain_reason})")
    check(old_a.drained, "A still runs requests after its drain")
    # the node's upgrade is done: a fresh replica takes node A back (the
    # router sees the node admit again at its next tick), then new traffic
    fleet.set_state(node_a, UpgradeState.DONE)
    fleet.pool.deregister(old_a.id)
    new_a = fleet.spawn(node_a)
    fleet.tick()
    gen = np.random.default_rng(4)
    fresh = [gen.integers(0, cfg.vocab_size, size=FLEET_NEW_LEN).tolist()
             for _ in range(len(prompts))]
    for k, p in enumerate(fresh):
        which[fleet.submit(p, LANES[k % len(LANES)])] = ("new", k)
    while router.outstanding:
        fleet.tick()
    fleet.tick()
    wall = time.monotonic() - t_phase
    launches = attn.LAUNCHES["paged_decode"]
    steps = fleet.decode_steps()

    fleet.check_delivery("phase 3d")
    after = [(t, rid, rep) for t, rid, rep, node in fleet.assigned
             if t >= drain_tick and rep == old_a.id]
    check(not after, f"admissions on the drained A: {after}")
    on_new_a = [rid for t, rid, rep, node in fleet.assigned
                if rep == new_a.id]
    check(on_new_a, "no request landed on the respawned replica on A")
    check(router.migration_successes >= 1 and router.migration_fallbacks == 0,
          f"{router.migration_successes} live migrations, "
          f"{router.migration_fallbacks} re-prefill fallbacks")
    check(launches == cfg.n_layers * steps > 0,
          f"A-K4 launched {launches} times over {steps} decode steps of "
          f"{cfg.n_layers} layers (all replicas)")

    # tokens: phase 3's for its prompts, generate's for the new ones, by
    # phase 3b's near-tie rule
    with torch.no_grad():
        want_new = generate(params, torch.as_tensor(fresh, device="cuda"),
                            cfg, max_new_tokens=MAX_NEW).cpu().tolist()
    gaps = {("old", k): top2_gaps(torch, params, cfg, t, len(prompts[k]))
            for k, t in enumerate(plain_tokens)}
    gaps.update({("new", k): top2_gaps(torch, params, cfg, t, FLEET_NEW_LEN)
                 for k, t in enumerate(want_new)})
    verdicts = []
    for rid, (lane, k) in sorted(which.items()):
        key = ("new", k) if lane == "new" else ("old", k)
        want = want_new[k] if lane == "new" else plain_tokens[k]
        got = router.result(rid)
        ok, what, _ = near_tie_verdict(got, want, gaps[key],
                                       len(router.requests[rid].prompt))
        check(ok, f"phase 3d request {rid} ({lane}, prompt {k}): {what}")
        verdicts.append(f"{lane} prompt {len(router.requests[rid].prompt)}"
                        f": {what}")

    ttft = {}
    for rid, (lane, _k) in which.items():
        ttft.setdefault(lane, []).append(fleet.first_t[rid]
                                         - fleet.submitted_t[rid])
    per_replica = {}
    for srv, rep in zip(fleet.batchers, fleet.batcher_ids):
        per_replica[rep] = (1e3 * srv.decode_seconds / srv.decode_steps
                            if srv.decode_steps else None,
                            srv.decode_steps)
    ticks = sorted(fleet.tick_ms)
    migrated = [r for r in router.requests.values() if r.migrations]
    log(f"phase 3d: 3 port replicas (Llama-3-8B, all {cfg.n_layers} layers, "
        f"one set of weights) under the port's router and pool; "
        f"{len(which)} streamed requests (prompts {PROMPT_LENS} in lanes "
        f"{', '.join(LANES)}, then {len(fresh)} new of {FLEET_NEW_LEN}), "
        f"max_new {MAX_NEW}; node A held {a_load} requests when its label "
        f"turned cordon-required at tick {drain_tick}; "
        f"{router.migration_successes} live migrations "
        f"({router.migration_attempts} attempts), "
        f"{router.migration_fallbacks} fallbacks, {router._rerouted} "
        f"re-placed; {len(on_new_a)} requests on the respawned A; all "
        f"delivered once, gapless, invariants empty at all "
        f"{fleet.ticks} ticks")
    log(f"phase 3d: A-K4 launches {launches} = {cfg.n_layers} x {steps} "
        f"decode steps over {len(fleet.batchers)} batchers")
    log(f"phase 3d: ms per router tick median {ticks[len(ticks) // 2]:.3f}, "
        f"mean {sum(ticks) / len(ticks):.3f}, max {ticks[-1]:.3f} (host "
        f"wall: refresh, scrape, drain watch, collection, placement; the "
        f"drain's tick holds the exports and adoptions)")
    log("phase 3d: TTFT per lane, host wall from submit to the tick that "
        "saw the first token (the loop's granularity: a tick and one step "
        "of each replica): " + ", ".join(
            f"{lane} {1e3 * sum(v) / len(v):.1f} ms (n {len(v)})"
            for lane, v in ttft.items()))
    log("phase 3d: ms per decode step per replica (4 slots): " + ", ".join(
        f"{rep} {'-' if ms is None else f'{ms:.2f}'} ({n} steps)"
        for rep, (ms, n) in per_replica.items()))
    for rec in records:
        log(f"phase 3d: migration {rec['op']} {rec['ms']:.2f} ms, "
            f"{rec['kv_bytes']} KV bytes"
            + (f" ({rec['tokens']} tokens generated)" if "tokens" in rec
               else ""))
    for line in verdicts:
        log(f"phase 3d: tokens: {line}")
    log(f"phase 3d: serving loop and its checks {wall:.1f} s (before the "
        f"reference tokens)")
    exports = [r for r in records if r["op"] == "export"]
    adopts = [r for r in records if r["op"] == "adopt"]
    stats = {"fleet_launches": launches, "fleet_decode_steps": steps,
             "fleet_ticks": fleet.ticks,
             "fleet_tick_ms_median": ticks[len(ticks) // 2],
             "fleet_migrations": router.migration_successes,
             "fleet_fallbacks": router.migration_fallbacks,
             "fleet_export_ms": [r["ms"] for r in exports],
             "fleet_adopt_ms": [r["ms"] for r in adopts],
             "fleet_kv_bytes": [r["kv_bytes"] for r in exports],
             "fleet_ttft_ms": {lane: 1e3 * sum(v) / len(v)
                               for lane, v in ttft.items()},
             "fleet_ms_per_decode_step": {rep: ms for rep, (ms, _) in
                                          per_replica.items()},
             "fleet_migrated": len(migrated), "fleet_wall_s": wall}
    del fleet, router, old_a, new_a
    return stats


def phase_fleet_fp32(torch):
    """Phase 3d's fp32 twin: Llama-3-8B width at FLEET32_LAYERS layers, two
    port replicas, one drain mid-stream; every request's tokens equal the
    contiguous ``generate``'s."""
    import numpy as np

    from k8s_operator_libs_tpu_torch.models.generate import generate
    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          init_params)
    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn
    from k8s_operator_libs_tpu_torch.upgrade import UpgradeState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=FLEET32_LAYERS, dtype=torch.float32)
    params = init_params(cfg, seed=2, device="cuda")
    gen = np.random.default_rng(2)
    prompts = [gen.integers(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    records = []
    attn.reset_launch_counts()
    fleet = Fleet(params, cfg, FLEET_NODES[:2], records)
    router = fleet.router
    donor = fleet.pool.replicas[f"{FLEET_NODES[0]}-g1"]
    rids = [fleet.submit(p, "interactive") for p in prompts]
    while min(fleet.streamed_by(r.id) for r in fleet.pool.replicas.values()
              ) < FLEET_DRAIN_AFTER:
        fleet.tick()
    fleet.set_state(FLEET_NODES[0], UpgradeState.CORDON_REQUIRED)
    while router.outstanding:
        fleet.tick()
    fleet.tick()
    launches = attn.LAUNCHES["paged_decode"]
    steps = fleet.decode_steps()
    fleet.check_delivery("phase 3d fp32")
    check(donor.drained and router.migration_successes >= 1
          and router.migration_fallbacks == 0,
          f"fp32 twin: drained {donor.drained}, "
          f"{router.migration_successes} migrations, "
          f"{router.migration_fallbacks} fallbacks")
    check(launches == cfg.n_layers * steps > 0,
          f"fp32 twin: A-K4 launched {launches} times over {steps} steps")
    with torch.no_grad():
        for rid, p in zip(rids, prompts):
            want = generate(params, torch.as_tensor([p], device="cuda"),
                            cfg, max_new_tokens=MAX_NEW)[0].tolist()
            got = router.result(rid)
            i = first_mismatch(got, want)
            check(i is None and len(got) == len(want),
                  f"fp32 twin prompt {len(p)}: token "
                  f"{None if i is None else i - len(p)} differs from the "
                  f"contiguous generate")
    log(f"phase 3d fp32: 2 port replicas (Llama-3-8B width, "
        f"{FLEET32_LAYERS} layers, fp32), A drained mid-stream: "
        f"{router.migration_successes} live migrations, 0 fallbacks; all "
        f"{len(rids)} requests token-identical to the contiguous generate; "
        f"A-K4 launches {launches} = {cfg.n_layers} x {steps}")
    stats = {"fleet32_migrations": router.migration_successes,
             "fleet32_launches": launches}
    del fleet, router, donor, params
    return stats


# phase 3f: a rolling driver upgrade under the port's state machine. The
# GPU nodes (GFD labels: each an H100 HGX node of 8 GPUs, so each its own
# upgrade group), the driver DaemonSet's namespace and name
# (gpu/device_plugin.py's labels), the component whose keys the state
# machine writes and the pool reads; a new UPGRADE_NEW_LEN-token prompt
# every UPGRADE_EVERY iterations up to UPGRADE_REQUESTS requests in all;
# the iteration bound
UPGRADE_NODES = ("gpu-a", "gpu-b", "gpu-c")
UPGRADE_PRODUCT, UPGRADE_GPUS = "NVIDIA-H100-80GB-HBM3", "8"
UPGRADE_NS, UPGRADE_DS, UPGRADE_COMPONENT = ("gpu-operator",
                                             "nvidia-driver-daemonset", "gpu")
UPGRADE_EVERY, UPGRADE_REQUESTS, UPGRADE_NEW_LEN = 4, 16, 64
UPGRADE_MAX_ITERS = 400
# the driver component's upgrade policy, as the operator binary's config
# spells it (phase 3h writes it there): one node at a time, wait for the
# serve pods (job=serve), delete the GPU pods, drain
UPGRADE_POLICY = {
    "autoUpgrade": True, "maxParallelUpgrades": 1, "maxUnavailable": 1,
    "waitForCompletion": {"podSelector": "job=serve"},
    "podDeletion": {"force": True, "timeoutSecond": 60},
    "drain": {"enable": True, "force": True, "timeoutSecond": 60}}
# phase 3g: fleet health on the same rig, on the host's clock. The
# windows are a few of phase 3f's iterations (~0.18 s each on the H100):
# a signal must hold HEALTH_DAMPING_S to count and HEALTH_PERSIST_S to
# be persistent (then the repair is injected); the node must read healthy
# for HEALTH_RECOVERY_S before the quarantine lifts; a second repair
# would wait HEALTH_BACKOFF_S. HEALTH_NODE's driver pod crash-loops with
# HEALTH_FIRST prompts of HEALTH_LEN tokens in flight; a new one every
# UPGRADE_EVERY iterations while fewer than HEALTH_FIRST are in flight
# (at most HEALTH_REQUESTS in all) until the respawned replica has taken
# one
HEALTH_DAMPING_S, HEALTH_PERSIST_S = 0.5, 1.0
HEALTH_RECOVERY_S, HEALTH_BACKOFF_S = 0.5, 5.0
HEALTH_NODE, HEALTH_FIRST, HEALTH_LEN = "gpu-b", 6, 48
HEALTH_REQUESTS, HEALTH_MAX_ITERS = 24, 600
# every node's journey on this schedule: once its replica has drained,
# the serve pod has completed, so the deletion filter finds no pod
# holding a GPU and the node skips the drain. The same order as the JAX
# package's state machine on the same schedule
# (tests/test_torch_upgrade_serving.py::ROLLING_ORDER)
UPGRADE_ORDER = ("upgrade-required", "cordon-required",
                 "wait-for-jobs-required", "pod-deletion-required",
                 "pod-restart-required", "uncordon-required", "upgrade-done")


def add_serve_pod(cluster, node, job="serve"):
    """The node's ``<job>-<node>`` pod, which holds one GPU and which the
    wait-for-jobs gate watches (``job=<job>``: serve, or phase 6b's
    train)."""
    from k8s_operator_libs_tpu_torch.core.objects import (ContainerStatus,
                                                          ObjectMeta, Pod,
                                                          PodCondition)
    from k8s_operator_libs_tpu_torch.gpu import GPU_RESOURCE
    pod = Pod(metadata=ObjectMeta(name=f"{job}-{node}", namespace="default",
                                  labels={"job": job}))
    pod.spec.node_name = node
    pod.spec.resource_requests = {GPU_RESOURCE: 1}
    pod.status.phase = "Running"
    pod.status.container_statuses = [ContainerStatus(ready=True)]
    pod.status.conditions = [PodCondition(type="Ready", status="True")]
    cluster.create(pod)
    cluster.flush_cache()


class LogErrors(logging.Handler):
    """Counts the records at ERROR and above that the port's operator and
    SLO engine log (each ``logger.exception`` of a tick phase that
    failed and was isolated)."""

    def __init__(self, names):
        super().__init__(logging.ERROR)
        self.records = []
        self.names = names
        for name in names:
            logging.getLogger(name).addHandler(self)

    def emit(self, record):
        exc = record.exc_info[1] if record.exc_info else None
        self.records.append(
            f"{record.name} [{record.threadName}]: {record.getMessage()}"
            + ("" if exc is None else f" ({type(exc).__name__}: {exc})"))

    def close(self):
        for name in self.names:
            logging.getLogger(name).removeHandler(self)
        super().close()


class OperatorRig:
    """Phases 3f and 3g's fleet under the port's operator: replicas on the
    GPU nodes of a port ``FakeCluster`` (the host's clock, no cache lag),
    the driver DaemonSet with one pod per node, one serve pod per node,
    and a ``GPUOperator`` over one managed component (the upgrade policy
    below) with fleet health (``HEALTH_*`` windows), the SLO stack (the
    default objectives) and the usage meter, all recording into
    ``self.hub``. The replicas' histograms go to ``self.serving_hub``,
    which the operator's tsdb scrapes under the ``tpu_workload`` prefix
    before each reconcile, so the serving TTFT objective reads the
    card's TTFT. ``iteration()`` is one turn of the loop, with the hard
    checks every turn holds."""

    def __init__(self, params, cfg, records):
        from k8s_operator_libs_tpu_torch.api import DriverUpgradePolicySpec
        from k8s_operator_libs_tpu_torch.core import FakeCluster
        from k8s_operator_libs_tpu_torch.gpu import (COUNT_LABEL, PRODUCT_LABEL,
                                                     GPUOperator,
                                                     ManagedComponent)
        from k8s_operator_libs_tpu_torch.gpu.device_plugin import \
            DRIVER_LABELS
        from k8s_operator_libs_tpu_torch.health import (ClassifierConfig,
                                                        HealthOptions,
                                                        RemediationPolicy)
        from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub
        from k8s_operator_libs_tpu_torch.obs.slo import SLOOptions
        from k8s_operator_libs_tpu_torch.obs.usage import UsageMeter
        from k8s_operator_libs_tpu_torch.upgrade import KeyFactory

        self.cluster = FakeCluster()     # the host's clock, no cache lag
        ds = self.cluster.add_daemonset(UPGRADE_DS, namespace=UPGRADE_NS,
                                        labels=DRIVER_LABELS,
                                        revision_hash="v1")
        for node in UPGRADE_NODES:
            self.cluster.add_node(node, labels={PRODUCT_LABEL: UPGRADE_PRODUCT,
                                                COUNT_LABEL: UPGRADE_GPUS})
            self.cluster.add_pod(f"{UPGRADE_DS}-{node}", node,
                                 namespace=UPGRADE_NS, owner_ds=ds,
                                 revision_hash="v1")
            add_serve_pod(self.cluster, node)
        self.keys = KeyFactory(UPGRADE_COMPONENT)
        self.labels = DRIVER_LABELS
        policy = DriverUpgradePolicySpec.from_dict(UPGRADE_POLICY)
        self.hub, self.serving_hub = MetricsHub(), MetricsHub()
        self.op = GPUOperator(
            self.cluster.client,
            [ManagedComponent(UPGRADE_COMPONENT, UPGRADE_NS, DRIVER_LABELS,
                              policy)],
            recorder=self.cluster.recorder, synchronous=True,
            health=HealthOptions(
                component=UPGRADE_COMPONENT,
                classifier=ClassifierConfig(
                    damping_seconds=HEALTH_DAMPING_S,
                    persist_seconds=HEALTH_PERSIST_S),
                policy=RemediationPolicy(
                    recovery_seconds=HEALTH_RECOVERY_S,
                    backoff_base_seconds=HEALTH_BACKOFF_S)),
            slo=SLOOptions.from_dict({}),
            usage=UsageMeter(metrics=self.hub), metrics=self.hub)
        self.spec_names = {spec.name for spec in self.op.slo_engine.specs}
        self.fleet = Fleet(params, cfg, UPGRADE_NODES, records,
                           client=self.cluster.client,
                           component=UPGRADE_COMPONENT,
                           serving_hub=self.serving_hub)
        self.errors = LogErrors(["k8s_operator_libs_tpu_torch.gpu.operator",
                                 "k8s_operator_libs_tpu_torch.obs.slo"])
        self.tick_ms = []
        self.slo_ticks = 0
        self.exited = set()
        self.drained_at = {}             # node -> iteration of its drain

    def iteration(self, it, tag):
        """One turn: the serving hub scraped into the operator's tsdb, one
        operator reconcile (host wall timed; every objective evaluated, no
        tick phase failed), the DaemonSet controller's step and the
        fleet's tick; then no admission on a cordoned or quarantined
        node, at most one node in progress, the serve pods' lifecycle
        (a drained replica's pod completes; a node back at upgrade-done,
        schedulable, gets a new pod and replica) and at least all but
        one replica admitting (:meth:`serve_step`). Returns the nodes by
        name."""
        op = self.op
        op.tsdb.scrape(hub=self.serving_hub, prefix="tpu_workload")
        t0 = time.monotonic()
        op.reconcile()
        self.tick_ms.append(1e3 * (time.monotonic() - t0))
        check(set(op.last_slo) == self.spec_names and not self.errors.records,
              f"{tag}: iteration {it}: objectives evaluated "
              f"{sorted(op.last_slo)}, errors {self.errors.records}")
        self.slo_ticks += 1
        return self.serve_step(it, tag)

    def serve_step(self, it, tag):
        """The turn's part without the in-process operator (phase 3h's
        operators are the binary's, in their own threads): the DaemonSet
        controller's step, the fleet's tick and every check and pod
        lifecycle step of :meth:`iteration`. Returns the nodes by name."""
        from k8s_operator_libs_tpu_torch.upgrade import UpgradeState
        from k8s_operator_libs_tpu_torch.wire import QUARANTINE_LABEL
        fleet, cluster, keys = self.fleet, self.cluster, self.keys
        cluster.reconcile_daemonsets()
        seen = len(fleet.assigned)
        fleet.tick()
        nodes = fleet.nodes()
        landed = [(rep, node) for _t, _rid, rep, node in fleet.assigned[seen:]
                  if nodes[node].spec.unschedulable
                  or QUARANTINE_LABEL in nodes[node].metadata.labels]
        check(not landed, f"{tag}: admissions on cordoned or quarantined "
                          f"nodes: {landed}")
        busy = [n for n, node in nodes.items()
                if node.metadata.labels.get(keys.state_label)
                in UpgradeState.IN_PROGRESS]
        check(len(busy) <= 1, f"{tag}: {busy} in progress at once "
                              f"(iteration {it})")
        for replica in list(fleet.pool.replicas.values()):
            node = nodes[replica.node_name]
            if (replica.draining and replica.drained
                    and replica.id not in self.exited):
                # the drained replica's server exits: its pod completes,
                # which the wait-for-jobs gate waits for
                cluster.set_pod_status("default",
                                       f"serve-{replica.node_name}",
                                       phase="Succeeded")
                self.exited.add(replica.id)
                self.drained_at[replica.node_name] = it
            elif (replica.id in self.exited and not node.spec.unschedulable
                  and QUARANTINE_LABEL not in node.metadata.labels
                  and node.metadata.labels.get(keys.state_label)
                  == UpgradeState.DONE):
                # the node is back: a new serve pod and replica take it
                fleet.pool.deregister(replica.id)
                cluster.set_pod_status("default",
                                       f"serve-{replica.node_name}",
                                       phase="Running")
                fleet.spawn(replica.node_name)
        admitting = len(fleet.pool.admitting())
        check(admitting >= len(UPGRADE_NODES) - 1,
              f"{tag}: {admitting} admitting replicas at iteration {it}")
        return nodes

    def close(self):
        self.errors.close()


def rolling_upgrade(torch, params, cfg, prompts, records, tag):
    """Phase 3f's schedule on an :class:`OperatorRig`: phase 3's prompts
    in flight, the driver DaemonSet bumped to v2, then per iteration one
    ``GPUOperator.reconcile()`` (upgrade pipeline, health, stuck
    detection, placement, usage, SLO), the DaemonSet controller's step,
    the fleet's tick and the pods' lifecycle. Every hard check on the
    upgrade and the serving runs here; the tokens are the caller's. The
    rig carries on into phase 3g."""
    import numpy as np

    from k8s_operator_libs_tpu_torch.upgrade import UpgradeState
    from k8s_operator_libs_tpu_torch.wire import QUARANTINE_LABEL

    rig = OperatorRig(params, cfg, records)
    cluster, fleet, keys = rig.cluster, rig.fleet, rig.keys
    which = {fleet.submit(p, "interactive"): ("old", k)
             for k, p in enumerate(prompts)}
    gen = np.random.default_rng(5)
    fresh = []
    cluster.bump_daemonset_revision(UPGRADE_DS, UPGRADE_NS, "v2")
    t_roll = time.monotonic()
    rollout_s = None
    min_admitting = len(UPGRADE_NODES)
    for it in range(UPGRADE_MAX_ITERS):
        nodes = rig.iteration(it, tag)
        if it % UPGRADE_EVERY == UPGRADE_EVERY - 1 \
                and len(which) < UPGRADE_REQUESTS:
            fresh.append(gen.integers(0, cfg.vocab_size,
                                      size=UPGRADE_NEW_LEN).tolist())
            which[fleet.submit(fresh[-1], "interactive")] = (
                "new", len(fresh) - 1)
        quarantined = [n for n, node in nodes.items()
                       if QUARANTINE_LABEL in node.metadata.labels]
        check(not quarantined and not rig.op.last_health.actions
              .repairs_injected, f"{tag}: health acted during the "
                                 f"rollout: {quarantined}")
        min_admitting = min(min_admitting, len(fleet.pool.admitting()))
        done = all(node.metadata.labels.get(keys.state_label)
                   == UpgradeState.DONE and not node.spec.unschedulable
                   for node in nodes.values())
        if done and rollout_s is None:
            rollout_s, rollout_iters = time.monotonic() - t_roll, it + 1
        if done and not fleet.router.outstanding \
                and len(which) >= UPGRADE_REQUESTS:
            break
    else:
        raise SmokeFailure(f"{tag}: the upgrade and its requests did not "
                           f"finish in {UPGRADE_MAX_ITERS} iterations")
    fleet.tick()
    fleet.check_delivery(tag)
    direct = cluster.client.direct()
    drivers = sorted((p.spec.node_name,
                      p.metadata.labels["controller-revision-hash"])
                     for p in direct.list_pods(namespace=UPGRADE_NS))
    check(drivers == [(n, "v2") for n in UPGRADE_NODES],
          f"{tag}: driver pods {drivers}")
    journeys = {}
    for n in UPGRADE_NODES:
        entries = json.loads(direct.get_node(n).metadata.annotations[
            keys.journey_annotation])
        journeys[n] = entries
        check(tuple(s for s, _t in entries) == UPGRADE_ORDER,
              f"{tag}: {n}'s journey {[s for s, _t in entries]}")
    router = fleet.router
    check(router.migration_successes >= 2
          and router.migration_fallbacks == 0,
          f"{tag}: {router.migration_successes} live migrations, "
          f"{router.migration_fallbacks} re-prefill fallbacks")
    check({node for _r, node, _reason, _s in router.drains}
          == set(UPGRADE_NODES)
          and all(reason == "upgrade:cordon-required" and sched
                  for _r, _n, reason, sched in router.drains),
          f"{tag}: drains {router.drains}")
    check(len(fleet.pool.admitting()) == len(UPGRADE_NODES),
          f"{tag}: the fleet did not come back to "
          f"{len(UPGRADE_NODES)} admitting replicas")
    ttft = rig.op.last_slo["serving-ttft-p99"]
    check(not ttft["no_data"] and ttft["events_total"] > 0,
          f"{tag}: the serving TTFT objective read no TTFT: {ttft}")
    return {"rig": rig, "fleet": fleet, "which": which, "fresh": fresh,
            "journeys": journeys, "reconcile_ms": list(rig.tick_ms),
            "rollout_s": rollout_s, "rollout_iters": rollout_iters,
            "iterations": it + 1, "min_admitting": min_admitting,
            "drained_at": dict(rig.drained_at), "ttft": ttft}


def quarantine_repair(torch, rig, cfg, tag):
    """Phase 3g's schedule on phase 3f's rig, right after its rollout:
    HEALTH_FIRST prompts of HEALTH_LEN tokens submitted, then gpu-b's
    driver pod crash-loops (not ready, 12 restarts). Each iteration is
    the rig's; a new prompt every UPGRADE_EVERY iterations while fewer
    than HEALTH_FIRST are in flight, until the respawned replica on
    HEALTH_NODE has taken one. The operator's
    health must quarantine the node (label, taint, cordon), the router
    drain its replica for ``quarantined`` with live migration, the
    repair ride the upgrade pipeline once, the driver pod come back new
    and ready, and the quarantine lift with one repair attempt on
    record. Returns the requests (prompt by rid), what was seen and the
    iterations at which each step happened."""
    import numpy as np

    from k8s_operator_libs_tpu_torch.health import consts as hconsts
    from k8s_operator_libs_tpu_torch.upgrade import UpgradeState

    fleet, cluster, op, keys = rig.fleet, rig.cluster, rig.op, rig.keys
    router = fleet.router
    direct = cluster.client.direct()
    driver = next(p for p in direct.list_pods(namespace=UPGRADE_NS)
                  if p.spec.node_name == HEALTH_NODE)
    old_uid = driver.metadata.uid
    gen = np.random.default_rng(7)
    prompts = {}

    def submit():
        p = gen.integers(0, cfg.vocab_size, size=HEALTH_LEN).tolist()
        prompts[fleet.submit(p, "interactive")] = p

    for _ in range(HEALTH_FIRST):
        submit()
    migrations0 = router.migration_successes
    fallbacks0 = router.migration_fallbacks
    drains0 = len(router.drains)
    replicas0 = set(fleet.pool.replicas)
    steps0 = fleet.decode_steps()
    launches0 = attn_launches()
    cluster.set_pod_status(UPGRADE_NS, driver.metadata.name, ready=False,
                           restart_count=12)
    t0 = time.monotonic()
    at, repairs, states = {}, [], set()
    respawned = None
    for it in range(HEALTH_MAX_ITERS):
        nodes = rig.iteration(it, tag)
        node = nodes[HEALTH_NODE]
        repairs.extend(op.last_health.actions.repairs_injected)
        if op.last_health.actions.repairs_injected:
            at.setdefault("repair injected", (it, time.monotonic() - t0))
        states.add(node.metadata.labels.get(keys.state_label, ""))
        if hconsts.QUARANTINE_LABEL in node.metadata.labels:
            at.setdefault("quarantined", (it, time.monotonic() - t0))
            check(node.spec.unschedulable
                  and any(t.key == hconsts.QUARANTINE_TAINT_KEY
                          for t in node.spec.taints),
                  f"{tag}: {HEALTH_NODE} quarantined but not cordoned and "
                  f"tainted")
        elif "quarantined" in at and not node.spec.unschedulable:
            at.setdefault("lifted", (it, time.monotonic() - t0))
        new = [r for r in fleet.pool.replicas.values()
               if r.id not in replicas0 and r.node_name == HEALTH_NODE]
        if new and respawned is None:
            respawned = new[0].id
            at["respawned"] = (it, time.monotonic() - t0)
        took = respawned is not None and any(
            rep == respawned for _t, _rid, rep, _n in fleet.assigned)
        if it % UPGRADE_EVERY == UPGRADE_EVERY - 1 and not took \
                and len(prompts) < HEALTH_REQUESTS \
                and router.outstanding < HEALTH_FIRST:
            # at most HEALTH_FIRST in flight: two replicas' slots then
            # hold the quarantined replica's requests, so each migrates
            submit()
        if took and not router.outstanding:
            break
    else:
        raise SmokeFailure(f"{tag}: quarantine and repair did not finish "
                           f"in {HEALTH_MAX_ITERS} iterations ({at})")
    fleet.tick()
    fleet.check_delivery(tag)
    check(repairs == [HEALTH_NODE],
          f"{tag}: repairs injected {repairs}, want [{HEALTH_NODE!r}] once")
    check(UpgradeState.DRAIN_REQUIRED in states
          or UpgradeState.WAIT_FOR_JOBS_REQUIRED in states,
          f"{tag}: the repair did not ride the upgrade pipeline: {states}")
    check(direct.get_node(HEALTH_NODE).metadata.labels.get(keys.state_label)
          == UpgradeState.DONE, f"{tag}: {HEALTH_NODE} not upgrade-done")
    pods = [p for p in direct.list_pods(namespace=UPGRADE_NS)
            if p.spec.node_name == HEALTH_NODE]
    check(len(pods) == 1 and pods[0].metadata.uid != old_uid
          and all(c.ready for c in pods[0].status.container_statuses),
          f"{tag}: {HEALTH_NODE}'s driver pod was not recreated ready")
    node = direct.get_node(HEALTH_NODE)
    annos = node.metadata.annotations
    check(hconsts.QUARANTINE_LABEL not in node.metadata.labels
          and not node.spec.taints and not node.spec.unschedulable
          and hconsts.REPAIR_ANNOTATION not in annos
          and annos.get(hconsts.REPAIR_ATTEMPTS_ANNOTATION) == "1",
          f"{tag}: quarantine not lifted cleanly: labels "
          f"{node.metadata.labels}, taints {node.spec.taints}, "
          f"annotations {annos}")
    messages = [e.message for e in cluster.recorder.events
                if e.reason == "FleetHealth"]
    for want in ("Quarantined", "slice-atomic repair", "Quarantine lifted"):
        check(any(want in m for m in messages),
              f"{tag}: no FleetHealth event says {want!r}: {messages}")
    drains = router.drains[drains0:]
    check([(n, reason) for _r, n, reason, _s in drains]
          == [(HEALTH_NODE, "quarantined")],
          f"{tag}: drains {drains}")
    migrations = router.migration_successes - migrations0
    fallbacks = router.migration_fallbacks - fallbacks0
    check(migrations >= 1 and fallbacks == 0,
          f"{tag}: {migrations} live migrations, {fallbacks} fallbacks")
    check(respawned is not None and router.requests and any(
        rep == respawned for _t, _rid, rep, _n in fleet.assigned),
          f"{tag}: the respawned replica took no request")
    steps = fleet.decode_steps() - steps0
    launches = attn_launches() - launches0
    check(launches == cfg.n_layers * steps > 0,
          f"{tag}: A-K4 launched {launches} times over {steps} decode steps "
          f"of {cfg.n_layers} layers")
    return {"prompts": prompts, "at": at, "iterations": it + 1,
            "migrations": migrations, "fallbacks": fallbacks,
            "launches": launches, "steps": steps, "respawned": respawned,
            "messages": messages, "states": states}


def attn_launches():
    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn
    return attn.LAUNCHES["paged_decode"]


def phase_upgrade(torch, params, cfg, prompts, plain_tokens):
    """Phase 3f: a rolling NVIDIA driver upgrade across three Llama-3-8B
    port replicas, driven by the port's ``GPUOperator`` (its
    ``ClusterUpgradeStateManager`` with the GPU grouper and deletion
    filter, fleet health, the SLO stack and the usage meter); each
    replica drains with live migration when its node leaves
    ``upgrade-done``. Returns the stats and, under ``"rig"``, the rig
    phase 3g carries on with."""
    from k8s_operator_libs_tpu_torch.models.generate import generate
    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn

    t_phase = time.monotonic()
    records = []
    attn.reset_launch_counts()
    out = rolling_upgrade(torch, params, cfg, prompts, records, "phase 3f")
    fleet, which, fresh = out["fleet"], out["which"], out["fresh"]
    router = fleet.router
    launches = attn.LAUNCHES["paged_decode"]
    steps = fleet.decode_steps()
    check(launches == cfg.n_layers * steps > 0,
          f"phase 3f: A-K4 launched {launches} times over {steps} decode "
          f"steps of {cfg.n_layers} layers (all replicas)")
    wall = time.monotonic() - t_phase

    with torch.no_grad():
        want_new = generate(params, torch.as_tensor(fresh, device="cuda"),
                            cfg, max_new_tokens=MAX_NEW).cpu().tolist()
    gaps = {("old", k): top2_gaps(torch, params, cfg, t, len(prompts[k]))
            for k, t in enumerate(plain_tokens)}
    gaps.update({("new", k): top2_gaps(torch, params, cfg, t,
                                       UPGRADE_NEW_LEN)
                 for k, t in enumerate(want_new)})
    verdicts = []
    for rid, key in sorted(which.items()):
        want = want_new[key[1]] if key[0] == "new" else plain_tokens[key[1]]
        ok, what, _ = near_tie_verdict(router.result(rid), want, gaps[key],
                                       len(router.requests[rid].prompt))
        check(ok, f"phase 3f request {rid} ({key[0]} prompt {key[1]}): "
                  f"{what}")
        verdicts.append(f"prompt {len(router.requests[rid].prompt)}: "
                        f"{what}")

    per_state, per_node = {}, {}
    for n, entries in out["journeys"].items():
        per_node[n] = entries[-1][1] - entries[0][1]
        for (state, t), (_next, t_next) in zip(entries, entries[1:]):
            per_state.setdefault(state, []).append(t_next - t)
    rec_ms = sorted(out["reconcile_ms"])
    ticks = sorted(fleet.tick_ms)
    ttft = out["ttft"]
    per_replica = {}
    for srv, rep in zip(fleet.batchers, fleet.batcher_ids):
        per_replica[rep] = (1e3 * srv.decode_seconds / srv.decode_steps
                            if srv.decode_steps else None,
                            srv.decode_steps)
    log(f"phase 3f: the port's GPUOperator (its upgrade state machine with "
        f"the GPU grouper and deletion filter, max_parallel_upgrades 1, "
        f"max_unavailable 1, wait for job=serve, drain; fleet health, the "
        f"SLO stack, the usage meter) rolled {UPGRADE_DS} v1 -> v2 across "
        f"{', '.join(UPGRADE_NODES)}, each hosting a port replica "
        f"(Llama-3-8B, all {cfg.n_layers} layers); every node's journey "
        f"{' -> '.join(UPGRADE_ORDER)}; at most 1 node in progress, "
        f">= {out['min_admitting']} admitting replicas, invariants empty "
        f"at all {fleet.ticks} ticks; {len(which)} requests delivered "
        f"once, gapless; {router.migration_successes} live migrations, "
        f"{router.migration_fallbacks} fallbacks")
    log(f"phase 3f: rollout wall {out['rollout_s']:.3f} s "
        f"({out['rollout_iters']} iterations; the loop ran "
        f"{out['iterations']} until its {len(which)} requests finished); "
        f"drains at iterations {out['drained_at']}")
    log("phase 3f: seconds per node, upgrade-required to upgrade-done "
        "(journey): " + ", ".join(f"{n} {s:.3f}"
                                  for n, s in per_node.items()))
    log("phase 3f: seconds per state (journey; per node): " + "; ".join(
        f"{state} " + "/".join(f"{v:.3f}" for v in vs)
        for state, vs in per_state.items()))
    log(f"phase 3f: ms per operator tick (GPUOperator.reconcile: upgrade "
        f"pipeline, health, stuck detection, placement, usage, SLO scrape "
        f"and evaluation; host wall) median {rec_ms[len(rec_ms) // 2]:.3f}, "
        f"max {rec_ms[-1]:.3f} over {len(rec_ms)} ticks (the bare "
        f"manager's build_state + apply_state pass, without health, SLO "
        f"and usage: 1.001/1.033 ms median on an H100 80GB HBM3 host at "
        f"700 W, PERF.md section 5); all {len(out['rig'].spec_names)} "
        f"objectives evaluated at every tick")
    log(f"phase 3f: the serving TTFT objective over the replicas' "
        f"histograms: {ttft['events_total']:.0f} first tokens, p50 "
        f"{ttft['quantiles']['p50']} s, p99 {ttft['quantiles']['p99']} s, "
        f"bad fraction {ttft['bad_fraction']}, error budget remaining "
        f"{ttft['error_budget_remaining']:.4f}")
    log(f"phase 3f: ms per router tick median {ticks[len(ticks) // 2]:.3f}, "
        f"max {ticks[-1]:.3f}")
    log("phase 3f: ms per decode step per replica (4 slots): " + ", ".join(
        f"{rep} {'-' if ms is None else f'{ms:.2f}'} ({n} steps)"
        for rep, (ms, n) in per_replica.items()))
    for rec in records:
        log(f"phase 3f: migration {rec['op']} {rec['ms']:.2f} ms, "
            f"{rec['kv_bytes']} KV bytes"
            + (f" ({rec['tokens']} tokens generated)" if "tokens" in rec
               else ""))
    for line in verdicts:
        log(f"phase 3f: tokens: {line}")
    log(f"phase 3f: A-K4 launches {launches} = {cfg.n_layers} x {steps} "
        f"decode steps over {len(fleet.batchers)} batchers; loop and checks "
        f"{wall:.1f} s (before the reference tokens)")
    exports = [r for r in records if r["op"] == "export"]
    adopts = [r for r in records if r["op"] == "adopt"]
    stats = {"upgrade_launches": launches, "upgrade_decode_steps": steps,
             "upgrade_rollout_s": out["rollout_s"],
             "upgrade_node_s": per_node,
             "upgrade_reconcile_ms_median": rec_ms[len(rec_ms) // 2],
             "upgrade_reconcile_ms_max": rec_ms[-1],
             "upgrade_tick_ms_median": ticks[len(ticks) // 2],
             "upgrade_migrations": router.migration_successes,
             "upgrade_fallbacks": router.migration_fallbacks,
             "upgrade_export_ms": [r["ms"] for r in exports],
             "upgrade_adopt_ms": [r["ms"] for r in adopts],
             "upgrade_kv_bytes": [r["kv_bytes"] for r in exports],
             "upgrade_ms_per_decode_step": {rep: ms for rep, (ms, _) in
                                            per_replica.items()},
             "upgrade_ttft_p99_s": ttft["quantiles"]["p99"],
             "rig": out["rig"]}
    del fleet, router, out
    return stats


def phase_health(torch, params, cfg, rig):
    """Phase 3g: fleet health through the port's operator on phase 3f's
    rig (quarantine, the router's drain with live migration, the repair
    through the upgrade pipeline, the lift and the replica's return);
    every request's tokens against a batched ``generate`` by the
    near-tie rule."""
    from k8s_operator_libs_tpu_torch.models.generate import generate

    out = quarantine_repair(torch, rig, cfg, "phase 3g")
    router = rig.fleet.router
    rids = sorted(out["prompts"])
    with torch.no_grad():
        want = generate(params, torch.as_tensor(
            [out["prompts"][r] for r in rids], device="cuda"), cfg,
            max_new_tokens=MAX_NEW).cpu().tolist()
    verdicts = []
    for rid, w in zip(rids, want):
        gaps = top2_gaps(torch, params, cfg, w, HEALTH_LEN)
        ok, what, _ = near_tie_verdict(router.result(rid), w, gaps,
                                       HEALTH_LEN)
        check(ok, f"phase 3g request {rid}: {what}")
        verdicts.append(what)
    ticks = sorted(rig.tick_ms[-out["iterations"]:])
    at = out["at"]
    log(f"phase 3g: {HEALTH_NODE}'s driver pod crash-looping (not ready, "
        f"12 restarts) under the port's GPUOperator (damping "
        f"{HEALTH_DAMPING_S} s, persist {HEALTH_PERSIST_S} s, recovery "
        f"{HEALTH_RECOVERY_S} s, backoff {HEALTH_BACKOFF_S} s, host clock): "
        + ", ".join(f"{k} at iteration {i} ({t:.3f} s)"
                    for k, (i, t) in at.items())
        + f"; {out['iterations']} iterations in all")
    log(f"phase 3g: quarantine (label, taint, cordon), the router's drain "
        f"for 'quarantined' with {out['migrations']} live migrations and "
        f"{out['fallbacks']} fallbacks, no admission on the node, one "
        f"repair through the upgrade pipeline (states seen "
        f"{sorted(out['states'])}), the driver pod recreated ready, the "
        f"lift with 1 repair attempt on record; {out['respawned']} took "
        f"requests; {len(rids)} requests delivered once, gapless")
    log(f"phase 3g: ms per operator tick median {ticks[len(ticks) // 2]:.3f}, "
        f"max {ticks[-1]:.3f} over {len(ticks)} ticks")
    for line in verdicts:
        log(f"phase 3g: tokens: {line}")
    log(f"phase 3g: A-K4 launches {out['launches']} = {cfg.n_layers} x "
        f"{out['steps']} decode steps")
    rig.close()
    return {"health_launches": out["launches"],
            "health_decode_steps": out["steps"],
            "health_iterations": out["iterations"],
            "health_at_s": {k: t for k, (_i, t) in at.items()},
            "health_migrations": out["migrations"],
            "health_fallbacks": out["fallbacks"],
            "health_tick_ms_median": ticks[len(ticks) // 2],
            "health_tick_ms_max": ticks[-1]}


# phase 3h: the operator binary's leader handover on phase 3g's rig. The
# driver's next revision; the lease (the binary's default name, in the
# component's namespace) and the two instances' identities; the
# binary's resync interval; new HANDOVER_LEN-token prompts, HANDOVER_FIRST
# at the bump, then one every UPGRADE_EVERY iterations while fewer than
# HANDOVER_FIRST are in flight, HANDOVER_REQUESTS in all; the least
# seconds an iteration takes (a 2-layer fp32 fleet steps in a few ms: the
# loop sleeps the rest, so it neither outruns the operators' 0.1 s ticks
# nor holds the interpreter lock they need); the bounds on iterations
# and on each wait for an instance
HANDOVER_REVISION = "v3"
HANDOVER_LEASE = "tpu-operator"
HANDOVER_IDS = ("op-a", "op-b")
HANDOVER_INTERVAL = 0.1
HANDOVER_FIRST, HANDOVER_LEN, HANDOVER_REQUESTS = 4, 64, 12
HANDOVER_MIN_ITER_S = 0.02
HANDOVER_MAX_ITERS, HANDOVER_WAIT_S = 1000, 60.0


class OperatorInstance:
    """One operator binary (``operator.main``) in a thread named after
    its ``--leader-elect-identity``; ``stop`` is the event its SIGTERM
    would set, ``server`` its metrics server once it serves."""

    def __init__(self, identity, argv):
        self.identity = identity
        self.argv = argv
        self.stop = threading.Event()
        self.server = None
        self.ready = threading.Event()
        self.box = {}
        self.thread = threading.Thread(target=self._run, name=identity,
                                       daemon=True)

    def _run(self):
        from k8s_operator_libs_tpu_torch import operator as op_bin

        def on_ready(server):
            self.server = server
            self.ready.set()
        try:
            self.box["rc"] = op_bin.main(self.argv, stop=self.stop,
                                         on_ready=on_ready)
        except BaseException as exc:   # reported by the caller's check
            self.box["error"] = repr(exc)
            self.ready.set()

    def start(self, tag):
        self.thread.start()
        check(self.ready.wait(HANDOVER_WAIT_S) and self.server is not None,
              f"{tag}: {self.identity} did not start: {self.box}")

    def get(self, path):
        return get_code(f"http://127.0.0.1:{self.server.port}{path}")

    def wait_for(self, cond, what, tag):
        deadline = time.monotonic() + HANDOVER_WAIT_S
        while not cond():
            check(time.monotonic() < deadline and self.thread.is_alive(),
                  f"{tag}: {self.identity}: {what} ({self.box})")
            time.sleep(0.01)

    def join(self, tag):
        self.thread.join(HANDOVER_WAIT_S)
        check(not self.thread.is_alive() and self.box.get("rc") == 0,
              f"{tag}: {self.identity} did not exit cleanly: {self.box}")


def lease_holder(direct):
    from k8s_operator_libs_tpu_torch.core.client import NotFoundError
    try:
        return direct.get_lease(UPGRADE_NS, HANDOVER_LEASE).spec \
            .holder_identity or ""
    except NotFoundError:
        return ""


def leader_handover(torch, rig, cfg, tag):
    """Phase 3h's schedule on phase 3g's rig: its ``FakeCluster`` behind
    the port's ``FakeAPIServer``, and in place of the in-process
    ``GPUOperator`` two operator binaries (``--watch --leader-elect
    --profile --ensure-crds``, over HTTP through the informer cache and
    the resilient client) with one component, the driver DaemonSet under
    3f's policy. op-a leads, op-b stands by; the driver is bumped to v3
    with new prompts in flight; each iteration is the rig's serving turn
    (the DaemonSet controller's step, the fleet's tick, the pods'
    lifecycle). Once one node is upgrade-done at v3 and a second has
    left upgrade-done past admission (in progress), op-a's stop event is
    set: it finishes its tick and releases the lease, and op-b takes over
    mid-journey and finishes the rollout.
    Returns the requests (prompt by rid), the per-instance tick times and
    bodies, and what was seen."""
    import logging

    import numpy as np

    from k8s_operator_libs_tpu_torch.core.httpapi import FakeAPIServer
    from k8s_operator_libs_tpu_torch.gpu.operator import GPUOperator
    from k8s_operator_libs_tpu_torch.obs.journey import parse_journey
    from k8s_operator_libs_tpu_torch.upgrade import UpgradeState
    from k8s_operator_libs_tpu_torch.utils import threads as port_threads

    fleet, cluster, keys = rig.fleet, rig.cluster, rig.keys
    router = fleet.router
    direct = cluster.client.direct()
    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke_operator"
    work.mkdir(parents=True, exist_ok=True)

    def journey(n):
        return parse_journey(direct.get_node(n).metadata.annotations.get(
            keys.journey_annotation))

    base = {n: len(journey(n)) for n in UPGRADE_NODES}
    api = FakeAPIServer(cluster).start()
    kubeconfig = work / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "current-context": "smoke",
        "contexts": [{"name": "smoke", "context": {"cluster": "smoke",
                                                   "user": "smoke"}}],
        "clusters": [{"name": "smoke",
                      "cluster": {"server": api.base_url}}],
        "users": [{"name": "smoke", "user": {}}]}))
    config = work / "operator.yaml"        # JSON is YAML
    config.write_text(json.dumps({"components": [{
        "name": UPGRADE_COMPONENT, "namespace": UPGRADE_NS,
        "driverLabels": dict(rig.labels), "policy": UPGRADE_POLICY}]}))
    instances = [OperatorInstance(ident, [
        "--config", str(config), "--kubeconfig", str(kubeconfig),
        "--watch", "--leader-elect", "--leader-elect-identity", ident,
        "--profile", "--ensure-crds", str(root / "crds"),
        "--interval", str(HANDOVER_INTERVAL), "--metrics-port", "0"])
        for ident in HANDOVER_IDS]
    a, b = instances

    # each instance's reconcile ticks, host wall, by its thread's name
    ticks = {ident: [] for ident in HANDOVER_IDS}
    real_reconcile = GPUOperator.reconcile

    def timed_reconcile(op):
        t0 = time.monotonic()
        try:
            return real_reconcile(op)
        finally:
            name = threading.current_thread().name
            if name in ticks:
                ticks[name].append((t0, time.monotonic()))

    # the binary configures logging for a process of its own: keep the
    # script's (a handler on the root makes its basicConfig a no-op) and
    # count the errors the operators log
    root_log = logging.getLogger()
    root_state = (root_log.level, list(root_log.handlers))
    root_log.handlers[:] = [logging.NullHandler()]
    errors = LogErrors(["tpu-operator", "k8s_operator_libs_tpu_torch"])
    GPUOperator.reconcile = timed_reconcile
    gen = np.random.default_rng(11)
    prompts = {}
    migrations0 = router.migration_successes
    fallbacks0 = router.migration_fallbacks
    steps0 = fleet.decode_steps()
    launches0 = attn_launches()
    decode0 = {rep: (srv.decode_seconds, srv.decode_steps)
               for srv, rep in zip(fleet.batchers, fleet.batcher_ids)}
    holders, seen_states = [], {n: [] for n in UPGRADE_NODES}
    bodies = {}
    t_stop = stop_at = rollout_s = None
    try:
        a.start(tag)
        a.wait_for(lambda: lease_holder(direct) == a.identity and ticks[
            a.identity], "never led", tag)
        b.start(tag)
        b.wait_for(lambda: b.server.snapshot["healthy"],
                   "the standby never reported healthy", tag)
        bodies["standby healthz"] = b.get("/healthz")
        bodies["standby metrics"] = b.get("/metrics")
        check(bodies["standby healthz"] == (200, "ok")
              and "tpu_operator_leader 0" in bodies["standby metrics"][1]
              and not ticks[b.identity]
              and lease_holder(direct) == a.identity,
              f"{tag}: the standby's /healthz {bodies['standby healthz']}, "
              f"leader gauge 0 missing or it reconciled")

        def submit():
            p = gen.integers(0, cfg.vocab_size, size=HANDOVER_LEN).tolist()
            prompts[fleet.submit(p, "interactive")] = p

        for _ in range(HANDOVER_FIRST):
            submit()
        cluster.bump_daemonset_revision(UPGRADE_DS, UPGRADE_NS,
                                        HANDOVER_REVISION)
        t_bump = time.monotonic()
        for it in range(HANDOVER_MAX_ITERS):
            t_it = time.monotonic()
            nodes = rig.serve_step(it, f"{tag} iteration {it}")
            holder = lease_holder(direct)
            if holder and (not holders or holders[-1] != holder):
                holders.append(holder)
            states = {n: node.metadata.labels.get(keys.state_label, "")
                      for n, node in nodes.items()}
            for n, st in states.items():
                if not seen_states[n] or seen_states[n][-1] != st:
                    seen_states[n].append(st)
            at_v3 = [n for n in UPGRADE_NODES
                     if states[n] == UpgradeState.DONE
                     and len(journey(n)) > base[n]]
            if t_stop is None and at_v3 and any(
                    st in UpgradeState.IN_PROGRESS
                    for st in states.values()):
                # one node upgraded, a second past admission: the leader
                # goes mid-journey
                a.stop.set()
                t_stop = time.monotonic()
                stop_at = (it, at_v3, {n: st for n, st in states.items()
                                       if n not in at_v3})
            if it % UPGRADE_EVERY == UPGRADE_EVERY - 1 \
                    and len(prompts) < HANDOVER_REQUESTS \
                    and router.outstanding < HANDOVER_FIRST:
                submit()
            done = len(at_v3) == len(UPGRADE_NODES) and not any(
                node.spec.unschedulable for node in nodes.values())
            if done and rollout_s is None:
                rollout_s, rollout_iters = time.monotonic() - t_bump, it + 1
                # the new leader's tick profiles while they still hold the
                # rollout's writes (the ring keeps the last 64 ticks, and
                # watch events keep it ticking after the rollout)
                bodies["leader /profile"] = b.get("/profile")
            if done and t_stop is not None and not router.outstanding \
                    and len(prompts) >= HANDOVER_REQUESTS \
                    and len(fleet.pool.admitting()) == len(UPGRADE_NODES):
                break
            time.sleep(max(0.0, HANDOVER_MIN_ITER_S
                           - (time.monotonic() - t_it)))
        else:
            raise SmokeFailure(f"{tag}: the rollout and its requests did "
                               f"not finish in {HANDOVER_MAX_ITERS} "
                               f"iterations (stopped at {stop_at})")
        fleet.tick()
        fleet.check_delivery(tag)
        a.join(tag)
        b.wait_for(lambda: "tpu_operator_leader 1" in b.get("/metrics")[1],
                   "the new leader's /metrics never read leader 1", tag)
        for path in ("/metrics", "/healthz", "/resilience"):
            bodies[f"leader {path}"] = b.get(path)
        bodies["stopped leader"] = dict(a.server.snapshot)
    finally:
        for inst in instances:
            inst.stop.set()
        for inst in instances:
            if inst.thread.ident is not None:
                inst.thread.join(HANDOVER_WAIT_S)
        GPUOperator.reconcile = real_reconcile
        errors.close()
        root_log.setLevel(root_state[0])
        root_log.handlers[:] = root_state[1]
        api.stop()
    b.join(tag)
    # the DaemonSet controller (this loop) runs beside the operators, not
    # between their ticks as in 3f: a tick that reads a driver pod deleted
    # and not yet recreated fails its build_state and the next tick
    # retries, as on a cluster whose controller lags. Any other error
    # fails the phase
    lagged = [r for r in errors.records
              if "should not have Unscheduled pods" in r]
    others = [r for r in errors.records if r not in lagged]
    check(not others, f"{tag}: the operators logged errors: {others[:5]}")
    check(not port_threads.live_threads("leader-elector")
          and not port_threads.live_threads("operator-"),
          f"{tag}: threads left running: "
          f"{port_threads.live_threads('leader-elector')} "
          f"{port_threads.live_threads('operator-')}")

    drivers = sorted((p.spec.node_name,
                      p.metadata.labels["controller-revision-hash"])
                     for p in direct.list_pods(namespace=UPGRADE_NS))
    check(drivers == [(n, HANDOVER_REVISION) for n in UPGRADE_NODES],
          f"{tag}: driver pods {drivers}")
    journeys = {n: journey(n)[base[n]:] for n in UPGRADE_NODES}
    for n, entries in journeys.items():
        check(tuple(st for st, _t in entries) == UPGRADE_ORDER,
              f"{tag}: {n}'s journey at {HANDOVER_REVISION} "
              f"{[st for st, _t in entries]}")
    check(holders == list(HANDOVER_IDS),
          f"{tag}: lease holders {holders}, want one change "
          f"{' -> '.join(HANDOVER_IDS)}")
    ta, tb = ticks[a.identity], ticks[b.identity]
    check(ta and tb and ta[-1][1] <= tb[0][0] and tb[0][0] > t_stop,
          f"{tag}: the two instances' reconciles overlap or the standby "
          f"reconciled before the leader stopped")
    handover_s = tb[0][0] - t_stop
    profile = json.loads(bodies["leader /profile"][1])["data"]
    calls = profile["aggregate"]["api_calls"]
    check(bodies["leader /profile"][0] == 200 and profile["ticks_profiled"]
          and calls and all(len(k.split()) == 2 for k in calls)
          and "patch Node" in calls,
          f"{tag}: the new leader's /profile has no apiserver calls by "
          f"verb and kind: {calls}")
    resil = [json.loads(bodies["leader /resilience"][1])["data"],
             json.loads(bodies["stopped leader"]["resilience"])["data"]]
    check(all(r["breaker"] == "closed" and r["breaker_opened_total"] == 0
              for r in resil), f"{tag}: the breaker opened: {resil}")
    crds = sorted(c["metadata"]["name"] for c in cluster.list_crds())
    check({"tpuslicepolicies.tpu.dev", "tpuworkloads.tpu.dev"} <= set(crds),
          f"{tag}: CRDs {crds}")
    migrations = router.migration_successes - migrations0
    fallbacks = router.migration_fallbacks - fallbacks0
    check(migrations >= 2 and fallbacks == 0,
          f"{tag}: {migrations} live migrations, {fallbacks} fallbacks")
    steps = fleet.decode_steps() - steps0
    launches = attn_launches() - launches0
    check(launches == cfg.n_layers * steps > 0,
          f"{tag}: A-K4 launched {launches} times over {steps} decode steps "
          f"of {cfg.n_layers} layers")
    per_replica = {}
    for srv, rep in zip(fleet.batchers, fleet.batcher_ids):
        s0, n0 = decode0.get(rep, (0.0, 0))
        n = srv.decode_steps - n0
        per_replica[rep] = ((1e3 * (srv.decode_seconds - s0) / n
                             if n else None), n)
    a_profile = json.loads(bodies["stopped leader"]["profile"])["data"]
    return {"prompts": prompts, "ticks": ticks, "handover_s": handover_s,
            "stop_at": stop_at, "rollout_s": rollout_s,
            "rollout_iters": rollout_iters, "iterations": it + 1,
            "journeys": journeys, "holders": holders,
            "calls_per_tick": {a.identity: a_profile["aggregate"],
                               b.identity: profile["aggregate"]},
            "migrations": migrations, "fallbacks": fallbacks,
            "launches": launches, "steps": steps, "crds": crds,
            "per_replica": per_replica, "resilience": resil,
            "seen_states": seen_states, "lagged_ticks": len(lagged)}


def handover_log(out, tag):
    """Phase 3h's figures, one line each."""
    log(f"{tag}: two operator binaries (python -m "
        f"k8s_operator_libs_tpu_torch.operator --watch --leader-elect "
        f"--profile --ensure-crds, interval {HANDOVER_INTERVAL} s) over the "
        f"port's FakeAPIServer, through the informer cache and the "
        f"resilient client, rolled {UPGRADE_DS} to {HANDOVER_REVISION}; "
        f"lease holders {' -> '.join(out['holders'])}; the leader stopped "
        f"at iteration {out['stop_at'][0]} (at {HANDOVER_REVISION}: "
        f"{out['stop_at'][1]}, on the way: {out['stop_at'][2]}); CRDs "
        f"{out['crds']}; breaker closed, never opened; "
        f"{out['lagged_ticks']} ticks retried after reading a driver pod "
        f"the DaemonSet controller had not yet recreated, no other error")
    log(f"{tag}: handover {out['handover_s']:.3f} s from the leader's stop "
        f"to the standby's first reconcile as leader; rollout wall "
        f"{out['rollout_s']:.3f} s ({out['rollout_iters']} iterations, "
        f"{out['iterations']} in all)")
    per_state, per_node = {}, {}
    for n, entries in out["journeys"].items():
        per_node[n] = entries[-1][1] - entries[0][1]
        for (state, t), (_next, t_next) in zip(entries, entries[1:]):
            per_state.setdefault(state, []).append(t_next - t)
    log(f"{tag}: seconds per node (journey): " + ", ".join(
        f"{n} {s:.3f}" for n, s in per_node.items()))
    log(f"{tag}: seconds per state (journey; per node): " + "; ".join(
        f"{state} " + "/".join(f"{v:.3f}" for v in vs)
        for state, vs in per_state.items()))
    for ident, spans in out["ticks"].items():
        ms = sorted(1e3 * (t1 - t0) for t0, t1 in spans)
        agg = out["calls_per_tick"][ident]
        per_tick = {k: round(v / agg["ticks"], 2)
                    for k, v in sorted(agg["api_calls"].items())} \
            if agg["ticks"] else {}
        log(f"{tag}: {ident}: {len(ms)} binary ticks, ms per tick median "
            f"{ms[len(ms) // 2]:.3f}, max {ms[-1]:.3f} (GPUOperator."
            f"reconcile over HTTP, host wall); apiserver calls per tick "
            f"(last {agg['ticks']} profiled): {per_tick}")
    log(f"{tag}: ms per decode step per replica (4 slots): " + ", ".join(
        f"{rep} {'-' if ms is None else f'{ms:.2f}'} ({n} steps)"
        for rep, (ms, n) in out["per_replica"].items() if n))
    log(f"{tag}: {len(out['prompts'])} requests delivered once, gapless; "
        f"{out['migrations']} live migrations, {out['fallbacks']} "
        f"fallbacks; A-K4 launches {out['launches']} = "
        f"{out['launches'] // max(1, out['steps'])} x {out['steps']} "
        f"decode steps")
    return per_node, per_state


def phase_handover(torch, params, cfg, rig):
    """Phase 3h: the operator binary's leader handover over a rolling
    driver upgrade on phase 3g's rig; every request's tokens against a
    batched ``generate`` by the near-tie rule."""
    from k8s_operator_libs_tpu_torch.models.generate import generate

    out = leader_handover(torch, rig, cfg, "phase 3h")
    router = rig.fleet.router
    rids = sorted(out["prompts"])
    with torch.no_grad():
        want = generate(params, torch.as_tensor(
            [out["prompts"][r] for r in rids], device="cuda"), cfg,
            max_new_tokens=MAX_NEW).cpu().tolist()
    verdicts = []
    for rid, w in zip(rids, want):
        gaps = top2_gaps(torch, params, cfg, w, HANDOVER_LEN)
        ok, what, _ = near_tie_verdict(router.result(rid), w, gaps,
                                       HANDOVER_LEN)
        check(ok, f"phase 3h request {rid}: {what}")
        verdicts.append(what)
    per_node, _ = handover_log(out, "phase 3h")
    for line in verdicts:
        log(f"phase 3h: tokens: {line}")
    stats = {"handover_launches": out["launches"],
             "handover_decode_steps": out["steps"],
             "handover_s": out["handover_s"],
             "handover_rollout_s": out["rollout_s"],
             "handover_node_s": per_node,
             "handover_migrations": out["migrations"],
             "handover_fallbacks": out["fallbacks"]}
    for ident, spans in out["ticks"].items():
        ms = sorted(1e3 * (t1 - t0) for t0, t1 in spans)
        agg = out["calls_per_tick"][ident]
        stats[f"handover_{ident}_tick_ms_median"] = ms[len(ms) // 2]
        stats[f"handover_{ident}_tick_ms_max"] = ms[-1]
        stats[f"handover_{ident}_calls_per_tick"] = (
            sum(agg["api_calls"].values()) / agg["ticks"]
            if agg["ticks"] else None)
    return stats


def phase_upgrade_fp32(torch):
    """Phases 3f, 3g and 3h's fp32 twin: Llama-3-8B width at
    FLEET32_LAYERS layers, three port replicas, the same schedules (the
    rolling upgrade, the quarantine and repair, then the operator
    binary's leader handover over the next rollout); every request's
    tokens equal the contiguous ``generate``'s."""
    import numpy as np

    from k8s_operator_libs_tpu_torch.models.generate import generate
    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          init_params)
    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=FLEET32_LAYERS, dtype=torch.float32)
    params = init_params(cfg, seed=3, device="cuda")
    gen = np.random.default_rng(3)
    prompts = [gen.integers(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    attn.reset_launch_counts()
    out = rolling_upgrade(torch, params, cfg, prompts, [], "phase 3f fp32")
    router = out["fleet"].router
    launches = attn.LAUNCHES["paged_decode"]
    steps = out["fleet"].decode_steps()
    check(launches == cfg.n_layers * steps > 0,
          f"fp32 twin: A-K4 launched {launches} times over {steps} steps")
    with torch.no_grad():
        for rid, (kind, k) in out["which"].items():
            p = prompts[k] if kind == "old" else out["fresh"][k]
            want = generate(params, torch.as_tensor([p], device="cuda"),
                            cfg, max_new_tokens=MAX_NEW)[0].tolist()
            got = router.result(rid)
            i = first_mismatch(got, want)
            check(i is None and len(got) == len(want),
                  f"phase 3f fp32 prompt {len(p)}: token "
                  f"{None if i is None else i - len(p)} differs from the "
                  f"contiguous generate")
    log(f"phase 3f fp32: 3 port replicas (Llama-3-8B width, "
        f"{FLEET32_LAYERS} layers, fp32), the same rolling upgrade: "
        f"{router.migration_successes} live migrations, "
        f"{router.migration_fallbacks} fallbacks; all {len(out['which'])} "
        f"requests token-identical to the contiguous generate; A-K4 "
        f"launches {launches} = {cfg.n_layers} x {steps}")
    rig = out["rig"]
    health = quarantine_repair(torch, rig, cfg, "phase 3g fp32")
    with torch.no_grad():
        for rid, p in health["prompts"].items():
            want = generate(params, torch.as_tensor([p], device="cuda"),
                            cfg, max_new_tokens=MAX_NEW)[0].tolist()
            got = router.result(rid)
            i = first_mismatch(got, want)
            check(i is None and len(got) == len(want),
                  f"phase 3g fp32 request {rid}: token "
                  f"{None if i is None else i - len(p)} differs from the "
                  f"contiguous generate")
    log(f"phase 3g fp32: the same quarantine and repair: "
        f"{health['migrations']} live migrations, {health['fallbacks']} "
        f"fallbacks; all {len(health['prompts'])} requests token-identical "
        f"to the contiguous generate; A-K4 launches {health['launches']} = "
        f"{cfg.n_layers} x {health['steps']}")
    handover = leader_handover(torch, rig, cfg, "phase 3h fp32")
    with torch.no_grad():
        for rid, p in handover["prompts"].items():
            want = generate(params, torch.as_tensor([p], device="cuda"),
                            cfg, max_new_tokens=MAX_NEW)[0].tolist()
            got = router.result(rid)
            i = first_mismatch(got, want)
            check(i is None and len(got) == len(want),
                  f"phase 3h fp32 request {rid}: token "
                  f"{None if i is None else i - len(p)} differs from the "
                  f"contiguous generate")
    handover_log(handover, "phase 3h fp32")
    log(f"phase 3h fp32: all {len(handover['prompts'])} requests "
        f"token-identical to the contiguous generate")
    rig.close()
    stats = {"upgrade32_migrations": router.migration_successes,
             "upgrade32_launches": launches,
             "health32_migrations": health["migrations"],
             "health32_launches": health["launches"],
             "handover32_migrations": handover["migrations"],
             "handover32_launches": handover["launches"],
             "handover32_s": handover["handover_s"]}
    del out, router, params, rig, health, handover
    return stats


# phase 3e: the router binary. Nodes; A's streams' tokens before A
# freezes; the router's tick; the market burst: requests kept in flight,
# their prompt length and new tokens; the arbiter's tick and its
# goodput stand-in (no trainer runs in this phase)
ROUTER_NODES = ("node-a", "node-b", "node-c")
ROUTER_DRAIN_AFTER, ROUTER_TICK = 2, 0.1
BURST_INFLIGHT, BURST_LEN, BURST_NEW = 8, 32, 8
MARKET_TICK, GOODPUT_STANDIN = 0.1, 1.0
ROUTER_TIMEOUT = 300.0


def histogram_quantiles(text, family, qs):
    """Upper bucket bounds holding the quantiles ``qs`` of a histogram
    family in Prometheus text, its series summed; (bounds, count)."""
    cum = {}
    for m in re.finditer(rf'^{family}_bucket{{.*le="([^"]+)"}} (\S+)$',
                         text, re.M):
        le = float("inf") if m.group(1) == "+Inf" else float(m.group(1))
        cum[le] = cum.get(le, 0.0) + float(m.group(2))
    if not cum:
        return [None] * len(qs), 0
    total = cum[float("inf")]
    bounds = [next(le for le in sorted(cum) if cum[le] >= q * total)
              for q in qs]
    return bounds, int(total)


def phase_router(torch, params, cfg, prompts, plain_tokens):
    """Phase 3e: the port's router binary (``router.py``, started through
    its ``main`` with ``--kubeconfig`` to the port's ``FakeAPIServer``) in front
    of two port replicas; node A's label drains A and the relay splices
    A's streams onto B; then a burst makes the port's capacity arbiter
    trade the training slice on node C to serving and back."""
    import logging

    import numpy as np

    from k8s_operator_libs_tpu_torch import router as router_bin
    from k8s_operator_libs_tpu_torch.core import FakeCluster
    from k8s_operator_libs_tpu_torch.core.client import ClientEventRecorder
    from k8s_operator_libs_tpu_torch.core.httpapi import FakeAPIServer
    from k8s_operator_libs_tpu_torch.core.liveclient import (KubeConfig,
                                                             KubeHTTP,
                                                             LiveClient)
    from k8s_operator_libs_tpu_torch.market import (CapacityArbiter,
                                                    HTTPLaneDemand,
                                                    ManagedSlice,
                                                    MarketConfig)
    from k8s_operator_libs_tpu_torch.models.generate import generate
    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn
    from k8s_operator_libs_tpu_torch.serving import LANES
    from k8s_operator_libs_tpu_torch.serving.pool import parse_gauges
    from k8s_operator_libs_tpu_torch.server import ServingRuntime
    from k8s_operator_libs_tpu_torch.upgrade import KeyFactory, UpgradeState
    from k8s_operator_libs_tpu_torch.utils import threads
    from k8s_operator_libs_tpu_torch.wire import (DRAIN_INTENT_ANNOTATION,
                                                  MARKET_DECISION_ANNOTATION,
                                                  MARKET_LEASE_ANNOTATION,
                                                  MARKET_OWNER_LABEL)

    t_phase = time.monotonic()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_router"
    work.mkdir(parents=True, exist_ok=True)
    cluster = FakeCluster()
    for node in ROUTER_NODES:
        cluster.add_node(node)
    api = FakeAPIServer(cluster).start()
    direct = cluster.client.direct()
    kubeconfig = work / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "current-context": "smoke",
        "contexts": [{"name": "smoke", "context": {"cluster": "smoke",
                                                   "user": "smoke"}}],
        "clusters": [{"name": "smoke", "cluster": {"server": api.base_url}}],
        "users": [{"name": "smoke", "user": {}}]}))
    attn.reset_launch_counts()
    reps = {}                       # node -> (runtime, httpd, thread, url)

    def start_replica(node):
        rt = ServingRuntime(params, cfg, max_slots=SLOTS, capacity=CAPACITY,
                            block_size=BS, chunk=1, drain_hold_s=60.0)
        reps[node] = (rt,) + serve_http(rt)
        return reps[node]

    rt_a, *_, base_a = start_replica("node-a")
    rt_b, *_, base_b = start_replica("node-b")
    gate = rt_a.srv = GatedBatcher(rt_a.srv, None)

    # instruments around the binary's own code: its tick and its
    # export/adopt hops (the relay's default transport), restored after
    tick_ms, hops = [], []
    real_tick, real_post = router_bin.RouterFront.tick, \
        router_bin.http_post_json

    def timed_tick(front):
        t0 = time.monotonic()
        real_tick(front)
        tick_ms.append(1e3 * (time.monotonic() - t0))

    def timed_post(url, payload, timeout):
        t0 = time.monotonic()
        out = real_post(url, payload, timeout)
        ms = 1e3 * (time.monotonic() - t0)
        op = url.rsplit("/", 1)[-1]
        if op in ("export", "adopt"):
            kv = (out["data"] if op == "export" else payload)["kv"]
            hops.append({"op": op, "ms": ms, "kv_bytes": sum(
                len(kv[k]["b64"]) * 3 // 4 for k in ("k", "v"))})
        return out

    class TickFailures(logging.Handler):
        def __init__(self):
            super().__init__(logging.ERROR)
            self.failed = []

        def emit(self, record):
            if "router tick failed" in record.getMessage():
                self.failed.append(record.getMessage())

    failures = TickFailures()
    router_log = logging.getLogger("tpu-router")
    root = logging.getLogger()
    root_state = (root.level, list(root.handlers))
    router_log.addHandler(failures)
    router_bin.RouterFront.tick = timed_tick
    router_bin.http_post_json = timed_post
    box, ready = {}, threading.Event()

    def on_ready(httpd):
        box["httpd"] = httpd
        ready.set()

    def run_binary():
        try:
            box["rc"] = router_bin.main(
                ["--port", "0", "--kubeconfig", str(kubeconfig), "--tick",
                 str(ROUTER_TICK), "--replica", f"a={base_a}@node-a",
                 "--replica", f"b={base_b}@node-b"], on_ready=on_ready)
        except Exception as exc:   # reported below as a failed phase
            box["error"] = repr(exc)
            ready.set()

    binary = threading.Thread(target=run_binary, daemon=True)
    binary.start()
    market_stop, burst_stop = threading.Event(), threading.Event()
    market_thread = None
    try:
        check(ready.wait(60) and "httpd" in box,
              f"the router binary did not start ({box.get('error')})")
        base = f"http://127.0.0.1:{box['httpd'].server_address[1]}"
        deadline = time.monotonic() + 60
        while get(base + "/replicas")[1]["data"]["summary"][
                "admitting"] != 2:
            check(time.monotonic() < deadline, "the router never admitted "
                  "both replicas")
            time.sleep(0.05)

        # --- phase 3's prompts stream through the router, in the lanes
        lanes = [LANES[k % len(LANES)] for k in range(len(prompts))]
        t_sent = time.monotonic()
        streams = [SSEReader(base + "/generate",
                             {"tokens": p, "max_new": MAX_NEW,
                              "stream": True, "lane": lane})
                   for p, lane in zip(prompts, lanes)]
        first_token_t = [None] * len(streams)

        def watch_first():
            for i, s in enumerate(streams):
                if first_token_t[i] is None and s.tokens():
                    first_token_t[i] = time.monotonic()

        while min(len(s.tokens()) for s in streams) < ROUTER_DRAIN_AFTER:
            watch_first()
            check(all(s.is_alive() or s.events for s in streams)
                  and time.monotonic() - t_sent < ROUTER_TIMEOUT,
                  f"a stream stopped early: {[s.error for s in streams]}")
            time.sleep(0.005)
        watch_first()
        # A freezes after at most one more step (its stepper then idles
        # with the lock free), so its streams are in flight when its
        # node's label flips; the step that froze it ends before the lock
        # is ours
        gate.left = 1
        while gate.left != 0:
            check(time.monotonic() - t_sent < ROUTER_TIMEOUT,
                  "replica A never froze")
            time.sleep(0.005)
        with rt_a.lock:
            on_a = rt_a.srv.decode_steps
        state_label = KeyFactory("libtpu").state_label
        direct.patch_node_metadata(
            "node-a", labels={state_label: UpgradeState.CORDON_REQUIRED})
        t_flip = time.monotonic()
        for s in streams:
            s.finish("phase 3e stream")
        streams_done = time.monotonic()
        code_a, _ = get_code(base_a + "/healthz")
        intent_a = dict(direct.get_node("node-a").metadata.annotations)

        # --- the market: a burst on one admitting replica preempts the
        # slice on node C, served by a third replica, and returns it
        routes = {"grant_ms": None}
        client = LiveClient(KubeHTTP(KubeConfig.from_kubeconfig(
            str(kubeconfig))))

        def grant(ms):
            # the arbiter logs a raising hook and carries on: keep the
            # error for the phase to fail on
            try:
                t0 = time.monotonic()
                rt_c, *_, base_c = start_replica(ms.anchor)
                code, body = post(base + "/register", {
                    "id": "c", "url": base_c, "node": ms.anchor})
                check(code == 200, f"/register returned {code}: {body}")
                routes["grant_ms"] = 1e3 * (time.monotonic() - t0)
                routes["c"] = (rt_c, base_c)
            except Exception as exc:   # reported below as a failed phase
                routes["error"] = repr(exc)

        def c_gauges():
            _, text = get_text(routes["c"][1] + "/metrics")
            return parse_gauges(text)

        def revoke(ms):
            # serving leaves the slice: C stops admitting, the router's
            # drain watch reads it off C's metrics and drains it (no
            # admission, the drain intent stamped), and C runs dry
            try:
                if not routes.get("drain_posted"):
                    code, _ = post(routes["c"][1] + "/drain", {})
                    check(code == 200, f"C /drain returned {code}")
                    routes["drain_posted"] = time.monotonic()
                view = {r["id"]: r for r in get(base + "/replicas")[1][
                    "data"]["replicas"]}
                g = c_gauges()
                return (view["c"]["draining"]
                        and g.get("tpu_workload_serve_slots_busy", 1) == 0
                        and g.get("tpu_workload_serve_queue_depth", 1) == 0)
            except Exception as exc:   # reported below as a failed phase
                routes["error"] = repr(exc)
                return False

        arb = CapacityArbiter(
            [ManagedSlice("train-c", ["node-c"])], client=client,
            demand=HTTPLaneDemand(base),
            goodput_fn=lambda: GOODPUT_STANDIN, grant=grant, revoke=revoke,
            recorder=ClientEventRecorder(client),
            config=MarketConfig(preempt_rate=1.0, return_rate=0.25,
                                sustain_ticks=2, cooldown_seconds=1.0,
                                queue_high=1.0))
        market_log = []

        def market_loop():
            try:
                while not market_stop.is_set():
                    decision = arb.tick()
                    if decision is not None:
                        market_log.append(decision)
                    market_stop.wait(MARKET_TICK)
            except Exception as exc:   # reported below as a failed phase
                market_log.append({"error": repr(exc)})

        market_thread = threading.Thread(target=market_loop, daemon=True)
        market_thread.start()
        gen = np.random.default_rng(5)
        burst, burst_lock = [], threading.Lock()

        def burst_client():
            while not burst_stop.is_set():
                with burst_lock:
                    prompt = gen.integers(0, cfg.vocab_size,
                                          size=BURST_LEN).tolist()
                try:
                    code, body = post(base + "/generate", {
                        "tokens": prompt, "max_new": BURST_NEW,
                        "lane": "interactive"})
                except Exception as exc:   # reported below
                    code, body = None, {"error": repr(exc)}
                with burst_lock:
                    burst.append((prompt, code, body))

        t_burst = time.monotonic()
        burst_threads = [threading.Thread(target=burst_client, daemon=True)
                         for _ in range(BURST_INFLIGHT)]
        for t in burst_threads:
            t.start()
        while True:
            served_c = ("c" in routes
                        and routes["c"][0].reqtrace.closed > 0)
            if served_c:
                break
            check(time.monotonic() - t_burst < ROUTER_TIMEOUT
                  and "error" not in routes
                  and not any("error" in d for d in market_log),
                  f"no request completed on a replica of node C "
                  f"(decisions {market_log}, {routes.get('error')})")
            time.sleep(0.02)
        burst_stop.set()
        for t in burst_threads:
            t.join(timeout=ROUTER_TIMEOUT)
        t_burst_end = time.monotonic()
        while arb.supply[0].phase != "training" or arb.returns < 1:
            check(time.monotonic() - t_burst_end < ROUTER_TIMEOUT
                  and "error" not in routes
                  and not any("error" in d for d in market_log),
                  f"the slice never came back (decisions {market_log}, "
                  f"{routes.get('error')})")
            time.sleep(0.02)
        market_stop.set()
        market_thread.join(timeout=30)
        t_returned = time.monotonic()
        node_c = direct.get_node("node-c").metadata
        labels_c, annotations_c = (dict(node_c.labels),
                                   dict(node_c.annotations))
        # the gauges refresh on the ticker: wait for the one that counts
        # the last completion
        want_done = len(streams) + len(burst)
        while True:
            _, metrics_text = get_text(base + "/metrics")
            if parse_gauges(metrics_text).get(
                    "tpu_router_requests_completed") == want_done or \
                    time.monotonic() - t_returned > 30:
                break
            time.sleep(ROUTER_TICK)
        _, lanes_view = get(base + "/lanes")
    finally:
        burst_stop.set()
        market_stop.set()
        if market_thread is not None:
            market_thread.join(timeout=30)
        if "httpd" in box:
            box["httpd"].shutdown()
        binary.join(timeout=30)
        router_bin.RouterFront.tick = real_tick
        router_bin.http_post_json = real_post
        router_log.removeHandler(failures)
        root.setLevel(root_state[0])
        root.handlers[:] = root_state[1]
        for rt, httpd, thread, _ in reps.values():
            close_http(httpd, thread, rt)
        api.stop()
    check(not binary.is_alive() and box.get("rc") == 0
          and not threads.live_threads("router-ticker"),
          "the router binary's ticker did not stop and join")
    check(not failures.failed, f"router ticks failed: {failures.failed}")
    wall = time.monotonic() - t_phase
    gauges = parse_gauges(metrics_text)
    launches = attn.LAUNCHES["paged_decode"]
    batchers = {node: rep[0].srv for node, rep in reps.items()}
    steps = {node: b.decode_steps for node, b in batchers.items()}

    # --- the drain and the splice
    check(code_a == 503, f"A's /healthz read {code_a} after the drain")
    check(intent_a.get(DRAIN_INTENT_ANNOTATION, "").startswith(
        "upgrade:cordon-required@"),
        f"no drain intent on node-a: {intent_a}")
    check(steps["node-a"] == on_a, "A decoded after its freeze")
    migrations = gauges.get("tpu_router_migration_success", 0)
    fallbacks = gauges.get("tpu_router_migration_fallbacks", -1)
    check(migrations >= 1 and fallbacks == 0,
          f"{migrations} live migrations, {fallbacks} fallbacks")
    verdicts = []
    for k, s in enumerate(streams):
        toks = s.tokens()
        check([e["seq"] for e in toks] == list(range(MAX_NEW))
              and s.events[-1].get("done")
              and s.events[-1]["tokens"] == prompts[k]
              + [e["token"] for e in toks],
              f"phase 3e stream {k}: not gapless or its tokens differ "
              f"from its done event")
        got = s.events[-1]["tokens"]
        gaps = top2_gaps(torch, params, cfg, plain_tokens[k],
                         len(prompts[k]))
        ok, what, _ = near_tie_verdict(got, plain_tokens[k], gaps,
                                       len(prompts[k]))
        check(ok, f"phase 3e stream {k} ({lanes[k]}): {what}")
        verdicts.append(f"{lanes[k]} prompt {len(prompts[k])}: {what}")

    # --- the market and the burst
    actions = [d.get("action") for d in market_log]
    check(actions == ["preempt", "grant", "return", "returned"],
          f"market decisions {market_log}")
    check(labels_c.get(MARKET_OWNER_LABEL) == "training"
          and annotations_c.get(MARKET_LEASE_ANNOTATION, "").startswith(
              f"training:{market_log[-1]['id']}@")
          and json.loads(annotations_c.get(MARKET_DECISION_ANNOTATION,
                                           "{}")).get("action") == "returned",
          f"node-c's market keys: {labels_c} {annotations_c}")
    reasons = [e.reason for e in cluster.recorder.events]
    check(reasons.count("MarketTrade") == 1
          and reasons.count("MarketReturn") == 1,
          f"market events on the apiserver: {reasons}")
    check(all(code == 200 and len(body["tokens"]) == BURST_LEN + BURST_NEW
              and body["tokens"][:BURST_LEN] == prompt
              for prompt, code, body in burst),
          f"a burst request failed: "
          f"{[b for _, c, b in burst if c != 200][:3]}")
    served_on_c = reps["node-c"][0].reqtrace.closed
    check(served_on_c >= 1, "no request completed on node C's replica")
    completed = gauges.get("tpu_router_requests_completed")
    check(completed == len(streams) + len(burst)
          and gauges.get("tpu_router_requests_rerouted") == 0,
          f"router completed {completed} of {len(streams) + len(burst)} "
          f"requests, rerouted {gauges.get('tpu_router_requests_rerouted')}")
    with torch.no_grad():
        want = generate(params, torch.as_tensor([p for p, _, _ in burst],
                                                device="cuda"),
                        cfg, max_new_tokens=BURST_NEW).cpu().tolist()
    differ = 0
    for (prompt, _, body), w in zip(burst, want):
        if body["tokens"] == w:
            continue
        differ += 1
        ok, what, _ = near_tie_verdict(
            body["tokens"], w, top2_gaps(torch, params, cfg, w, BURST_LEN),
            BURST_LEN)
        check(ok, f"phase 3e burst request: {what}")
    total_steps = sum(steps.values())
    check(launches == cfg.n_layers * total_steps > 0
          and steps["node-c"] > 0,
          f"A-K4 launched {launches} times over {steps} decode steps of "
          f"{cfg.n_layers} layers")

    ttft = {}
    for k, t in enumerate(first_token_t):
        ttft.setdefault(lanes[k], []).append(t - t_sent)
    (p50, p99), n_over = histogram_quantiles(
        metrics_text, "tpu_router_proxy_overhead_seconds", (0.5, 0.99))
    per_replica = {node: (1e3 * b.decode_seconds / b.decode_steps
                          if b.decode_steps else None, b.decode_steps)
                   for node, b in batchers.items()}
    ticks = sorted(tick_ms)
    log(f"phase 3e: the port's router binary (router.main, --kubeconfig "
        f"to the port's FakeAPIServer, tick {ROUTER_TICK} s) in front of 2 "
        f"port replicas (Llama-3-8B, all {cfg.n_layers} layers); phase 3's "
        f"{len(streams)} prompts streamed in lanes {', '.join(lanes)}; "
        f"node-a's label turned cordon-required "
        f"{1e3 * (t_flip - t_sent):.0f} ms after the first request: A "
        f"drained (/healthz 503, intent "
        f"{intent_a[DRAIN_INTENT_ANNOTATION]}), {migrations:g} live "
        f"migrations, {fallbacks:g} fallbacks, every stream gapless, done "
        f"{1e3 * (streams_done - t_flip):.0f} ms after the flip")
    for line in verdicts:
        log(f"phase 3e: tokens: {line}")
    for hop in hops:
        log(f"phase 3e: {hop['op']} over HTTP {hop['ms']:.2f} ms, "
            f"{hop['kv_bytes']} KV bytes")
    log(f"phase 3e: market: goodput_fn is the constant "
        f"{GOODPUT_STANDIN} (a stand-in: no trainer in this phase); "
        f"{len(burst)} burst requests ({BURST_INFLIGHT} in flight, prompt "
        f"{BURST_LEN}, {BURST_NEW} new; {differ} off the batched generate, "
        f"each within the near-tie rule); replica on node-c up and "
        f"registered in {routes['grant_ms']:.0f} ms, served {served_on_c} "
        f"requests; slice back with training "
        f"{1e3 * (t_returned - t_burst_end):.0f} ms after the burst ended")
    for d in market_log:
        log(f"phase 3e: market decision #{d['id']} {d['action']} "
            f"{d['slice']}: rate {d['rate']}, pressure {d['pressure']}, "
            f"value {d['value']} ({d['reason']})")
    log(f"phase 3e: node-c {MARKET_OWNER_LABEL}="
        f"{labels_c[MARKET_OWNER_LABEL]}, {MARKET_LEASE_ANNOTATION}="
        f"{annotations_c[MARKET_LEASE_ANNOTATION]}; events "
        f"{', '.join(reasons)}")
    log(f"phase 3e: A-K4 launches {launches} = {cfg.n_layers} x "
        f"{total_steps} decode steps ({', '.join(f'{n} {v}' for n, v in steps.items())})")
    log(f"phase 3e: ms per router tick median {ticks[len(ticks) // 2]:.3f}, "
        f"mean {sum(ticks) / len(ticks):.3f}, max {ticks[-1]:.3f} over "
        f"{len(ticks)} ticks (host wall: node reads over HTTP, scrapes, "
        f"drain watch)")
    log(f"phase 3e: tpu_router_proxy_overhead_seconds over {n_over} "
        f"requests: p50 <= {p50} s, p99 <= {p99} s (bucket bounds)")
    log("phase 3e: TTFT per lane through the router (client wall from the "
        "POST to the first token event seen): " + ", ".join(
            f"{lane} {1e3 * sum(v) / len(v):.1f} ms (n {len(v)})"
            for lane, v in ttft.items()))
    log("phase 3e: ms per decode step per replica (4 slots): " + ", ".join(
        f"{node} {'-' if ms is None else f'{ms:.2f}'} ({n} steps)"
        for node, (ms, n) in per_replica.items()))
    log(f"phase 3e: lanes at the end {json.dumps(lanes_view['data'])}")
    log(f"phase 3e: wall {wall:.1f} s (with the reference tokens)")
    exports = [h for h in hops if h["op"] == "export"]
    adopts = [h for h in hops if h["op"] == "adopt"]
    return {"router_launches": launches, "router_decode_steps": total_steps,
            "router_migrations": migrations, "router_fallbacks": fallbacks,
            "router_tick_ms_median": ticks[len(ticks) // 2],
            "router_proxy_overhead_p50_s": p50,
            "router_proxy_overhead_p99_s": p99,
            "router_ttft_ms": {lane: 1e3 * sum(v) / len(v)
                               for lane, v in ttft.items()},
            "router_export_ms": [h["ms"] for h in exports],
            "router_adopt_ms": [h["ms"] for h in adopts],
            "router_kv_bytes": [h["kv_bytes"] for h in exports],
            "router_ms_per_decode_step": {n: ms for n, (ms, _) in
                                          per_replica.items()},
            "router_burst_requests": len(burst),
            "router_served_on_c": served_on_c,
            "router_market_rates": [d["rate"] for d in market_log],
            "router_wall_s": wall}


def profile_kernels(torch, fn):
    """``torch.profiler`` kernel times of one call of ``fn``: (host wall
    ms under the profiler, [(device ms, count, kernel name)])."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
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
    return wall_ms, kernels


def profile_decode(torch, srv, n, phase="phase 3"):
    """Where one batcher chunk of ``n`` decode ticks spends the card's
    time: ``torch.profiler`` kernel times (device busy, its share of the
    host wall, the paged-decode kernel's share) and the top kernels. The
    profiler slows the host, so the wall here is above the unprofiled
    ms per step; this is a breakdown, not a timing."""
    wall_ms, kernels = profile_kernels(torch, lambda: srv.step(n))
    busy = sum(ms for ms, _, _ in kernels)
    if not busy:
        log(f"{phase}: profile: no device time recorded (not measured)")
        return {}
    attn_ms = sum(ms for ms, _, key in kernels if "paged_decode" in key)
    log(f"{phase}: profile of one {n}-tick chunk: wall {wall_ms:.2f} ms "
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

    # (c) phase 4c: the speculative batcher (self-int8 draft, its draft
    # steps through A-K4) against the plain batcher of (a)
    from k8s_operator_libs_tpu_torch.models.quant import (
        paged_quantized_generate, quantize_params)
    attn.reset_launch_counts()
    spec = ContinuousBatcher(params, cfg, max_slots=SLOTS,
                             capacity_per_slot=CAPACITY, block_size=BS,
                             draft="self-int8", spec_k=SPEC_K)
    spec_rids = [spec.submit(p, MAX_NEW) for p in prompts]
    spec_out = {}
    while not spec.idle:
        spec.step(CHUNK)
        spec_out.update(spec.poll())
    launches_spec = attn.LAUNCHES["paged_decode"]
    check(launches_spec == cfg.n_layers * (
        (SPEC_K + 1) * spec.spec_rounds + spec.decode_steps) > 0
        and spec.spec_rounds > 0,
        f"A-K4 launched {launches_spec} times over {spec.spec_rounds} "
        f"rounds and {spec.decode_steps} plain steps")
    mism = []
    for rid, srid, p in zip(rids, spec_rids, prompts):
        i = first_mismatch(spec_out[srid].tolist(), out[rid].tolist())
        if i is not None:
            gap = logit_gap(torch, params, cfg, out[rid][:i].tolist())
            mism.append(f"speculative batcher prompt {len(p)}: token "
                        f"{i - len(p)} differs, plain top-2 logit gap "
                        f"there {gap:.3e}")
    failures += mism
    log(f"phase 4c: speculative batcher (self-int8 draft, k {SPEC_K}, "
        f"{spec.spec_rounds} rounds, {spec.spec_accepted} drafts "
        f"accepted, A-K4 {launches_spec} launches) vs the batcher of 4a, "
        f"fp32: {'identical' if not mism else 'MISMATCH'}")
    del spec

    # (d) phase 4c: int8 weights + int8 KV through A-K5 against the same
    # call with the plain decode attention
    qparams = quantize_params(params)
    attn.reset_launch_counts()
    got = paged_quantized_generate(qparams, prompt_t, cfg,
                                   max_new_tokens=MAX_NEW,
                                   prompt_lengths=plens, block_size=BS,
                                   kv_int8=True).cpu().numpy()
    launches_q = attn.LAUNCHES["paged_decode_int8"]
    check(launches_q == cfg.n_layers * (MAX_NEW - 1),
          f"A-K5 launched {launches_q} times under int8 weights, expected "
          f"{cfg.n_layers * (MAX_NEW - 1)}")
    ref = paged_quantized_generate(
        qparams, prompt_t, cfg, max_new_tokens=MAX_NEW,
        prompt_lengths=plens, block_size=BS, kv_int8=True,
        decode_attn=attn.paged_decode_plain).cpu().numpy()
    mism = [f"paged_quantized_generate(kv_int8) row {b}: token {i} differs"
            for b in range(B)
            for i in [first_mismatch(got[b, Tp:].tolist(),
                                     ref[b, Tp:].tolist())] if i is not None]
    failures += mism
    log(f"phase 4c: paged_quantized_generate(kv_int8=True), int8 weights "
        f"and KV, A-K5 ({launches_q} launches) vs plain, fp32: "
        f"{'identical' if not mism else 'MISMATCH'}")
    del qparams
    for f in failures:
        log(f"phase 4: {f}")
    check(not failures, "token parity failed")
    return {"launches_int8": launches_k5, "launches_spec_fp32": launches_spec,
            "launches_int8_weights": launches_q}


# ------------------------------------------------------------ training

TRAIN_LAYERS, TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 2, 2048, 5


def phase_train(torch):
    """Llama-3-8B width, 8 layers, bf16, remat, B 2 x T 2048 on one fixed
    batch: one warm-up step and TRAIN_STEPS timed steps through the
    trainer's step, with A-K1/A-K2/A-K3 counted."""
    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          param_count)
    from k8s_operator_libs_tpu_torch.ops import attention as fa
    from k8s_operator_libs_tpu_torch.parallel import fsdp

    cfg = LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS,
                                max_seq_len=TRAIN_T)
    # the serving phases' weights are freed when their last reference
    # goes: nothing of them may still be allocated here
    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"{held / 2**30:.1f} GiB of the earlier phases is "
                        f"still allocated")
    torch.cuda.reset_peak_memory_stats()
    state = fsdp.init_train_state(cfg, seed=0, device="cuda")
    n_params = param_count(state.params)
    step = fsdp.make_train_step(cfg)
    g = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_T + 1),
                           generator=g, device="cuda", dtype=torch.int32)
    state, m = step(state, tokens)                         # warm-up
    losses = [float(m["loss"])]
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.monotonic()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, tokens)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(fa.LAUNCHES)
    routes = dict(fa.ROUTE_LAUNCHES)
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    for name in FLASH_NAMES:
        check(launches[name] == TRAIN_LAYERS * TRAIN_STEPS,
              f"{name} launched {launches[name]} times over {TRAIN_STEPS} "
              f"steps of {TRAIN_LAYERS} layers")
    # every launch of the three (the forward's 8 per step among them) on
    # the tensor cores
    check(routes == {"wgmma": 3 * TRAIN_LAYERS * TRAIN_STEPS, "fma": 0},
          f"bf16 training took routes {routes}")
    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    ms = wall / TRAIN_STEPS * 1e3
    tokens_per_step = TRAIN_B * TRAIN_T
    # model flops per step: 6 x (matmul params: all but the embedding
    # table) x tokens, plus attention's 3 x 4 x B*H*Dh*sum_visible per
    # layer (forward + backward); remat's recompute is not counted
    matmul_params = n_params - cfg.vocab_size * cfg.d_model
    visible = TRAIN_T * (TRAIN_T + 1) // 2
    attn_flops = (12 * TRAIN_B * cfg.n_heads * cfg.head_dim * visible
                  * TRAIN_LAYERS)
    flops = 6 * matmul_params * tokens_per_step + attn_flops
    mfu = flops / (ms / 1e3) / H100_BF16_FLOPS
    log(f"phase 5: Llama-3-8B width x {TRAIN_LAYERS} layers "
        f"({n_params} params), bf16, remat, B {TRAIN_B} T {TRAIN_T}: "
        f"{ms:.1f} ms per step, {tokens_per_step / ms * 1e3:.0f} tokens/s, "
        f"model flops {flops:.4g} per step = 6 x {matmul_params} x "
        f"{tokens_per_step} + 12 x B*H*Dh*T(T+1)/2 x L -> {mfu:.2%} of "
        f"{H100_BF16_FLOPS:.3g} FLOP/s; peak memory {peak / 2**30:.1f} GiB "
        f"({held / 2**30:.1f} GiB held before the phase)")
    log(f"phase 5: losses {' '.join(f'{x:.4f}' for x in losses)} (warm-up "
        f"first); launches per step " + ", ".join(
            f"{n} {launches[n] // TRAIN_STEPS}" for n in FLASH_NAMES)
        + f", all on route wgmma ({routes['wgmma'] // TRAIN_STEPS} per step)")

    def one_step():
        nonlocal state
        state, _ = step(state, tokens)

    wall_ms, kernels = profile_kernels(torch, one_step)
    busy = sum(t for t, _, _ in kernels)
    stats = {"ms_per_step": ms, "tokens_per_s": tokens_per_step / ms * 1e3,
             "model_flops_per_step": flops, "mfu": mfu,
             "peak_memory_bytes": peak, "loss_first": losses[0],
             "loss_last": losses[-1],
             **{f"launches_{n}": launches[n] for n in FLASH_NAMES}}
    if not busy:
        log("phase 5: profile: no device time recorded (not measured)")
        return stats
    # kernel symbols: flash_fwd(_tc)_kernel, flash_bwd_dq(_tc)_kernel and
    # flash_bwd_dkv(_tc)_kernel, whichever the dtype routes to
    shares = {n: sum(t for t, _, key in kernels if k in key)
              for n, k in (("flash_forward", "flash_fwd"),
                           ("flash_bwd_dq", "flash_bwd_dq"),
                           ("flash_bwd_dkv", "flash_bwd_dkv"))}
    log(f"phase 5: profile of one step: wall {wall_ms:.1f} ms (profiled), "
        f"device busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.1%}; "
        + ", ".join(f"{n} {t:.1f} ms = {t / busy:.1%}"
                    for n, t in shares.items()))
    gemm = sum(t for t, _, key in kernels
               if any(s in key for s in ("nvjet", "gemm", "cutlass")))
    flash = sum(shares.values())
    log(f"phase 5: by kind: flash kernels {flash:.1f} ms, matmuls (cuBLAS) "
        f"{gemm:.1f} ms, everything else (elementwise, copies, reductions) "
        f"{busy - flash - gemm:.1f} ms")
    for t, count, key in sorted(kernels, reverse=True)[:12]:
        log(f"  {t:8.3f} ms  x{count:<5d} {key[:90]}")
    stats.update({"profile_wall_ms": wall_ms, "profile_busy_ms": busy,
                  "profile_gemm_ms": gemm,
                  **{f"profile_{n}_ms": t for n, t in shares.items()}})
    del state
    return stats


def phase_train_parity(torch):
    """(a) One step's loss and gradients through the kernels against the
    plain attention, fp32, Llama-3-8B width x 2 layers. (b) The CLI:
    checkpoint at step 2, drained at step 3, resumed to step 6, against
    an uninterrupted 6-step run."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from k8s_operator_libs_tpu_torch import train
    from k8s_operator_libs_tpu_torch.data.loader import write_token_file
    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          param_leaves)
    from k8s_operator_libs_tpu_torch.ops import attention as fa
    from k8s_operator_libs_tpu_torch.parallel import fsdp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32,
                                max_seq_len=512)
    state = fsdp.init_train_state(cfg, seed=2, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (2, 513), generator=g,
                           device="cuda", dtype=torch.int32)
    results = {}
    for name, attn_fn in (("kernels", None),
                          ("plain", fa.reference_attention)):
        fa.reset_launch_counts()
        results[name] = fsdp.value_and_grad(
            lambda p, t: fsdp.causal_lm_loss(p, t, cfg, attn_fn),
            state.params, tokens)
        results[name + "_launches"] = fa.LAUNCHES["flash_forward"]
    check(results["kernels_launches"] == 2 and results["plain_launches"] == 0,
          "the parity step did not take the paths it names")
    (lk, gk), (lp, gp) = results["kernels"], results["plain"]
    # fp32 with TF32 off: the kernels sum in another order than the plain
    # matmuls (~1e-6 relative per attention output), which two layers of
    # backward spread; allow 1e-5 of the loss and 1e-3 of each leaf's
    # largest gradient
    loss_diff = abs(float(lk) - float(lp))
    check(loss_diff <= 1e-5 * abs(float(lp)),
          f"loss through the kernels {float(lk)} vs plain {float(lp)}")
    worst = 0.0
    for a, b in zip(param_leaves(gk), param_leaves(gp)):
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
    check(worst <= 1e-3, f"gradients through the kernels differ by "
                         f"{worst:.2e} of a leaf's largest")
    log(f"phase 6a: Llama-3-8B width x 2 layers, fp32, B 2 T 512: loss "
        f"kernels {float(lk):.6f} vs plain {float(lp):.6f} (diff "
        f"{loss_diff:.2e}, tolerance 1e-5 relative); worst gradient diff "
        f"{worst:.2e} of its leaf's max (tolerance 1e-3)")
    del state, results, gk, gp
    torch.cuda.empty_cache()

    work = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    data = work / "tokens.bin"
    write_token_file(str(data), np.random.default_rng(7).integers(
        0, 32000, size=200_000))

    def run(ckpt, drain_signal=None):
        argv = ["--data", str(data), "--ckpt", str(work / ckpt), "--model",
                "small", "--seq", "512", "--batch", "4", "--steps", "6",
                "--ckpt-interval", "2", "--device", "cuda"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(argv, drain_signal=drain_signal)
        out = buf.getvalue().strip()
        log(f"phase 6 (CLI): train.main --ckpt {ckpt}: "
            f"{out.splitlines()[-1]}")
        check(rc == 0, f"train.main returned {rc}")
        return out

    calls = {"n": 0}

    def drain_at_3():
        calls["n"] += 1
        return calls["n"] == 4                       # polled before step 4

    straight = run("straight")
    drained = run("drained", drain_at_3)
    check("preempted at step 3; checkpoint 3 saved" in drained,
          f"the drain did not stop at step 3: {drained}")
    check((work / "drained" / "2").is_dir(), "no periodic checkpoint at 2")
    resumed = run("drained")

    def last_loss(out):
        m = re.search(r"\(step 6 loss ([0-9.]+)\)", out)
        check(m is not None, f"no step-6 loss in {out!r}")
        return m.group(1)

    check("done: 3 steps" in resumed, f"the resumed run did not run steps "
                                      f"4-6: {resumed}")
    a, b = last_loss(straight), last_loss(resumed)
    check(a == b, f"step-6 loss {b} after drain + resume vs {a} straight")
    log(f"phase 6 (CLI): step-6 loss after a drain at 3 and a resume: {b}, "
        f"uninterrupted: {a}: identical")
    seconds = ledger_seconds("phase 6 (CLI)", work)
    shutil.rmtree(work, ignore_errors=True)
    return {"train_parity_loss_diff": loss_diff,
            "train_parity_worst_grad": worst, "resume_step6_loss": float(b),
            **{f"small_{k}": v for k, v in seconds.items()}}


def ledger_seconds(phase, work):
    """The goodput ledger of the drained and resumed CLI runs under
    ``work``: each badput phase's seconds (the periodic save's is its
    asynchronous dispatch, the drain save the whole synchronous write),
    the goodput fraction and the unavailability window, checked for the
    phases the runs must have; and each periodic save's dispatch, of those
    runs and of the uninterrupted run (three saves in one process)."""
    from k8s_operator_libs_tpu_torch.obs.goodput import (read_ledger,
                                                         summarize)
    path = work / "drained" / "goodput.jsonl"
    s = summarize(read_ledger(str(path)))
    bad = s["badput_s"]
    for name in ("compile", "rewarmup", "ckpt_save", "drain_save",
                 "ckpt_restore"):
        check(name in bad, f"{phase}: the ledger has no {name} phase: {bad}")
    saves = [[r["duration_s"] for r in read_ledger(str(p))
              if r.get("phase") == "ckpt_save"]
             for p in (path, work / "straight" / "goodput.jsonl")]
    out = {f"{name}_s": bad[name] for name in bad}
    drain = s["phases"]["drain_save"]
    out.update(goodput_fraction=s["goodput_fraction"],
               goodput_s=s["goodput_s"], ledger_steps=s["steps"],
               ckpt_save_each_s=saves, drain_fetch_s=drain["fetch_s"],
               drain_write_s=drain["write_s"])
    log(f"{phase}: goodput ledger: " + ", ".join(
        f"{name} {bad[name]:.4f} s" for name in sorted(bad))
        + " (periodic saves' asynchronous dispatch, each, drained and "
        "resumed: {} s, uninterrupted: {} s; each waits for the write in "
        "flight, a trainer's first pins its host buffers)".format(*(" ".join(f"{x:.4f}" for x in run)
                                     for run in saves))
        + f"; the drain save's device->host fetch {drain['fetch_s']:.4f} s"
        f", file write {drain['write_s']:.4f} s"
        + f"; goodput {s['goodput_s']:.3f} s over "
        f"{s['steps']} steps, fraction {s['goodput_fraction']:.4f} of "
        f"accounted time")
    return out


# ------------------------------------------ the trainer under the operator

# phase 6b: a CheckpointingTrainer at Llama-3-8B width drained by the
# port's operator during a rolling NVIDIA driver upgrade. Depth cut 32 ->
# TO_LAYERS: a drain save writes 6 B per parameter (bf16 parameters and
# both moments), 7.6 GB at 1 layer (1.27e9 parameters, the embedding and
# the head most of them) and 16.8 GB at 8, and the resume reads it back.
# B TO_B x T TO_T, bf16, remat; the batch of step k is drawn from
# numpy's generator seeded [TO_SEED, k]. TO_NODES are a port FakeCluster's
# nodes, the trainer on TO_NODE; TO_WARM steps before the DaemonSet's
# bump, TO_RESUMED after the resume; the loop's bounds in ticks and steps
TO_LAYERS, TO_B, TO_T, TO_SEED = 1, 2, 2048, 61
TO_NODES, TO_NODE = ("gpu-s", "gpu-t"), "gpu-t"
TO_WARM, TO_RESUMED, TO_MAX_TICKS, TO_MAX_STEPS = 2, 2, 200, 100
# phase 3f's policy with the wait-for-jobs gate on the trainer's pod
TO_POLICY = {**UPGRADE_POLICY,
             "waitForCompletion": {"podSelector": "job=train"}}
# the phases the one unavailability window of TO_NODE must be split into
TO_PHASES = ("drain_save", "ckpt_restore", "window_to_gate",
             "window_gate_to_restart", "window_after_restart")


def trainer_under_operator(torch, cfg, device, work, product, smi="",
                           shape=(TO_B, TO_T)):
    """Phase 6b's sequence on ``device``: a ``CheckpointingTrainer`` of
    ``cfg`` with the goodput ledger on, batches of ``shape`` (B, T), on
    node TO_NODE of a port
    ``FakeCluster`` of TO_NODES (GPU Feature Discovery's labels for
    ``product``, one GPU each, no clique: each node its own group), the
    NVIDIA driver DaemonSet at v1 with a pod per node, a ``job=train``
    pod on TO_NODE and an in-process ``GPUOperator`` (TO_POLICY; health,
    the default objectives and usage; the host's clock). The trainer
    takes TO_WARM steps; the DaemonSet goes to v2; then one operator tick
    follows each step until the trainer, whose drain signal is "my node
    is cordoned" read through the cluster client, drain-saves and returns
    ``preempted=True`` at step s. One forward pass of step s+1's batch on
    the saved state keeps its loss; the pod completes; ticks run until
    TO_NODE is upgrade-done and schedulable; a fresh trainer on the same
    directory and ledger resumes and takes TO_RESUMED steps; ticks run
    until both nodes are upgrade-done at v2. Every tick holds the chaos
    harness's budget, journey, alert-transition, event-dedup and
    attribution invariants over the rig. Then the checks: the resume at
    s+1, the ledger's booking of steps 1 to s+2, step s+1's loss equal to
    the kept one (bit for bit: the same kernels on the same inputs), one
    attribution window on TO_NODE's journey whose phases sum to its total
    within 1e-6 s and include TO_PHASES, the status CLI's ``--goodput``
    split equal to it, and its table view's exit codes (3 in flight, 0
    at the end). Returns the readings, the flash launches of the trained
    steps (the kept forward's excluded), the ledger's records and
    TO_NODE's journey."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from k8s_operator_libs_tpu_torch import status
    from k8s_operator_libs_tpu_torch.api import DriverUpgradePolicySpec
    from k8s_operator_libs_tpu_torch.chaos.invariants import (
        AlertTransitionInvariant, AttributionInvariant, BudgetInvariant,
        CampaignView, EventDedupInvariant, JourneyInvariant)
    from k8s_operator_libs_tpu_torch.core import FakeCluster
    from k8s_operator_libs_tpu_torch.gpu import (COUNT_LABEL, PRODUCT_LABEL,
                                                 GPUOperator,
                                                 ManagedComponent)
    from k8s_operator_libs_tpu_torch.gpu.device_plugin import DRIVER_LABELS
    from k8s_operator_libs_tpu_torch.health import (ClassifierConfig,
                                                    HealthOptions,
                                                    RemediationPolicy)
    from k8s_operator_libs_tpu_torch.obs.attribution import (
        attribute_downtime, downtime_summary, windows_from_journey)
    from k8s_operator_libs_tpu_torch.obs.goodput import (GoodputLedger,
                                                         read_ledger)
    from k8s_operator_libs_tpu_torch.obs.journey import parse_journey
    from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub
    from k8s_operator_libs_tpu_torch.obs.slo import SLOOptions
    from k8s_operator_libs_tpu_torch.obs.usage import UsageMeter
    from k8s_operator_libs_tpu_torch.ops import attention as fa
    from k8s_operator_libs_tpu_torch.parallel import fsdp
    from k8s_operator_libs_tpu_torch.utils.mesh import (local_mesh,
                                                        param_specs)
    from k8s_operator_libs_tpu_torch.train.harness import (
        CheckpointingTrainer)
    from k8s_operator_libs_tpu_torch.upgrade import KeyFactory, UpgradeState

    tag = "phase 6b"
    t_phase = time.monotonic()
    work = Path(work)
    shutil.rmtree(work, ignore_errors=True)
    ckpt = work / "ckpt"
    ckpt.mkdir(parents=True)

    # the rig
    cluster = FakeCluster()              # the host's clock, no cache lag
    ds = cluster.add_daemonset(UPGRADE_DS, namespace=UPGRADE_NS,
                               labels=DRIVER_LABELS, revision_hash="v1")
    for node in TO_NODES:
        cluster.add_node(node, labels={PRODUCT_LABEL: product,
                                       COUNT_LABEL: "1"})
        cluster.add_pod(f"{UPGRADE_DS}-{node}", node, namespace=UPGRADE_NS,
                        owner_ds=ds, revision_hash="v1")
    add_serve_pod(cluster, TO_NODE, job="train")
    keys = KeyFactory(UPGRADE_COMPONENT)
    hub = MetricsHub()
    op = GPUOperator(
        cluster.client,
        [ManagedComponent(UPGRADE_COMPONENT, UPGRADE_NS, DRIVER_LABELS,
                          DriverUpgradePolicySpec.from_dict(TO_POLICY))],
        recorder=cluster.recorder, synchronous=True,
        health=HealthOptions(
            component=UPGRADE_COMPONENT,
            classifier=ClassifierConfig(damping_seconds=HEALTH_DAMPING_S,
                                        persist_seconds=HEALTH_PERSIST_S),
            policy=RemediationPolicy(recovery_seconds=HEALTH_RECOVERY_S,
                                     backoff_base_seconds=HEALTH_BACKOFF_S)),
        slo=SLOOptions.from_dict({}), usage=UsageMeter(metrics=hub),
        metrics=hub)
    errors = LogErrors(["k8s_operator_libs_tpu_torch.gpu.operator",
                        "k8s_operator_libs_tpu_torch.obs.slo"])
    alerts = AlertTransitionInvariant()
    invariants = [BudgetInvariant(), JourneyInvariant(), alerts,
                  EventDedupInvariant(alerts), AttributionInvariant()]
    ledger_path = str(ckpt / "goodput.jsonl")
    t0_wall = time.time()
    tick_ms = []

    def tick():
        """One operator reconcile, the DaemonSet controller's step, then
        the invariants over the rig and at most one node in progress."""
        t0 = time.monotonic()
        op.reconcile()
        tick_ms.append(1e3 * (time.monotonic() - t0))
        check(not errors.records, f"{tag}: tick {len(tick_ms)}: "
                                  f"errors {errors.records}")
        cluster.reconcile_daemonsets()
        nodes = {n.metadata.name: n
                 for n in cluster.client.direct().list_nodes()}
        view = CampaignView(
            tick=len(tick_ms), t=time.time() - t0_wall, nodes=nodes,
            keys=keys, budget=1, fault_notready=set(), leaders=[],
            recorder_events=list(cluster.recorder.events),
            alert_status={"op": (op.alert_manager.status()
                                 if op.alert_manager else [])},
            ledger_path=ledger_path, workload_node=TO_NODE,
            tick_seconds=1.0)
        found = [str(v) for inv in invariants for v in inv.check(view)]
        check(not found, f"{tag}: invariants violated: {found}")
        busy = [n for n, node in nodes.items()
                if node.metadata.labels.get(keys.state_label)
                in UpgradeState.IN_PROGRESS]
        check(len(busy) <= 1, f"{tag}: {busy} in progress at once")
        return nodes

    def tick_until(done, what):
        for _ in range(TO_MAX_TICKS):
            nodes = tick()
            if done(nodes):
                return nodes
        check(False, f"{tag}: {what} not within {TO_MAX_TICKS} ticks")

    def upgraded(node):
        return (node.metadata.labels.get(keys.state_label)
                == UpgradeState.DONE and not node.spec.unschedulable)

    def cordoned():
        return cluster.client.get_node(TO_NODE).spec.unschedulable

    def batch(step):
        return np.random.default_rng([TO_SEED, step]).integers(
            0, cfg.vocab_size, size=(shape[0], shape[1] + 1),
            dtype=np.int32)

    def batches(first):
        step = first
        while True:
            yield batch(step)
            step += 1

    def table_rc():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = status.main(["--component", UPGRADE_COMPONENT,
                              "--namespace", UPGRADE_NS, "--selector",
                              ",".join(f"{k}={v}" for k, v in
                                       DRIVER_LABELS.items())],
                             client=cluster.client)
        return rc, out.getvalue()

    # each step's host seconds (from the loop's last return to the next
    # call, the step synced) and loss, by host step
    step_s, losses = {}, {}
    mark = {"t": None}

    def on_step(ticking):
        def hook(step, metrics):
            t = time.monotonic()
            losses[step] = float(metrics["loss"])
            step_s[step] = t - mark["t"]
            if step == TO_WARM:
                cluster.bump_daemonset_revision(UPGRADE_DS, UPGRADE_NS, "v2")
            if ticking and step >= TO_WARM:
                tick()
            mark["t"] = time.monotonic()
        return hook

    def trainer():
        return CheckpointingTrainer(
            cfg, str(ckpt), checkpoint_interval=10 * TO_MAX_STEPS,
            device=device, ledger=GoodputLedger.for_checkpoint_dir(str(ckpt)),
            metrics_sync_every=1)

    fa.reset_launch_counts()
    job = trainer()
    state = job.init_or_resume(0)
    mark["t"] = time.monotonic()
    result = job.run(state, batches(1), TO_MAX_STEPS, drain_signal=cordoned,
                     on_step=on_step(True))
    s = int(result.state.step)
    check(result.preempted and cordoned() and job.latest_step == s,
          f"{tag}: the trainer ran to step {s} (preempted "
          f"{result.preempted}, last checkpoint {job.latest_step}) without "
          f"a drain for the cordon")
    fetch_s, write_s = job.last_fetch_s, job.last_write_s
    trained = dict(fa.LAUNCHES)
    routes = dict(fa.ROUTE_LAUNCHES)
    # step s+1's loss on the saved state, before the job exits: the
    # training step's loss function, forward only
    loss_fn = fsdp.fsdp_loss(cfg, local_mesh(), param_specs())
    with torch.no_grad():
        kept = float(loss_fn(result.state.params,
                             torch.as_tensor(batch(s + 1), device=device)))
    fa.reset_launch_counts()
    job.ledger.close()
    job.close()
    del job, state, result
    if device != "cpu":
        torch.cuda.empty_cache()
    rc_flight, _ = table_rc()
    check(rc_flight == 3, f"{tag}: status exited {rc_flight} with "
                          f"{TO_NODE} in flight, not 3")
    # the job's pod completes: the wait-for-jobs gate opens
    cluster.set_pod_status("default", f"train-{TO_NODE}", phase="Succeeded")
    tick_until(lambda nodes: upgraded(nodes[TO_NODE]),
               f"{TO_NODE} upgrade-done and schedulable")
    cluster.set_pod_status("default", f"train-{TO_NODE}", phase="Running")
    job = trainer()
    t_restore = time.monotonic()
    state = job.init_or_resume(1)
    restore_wall = time.monotonic() - t_restore
    check(int(state.step) == s, f"{tag}: resumed at step {int(state.step)}"
                                f", not at the drain's {s}")
    mark["t"] = time.monotonic()
    resumed = job.run(state, batches(s + 1), TO_RESUMED,
                      drain_signal=cordoned, on_step=on_step(False))
    check(not resumed.preempted and int(resumed.state.step) == s + TO_RESUMED,
          f"{tag}: the resumed run ended at step {int(resumed.state.step)}")
    for name, n in fa.LAUNCHES.items():
        trained[name] = trained.get(name, 0) + n
    for name, n in fa.ROUTE_LAUNCHES.items():
        routes[name] = routes.get(name, 0) + n
    job.ledger.close()
    job.close()
    del job, state, resumed
    if device != "cpu":
        torch.cuda.empty_cache()
    final = tick_until(lambda nodes: all(upgraded(nodes[n])
                                         for n in TO_NODES),
                       "both nodes upgrade-done")
    errors.close()
    pods = cluster.client.direct().list_pods(namespace=UPGRADE_NS,
                                             label_selector=DRIVER_LABELS)
    check(sorted(p.metadata.labels["controller-revision-hash"]
                 for p in pods) == ["v2"] * len(TO_NODES),
          f"{tag}: driver pods not all at v2")
    rc_done, table = table_rc()
    check(rc_done == 0, f"{tag}: status exited {rc_done} at the end:\n"
                        f"{table}")

    # steps and loss
    check(sorted(losses) == list(range(1, s + TO_RESUMED + 1)),
          f"{tag}: steps taken {sorted(losses)}")
    records = read_ledger(ledger_path)
    booked = []
    for rec in records:
        if rec.get("kind") == "step":
            booked += range(rec["step"] - rec["n"] + 1, rec["step"] + 1)
    firsts = [rec["phase"] for rec in records if rec.get("kind") == "phase"
              and rec["phase"] in ("compile", "rewarmup")]
    runs = [(rec["step"], rec.get("preempted")) for rec in records
            if rec.get("kind") == "run_end"]
    # each run's first step is booked as its compile (fresh) or
    # re-warmup (resumed) badput, every other step as goodput
    check(sorted(booked) == [k for k in range(1, s + TO_RESUMED + 1)
                             if k not in (1, s + 1)]
          and firsts == ["compile", "rewarmup"]
          and runs == [(s, True), (s + TO_RESUMED, False)],
          f"{tag}: the ledger booked steps {sorted(booked)}, first steps "
          f"{firsts}, runs {runs}")
    check(losses[s + 1] == kept,
          f"{tag}: step {s + 1}'s loss {losses[s + 1]!r} after the resume vs "
          f"{kept!r} on the saved state before the exit (bound: bit-equal)")

    # attribution
    entries = parse_journey(final[TO_NODE].metadata.annotations.get(
        keys.journey_annotation))
    reports = attribute_downtime(records, entries)
    check(len(reports) == 1, f"{tag}: {len(reports)} attribution windows")
    (report,) = reports
    phases = report["phases"]
    check(abs(sum(phases.values()) - report["total_s"]) <= 1e-6
          and all(phases.get(p, 0.0) > 0 for p in TO_PHASES),
          f"{tag}: window {report['total_s']} s split {phases}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = status.main(["--component", UPGRADE_COMPONENT, "--goodput",
                          ledger_path, "--goodput-node", TO_NODE, "--json"],
                         client=cluster.client)
    envelope = json.loads(out.getvalue())
    check(rc == 0 and envelope["kind"] == "goodput"
          and envelope["data"]["attribution"][UPGRADE_COMPONENT] == reports,
          f"{tag}: status --goodput split "
          f"{envelope['data']['attribution']} vs {reports}")
    (window,) = windows_from_journey(entries)
    restore_s, rewarmup_s = (
        next(rec["duration_s"] for rec in records
             if rec.get("phase") == name)
        for name in ("ckpt_restore", "rewarmup"))
    summary = downtime_summary(window, ckpt_fetch_s=fetch_s,
                               ckpt_write_s=write_s,
                               ckpt_restore_s=restore_s,
                               rewarmup_s=rewarmup_s)
    shutil.rmtree(work, ignore_errors=True)

    before = [step_s[k] * 1e3 for k in range(2, s + 1)]
    after = [step_s[k] * 1e3 for k in range(s + 2, s + TO_RESUMED + 1)]
    ms_before = float(np.median(before)) if before else float("nan")
    ms_after = float(np.median(after)) if after else float("nan")
    lead = f"{tag} ({smi})" if smi else tag
    log(f"{lead}: drained at step {s} ({len(tick_ms)} operator ticks, "
        f"median {np.median(tick_ms):.3f} ms); ms per step (host, synced, "
        f"an operator tick between steps before the drain) median "
        f"{ms_before:.1f} before the resume (steps 2-{s}), {ms_after:.1f} "
        f"after (steps {s + 2}-{s + TO_RESUMED}); step {s + 1}'s loss "
        f"{losses[s + 1]!r} after the resume = {kept!r} before the exit")
    log(f"{lead}: drain save: device->host fetch {fetch_s:.4f} s, file "
        f"write {write_s:.4f} s; restore {restore_s:.4f} s (ledger), "
        f"{restore_wall:.4f} s (host, the trainer's init_or_resume); "
        f"first step after the resume {rewarmup_s:.4f} s (ledger, "
        f"rewarmup), {step_s[s + 1]:.4f} s (host)")
    log(f"{lead}: {TO_NODE}'s unavailability window {report['total_s']:.4f}"
        f" s split " + ", ".join(f"{k} {v:.4f}" for k, v in
                                 sorted(phases.items(), key=lambda kv:
                                        -kv[1]))
        + " s (status --goodput the same); the journey's window "
        + ", ".join(f"{k} {v:.4f}" for k, v in window.as_dict().items()))
    log(f"{lead}: downtime_summary: " + json.dumps(
        {k: (round(v, 6) if isinstance(v, float) else v)
         for k, v in summary.items()}))
    log(f"{lead}: wall {time.monotonic() - t_phase:.1f} s")
    return {"drain_step": s, "ticks": len(tick_ms),
            "tick_ms_median": float(np.median(tick_ms)),
            "ms_per_step_before": ms_before, "ms_per_step_after": ms_after,
            "first_step_after_s": rewarmup_s, "fetch_s": fetch_s,
            "write_s": write_s, "restore_s": restore_s,
            "restore_wall_s": restore_wall, "loss_resumed": losses[s + 1],
            "loss_kept": kept, "window_s": report["total_s"],
            "phases": phases, "downtime": summary,
            "steps": s + TO_RESUMED, "launches": trained, "routes": routes,
            "records": records, "journey": entries}


def phase_trainer_operator(torch, smi):
    """Phase 6b on the card: :func:`trainer_under_operator` at
    Llama-3-8B width, TO_LAYERS layer(s); A-K1, A-K2 and A-K3 must each
    launch once per layer and trained step, all on ``wgmma``."""
    from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig

    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"phase 6b: {held / 2**30:.1f} GiB of the earlier "
                        f"phases is still allocated")
    cfg = LlamaConfig.llama3_8b(n_layers=TO_LAYERS, max_seq_len=TO_T)
    out = trainer_under_operator(
        torch, cfg, "cuda",
        Path(__file__).resolve().parent / "build" / "chip_smoke_operator",
        torch.cuda.get_device_name(0).replace(" ", "-"), smi)
    want = TO_LAYERS * out["steps"]
    check(all(out["launches"].get(n) == want for n in FLASH_NAMES)
          and out["routes"] == {"wgmma": 3 * want, "fma": 0},
          f"phase 6b: launches {out['launches']}, routes {out['routes']} "
          f"over {out['steps']} steps of {TO_LAYERS} layer(s)")
    log(f"phase 6b: A-K1-3 launched {want} times each over {out['steps']} "
        f"steps of {TO_LAYERS} layer(s), all on wgmma")
    torch.cuda.empty_cache()
    return {f"operator_{k}": v for k, v in out.items()
            if k not in ("records", "journey")}


# ------------------------------------------------------------ MoE

# phase 7: Llama-3-8B-width MoE served, depth cut 32 -> 16 (48.5 GB of
# bf16 weights; the 32 layers need ~94.5 GB)
MOE_SERVE_LAYERS = 16
# phase 8: MoE training, depth cut 32 -> 2 (params, gradients and two
# bf16 moments take 8 B per parameter: 31.6 GB at 2 layers)
MOE_TRAIN_LAYERS = 2


def copies_at_least(torch, fn, numel):
    """The copy ops (``copy_``, ``clone``, ``contiguous``, ``_to_copy``)
    that one call of ``fn`` makes of a tensor with at least ``numel``
    elements, from ``torch.profiler``'s recorded input shapes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    found = []
    for evt in prof.events():
        if evt.name not in ("aten::copy_", "aten::clone", "aten::contiguous",
                            "aten::_to_copy"):
            continue
        for shape in evt.input_shapes or ():
            if shape and math.prod(shape) >= numel:
                found.append((evt.name, tuple(shape)))
    return found


def phase_moe_serve(torch):
    """Phase 7: the MoE family on the continuous batcher at Llama-3-8B
    width, 16 layers, bf16 (A-K4 on every decode step)."""
    import numpy as np

    from k8s_operator_libs_tpu_torch.models.moe import (MoEConfig,
                                                        init_params,
                                                        moe_paged_forward)
    from k8s_operator_libs_tpu_torch.models.quant import stream_bytes
    from k8s_operator_libs_tpu_torch.models.serve import ContinuousBatcher
    from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub
    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn

    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"{held / 2**30:.1f} GiB of the earlier phases is "
                        f"still allocated")
    cfg = MoEConfig.llama3_8b(n_layers=MOE_SERVE_LAYERS)
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 7: MoE (Llama-3-8B attention, {cfg.n_experts} experts of "
        f"d_ff {cfg.d_ff}, top-{cfg.top_k}) bf16, {cfg.n_layers} of 32 "
        f"layers, weights seeded on the card in {time.monotonic() - t0:.1f} "
        f"s ({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    weight_bytes = stream_bytes(params)
    floor_ms = weight_bytes / H100_BYTES_PER_S * 1e3
    log(f"phase 7: a decode step streams {weight_bytes} weight bytes (dense "
        f"dispatch: every expert): floor {floor_ms:.3f} ms at "
        f"{H100_BYTES_PER_S:.3g} B/s")
    hub = MetricsHub()
    srv = ContinuousBatcher(params, cfg, max_slots=SLOTS,
                            capacity_per_slot=CAPACITY, block_size=BS,
                            forward=moe_paged_forward, metrics=hub)
    srv.submit(np.arange(1, 9, dtype=np.int32), 4)          # warm-up
    while not srv.idle:
        srv.step(CHUNK)
    srv.poll()
    gen = np.random.default_rng(0)
    prompts = [gen.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    attn.reset_launch_counts()
    srv.decode_steps, srv.decode_seconds, srv.decode_tokens = 0, 0.0, 0
    ttft0 = hist(hub, "serve_ttft_seconds")
    t_req = time.monotonic()
    rids = [srv.submit(p, MAX_NEW) for p in prompts]
    out = {}
    while not srv.idle:
        srv.step(CHUNK)
        out.update(srv.poll())
    wall = time.monotonic() - t_req
    launches = attn.LAUNCHES["paged_decode"]
    steps = srv.decode_steps
    ttft1 = hist(hub, "serve_ttft_seconds")
    for rid, p in zip(rids, prompts):
        check(len(out[rid]) == len(p) + MAX_NEW
              and out[rid][:len(p)].tolist() == p.tolist(),
              "phase 7: a request has the wrong length or prompt")
    check(steps > 0 and launches == cfg.n_layers * steps,
          f"phase 7: A-K4 launched {launches} times over {steps} decode "
          f"steps of {cfg.n_layers} layers")
    ttft = (ttft1[0] - ttft0[0]) / max(1, ttft1[1] - ttft0[1])
    ms_step = 1e3 * srv.decode_seconds / steps
    log(f"phase 7: 4 requests (prompts {PROMPT_LENS}, max_new {MAX_NEW}) "
        f"in {wall:.2f} s; A-K4 launches {launches} = {cfg.n_layers} x "
        f"{steps} decode steps; mean TTFT {ttft * 1e3:.1f} ms, "
        f"{ms_step:.2f} ms per decode step ({SLOTS} slots) against the "
        f"{floor_ms:.3f} ms floor ({floor_ms / ms_step:.1%}), decode "
        f"{srv.decode_tokens / srv.decode_seconds:.1f} tokens/s")
    stats = {"launches": launches, "decode_steps": steps,
             "ttft_mean_s": ttft, "ms_per_decode_step": ms_step,
             "weight_stream_bytes": weight_bytes,
             "weight_stream_floor_ms": floor_ms, "wall_s": wall}

    # one decode step on the same cache through the kernel and the plain
    # version (phase 3's check and bound)
    for p in prompts:
        srv.submit(p, 8)
    srv.step(1)
    cache, toks = srv.snapshot()
    check(int((cache.lengths > 0).sum()) == SLOTS, "slots not all running")
    lk, _ = moe_paged_forward(params, toks, cache, cfg)
    lp, _ = moe_paged_forward(params, toks, cache, cfg,
                              decode_attn=attn.paged_decode_plain)
    torch.cuda.synchronize()
    check(torch.isfinite(lk).all().item(), "phase 7: non-finite logits")
    diff = float((lk - lp).abs().max())
    tol = 0.05 * float(lp.abs().max())
    log(f"phase 7: decode logits kernel vs plain max diff {diff:.4f} "
        f"(tolerance {tol:.4f} = 5% of max |logit|)")
    check(diff <= tol, "phase 7: decode logits through the kernel disagree")
    stats["logit_max_diff"] = diff
    del lk, lp, cache
    expert = cfg.d_model * cfg.d_ff
    copies = copies_at_least(torch, lambda: srv.step(CHUNK), expert)
    check(not copies, f"phase 7: a decode chunk copies tensors of expert-"
                      f"weight size: {copies[:4]}")
    log(f"phase 7: no copy op of >= {expert} elements (one expert's [D, F]) "
        f"in a {CHUNK}-tick chunk (profiler input shapes)")
    stats.update(profile_decode(torch, srv, CHUNK, phase="phase 7"))
    return stats


def phase_moe_parity(torch):
    """Phase 7b: fp32, Llama-3-8B width, 2 layers: the MoE batcher's
    greedy tokens (A-K4) against ``moe_generate`` (contiguous cache, plain
    attention)."""
    import numpy as np

    from k8s_operator_libs_tpu_torch.models.moe import (
        MoEConfig, init_params, moe_generate, moe_paged_forward)
    from k8s_operator_libs_tpu_torch.models.serve import ContinuousBatcher
    from k8s_operator_libs_tpu_torch.ops import paged_attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MoEConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device="cuda")
    gen = np.random.default_rng(1)
    prompts = [gen.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    attn.reset_launch_counts()
    srv = ContinuousBatcher(params, cfg, max_slots=SLOTS,
                            capacity_per_slot=CAPACITY, block_size=BS,
                            forward=moe_paged_forward)
    rids = [srv.submit(p, MAX_NEW) for p in prompts]
    out = {}
    while not srv.idle:
        srv.step(CHUNK)
        out.update(srv.poll())
    launches = attn.LAUNCHES["paged_decode"]
    check(launches == cfg.n_layers * srv.decode_steps > 0,
          f"phase 7b: A-K4 launched {launches} times over "
          f"{srv.decode_steps} steps")
    failures = []
    for rid, p in zip(rids, prompts):
        ref = moe_generate(params, torch.as_tensor(p[None]), cfg,
                           max_new_tokens=MAX_NEW)[0].cpu().numpy()
        i = first_mismatch(out[rid].tolist(), ref.tolist())
        if i is not None:
            failures.append(f"prompt {len(p)}: token {i - len(p)} differs "
                            f"({out[rid][i]} vs {ref[i]})")
    log(f"phase 7b: MoE batcher (A-K4, {launches} launches) vs contiguous "
        f"moe_generate (plain), fp32, 4 prompts x {MAX_NEW} tokens: "
        f"{'identical' if not failures else 'MISMATCH: ' + '; '.join(failures)}")
    check(not failures, "phase 7b: MoE token parity failed")
    return {"parity_launches": launches}


def phase_moe_train(torch):
    """Phase 8: the MoE trained at Llama-3-8B width, 2 layers, bf16, remat,
    B 2 x T 2048 through ``make_train_step_from_loss(moe_reference_loss)``:
    one warm-up and TRAIN_STEPS timed steps on one batch."""
    from k8s_operator_libs_tpu_torch.models import moe
    from k8s_operator_libs_tpu_torch.models.llama import param_count
    from k8s_operator_libs_tpu_torch.ops import attention as fa
    from k8s_operator_libs_tpu_torch.parallel import fsdp
    from k8s_operator_libs_tpu_torch.parallel.expert import moe_reference_loss

    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"{held / 2**30:.1f} GiB of the earlier phases is "
                        f"still allocated")
    cfg = moe.MoEConfig.llama3_8b(n_layers=MOE_TRAIN_LAYERS,
                                  max_seq_len=TRAIN_T)
    torch.cuda.reset_peak_memory_stats()
    opt = fsdp.default_optimizer()
    params = moe.init_params(cfg, seed=0, device="cuda")
    state = fsdp.TrainState(params=params, opt_state=opt.init(params),
                            step=0)
    del params
    n_params = param_count(state.params)
    step = fsdp.make_train_step_from_loss(moe_reference_loss(cfg), opt)
    g = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_T + 1),
                           generator=g, device="cuda", dtype=torch.int32)
    state, m = step(state, tokens)                         # warm-up
    losses = [float(m["loss"])]
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.monotonic()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, tokens)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(fa.LAUNCHES)
    routes = dict(fa.ROUTE_LAUNCHES)
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    for name in FLASH_NAMES:
        check(launches[name] == L * TRAIN_STEPS,
              f"phase 8: {name} launched {launches[name]} times over "
              f"{TRAIN_STEPS} steps of {L} layers")
    check(routes == {"wgmma": 3 * L * TRAIN_STEPS, "fma": 0},
          f"phase 8: bf16 MoE training took routes {routes}")
    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    check(losses[-1] < losses[0], f"phase 8: loss did not fall: {losses}")
    with torch.no_grad():
        _, aux = moe.forward(state.params, tokens[:, :-1], cfg)
    aux = float(aux)
    check(math.isfinite(aux) and aux > 0, f"phase 8: aux {aux}")
    check(peak < 80e9, f"phase 8: peak {peak / 2**30:.1f} GiB")

    ms = wall / TRAIN_STEPS * 1e3
    tokens_per_step = TRAIN_B * TRAIN_T
    # dense dispatch runs all E experts on every token: 6 x (every matmul
    # parameter: all but the embedding, all experts and the router) x
    # tokens, plus attention's 12 x B*H*Dh*T(T+1)/2 per layer
    matmul_params = n_params - cfg.vocab_size * cfg.d_model
    visible = TRAIN_T * (TRAIN_T + 1) // 2
    attn_flops = 12 * TRAIN_B * cfg.n_heads * cfg.head_dim * visible * L
    flops = 6 * matmul_params * tokens_per_step + attn_flops
    share = flops / (ms / 1e3) / H100_BF16_FLOPS
    log(f"phase 8: MoE at Llama-3-8B width x {L} layers ({n_params} params, "
        f"{cfg.n_experts} experts), bf16, remat, B {TRAIN_B} T {TRAIN_T}: "
        f"{ms:.1f} ms per step, {tokens_per_step / ms * 1e3:.0f} tokens/s; "
        f"model flops of dense dispatch (all {cfg.n_experts} experts) "
        f"{flops:.4g} per step -> {share:.2%} of {H100_BF16_FLOPS:.3g} "
        f"FLOP/s; peak memory {peak / 2**30:.1f} GiB")
    log(f"phase 8: losses {' '.join(f'{x:.4f}' for x in losses)} (warm-up "
        f"first); aux after the steps {aux:.4f}; launches per step "
        + ", ".join(f"{n} {launches[n] // TRAIN_STEPS}" for n in FLASH_NAMES)
        + ", all on route wgmma")
    stats = {"ms_per_step": ms, "tokens_per_s": tokens_per_step / ms * 1e3,
             "model_flops_per_step_dense_dispatch": flops,
             "model_flop_share_dense_dispatch": share,
             "peak_memory_bytes": peak, "loss_first": losses[0],
             "loss_last": losses[-1], "aux": aux,
             **{f"launches_{n}": launches[n] for n in FLASH_NAMES}}

    def one_step():
        nonlocal state
        state, _ = step(state, tokens)

    wall_ms, kernels = profile_kernels(torch, one_step)
    busy = sum(t for t, _, _ in kernels)
    del state
    if not busy:
        log("phase 8: profile: no device time recorded (not measured)")
        return stats
    flash = sum(t for t, _, key in kernels
                if any(k in key for k in ("flash_fwd", "flash_bwd")))
    gemm = sum(t for t, _, key in kernels
               if any(k in key for k in ("nvjet", "gemm", "cutlass")))
    log(f"phase 8: profile of one step: wall {wall_ms:.1f} ms (profiled), "
        f"device busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.1%}; "
        f"flash kernels {flash:.1f} ms, matmuls (cuBLAS) {gemm:.1f} ms, "
        f"everything else (elementwise, copies, reductions) "
        f"{busy - flash - gemm:.1f} ms")
    for t, count, key in sorted(kernels, reverse=True)[:12]:
        log(f"  {t:8.3f} ms  x{count:<5d} {key[:90]}")
    stats.update({"profile_wall_ms": wall_ms, "profile_busy_ms": busy,
                  "profile_gemm_ms": gemm, "profile_flash_ms": flash})
    return stats


def phase_moe_train_parity(torch):
    """Phase 8b: (a) one MoE step's loss and every gradient through the
    kernels against the plain attention, fp32, Llama-3-8B width x 2
    layers, B 2 x T 512. (b) The CLI on ``moe_tiny`` (bf16, Dh 32 on the
    wgmma route) with the goodput ledger, the textfile and the profiler:
    checkpoint at 2, drained at 3, resumed to 6, against an uninterrupted
    run."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from k8s_operator_libs_tpu_torch import train
    from k8s_operator_libs_tpu_torch.data.loader import write_token_file
    from k8s_operator_libs_tpu_torch.models import moe
    from k8s_operator_libs_tpu_torch.models.llama import param_leaves
    from k8s_operator_libs_tpu_torch.ops import attention as fa
    from k8s_operator_libs_tpu_torch.parallel import fsdp
    from k8s_operator_libs_tpu_torch.parallel.expert import moe_reference_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = moe.MoEConfig.llama3_8b(n_layers=2, dtype=torch.float32,
                                  max_seq_len=512)
    params = moe.init_params(cfg, seed=2, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (2, 513), generator=g,
                           device="cuda", dtype=torch.int32)
    results = {}
    for name, attn_fn in (("kernels", None),
                          ("plain", fa.reference_attention)):
        fa.reset_launch_counts()
        results[name] = fsdp.value_and_grad(
            moe_reference_loss(cfg, attn_fn), params, tokens)
        results[name + "_launches"] = fa.LAUNCHES["flash_forward"]
    check(results["kernels_launches"] == 2 and results["plain_launches"] == 0,
          "phase 8b: the parity step did not take the paths it names")
    (lk, gk), (lp, gp) = results["kernels"], results["plain"]
    # phase 6a's bounds: fp32 summation order through two layers
    loss_diff = abs(float(lk) - float(lp))
    check(loss_diff <= 1e-5 * abs(float(lp)),
          f"phase 8b: loss through the kernels {float(lk)} vs plain "
          f"{float(lp)}")
    worst = 0.0
    for a, b in zip(param_leaves(gk), param_leaves(gp)):
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
    check(worst <= 1e-3, f"phase 8b: gradients through the kernels differ "
                         f"by {worst:.2e} of a leaf's largest")
    log(f"phase 8b: MoE at Llama-3-8B width x 2 layers, fp32, B 2 T 512: "
        f"loss kernels {float(lk):.6f} vs plain {float(lp):.6f} (diff "
        f"{loss_diff:.2e}, tolerance 1e-5 relative); worst gradient diff "
        f"{worst:.2e} of its leaf's max (tolerance 1e-3)")
    del params, results, gk, gp
    torch.cuda.empty_cache()

    work = Path(__file__).resolve().parent / "build" / "chip_smoke_moe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    data = work / "tokens.bin"
    write_token_file(str(data), np.random.default_rng(7).integers(
        0, 512, size=200_000))

    def run(ckpt, drain_signal=None, *extra):
        argv = ["--data", str(data), "--ckpt", str(work / ckpt), "--model",
                "moe_tiny", "--seq", "256", "--batch", "8", "--steps", "6",
                "--ckpt-interval", "2", "--device", "cuda", "--parallel",
                "none", *extra]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(argv, drain_signal=drain_signal)
        out = buf.getvalue().strip()
        log(f"phase 8b: train.main --model moe_tiny --ckpt {ckpt}: "
            f"{out.splitlines()[-1]}")
        check(rc == 0, f"train.main returned {rc}")
        return out

    calls = {"n": 0}

    def drain_at_3():
        calls["n"] += 1
        return calls["n"] == 4                       # polled before step 4

    fa.reset_launch_counts()
    straight = run("straight")
    check(fa.ROUTE_LAUNCHES["wgmma"] > 0 and fa.ROUTE_LAUNCHES["fma"] == 0,
          f"phase 8b: moe_tiny (bf16, Dh 32) took routes {fa.ROUTE_LAUNCHES}")
    textfile = work / "train.prom"
    profile_dir = work / "profile"
    extra = ("--metrics-textfile", str(textfile), "--profile",
             str(profile_dir))
    drained = run("drained", drain_at_3, *extra)
    check("preempted at step 3; checkpoint 3 saved" in drained,
          f"phase 8b: the drain did not stop at step 3: {drained}")
    check((work / "drained" / "2").is_dir(), "no periodic checkpoint at 2")
    resumed = run("drained", None, *extra)
    check("done: 3 steps" in resumed, f"phase 8b: the resumed run did not "
                                      f"run steps 4-6: {resumed}")

    def last_loss(out):
        m = re.search(r"\(step 6 loss ([0-9.]+)\)", out)
        check(m is not None, f"no step-6 loss in {out!r}")
        return m.group(1)

    a, b = last_loss(straight), last_loss(resumed)
    check(a == b, f"phase 8b: step-6 loss {b} after drain + resume vs {a}")
    log(f"phase 8b: step-6 loss after a drain at 3 and a resume: {b}, "
        f"uninterrupted: {a}: identical")
    prom = textfile.read_text()
    for family in ("tpu_workload_goodput_fraction",
                   'tpu_workload_badput_phase_seconds{phase="drain_save"}',
                   "tpu_workload_step_duration_seconds_count"):
        check(family in prom, f"phase 8b: {family} not in the textfile")
    traces = sorted(profile_dir.glob("*.pt.trace.json"))
    check(len(traces) == 2, f"phase 8b: {len(traces)} profiler traces, "
                            f"expected one per run")
    sizes = [t.stat().st_size for t in traces]
    log(f"phase 8b: --profile wrote {len(traces)} traces of {sizes} bytes; "
        f"--metrics-textfile holds the goodput gauges")
    seconds = ledger_seconds("phase 8b", work)
    shutil.rmtree(work, ignore_errors=True)
    return {"moe_parity_loss_diff": loss_diff, "moe_parity_worst_grad": worst,
            "moe_resume_step6_loss": float(b), "moe_trace_bytes": sizes,
            **{f"moe_tiny_{k}": v for k, v in seconds.items()}}


# ------------------------------------------------------------ multi-process

# phase 9: ranks share the one card over gloo (NCCL refuses two ranks on
# one device), so every collective goes through host memory: its times
# measure no interconnect
GLOO_LABEL = "gloo host-staged, one card, not an interconnect figure"
NVLINK_BYTES_PER_S = 450e9      # H100 SXM NVLink 4: 900 GB/s, 450 each way
# timed optimizer steps (2 before phase 3g joined, cut to keep the
# smoke's phases under 1000 s). Each path's parity pass, the same loss's
# forward and backward at the same shapes just before, is their warm-up
# (a separate warm-up step went when phase 6b joined)
MP_TIMED_STEPS = 1
MP_TIMEOUT = 900.0
# bf16 parity against the one-rank step, which runs the same kernels on
# the whole sequence and batch (phase 2 holds the kernels against their
# plain versions at the ranks' own shapes): the ring merges bf16 partial
# outputs in fp32 and rounds once, Ulysses and FSDP run the kernels on
# other splits and FSDP sums the ranks' bf16 gradient halves in fp32;
# each moves an element by about one bf16 rounding (2^-8 relative), and
# the difference then passes through two or four layers' bf16 backward
# (the per-element rule of phase 2 does not carry over: a leaf's gradient
# sums every position's rounding). On an H100 80GB HBM3 at 700 W the
# worst leaf read 6.7e-3 (FSDP) to 1.29e-2 (ring) of its largest
# gradient, the same in every run, and the fault this slice repaired,
# planted in 9a (the ring's lse cut from the graph), 3.35e-2. The bound:
# 2e-2 of each leaf's largest gradient, between the two, and 1e-3 of the
# loss; 9a must see the planted fault exceed it. fp32 keeps phase 6a's
# 1e-5 of the loss and 1e-3 of the leaf's largest gradient against plain
# attention.
MP_BF16_TOL = (1e-3, 2e-2)
MP_FP32_TOL = (1e-5, 1e-3)


def _worst(torch, grads, ref):
    """The largest |got - ref| over a leaf's max |ref|, over leaves."""
    from k8s_operator_libs_tpu_torch.models.llama import param_leaves
    worst = 0.0
    for a, b in zip(param_leaves(grads), param_leaves(ref)):
        b = b.to(a.device).float()
        rel = float((a.float() - b).abs().max()
                    / b.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
    return worst


def _host_tree(tree):
    from k8s_operator_libs_tpu_torch.parallel.fsdp import _tree_map
    return _tree_map(lambda t: t.detach().cpu(), tree)


def _tokens(torch, cfg, B, T, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, T + 1), generator=g,
                         device="cuda", dtype=torch.int32)


def _mp_sp(torch, dist, timed_steps):
    """9a in one rank: the one-rank step (rank 0, then freed to the host),
    then ring and Ulysses over every rank, bf16 at 8B width; fp32 against
    plain attention."""
    from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig
    from k8s_operator_libs_tpu_torch.models.llama import init_params
    from k8s_operator_libs_tpu_torch.ops import attention as fa
    from k8s_operator_libs_tpu_torch.utils import comm
    from k8s_operator_libs_tpu_torch.parallel import fsdp, ring_attention
    from k8s_operator_libs_tpu_torch.parallel.long_context import (
        make_sp_loss)
    from k8s_operator_libs_tpu_torch.utils.mesh import make_mesh

    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(seq=n, fsdp=1)
    out = {}
    for dtype, B, T, tol in ((torch.bfloat16, SP_B, SP_T, MP_BF16_TOL),
                             (torch.float32, SP32_B, SP32_T, MP_FP32_TOL)):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        cfg = LlamaConfig.llama3_8b(n_layers=SP_LAYERS, max_seq_len=T,
                                    dtype=dtype)
        params = init_params(cfg, seed=0, device="cuda")
        tokens = _tokens(torch, cfg, B, T, 11)
        ref = None
        if rank == 0:
            # the one-rank step: flash kernels in bf16, plain attention in
            # fp32 (phase 6a's reference)
            attn = None if dtype == torch.bfloat16 else fa.reference_attention
            ref_loss, ref = fsdp.value_and_grad(
                lambda p, t: fsdp.causal_lm_loss(p, t, cfg, attn), params,
                tokens)
            ref_loss, ref = float(ref_loss), _host_tree(ref)
            torch.cuda.empty_cache()
        dist.barrier()
        for impl in ("ring", "ulysses"):
            loss_fn = make_sp_loss(cfg, mesh, attn_impl=impl)
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            comm.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            loss, grads = fsdp.value_and_grad(loss_fn, params, tokens)
            torch.cuda.synchronize()
            res = {"loss": float(loss), "launches": dict(fa.LAUNCHES),
                   "full_launches": dict(fa.FULL_LAUNCHES),
                   "routes": dict(fa.ROUTE_LAUNCHES),
                   "calls": dict(comm.CALLS),
                   "peak": torch.cuda.max_memory_allocated()}
            if ref is not None:
                res.update(ref_loss=ref_loss, worst=_worst(torch, grads, ref),
                           tol=tol)
            del grads
            if impl == "ring" and dtype == torch.bfloat16:
                # the fault this slice repaired, planted: the ring's merge
                # with each chunk's lse cut from the graph
                real = ring_attention.flash_attention_with_lse

                def planted(*a, **kw):
                    o, lse = real(*a, **kw)
                    return o, lse.detach()

                ring_attention.flash_attention_with_lse = planted
                try:
                    _, bad = fsdp.value_and_grad(
                        make_sp_loss(cfg, mesh, attn_impl=impl), params,
                        tokens)
                finally:
                    ring_attention.flash_attention_with_lse = real
                if ref is not None:
                    res["planted_worst"] = _worst(torch, bad, ref)
                del bad
            out[f"{impl}_{tag}"] = res
        del ref
        if dtype == torch.bfloat16 and timed_steps:
            for impl in ("ring", "ulysses"):
                out[f"{impl}_bf16"].update(
                    _timed_steps(torch, fsdp.make_train_step_from_loss(
                        make_sp_loss(cfg, mesh, attn_impl=impl)),
                        params, tokens, dist))
        del params
        torch.cuda.empty_cache()
    return out


def _timed_steps(torch, step, params, tokens, dist):
    """MP_TIMED_STEPS optimizer steps from a copy of ``params``: ms per
    step on this rank and the bytes each collective kind sent per step.
    The caller's parity pass of the same loss at the same shapes was the
    warm-up."""
    from k8s_operator_libs_tpu_torch.utils import comm
    from k8s_operator_libs_tpu_torch.parallel import fsdp
    opt = fsdp.default_optimizer()
    p = fsdp._tree_map(lambda t: t.clone(), params)
    state = fsdp.TrainState(params=p, opt_state=opt.init(p), step=0)
    torch.cuda.synchronize()
    dist.barrier()
    comm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    for _ in range(MP_TIMED_STEPS):
        state, m = step(state, tokens)
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) / MP_TIMED_STEPS * 1e3
    per_step = {k: v // MP_TIMED_STEPS for k, v in comm.BYTES.items()}
    loss = float(m["loss"])
    peak = torch.cuda.max_memory_allocated()
    del state, p
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "bytes_per_step": per_step,
            "timed_loss": loss, "peak": peak}


def _mp_fsdp(torch, dist, timed_steps):
    """9b in one rank: the one-rank step (rank 0, then freed), FSDP over
    every rank (gradient slices gathered to rank 0 to compare), the
    resident bytes, launches, and timed steps."""
    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          init_params,
                                                          param_leaves)
    from k8s_operator_libs_tpu_torch.ops import attention as fa
    from k8s_operator_libs_tpu_torch.utils import comm
    from k8s_operator_libs_tpu_torch.parallel import fsdp
    from k8s_operator_libs_tpu_torch.utils.mesh import (make_mesh,
                                                        param_specs)

    rank, n = dist.get_rank(), dist.get_world_size()
    cfg = LlamaConfig.llama3_8b(n_layers=FSDP_LAYERS, max_seq_len=FSDP_T)
    tokens = _tokens(torch, cfg, FSDP_B, FSDP_T, 12)
    ref = None
    whole_bytes = 0
    if rank == 0:
        params = init_params(cfg, seed=0, device="cuda")
        whole_bytes = 3 * sum(t.numel() * t.element_size()
                              for t in param_leaves(params))
        ref_loss, ref = fsdp.value_and_grad(
            lambda p, t: fsdp.causal_lm_loss(p, t, cfg), params, tokens)
        ref_loss, ref = float(ref_loss), _host_tree(ref)
        del params
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_mesh()
    specs = param_specs()
    torch.cuda.reset_peak_memory_stats()
    state = fsdp.init_train_state(cfg, seed=0, device="cuda", mesh=mesh)
    resident = sum(t.numel() * t.element_size() for tree in
                   (state.params, state.opt_state.mu, state.opt_state.nu)
                   for t in param_leaves(tree))
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    comm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = fsdp.value_and_grad(fsdp.fsdp_loss(cfg, mesh, specs),
                                      state.params, tokens)
    torch.cuda.synchronize()
    res = {"loss": float(loss), "launches": dict(fa.LAUNCHES),
           "routes": dict(fa.ROUTE_LAUNCHES), "calls": dict(comm.CALLS),
           "resident": resident, "whole_bytes": whole_bytes,
           "peak": torch.cuda.max_memory_allocated()}
    # every rank joins the gathers; rank 0 compares the whole gradients
    whole = fsdp._tree_map(lambda g, s: fsdp.full_leaf(g, s, mesh), grads,
                           specs)
    if ref is not None:
        res.update(ref_loss=ref_loss, worst=_worst(torch, whole, ref),
                   tol=MP_BF16_TOL)
    del grads, whole, ref
    torch.cuda.empty_cache()
    if timed_steps:
        # the parity pass above was the warm-up
        step = fsdp.make_train_step(cfg, mesh=mesh)
        torch.cuda.synchronize()
        dist.barrier()
        comm.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        for _ in range(MP_TIMED_STEPS):
            state, m = step(state, tokens)
        torch.cuda.synchronize()
        res.update(ms_per_step=(time.monotonic() - t0) / MP_TIMED_STEPS * 1e3,
                   bytes_per_step={k: v // MP_TIMED_STEPS
                                   for k, v in comm.BYTES.items()},
                   timed_loss=float(m["loss"]),
                   peak=torch.cuda.max_memory_allocated())
    del state
    torch.cuda.empty_cache()
    return res


def phase9_rank(timed_steps, cli_argv=None, ep_runs=None):
    """The body of one rank of phase 9a-9c (run by ``launch.run``); with
    ``cli_argv``, 9d's drained CLI run, and with ``ep_runs`` phase 10's
    2-rank work (:func:`phase10_pair_rank`) after it, in the same ranks
    (one start of the two ranks for 9a, 9b, 9d, 10a, 10c and 10e's ep
    runs)."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    sp = _mp_sp(torch, dist, timed_steps)
    fsdp = _mp_fsdp(torch, dist, timed_steps)
    out = {"sp": sp, "fsdp": fsdp, "backend": dist.get_backend(),
           "wall_s": time.monotonic() - t0}
    if cli_argv is not None:
        t1 = time.monotonic()
        out["cli"] = phase9_cli_rank(cli_argv)
        out["cli_s"] = time.monotonic() - t1
    if ep_runs is not None:
        out["10"] = phase10_pair_rank(ep_runs)
    check_threads_stopped(f"phase 9 {rank_name()}")
    return out


def nccl_rank(data, work):
    """Phases 9c, 10d and 11b in the one rank of an NCCL group of one, so
    the rank starts once for the three: 9c's SP and FSDP steps, 10d's
    paths, then 11b's re-formation (last: it re-creates the group). Each
    part's seconds by the rank's clock."""
    t0 = time.monotonic()
    out = {"9c": phase9_rank(False)}
    t1 = time.monotonic()
    out["10d"] = phase10_nccl_rank()
    t2 = time.monotonic()
    out["11b"] = phase11_nccl_rank(data, work)
    out["seconds"] = {"9c": t1 - t0, "10d": t2 - t1,
                      "11b": time.monotonic() - t2}
    check_threads_stopped(f"phases 9c-11b {rank_name()}")
    return out


# phase 9's NCCL rank's results, read by phases 10d and 11b
NCCL_RESULTS = {}
# phase 10's inputs, made by phase 9, and the results of its 2-rank work
# in phase 9's ranks
PAIR_RESULTS = {}


def phase9_cli_rank(argv):
    """``train.main(argv)`` in one rank; rank 0 signals a drain before
    step 4, which every rank must follow."""
    import contextlib
    import io

    import torch.distributed as dist

    from k8s_operator_libs_tpu_torch import train
    rank = dist.get_rank()
    calls = {"n": 0}

    def drain():
        calls["n"] += 1
        return rank == 0 and calls["n"] == 4

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv, drain_signal=drain)
    return {"rc": rc, "out": buf.getvalue()}


def _check_rank(tag, r, res, n, layers, what):
    """The launch counts of one rank's run of path ``what``."""
    want = {"sp ring": r + 1, "sp ulysses": 1, "fsdp": 1}[what] * layers
    check(res["launches"] == {"flash_forward": want, "flash_bwd_dq": want,
                              "flash_bwd_dkv": want},
          f"{tag}: {what} rank {r} of {n} launched {res['launches']}, "
          f"expected {want} of each")
    if "full_launches" in res:
        # the ring's r earlier chunks are full blocks, its own is causal
        full = r * layers if what == "sp ring" else 0
        check(res["full_launches"] == {"flash_forward": full,
                                       "flash_bwd_dq": full,
                                       "flash_bwd_dkv": full},
              f"{tag}: {what} rank {r} launched {res['full_launches']} "
              f"without the causal mask, expected {full} of each")
    route = "wgmma" if "fp32" not in tag else "fma"
    check(res["routes"] == {"wgmma": 0, "fma": 0, route: 3 * want},
          f"{tag}: {what} rank {r} took routes {res['routes']}")


def _check_parity(tag, res):
    loss_tol, grad_tol = res["tol"]
    d = abs(res["loss"] - res["ref_loss"])
    check(math.isfinite(res["loss"]) and d <= loss_tol * abs(res["ref_loss"]),
          f"{tag}: loss {res['loss']} vs the one-rank step {res['ref_loss']}")
    check(res["worst"] <= grad_tol,
          f"{tag}: gradients differ from the one-rank step by "
          f"{res['worst']:.3e} of a leaf's largest (bound {grad_tol})")
    log(f"{tag}: loss {res['loss']:.6f} vs one-rank {res['ref_loss']:.6f} "
        f"(diff {d:.2e}, bound {loss_tol} relative); worst gradient "
        f"{res['worst']:.3e} of its leaf's max (bound {grad_tol})")
    return d


def phase_multiprocess(torch):
    """Phase 9: sequence parallelism (ring, Ulysses) and FSDP at
    Llama-3-8B width over 2 ranks on the one card (gloo), the same steps
    through NCCL at world size 1, and the CLI drained at 2 ranks and
    resumed at 1."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from k8s_operator_libs_tpu_torch import train
    from k8s_operator_libs_tpu_torch.data.loader import write_token_file
    from k8s_operator_libs_tpu_torch.parallel import launch

    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"phase 9: {held / 2**30:.1f} GiB of the earlier "
                        f"phases is still allocated")
    torch.cuda.empty_cache()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_mp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    stats = {}

    # 9d's data: the CLI runs last in 9a/9b's ranks
    data = work / "tokens.bin"
    write_token_file(str(data), np.random.default_rng(7).integers(
        0, 32000, size=200_000))

    def argv(ckpt):
        return ["--data", str(data), "--ckpt", str(work / ckpt), "--model",
                "small", "--seq", "512", "--batch", "4", "--steps", "6",
                "--ckpt-interval", "2", "--device", "cuda", "--parallel",
                "fsdp"]

    # 9a, 9b, 9d's drained run, then 10a, 10c and 10e's ep runs: two
    # ranks on the card over gloo
    inputs = phase10_inputs()
    check(MP_RANKS == PP_S, "phase 10's 2-rank work is not at 9's ranks")
    t0 = time.monotonic()
    results = launch.run(phase9_rank, MP_RANKS, True, argv("drained"),
                         inputs["ep_runs"], backend="gloo",
                         timeout=MP_TIMEOUT, workdir=str(work))
    own = ", ".join(f"{r['wall_s']:.1f}" for r in results)
    cli_s = ", ".join(f"{r['cli_s']:.1f}" for r in results)
    log(f"phase 9a/9b/9d (+10a/10c/10e): {MP_RANKS} ranks over gloo, wall "
        f"{time.monotonic() - t0:.1f} s (ranks' own {own} s for 9a/9b, "
        f"{cli_s} s for 9d's drained run, " + ", ".join(
            f"{r['10']['pp_s'] + r['10']['ep_s'] + r['10']['cli_s']:.1f}"
            for r in results) + " s for phase 10's)")
    PAIR_RESULTS.update(inputs, ranks=[r.pop("10") for r in results])
    cli_res = [r["cli"] for r in results]
    launches = {}
    for impl in ("ring", "ulysses"):
        for tag in ("bf16", "fp32"):
            key = f"{impl}_{tag}"
            for r, res in enumerate(results):
                _check_rank(f"phase 9a {tag}", r, res["sp"][key], MP_RANKS,
                            SP_LAYERS, f"sp {impl}")
                first = results[0]["sp"][key]["loss"]
                check(abs(res["sp"][key]["loss"] - first) <= 1e-6 * first,
                      f"phase 9a: {key} ranks disagree on the loss")
            B, T = (SP_B, SP_T) if tag == "bf16" else (SP32_B, SP32_T)
            stats[f"sp_{key}_loss_diff"] = _check_parity(
                f"phase 9a {impl} {tag} (B {B} T {T})", results[0]["sp"][key])
            stats[f"sp_{key}_worst_grad"] = results[0]["sp"][key]["worst"]
        runs = [res["sp"][f"{impl}_bf16"] for res in results]
        if impl == "ring":
            bad = results[0]["sp"]["ring_bf16"]["planted_worst"]
            bound = MP_BF16_TOL[1]
            check(bad > bound, f"phase 9a: the bound {bound} would pass the "
                               f"ring with lse cut from the graph (worst "
                               f"gradient {bad:.3e} of its leaf's max)")
            log(f"phase 9a: planted fault, the ring's lse cut from the "
                f"graph: worst gradient {bad:.3e} of its leaf's max, over "
                f"the bound {bound}: caught")
            stats["sp_ring_planted_lse_fault_worst_grad"] = bad
            launches["sp_ring_full"] = {
                name: sum(r["full_launches"][name] for r in runs)
                for name in FLASH_NAMES}
            launches["sp_ring_diagonal"] = {
                name: sum(r["launches"][name] - r["full_launches"][name]
                          for r in runs) for name in FLASH_NAMES}
        else:
            launches["sp_ulysses"] = {
                name: sum(r["launches"][name] for r in runs)
                for name in FLASH_NAMES}
        for r, res in enumerate(results):
            b = res["sp"][f"{impl}_bf16"]
            log(f"phase 9a: {impl} bf16 rank {r}: {b['ms_per_step']:.1f} ms "
                f"per step ({GLOO_LABEL}), peak memory of a train step "
                f"{b['peak'] / 2**30:.1f} GiB; launches per step "
                + ", ".join(f"{k} {v}" for k, v in b["launches"].items()))
            stats[f"sp_{impl}_ms_per_step_rank{r}"] = b["ms_per_step"]
            stats[f"sp_{impl}_peak_bytes_rank{r}"] = b["peak"]
        _log_bytes(f"phase 9a: {impl}", results[0]["sp"][f"{impl}_bf16"]
                   ["bytes_per_step"], stats, f"sp_{impl}")
    for r, res in enumerate(results):
        f = res["fsdp"]
        _check_rank("phase 9b", r, f, MP_RANKS, FSDP_LAYERS, "fsdp")
        log(f"phase 9b: FSDP rank {r}: {f['ms_per_step']:.1f} ms per step "
            f"({GLOO_LABEL}), peak memory of a train step "
            f"{f['peak'] / 2**30:.1f} GiB, parameters and moments held "
            f"{f['resident']} bytes")
        stats[f"fsdp_ms_per_step_rank{r}"] = f["ms_per_step"]
        stats[f"fsdp_peak_bytes_rank{r}"] = f["peak"]
    whole = results[0]["fsdp"]["whole_bytes"]
    for r, res in enumerate(results):
        check(res["fsdp"]["resident"] <= whole / MP_RANKS * 1.01,
              f"phase 9b: rank {r} holds {res['fsdp']['resident']} bytes of "
              f"parameters and moments, over 1/{MP_RANKS} of {whole} + 1%")
    log(f"phase 9b: the one-rank state is {whole} bytes; each rank holds "
        f"{max(r['fsdp']['resident'] for r in results) / whole:.4f} of it")
    stats["fsdp_loss_diff"] = _check_parity(
        f"phase 9b FSDP bf16 (B {FSDP_B} T {FSDP_T}, {FSDP_LAYERS} layers)",
        results[0]["fsdp"])
    stats["fsdp_worst_grad"] = results[0]["fsdp"]["worst"]
    launches["fsdp"] = {name: sum(res["fsdp"]["launches"][name]
                                  for res in results) for name in FLASH_NAMES}
    _log_bytes("phase 9b: FSDP", results[0]["fsdp"]["bytes_per_step"],
               stats, "fsdp")
    del results

    # 9c (with 10d's and 11b's work): the same steps through an NCCL group
    # of one rank, started once for the three
    t0 = time.monotonic()
    nccl_work = Path(__file__).resolve().parent / "build" / "chip_smoke_nccl"
    shutil.rmtree(nccl_work, ignore_errors=True)
    nccl_work.mkdir(parents=True)
    nccl_data = str(nccl_work / "tokens.bin")
    write_token_file(nccl_data, np.random.default_rng(11).integers(
        0, _el_cfg().vocab_size, size=4_000_000))
    (both,) = launch.run(nccl_rank, 1, nccl_data, str(nccl_work),
                         backend="nccl", timeout=MP_TIMEOUT,
                         workdir=str(nccl_work))
    shutil.rmtree(nccl_work, ignore_errors=True)
    NCCL_RESULTS.update(both)
    wall = time.monotonic() - t0
    log(f"phases 9c/10d/11b: one NCCL rank at world size 1, wall "
        f"{wall:.1f} s (the rank's own: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in both["seconds"].items()) + ")")
    stats["nccl_rank_wall_s"] = wall
    one = both["9c"]
    check(one["backend"] == "nccl", f"phase 9c ran on {one['backend']}")
    for key, res in one["sp"].items():
        impl, tag = key.split("_")
        _check_rank(f"phase 9c {tag}", 0, res, 1, SP_LAYERS, f"sp {impl}")
        check(res["calls"]["psum"] > 0, f"phase 9c: {key} ran no all-reduce")
        stats[f"nccl_sp_{key}_loss_diff"] = _check_parity(
            f"phase 9c NCCL {impl} {tag}", res)
    check(one["sp"]["ulysses_bf16"]["calls"]["all_to_all"] > 0,
          "phase 9c: Ulysses ran no all-to-all")
    _check_rank("phase 9c", 0, one["fsdp"], 1, FSDP_LAYERS, "fsdp")
    check(one["fsdp"]["calls"]["all_gather"] > 0
          and one["fsdp"]["calls"]["reduce_scatter"] > 0,
          f"phase 9c: FSDP ran {one['fsdp']['calls']}")
    stats["nccl_fsdp_loss_diff"] = _check_parity("phase 9c NCCL FSDP",
                                                 one["fsdp"])
    log(f"phase 9c: NCCL at world size 1, {both['seconds']['9c']:.1f} s; "
        f"collectives called: SP ring {one['sp']['ring_bf16']['calls']}, "
        f"FSDP {one['fsdp']['calls']}")

    # 9d: the CLI, drained at 2 ranks (in 9a/9b's ranks) and resumed at 1
    check([r["rc"] for r in cli_res] == [0] * MP_RANKS,
          f"phase 9d: {cli_res}")
    check("preempted at step 3; checkpoint 3 saved" in cli_res[0]["out"],
          f"phase 9d: the drain did not stop at step 3: "
          f"{cli_res[0]['out']}")
    check((work / "drained" / "2").is_dir(), "phase 9d: no checkpoint at 2")
    outs = {}
    for name in ("drained", "straight"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(argv(name))
        check(rc == 0, f"phase 9d: train.main returned {rc}")
        outs[name] = buf.getvalue()
        log(f"phase 9d: train.main --ckpt {name} at 1 rank: "
            f"{outs[name].strip().splitlines()[-1]}")
    check("done: 3 steps" in outs["drained"],
          f"phase 9d: the resume did not run steps 4-6: {outs['drained']}")

    def last_loss(out):
        m = re.search(r"\(step 6 loss ([0-9.]+)\)", out)
        check(m is not None, f"no step-6 loss in {out!r}")
        return float(m.group(1))

    a, b = last_loss(outs["straight"]), last_loss(outs["drained"])
    # bf16: 2 ranks sum each gradient's halves in fp32 and round once
    # where one rank rounds the whole batch's; the CPU test's bound
    check(abs(a - b) <= 1e-3 * a, f"phase 9d: step-6 loss {b} after a "
                                  f"drain at 2 ranks and a resume at 1 "
                                  f"vs {a}")
    log(f"phase 9d: step-6 loss drained at {MP_RANKS} ranks and resumed at "
        f"1: {b}, uninterrupted at 1: {a} (diff {abs(a - b):.2e}, bound "
        f"1e-3 relative)")
    stats.update(cli_step6_loss_resumed=b, cli_step6_loss_straight=a)
    shutil.rmtree(work, ignore_errors=True)
    stats["launches"] = launches
    return stats


# ------------------------------------------------ pipeline, 3-D, experts

# phase 10's ranks share the card over gloo as phase 9's do (MP_TIMEOUT,
# GLOO_LABEL); each multi-rank step is held against its one-rank step by
# phase 9's bounds (MP_BF16_TOL), every gradient leaf gathered whole
# over the axes that split it. NCCL at world size 1 (10d) must give the
# loss of the same path with no process group to within this share.
NCCL_LOSS_RTOL = 1e-6


def _whole_on_rank0(torch, dist, x, spec, mesh):
    """A leaf that ``spec`` splits over ``mesh``, whole on rank 0 (None
    elsewhere): every rank's slice gathered to rank 0 through the host,
    half the bytes of an all-gather."""
    from k8s_operator_libs_tpu_torch.parallel.fsdp import full_shape
    from k8s_operator_libs_tpu_torch.utils.mesh import coordinates
    split = {}
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None and mesh.size(axis) > 1:
                split.setdefault(d, []).append(axis)
    if not split:
        return x if dist.get_rank() == 0 else None
    host = x.detach().cpu().contiguous()
    if dist.get_rank() != 0:
        dist.gather(host, dst=0)
        return None
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.gather(host, parts, dst=0)
    full = torch.empty(full_shape(x, spec, mesh), dtype=x.dtype)
    for j, part in enumerate(parts):
        c = coordinates(mesh.shape, j)
        idx = [slice(None)] * x.dim()
        for d, axes in split.items():
            pos = 0
            for axis in axes:          # a dim split over several: outer first
                pos = pos * mesh.size(axis) + c[axis]
            idx[d] = slice(pos * x.shape[d], (pos + 1) * x.shape[d])
        full[tuple(idx)] = part
    return full.to(x.device)


def _worst_sharded(torch, dist, grads, specs, mesh, ref):
    """phase 9's worst gradient reading over leaves that ``specs`` split
    over ``mesh``: each leaf gathered whole to rank 0 (every rank joins)
    and read there against ``ref`` (None elsewhere)."""
    from k8s_operator_libs_tpu_torch.models.llama import param_leaves
    from k8s_operator_libs_tpu_torch.parallel import fsdp
    flat_specs = []
    fsdp._tree_map(lambda g, s: flat_specs.append(s), grads, specs)
    refs = list(param_leaves(ref)) if ref is not None else None
    worst = 0.0
    for i, (g, spec) in enumerate(zip(param_leaves(grads), flat_specs)):
        full = _whole_on_rank0(torch, dist, g, spec, mesh)
        if full is not None:
            b = refs[i].to(full.device).float()
            worst = max(worst, float((full.float() - b).abs().max()
                                     / b.abs().max().clamp_min(1e-30)))
        del full
    return worst if ref is not None else None


def _state_bytes(state, keys=None):
    """Bytes of parameters and both moments, of the leaves whose top-level
    key is in ``keys`` (all when None)."""
    from k8s_operator_libs_tpu_torch.models.llama import param_leaves
    total = 0
    for tree in (state.params, state.opt_state.mu, state.opt_state.nu):
        for k, v in tree.items():
            if keys is None or k in keys:
                total += sum(t.numel() * t.element_size()
                             for t in param_leaves({k: v}))
    return total


def _one_rank_ref(torch, dist, loss_fn, init, tokens):
    """The one-rank step on rank 0 (loss and gradients moved to the host,
    the card freed), and the bytes of its parameters; None elsewhere."""
    from k8s_operator_libs_tpu_torch.models.llama import param_leaves
    from k8s_operator_libs_tpu_torch.parallel import fsdp
    out = (None, None, 0)
    if dist.get_rank() == 0:
        params = init()
        nbytes = sum(t.numel() * t.element_size()
                     for t in param_leaves(params))
        loss, grads = fsdp.value_and_grad(loss_fn, params, tokens)
        out = (float(loss), _host_tree(grads), nbytes)
        del params, grads
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _path_step(torch, loss_fn, params, tokens, specs, mesh, ref, tol,
               grads=True):
    """One step of a path on every rank: its loss, launches, routes,
    collectives, peak, and on rank 0 the one-rank loss ``ref[0]`` and,
    with ``grads`` (every rank must agree on it), the worst gradient
    reading against ``ref[1]``."""
    import torch.distributed as dist

    from k8s_operator_libs_tpu_torch.ops import attention as fa
    from k8s_operator_libs_tpu_torch.utils import comm
    from k8s_operator_libs_tpu_torch.parallel import fsdp
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    comm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    loss, got = fsdp.value_and_grad(loss_fn, params, tokens)
    torch.cuda.synchronize()
    res = {"loss": float(loss), "launches": dict(fa.LAUNCHES),
           "routes": dict(fa.ROUTE_LAUNCHES), "calls": dict(comm.CALLS),
           "peak": torch.cuda.max_memory_allocated()}
    if ref[0] is not None:
        res.update(ref_loss=ref[0], tol=tol)
    if grads:
        worst = _worst_sharded(torch, dist, got, specs, mesh, ref[1])
        if ref[1] is not None:
            res["worst"] = worst
    del got
    torch.cuda.empty_cache()
    return res


def _mp_pp(torch, dist):
    """10a in one rank: the one-rank step, then the pipeline over every
    rank (stage = world), then timed steps."""
    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          init_params)
    from k8s_operator_libs_tpu_torch.parallel import fsdp, pipeline
    from k8s_operator_libs_tpu_torch.utils.mesh import make_mesh
    cfg = LlamaConfig.llama3_8b(n_layers=PP_LAYERS, max_seq_len=PP_T)
    tokens = _tokens(torch, cfg, PP_B, PP_T, 13)
    ref = _one_rank_ref(torch, dist,
                        lambda p, t: fsdp.causal_lm_loss(p, t, cfg),
                        lambda: init_params(cfg, seed=0, device="cuda"),
                        tokens)
    mesh = make_mesh(stage=dist.get_world_size(), fsdp=1)
    specs = pipeline.pp_param_specs()
    state = pipeline.init_pp_state(cfg, 0, mesh, device="cuda")
    res = _path_step(torch, pipeline.make_pp_loss(cfg, mesh, PP_M),
                     state.params, tokens, specs, mesh, ref, MP_BF16_TOL)
    res.update(resident=_state_bytes(state), whole_bytes=3 * ref[2])
    res.update(_timed_steps(torch, pipeline.make_pp_train_step(
        cfg, mesh, PP_M), state.params, tokens, dist))
    del state
    torch.cuda.empty_cache()
    return res


def _mp_3d(torch, dist):
    """10b in one rank: the one-rank step, the composed step over stage 2
    x tensor 2 (and again with the column-parallel input's replicate
    planted away), the bytes held, timed steps."""
    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          init_params)
    from k8s_operator_libs_tpu_torch.parallel import composed, fsdp
    from k8s_operator_libs_tpu_torch.utils.mesh import make_mesh
    cfg = LlamaConfig.llama3_8b(n_layers=TD_LAYERS, max_seq_len=TD_T)
    tokens = _tokens(torch, cfg, TD_B, TD_T, 14)
    whole = {}

    def init():
        params = init_params(cfg, seed=0, device="cuda")
        for key in ("blocks", "embed", "lm_head"):
            whole[key] = 3 * sum(t.numel() * t.element_size() for t in (
                params[key].values() if key == "blocks" else [params[key]]))
        return params

    ref = _one_rank_ref(torch, dist,
                        lambda p, t: fsdp.causal_lm_loss(p, t, cfg), init,
                        tokens)
    mesh = make_mesh(stage=TD_S, fsdp=1, tensor=TD_TP)
    specs = composed.composed_param_specs()
    state = composed.init_composed_state(cfg, 0, mesh,
                                         device="cuda")
    res = _path_step(torch, composed.make_composed_loss(cfg, mesh, TD_M),
                     state.params, tokens, specs, mesh, ref, MP_BF16_TOL)
    res.update(blocks=_state_bytes(state, ("blocks",)),
               embed_head=_state_bytes(state, ("embed", "lm_head")),
               whole=whole)
    real = composed.column_input
    composed.column_input = lambda h, group: h
    try:
        bad = _path_step(torch, composed.make_composed_loss(cfg, mesh, TD_M),
                         state.params, tokens, specs, mesh, ref,
                         MP_BF16_TOL)
    finally:
        composed.column_input = real
    res["planted_worst"] = bad.get("worst")
    res.update(_timed_steps(torch, composed.make_composed_train_step(
        cfg, mesh, TD_M), state.params, tokens, dist))
    del state
    torch.cuda.empty_cache()
    return res


def _one_rank_loss(torch, dist, loss_fn, init, tokens):
    """The one-rank loss on rank 0 (forward only, the card freed); None
    elsewhere."""
    loss = None
    if dist.get_rank() == 0:
        params = init()
        with torch.no_grad():
            loss = float(loss_fn(params, tokens))
        del params
        torch.cuda.empty_cache()
    dist.barrier()
    return (loss, None, 0)


def _mp_ep(torch, dist):
    """10c in one rank. fp32 (B 2 x T EP32_T): dense dispatch against the
    one-rank step, lossless a2a (aux off) against the one-rank step
    without aux, every gradient leaf. bf16 (B 2 x T 2048): the same two
    steps against the one-rank losses, the kept pairs at capacity factor
    EP_CF, two a2a optimizer steps there, timed."""
    import dataclasses

    from k8s_operator_libs_tpu_torch.models import moe
    from k8s_operator_libs_tpu_torch.parallel import expert, fsdp
    from k8s_operator_libs_tpu_torch.utils.mesh import make_mesh
    mesh = make_mesh(tensor=dist.get_world_size(), fsdp=1)
    specs = expert.ep_param_specs()
    out = {}
    for dtype, T in ((torch.float32, EP32_T), (torch.bfloat16, EP_T)):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        cfg = moe.MoEConfig.llama3_8b(n_layers=EP_LAYERS, max_seq_len=T,
                                      dtype=dtype)
        cfg0 = dataclasses.replace(cfg, router_aux_coef=0.0)
        tokens = _tokens(torch, cfg, EP_B, T, 15)
        params = expert.init_ep_state(cfg, 0, mesh, device="cuda").params

        def init():
            return moe.init_params(cfg, seed=0, device="cuda")

        one_rank = (_one_rank_ref if dtype == torch.float32
                    else _one_rank_loss)
        tol = MP_FP32_TOL if dtype == torch.float32 else MP_BF16_TOL
        for kind, c, loss_fn in (
                ("dense", cfg, expert.make_ep_loss(cfg, mesh)),
                ("a2a", cfg0, expert.make_ep_a2a_loss(
                    cfg0, mesh, cfg.n_experts / cfg.top_k))):
            ref = one_rank(torch, dist, expert.moe_reference_loss(c), init,
                           tokens)
            out[f"{kind}_{tag}"] = _path_step(
                torch, loss_fn, params, tokens, specs, mesh, ref, tol,
                grads=dtype == torch.float32)
            del ref
        if dtype == torch.float32:
            del params
            torch.cuda.empty_cache()
            continue
        record = []
        with torch.no_grad():
            expert.make_ep_a2a_loss(cfg, mesh, EP_CF, record)(params, tokens)
        routed = sum(int(m.sum()) for m, _ in record)
        dropped = sum(int((m & ~k).sum()) for m, k in record)
        del record
        opt = fsdp.default_optimizer()
        state = fsdp.TrainState(params=params, opt_state=opt.init(params),
                                step=0)
        step = expert.make_ep_train_step(cfg, mesh, opt, dispatch="a2a",
                                         capacity_factor=EP_CF)
        losses = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.monotonic()
        for _ in range(2):
            state, m = step(state, tokens)
            losses.append(float(m["loss"]))
        ms = (time.monotonic() - t0) / 2 * 1e3
        out["train"] = {"losses": losses, "routed": routed,
                        "dropped": dropped, "ms_per_step": ms,
                        "peak": torch.cuda.max_memory_allocated()}
        del state, params
        torch.cuda.empty_cache()
    return out


def phase10_pair_rank(cli_runs):
    """The body of one rank of phase 10a and 10c (2 ranks), then 10e's
    CLI runs at 2 ranks (:func:`phase10_cli_rank`) in the same ranks."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    pp = _mp_pp(torch, dist)
    t1 = time.monotonic()
    ep = _mp_ep(torch, dist)
    t2 = time.monotonic()
    cli = phase10_cli_rank(cli_runs)
    return {"pp": pp, "ep": ep, "cli": cli, "pp_s": t1 - t0,
            "ep_s": t2 - t1, "cli_s": time.monotonic() - t2}


def phase10_quad_rank(cli_runs):
    """The body of one rank of phase 10b (4 ranks), then 10e's CLI runs
    at 4 ranks in the same ranks."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    td = _mp_3d(torch, dist)
    t1 = time.monotonic()
    cli = phase10_cli_rank(cli_runs)
    check_threads_stopped(f"phase 10b {rank_name()}")
    return {"3d": td, "cli": cli, "wall_s": t1 - t0,
            "cli_s": time.monotonic() - t1}


def phase10_nccl_rank():
    """10d: each path's loss through an NCCL group of one rank against
    the same path with no process group (every collective the identity),
    and the collectives each called through NCCL."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from k8s_operator_libs_tpu_torch.models import moe
    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          init_params)
    from k8s_operator_libs_tpu_torch.utils import comm
    from k8s_operator_libs_tpu_torch.parallel import (composed, expert, fsdp,
                                                      pipeline)
    from k8s_operator_libs_tpu_torch.utils.mesh import (local_mesh,
                                                        make_mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=PP_LAYERS, max_seq_len=PP_T)
    mcfg = moe.MoEConfig.llama3_8b(n_layers=EP_LAYERS, max_seq_len=EP_T)
    out = {"backend": dist.get_backend()}
    paths = (
        ("pp", cfg, PP_B, lambda m: pipeline.make_pp_loss(cfg, m, PP_M)),
        ("3d", cfg, TD_B, lambda m: composed.make_composed_loss(cfg, m,
                                                                TD_M)),
        ("ep_dense", mcfg, EP_B, lambda m: expert.make_ep_loss(mcfg, m)),
        ("ep_a2a", mcfg, EP_B, lambda m: expert.make_ep_a2a_loss(
            dataclasses.replace(mcfg, router_aux_coef=0.0), m,
            mcfg.n_experts / mcfg.top_k)))
    params = None
    for name, c, B, make in paths:
        if params is None or params[0] is not c:
            params = None
            torch.cuda.empty_cache()
            params = (c, (moe.init_params if c is mcfg else init_params)(
                c, seed=0, device="cuda"))
        tokens = _tokens(torch, c, B, PP_T, 16)
        local_loss, _ = fsdp.value_and_grad(make(local_mesh()), params[1],
                                            tokens)
        comm.reset_counts()
        loss, _ = fsdp.value_and_grad(make(make_mesh(fsdp=1)), params[1],
                                      tokens)
        torch.cuda.synchronize()
        out[name] = {"loss": float(loss), "local_loss": float(local_loss),
                     "calls": dict(comm.CALLS)}
    del params
    torch.cuda.empty_cache()
    return out


def phase10_cli_rank(runs):
    """``train.main`` for each (argv, drain_at) in turn in one rank, rank
    0 signalling a drain before step ``drain_at``; the output and the
    flash launches of each run."""
    import contextlib
    import io

    import torch.distributed as dist

    from k8s_operator_libs_tpu_torch import train
    from k8s_operator_libs_tpu_torch.ops import attention as fa
    rank = dist.get_rank()
    out = []
    for argv, drain_at in runs:
        calls = {"n": 0}

        def drain():
            calls["n"] += 1
            return rank == 0 and drain_at is not None \
                and calls["n"] == drain_at

        fa.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(argv, drain_signal=drain)
        out.append({"rc": rc, "out": buf.getvalue(),
                    "launches": dict(fa.LAUNCHES)})
    return out


def _check_counts(tag, res, want, route="wgmma"):
    check(res["launches"] == {name: want for name in FLASH_NAMES},
          f"{tag}: launched {res['launches']}, expected {want} of each")
    check(res["routes"] == {"wgmma": 0, "fma": 0, route: 3 * want},
          f"{tag}: took routes {res['routes']}")


def _log_rank_times(tag, results, key, stats, skey):
    for r, res in enumerate(results):
        b = res[key] if key else res
        log(f"{tag} rank {r}: {b['ms_per_step']:.1f} ms per step "
            f"({GLOO_LABEL}), peak memory of a train step "
            f"{b['peak'] / 2**30:.1f} GiB; launches per step "
            + ", ".join(f"{k} {v}" for k, v in b["launches"].items()))
        stats[f"{skey}_ms_per_step_rank{r}"] = b["ms_per_step"]
        stats[f"{skey}_peak_bytes_rank{r}"] = b["peak"]


def _last_loss(out, step):
    m = re.search(rf"\(step {step} loss ([0-9.]+)\)", out)
    check(m is not None, f"no step-{step} loss in {out!r}")
    return float(m.group(1))


def phase10_inputs():
    """Phase 10's work directory, made afresh with 10e's token files, its
    ``argv(ckpt, parallel, ...)`` for ``train.main``, and 10e's runs:
    ``ep_runs`` at 2 ranks (10a/10c's, which phase 9 starts) and
    ``td_runs`` at 4 (10b's), each ``(argv, drain_at)``."""
    import shutil

    import numpy as np

    from k8s_operator_libs_tpu_torch.data.loader import write_token_file

    work = Path(__file__).resolve().parent / "build" / "chip_smoke_pp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    data = work / "tokens.bin"
    write_token_file(str(data), np.random.default_rng(7).integers(
        0, 32000, size=200_000))
    moe_data = work / "moe_tokens.bin"      # moe_tiny's vocabulary is 512
    write_token_file(str(moe_data), np.random.default_rng(7).integers(
        0, 512, size=200_000))
    cycle = work / "cycle.bin"
    write_token_file(str(cycle), np.tile(np.arange(16), 20_000))

    def argv(ckpt, parallel, model="small", steps=6, tokens=data,
             extra=()):
        return ["--data", str(tokens), "--ckpt", str(work / ckpt),
                "--model", model, "--seq", "512" if model == "small"
                else "256", "--batch", "4" if model == "small" else "8",
                "--steps", str(steps), "--ckpt-interval", "2" if steps > 1
                else "1", "--device", "cuda", "--parallel", parallel,
                *extra]

    a2a = ("--moe-dispatch", "a2a")
    check(EP_RANKS == PP_S and TD_S * TD_TP == 4,
          "phase 10e's CLI ranks are not 10a/10c's and 10b's")
    ep_runs = [
        (argv("a2a_straight", "ep", "moe_tiny", tokens=moe_data,
              extra=a2a), None),
        (argv("a2a_drained", "ep", "moe_tiny", tokens=moe_data,
              extra=a2a), 4),
        (argv("a2a_drained", "ep", "moe_tiny", tokens=moe_data,
              extra=a2a), None)]
    td_runs = [
        (argv("drained3d", "3d"), 4),
        (argv("moe3d", "3d", "moe_tiny", 1, cycle), None),
        (argv("moe3d", "3d", "moe_tiny", 3, cycle), None)]
    return {"work": work, "argv": argv, "ep_runs": ep_runs,
            "td_runs": td_runs}


def phase_pp_tp_ep(torch):
    """Phase 10: pipeline (10a), 3-D (10b) and expert parallelism (10c) at
    Llama-3-8B width on the one card over gloo, held against their
    one-rank steps; the same paths through NCCL at world size 1 (10d);
    and the CLI's ``--parallel 3d`` and ``ep --moe-dispatch a2a`` (10e).
    10a, 10c and 10e's 2-rank runs ran in phase 9's ranks, 10d in its
    NCCL rank; this phase checks their results."""
    import contextlib
    import io
    import shutil

    from k8s_operator_libs_tpu_torch import train
    from k8s_operator_libs_tpu_torch.parallel import launch

    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"phase 10: {held / 2**30:.1f} GiB of the earlier "
                        f"phases is still allocated")
    torch.cuda.empty_cache()
    work, argv = PAIR_RESULTS["work"], PAIR_RESULTS["argv"]
    stats, launches = {}, {}

    # 10a and 10c (then 10e's ep runs): two ranks, phase 9's
    pair = PAIR_RESULTS["ranks"]
    ep_cli = [r["cli"] for r in pair]
    ep_cli_s = max(r["cli_s"] for r in pair)
    log(f"phase 10a/10c/10e: {PP_S} ranks over gloo, in phase 9's ranks "
        f"(pipeline " + ", ".join(f"{r['pp_s']:.1f}" for r in pair)
        + " s, experts " + ", ".join(f"{r['ep_s']:.1f}" for r in pair)
        + " s by rank)")
    want = PP_LAYERS // PP_S * (PP_S + PP_M - 1)
    for r, res in enumerate(pair):
        # (L/S)(S + M - 1): every tick, bubbles included, each direction
        _check_counts(f"phase 10a rank {r}", res["pp"], want)
        check(abs(res["pp"]["loss"] - pair[0]["pp"]["loss"])
              <= 1e-6 * abs(pair[0]["pp"]["loss"]),
              "phase 10a: the stages disagree on the loss")
    stats["pp_loss_diff"] = _check_parity(
        f"phase 10a PP (stage {PP_S}, M {PP_M}, B {PP_B} T {PP_T}, "
        f"{PP_LAYERS} layers)", pair[0]["pp"])
    stats["pp_worst_grad"] = pair[0]["pp"]["worst"]
    _log_rank_times("phase 10a: PP", pair, "pp", stats, "pp")
    whole = pair[0]["pp"]["whole_bytes"]
    for r, res in enumerate(pair):
        log(f"phase 10a: rank {r} holds {res['pp']['resident']} bytes of "
            f"parameters and moments ({res['pp']['resident'] / whole:.4f} "
            f"of the one-rank {whole})")
    _log_bytes("phase 10a: PP", pair[0]["pp"]["bytes_per_step"], stats, "pp")
    launches["pp"] = {n: sum(r["pp"]["launches"][n] for r in pair)
                      for n in FLASH_NAMES}

    # 10c: attention is the one-rank's on every rank (dense: the whole
    # batch; a2a: this rank's rows), L launches of each kernel
    for kind in ("dense", "a2a"):
        what = ("dense dispatch vs the one-rank step" if kind == "dense"
                else "a2a at capacity factor E/top_k (lossless), aux off, "
                     "vs the one-rank step without aux")
        for tag, route in (("fp32", "fma"), ("bf16", "wgmma")):
            for r, res in enumerate(pair):
                _check_counts(f"phase 10c {kind} {tag} rank {r}",
                              res["ep"][f"{kind}_{tag}"], EP_LAYERS, route)
        res = pair[0]["ep"][f"{kind}_fp32"]
        stats[f"ep_{kind}_fp32_loss_diff"] = _check_parity(
            f"phase 10c EP {what} (MoE {EP_LAYERS} layers, fp32, B {EP_B} "
            f"T {EP32_T})", res)
        stats[f"ep_{kind}_fp32_worst_grad"] = res["worst"]
        res = pair[0]["ep"][f"{kind}_bf16"]
        d = abs(res["loss"] - res["ref_loss"])
        check(math.isfinite(res["loss"])
              and d <= MP_BF16_TOL[0] * abs(res["ref_loss"]),
              f"phase 10c: {kind} bf16 loss {res['loss']} vs the one-rank "
              f"step {res['ref_loss']}")
        log(f"phase 10c EP {what} (bf16, B {EP_B} T {EP_T}): loss "
            f"{res['loss']:.6f} vs one-rank {res['ref_loss']:.6f} (diff "
            f"{d:.2e}, bound {MP_BF16_TOL[0]} relative)")
        stats[f"ep_{kind}_bf16_loss_diff"] = d
        launches[f"ep_{kind}"] = {
            n: sum(r["ep"][f"{kind}_bf16"]["launches"][n] for r in pair)
            for n in FLASH_NAMES}
    for r, res in enumerate(pair):
        t = res["ep"]["train"]
        check(all(math.isfinite(x) for x in t["losses"])
              and t["losses"][1] < t["losses"][0],
              f"phase 10c: a2a (capacity factor {EP_CF}) rank {r} losses "
              f"{t['losses']}")
        log(f"phase 10c: a2a at capacity factor {EP_CF}, rank {r}: losses "
            f"{' '.join(f'{x:.4f}' for x in t['losses'])} (falling), "
            f"{t['dropped']} of {t['routed']} routed (token, expert) pairs "
            f"dropped, {t['ms_per_step']:.1f} ms per step ({GLOO_LABEL}), "
            f"peak {t['peak'] / 2**30:.1f} GiB")
        stats[f"ep_a2a_dropped_rank{r}"] = t["dropped"]
        stats[f"ep_a2a_routed_rank{r}"] = t["routed"]
        stats[f"ep_a2a_ms_per_step_rank{r}"] = t["ms_per_step"]
    del pair

    # 10b: four ranks (then 10e's 3d runs)
    t0 = time.monotonic()
    quad = launch.run(phase10_quad_rank, TD_S * TD_TP,
                      PAIR_RESULTS["td_runs"], backend="gloo",
                      timeout=MP_TIMEOUT, workdir=str(work))
    runs = [r["cli"] for r in quad]
    td_cli_s = max(r["cli_s"] for r in quad)
    log(f"phase 10b/10e: {TD_S * TD_TP} ranks over gloo, wall "
        f"{time.monotonic() - t0:.1f} s (10e's 3d runs "
        + ", ".join(f"{r['cli_s']:.1f}" for r in quad) + " s by rank)")
    want = TD_LAYERS // TD_S * (TD_S + TD_M - 1)
    for r, res in enumerate(quad):
        _check_counts(f"phase 10b rank {r}", res["3d"], want)
    res0 = quad[0]["3d"]
    stats["3d_loss_diff"] = _check_parity(
        f"phase 10b 3D (stage {TD_S} x tensor {TD_TP}, M {TD_M}, B {TD_B} "
        f"T {TD_T}, {TD_LAYERS} layers)", res0)
    stats["3d_worst_grad"] = res0["worst"]
    bad, bound = res0["planted_worst"], MP_BF16_TOL[1]
    check(bad > bound, f"phase 10b: the bound {bound} would pass the step "
                       f"without the column-parallel input's replicate "
                       f"(worst gradient {bad:.3e} of its leaf's max)")
    log(f"phase 10b: planted fault, no replicate before the column-parallel"
        f" matmuls: worst gradient {bad:.3e} of its leaf's max, over the "
        f"bound {bound}: caught")
    stats["3d_planted_column_fault_worst_grad"] = bad
    whole = res0["whole"]
    for r, res in enumerate(quad):
        b = res["3d"]
        check(b["blocks"] <= whole["blocks"] / (TD_S * TD_TP) * 1.01,
              f"phase 10b: rank {r} holds {b['blocks']} bytes of the layer "
              f"stacks, over 1/{TD_S * TD_TP} of {whole['blocks']} + 1%")
        eh = whole["embed"] + whole["lm_head"]
        check(b["embed_head"] <= eh / TD_TP * 1.01,
              f"phase 10b: rank {r} holds {b['embed_head']} bytes of embed "
              f"and lm_head, over 1/{TD_TP} of {eh} + 1%")
        log(f"phase 10b: rank {r} holds {b['blocks'] / whole['blocks']:.4f}"
            f" of the layer stacks and {b['embed_head'] / eh:.4f} of "
            f"embed/lm_head (parameters and moments)")
    _log_rank_times("phase 10b: 3D", quad, "3d", stats, "3d")
    _log_bytes("phase 10b: 3D", res0["bytes_per_step"], stats, "3d")
    launches["tp"] = {n: sum(r["3d"]["launches"][n] for r in quad)
                      for n in FLASH_NAMES}
    del quad

    # 10d: NCCL at world size 1 (in phase 9's NCCL rank)
    one = NCCL_RESULTS["10d"]
    check(one["backend"] == "nccl", f"phase 10d ran on {one['backend']}")
    used = {"pp": ("psum", "pmax"),
            "3d": ("psum", "pmax", "all_gather", "reduce_scatter"),
            "ep_dense": ("psum",), "ep_a2a": ("psum", "all_to_all")}
    for name, kinds in used.items():
        res = one[name]
        d = abs(res["loss"] - res["local_loss"])
        check(d <= NCCL_LOSS_RTOL * abs(res["local_loss"]),
              f"phase 10d: {name} loss {res['loss']} through NCCL vs "
              f"{res['local_loss']} with no process group")
        check(all(res["calls"][k] > 0 for k in kinds),
              f"phase 10d: {name} called {res['calls']}")
        stats[f"nccl_{name}_loss_diff"] = d
    log(f"phase 10d: NCCL at world size 1, "
        f"{NCCL_RESULTS['seconds']['10d']:.1f} s in phase 9's NCCL rank; "
        f"loss through NCCL vs no process group: "
        + ", ".join(
            f"{n} {one[n]['loss']:.6f}/{one[n]['local_loss']:.6f}"
            for n in used) + "; collectives called: " + ", ".join(
            f"{n} {dict((k, v) for k, v in one[n]['calls'].items() if v)}"
            for n in used))

    # 10e: the CLI (its multi-rank runs ran in 10a/10c's and 10b's ranks)
    t0 = time.monotonic()
    check(all(c["rc"] == 0 for r in runs for c in r),
          f"phase 10e: {[[c['rc'] for c in r] for r in runs]}")
    drained, first, third = (c["out"] for c in runs[0])
    check("preempted at step 3; checkpoint 3 saved" in drained,
          f"phase 10e: the 3d drain did not stop at step 3: {drained}")
    check((work / "drained3d" / "2").is_dir(), "phase 10e: no checkpoint 2")
    # moe_tiny 3d, 3 steps (1 + a resumed 2): (L/S)(S + M - 1) per step
    want = 2 // TD_S * (TD_S + TD_M - 1) * 3
    for r, res in enumerate(runs):
        got = {n: res[1]["launches"][n] + res[2]["launches"][n]
               for n in FLASH_NAMES}
        check(got == {n: want for n in FLASH_NAMES},
              f"phase 10e: moe_tiny 3d rank {r} launched {got}, expected "
              f"{want} of each")
    l1, l3 = _last_loss(first, 1), _last_loss(third, 3)
    check(l3 < l1, f"phase 10e: moe_tiny 3d loss {l1} -> {l3} did not fall")
    log(f"phase 10e: train.main --model moe_tiny --parallel 3d at "
        f"{TD_S * TD_TP} ranks: step 1 loss {l1}, step 3 loss {l3} "
        f"(falling); flash launches per rank {want} of each")
    outs = {}
    for name in ("drained3d", "straight3d"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(argv(name, "none"))
        check(rc == 0, f"phase 10e: train.main returned {rc}")
        outs[name] = buf.getvalue()
    check("done: 3 steps" in outs["drained3d"],
          f"phase 10e: the resume did not run steps 4-6: "
          f"{outs['drained3d']}")
    a, b = _last_loss(outs["straight3d"], 6), _last_loss(outs["drained3d"],
                                                         6)
    check(abs(a - b) <= 1e-3 * a, f"phase 10e: step-6 loss {b} after a "
                                  f"3d drain at 4 ranks and a resume at 1 "
                                  f"vs {a}")
    log(f"phase 10e: --parallel 3d (small) drained at {TD_S * TD_TP} ranks "
        f"and resumed at 1: step-6 loss {b}, uninterrupted at 1: {a} (diff "
        f"{abs(a - b):.2e}, bound 1e-3 relative)")
    stats.update(cli_3d_step6_loss_resumed=b, cli_3d_step6_loss_straight=a,
                 cli_moe3d_losses=[l1, l3])
    runs = ep_cli
    check(all(c["rc"] == 0 for r in runs for c in r),
          f"phase 10e: {[[c['rc'] for c in r] for r in runs]}")
    straight, drained, resumed = (c["out"] for c in runs[0])
    check("preempted at step 3; checkpoint 3 saved" in drained,
          f"phase 10e: the a2a drain did not stop at step 3: {drained}")
    check("done: 3 steps" in resumed,
          f"phase 10e: the a2a resume did not run steps 4-6: {resumed}")
    a, b = _last_loss(straight, 6), _last_loss(resumed, 6)
    check(abs(a - b) <= 1e-3 * a, f"phase 10e: a2a step-6 loss {b} after a "
                                  f"drain and a resume vs {a}")
    log(f"phase 10e: --parallel ep --moe-dispatch a2a (moe_tiny) at "
        f"{EP_RANKS} ranks drained at 3 and resumed: step-6 loss {b}, "
        f"uninterrupted {a} (diff {abs(a - b):.2e}); CLI wall: the ranks' "
        f"runs {ep_cli_s:.1f} s (ep) and {td_cli_s:.1f} s (3d), the "
        f"one-rank resumes {time.monotonic() - t0:.1f} s")
    stats.update(cli_a2a_step6_loss_resumed=b, cli_a2a_step6_loss_straight=a)
    shutil.rmtree(work, ignore_errors=True)
    stats["launches"] = launches
    return stats


# ------------------------------------------------------------ elastic

# phase 11: the elastic trainer at Llama-3-8B width, FSDP over 4 -> 2 -> 4
# ranks sharing the card over gloo (GLOO_LABEL, MP_TIMEOUT): steps 1-2 at
# 4 ranks, a reclaim whose survivors exclude rank 0, steps 3-4 at 2, a
# grow with 2 joiners, steps 5-6 at 4; each rank B/n x T 2048
EL_LAYERS, EL_B, EL_T, EL_STEPS = 1, 4, 2048, 6
EL_SHRINK_AT, EL_GROW_AT, EL_SEED = 2, 4, 23
EL_NCCL_B = 2                   # 11b: one rank, phase 5's B 2 x T 2048
# the cold start from the grow's checkpoint runs the same kernels on the
# same ranks, shapes and batches as the elastic run's steps 5-6, so every
# loss and parameter is expected bit-equal; the bound is the reference's
# (tests/test_elastic.py: rel 1e-5, atol 1e-6), which the moment-reset
# fault must exceed
EL_RTOL, EL_ATOL = 1e-5, 1e-6
EL_DISK_BYTES = 40e9            # 11a's 2 checkpoints of 7.61 GB, mirrored


def _el_cfg(**kw):
    from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig.llama3_8b(n_layers=EL_LAYERS, max_seq_len=EL_T, **kw)


def _el_trainer(ckpt, membership, ledger):
    """An elastic FSDP trainer over the current group (its own ledger
    beside the checkpoints on every rank when ``ledger``)."""
    from k8s_operator_libs_tpu_torch.obs.goodput import GoodputLedger
    from k8s_operator_libs_tpu_torch.utils.mesh import make_mesh
    from k8s_operator_libs_tpu_torch.train.harness import (
        CheckpointingTrainer)
    book = GoodputLedger.for_checkpoint_dir(ckpt) if ledger else None
    trainer = CheckpointingTrainer(
        _el_cfg(), ckpt, device="cuda", mesh=make_mesh(), elastic=True,
        membership=membership, ledger=book, checkpoint_interval=10**6,
        metrics_sync_every=1)
    return trainer, book


def _el_run(torch, dist, trainer, data, B, shrink=None, grow=None,
            plant=False, to_step=EL_STEPS):
    """``trainer.run`` from its restored (or fresh) step to ``to_step`` on
    the native token stream. ``shrink`` / ``grow``: rank 0's notice
    (generation, after step, members, marker file or None). ``plant``
    re-initializes both moments in every restore after the first. What
    each step and restore saw on this rank, and the final parameters
    (None for a reclaimed rank)."""
    from k8s_operator_libs_tpu_torch.data.loader import TokenDataset
    from k8s_operator_libs_tpu_torch.models.llama import param_leaves
    from k8s_operator_libs_tpu_torch.ops import attention as fa
    from k8s_operator_libs_tpu_torch.train.harness import (GrowNotice,
                                                           ReclaimNotice)
    real = trainer._restore
    held, planted = [], {"on": False}

    def restore(step):
        s = real(step)
        if planted["on"]:
            for tree in (s.opt_state.mu, s.opt_state.nu):
                for leaf in param_leaves(tree):
                    leaf.zero_()
        world = dist.get_world_size() if dist.is_initialized() else 1
        held.append((world, _state_bytes(s)))
        return s

    trainer._restore = restore
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_or_resume(0)
    planted["on"] = plant
    start = int(state.step)
    fa.reset_launch_counts()
    losses, walls, worlds, counts, notices = {}, {}, {}, {}, {}

    def on_step(step, metrics):
        losses[step] = float(metrics["loss"])
        walls[step] = time.time()
        worlds[step] = dist.get_world_size()
        counts[step] = (dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES))

    def notice(plan, make):
        if plan is None or trainer.membership.generation != plan[0]:
            return None
        if max(losses, default=start) != plan[1]:
            return None
        notices[plan[1]] = time.time()
        if plan[3] is not None:
            Path(plan[3]).touch()     # the platform starts the joiners
        return make(plan[2])

    ds = TokenDataset(data, native=True)
    check(ds.native, "phase 11: the native token loader did not load")
    try:
        result = trainer.run(
            state, ds.batches(B, EL_T + 1, seed=EL_SEED, start_step=start),
            to_step - start, on_step=on_step,
            reclaim_signal=lambda: notice(shrink, ReclaimNotice),
            grow_signal=lambda: notice(grow, GrowNotice))
    finally:
        ds.close()
        trainer.close()
    torch.cuda.synchronize()
    out = {"start": start, "losses": losses, "walls": walls,
           "worlds": worlds, "counts": counts, "notices": notices,
           "held": held, "peak": torch.cuda.max_memory_allocated(),
           "reshards": result.reshards, "device_count": result.device_count,
           "preempted": result.preempted, "reclaimed": result.reclaimed,
           "writer": trainer._writer_rank,
           "generation": (trainer.membership.generation
                          if trainer.membership is not None else None),
           "backend": dist.get_backend() if dist.is_initialized() else None}
    params = None if result.reclaimed else result.state.params
    del state, result
    return out, params, trainer.membership


def _el_compare(torch, dist, a, b):
    """Over every parameter leaf of every rank: the largest |a - b| and
    whether each element is within EL_ATOL + EL_RTOL |b| (ranks compare
    their own slices: the same mesh slices both runs alike)."""
    from k8s_operator_libs_tpu_torch.models.llama import param_leaves
    worst, far = 0.0, 0.0
    for x, y in zip(param_leaves(a), param_leaves(b)):
        d = (x.float() - y.float()).abs()
        worst = max(worst, float(d.max()))
        far = max(far, float((d > EL_ATOL + EL_RTOL * y.float().abs())
                             .any()))
    t = torch.tensor([worst, far])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return {"max_abs": float(t[0]), "close": not bool(t[1])}


def _el_twins(torch, dist, ckpt, data, membership, params):
    """The cold start from the latest checkpoint (the grow's) to step 6,
    held against the elastic run's final parameters; then a resize that
    keeps every member but restores with both moments re-initialized,
    held against the cold start (every rank of the grown group)."""
    trainer, _ = _el_trainer(ckpt, membership, ledger=False)
    cold, cold_params, membership = _el_run(torch, dist, trainer, data,
                                            EL_B)
    out = {"cold": cold,
           "cold_vs_elastic": _el_compare(torch, dist, params, cold_params)}
    del params
    trainer, _ = _el_trainer(ckpt, membership, ledger=False)
    planted, bad, _ = _el_run(
        torch, dist, trainer, data, EL_B,
        shrink=(membership.generation, cold["start"],
                list(membership.members), None), plant=True)
    out["planted"] = planted
    out["planted_vs_cold"] = _el_compare(torch, dist, bad, cold_params)
    del bad, cold_params
    torch.cuda.empty_cache()
    return out


def phase11_member(data, work, survivors, grown, marker):
    """A rank of the elastic job from its start (11a)."""
    import torch
    import torch.distributed as dist

    from k8s_operator_libs_tpu_torch.parallel import launch
    torch.backends.cuda.matmul.allow_tf32 = False
    ckpt = str(Path(work) / "ckpt")
    trainer, book = _el_trainer(ckpt, launch.membership(), ledger=True)
    try:
        out, params, membership = _el_run(
            torch, dist, trainer, data, EL_B,
            shrink=(0, EL_SHRINK_AT, survivors, None),
            grow=(1, EL_GROW_AT, grown, marker))
    finally:
        book.close()
    if not out["reclaimed"]:
        out.update(_el_twins(torch, dist, ckpt, data, membership, params))
    check_threads_stopped(f"phase 11a member {rank_name()}")
    return out


def phase11_joiner(data, work):
    """A rank the grow added (11a): it joins generation 2, restores the
    grow's save and trains steps 5-6, then the twins."""
    import torch
    import torch.distributed as dist

    from k8s_operator_libs_tpu_torch.parallel import launch
    torch.backends.cuda.matmul.allow_tf32 = False
    joined = time.time()
    ckpt = str(Path(work) / "ckpt")
    trainer, book = _el_trainer(ckpt, launch.membership(), ledger=True)
    try:
        out, params, membership = _el_run(torch, dist, trainer, data, EL_B)
    finally:
        book.close()
    out["joined"] = joined
    out.update(_el_twins(torch, dist, ckpt, data, membership, params))
    check_threads_stopped(f"phase 11a joiner {rank_name()}")
    return out


def phase11_nccl_rank(data, work):
    """11b: a reclaim whose survivors are this one member re-forms the
    group through NCCL (the communicator destroyed and re-created); the
    step after it against the same step with no resize."""
    import torch
    import torch.distributed as dist

    from k8s_operator_libs_tpu_torch.utils import comm
    from k8s_operator_libs_tpu_torch.parallel import launch
    torch.backends.cuda.matmul.allow_tf32 = False
    me = launch.membership()
    trainer, _ = _el_trainer(str(Path(work) / "nccl_resized"), me, False)
    comm.reset_counts()
    resized, _, after = _el_run(torch, dist, trainer, data, EL_NCCL_B,
                                shrink=(0, 1, [me.me], None), to_step=2)
    resized["calls"] = dict(comm.CALLS)
    torch.cuda.empty_cache()
    trainer, _ = _el_trainer(str(Path(work) / "nccl_straight"), after,
                             False)
    straight, _, _ = _el_run(torch, dist, trainer, data, EL_NCCL_B,
                             to_step=2)
    torch.cuda.empty_cache()
    return {"resized": resized, "straight": straight}


def _el_whole_bytes():
    """(bytes of the one-rank state's parameters and both moments, its
    parameter count), from the shapes: matrices in the model's dtype,
    norms in fp32, each moment in its parameter's dtype."""
    import torch
    cfg = _el_cfg()
    L, D, H, KV, Dh, F, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                             cfg.vocab_size)
    mats = 2 * V * D + L * (2 * D * H * Dh + 2 * D * KV * Dh + 3 * D * F)
    norms = 2 * L * D + D
    elem = torch.empty(0, dtype=cfg.dtype).element_size()
    return 3 * (mats * elem + norms * 4), mats + norms


def _el_launch_rows(results, stats):
    """A-K1-3 launches by the rank's rows (B 1 at 4 ranks, B 2 at 2
    ranks and in 11b), summed over ranks and runs, each step's own delta
    (route ``wgmma`` only)."""
    rows = {"b1": dict.fromkeys(FLASH_NAMES, 0),
            "b2": dict.fromkeys(FLASH_NAMES, 0)}
    for run in results:
        prev = (dict.fromkeys(FLASH_NAMES, 0), {"wgmma": 0, "fma": 0})
        for step in sorted(run["counts"]):
            launches, routes = run["counts"][step]
            n = run["worlds"][step]
            B = EL_B // n if n > 1 else EL_NCCL_B
            delta = {k: launches[k] - prev[0][k] for k in FLASH_NAMES}
            check(delta == dict.fromkeys(FLASH_NAMES, EL_LAYERS),
                  f"phase 11: step {step} at {n} ranks launched {delta}, "
                  f"expected {EL_LAYERS} of each")
            check(routes["fma"] == 0 and routes["wgmma"]
                  - prev[1]["wgmma"] == 3 * EL_LAYERS,
                  f"phase 11: step {step} took routes {routes}")
            for k in FLASH_NAMES:
                rows[f"b{B}"][k] += delta[k]
            prev = (launches, routes)
    stats["launches"] = rows
    return rows


def phase_elastic(torch):
    """Phase 11: the elastic trainer on the card. 11a: FSDP at
    Llama-3-8B width over 4 -> 2 -> 4 ranks (gloo), the shrink reclaiming
    rank 0, the grow adding 2 joiners; the cold start from the grow's
    checkpoint and a planted moment-reset resize. 11b: the NCCL
    re-formation at world size 1. 11c: the native loader against numpy,
    the uploader's mirror of 11a's saves, and a one-rank restore from it
    against one from the local directory."""
    import shutil

    import numpy as np

    from k8s_operator_libs_tpu_torch.data.loader import (TokenDataset,
                                                         write_token_file)
    from k8s_operator_libs_tpu_torch.obs import goodput
    from k8s_operator_libs_tpu_torch.parallel import launch
    from k8s_operator_libs_tpu_torch.train import CheckpointUploader
    from k8s_operator_libs_tpu_torch.train.harness import (
        CheckpointingTrainer)
    from k8s_operator_libs_tpu_torch.train.uploader import _finalized_steps

    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"phase 11: {held / 2**30:.1f} GiB of the earlier "
                        f"phases is still allocated")
    torch.cuda.empty_cache()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_elastic"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    free = shutil.disk_usage(work).free
    check(free >= EL_DISK_BYTES, f"phase 11: {free / 1e9:.1f} GB free "
                                 f"under {work}, needs {EL_DISK_BYTES / 1e9}")
    stats = {}
    whole, n_params = _el_whole_bytes()
    log(f"phase 11: the state is {n_params} parameters, {whole} bytes of "
        f"parameters and moments (from the shapes); {free / 1e9:.1f} GB "
        f"free on disk")

    # 11c, the loader: native batches equal numpy's, sharded or not
    data = str(work / "tokens.bin")
    write_token_file(data, np.random.default_rng(11).integers(
        0, _el_cfg().vocab_size, size=4_000_000))
    native, plain = TokenDataset(data, native=True), TokenDataset(data,
                                                                  native=False)
    try:
        check(native.native and not plain.native,
              "phase 11c: the native loader did not load")
        for shard in (None, (1, 4)):
            for step in range(EL_STEPS):
                a = native.sample_at(EL_B, EL_T + 1, EL_SEED, step, shard)
                b = plain.sample_at(EL_B, EL_T + 1, EL_SEED, step, shard)
                check(np.array_equal(a, b), f"phase 11c: native batch "
                                            f"{step} shard {shard} differs")
    finally:
        native.close()
        plain.close()
    log(f"phase 11c: native and numpy batches equal for steps 0-"
        f"{EL_STEPS - 1}, whole and shard (1, 4) (B {EL_B}, T {EL_T + 1})")

    # 11a: 4 -> 2 -> 4 ranks, the uploader mirroring the saves meanwhile
    ckpt, mirror = work / "ckpt", work / "mirror"
    marker = work / "grow-notice"
    uploader = CheckpointUploader(str(ckpt), str(mirror),
                                  poll_seconds=1.0).start()
    t0 = time.monotonic()
    try:
        with launch.Job(backend="gloo", timeout=MP_TIMEOUT,
                        workdir=str(work)) as job:
            start = job.members(0, 4)
            survivors, grown = start[2:], start[2:] + job.members(4, 2)
            job.start(phase11_member, start, data, str(work), survivors,
                      grown, str(marker))
            job.wait(until=marker.exists)
            spawned = time.time()
            job.start(phase11_joiner, grown, data, str(work), generation=2,
                      only=grown[2:])
            res = job.wait()
        wall = time.monotonic() - t0
        caught_up = uploader.wait_idle(timeout=600.0)
    finally:
        uploader.stop()
    log(f"phase 11a: 6 processes over gloo, wall {wall:.1f} s")
    for name in start[:2]:
        r = res[name]
        check(r["reclaimed"] and r["preempted"] and not r["writer"]
              and sorted(r["losses"]) == [1, 2],
              f"phase 11a: reclaimed {name} ended {r}")
    for name in survivors:
        r = res[name]
        check(not r["preempted"] and not r["reclaimed"]
              and r["reshards"] == 2 and r["device_count"] == 4
              and sorted(r["losses"]) == list(range(1, EL_STEPS + 1)),
              f"phase 11a: survivor {name}: reshards {r['reshards']}, "
              f"device_count {r['device_count']}, steps "
              f"{sorted(r['losses'])}")
    for name in grown[2:]:
        r = res[name]
        check(r["start"] == EL_GROW_AT and sorted(r["losses"]) == [5, 6]
              and r["device_count"] == 4,
              f"phase 11a: joiner {name} ran {sorted(r['losses'])} from "
              f"{r['start']}")
    check([n for n, r in res.items() if r["writer"]] == [survivors[0]],
          "phase 11a: the writer did not move to the shrink's first member")
    for step in range(1, EL_STEPS + 1):
        seen = {r["losses"][step] for r in res.values()
                if step in r["losses"]}
        check(len(seen) == 1 and all(map(math.isfinite, seen)),
              f"phase 11a: step {step} losses {seen}")
    losses = res[survivors[0]]["losses"]
    log("phase 11a: losses " + ", ".join(
        f"{s} {v:.6f}" for s, v in sorted(losses.items())))
    stats["losses"] = losses

    # what each rank held after each restore: at most 1/n + 1%
    for name, r in res.items():
        for n, b in r["held"] + r.get("cold", {}).get("held", []):
            check(b <= whole / n * 1.01, f"phase 11a: {name} held {b} "
                                         f"bytes at {n} ranks, over 1/{n} "
                                         f"of {whole} + 1%")
    log("phase 11a: held after each restore, share of the state: "
        + "; ".join(f"{name} " + ", ".join(
            f"{b / whole:.4f} at {n}" for n, b in r["held"])
            for name, r in res.items()))

    # ms per step at each membership: a step after one at the same size
    walls = res[survivors[0]]["walls"]
    worlds = res[survivors[0]]["worlds"]
    for step in (2, 4, 6):
        n = worlds[step]
        check(worlds[step - 1] == n, f"phase 11a: steps {step - 1} and "
                                     f"{step} at different sizes")
        ms = (walls[step] - walls[step - 1]) * 1e3
        stats[f"ms_per_step_{n}ranks_step{step}"] = ms
        log(f"phase 11a: step {step} at {n} ranks {ms:.1f} ms "
            f"({GLOO_LABEL})")
    shrink_t = res[start[0]]["notices"][EL_SHRINK_AT]
    grow_t = res[survivors[0]]["notices"][EL_GROW_AT]
    stats["notice_to_step_shrink_s"] = walls[3] - shrink_t
    stats["notice_to_step_grow_s"] = walls[5] - grow_t
    joined = [res[n]["joined"] - grow_t for n in grown[2:]]
    stats["joiners_spawned_after_notice_s"] = spawned - grow_t
    stats["joiners_joined_after_notice_s"] = max(joined)
    log(f"phase 11a: notice to the first step after it: shrink "
        f"{walls[3] - shrink_t:.1f} s, grow {walls[5] - grow_t:.1f} s "
        f"(joiners spawned {spawned - grow_t:.1f} s after the grow "
        f"notice, in the group {max(joined):.1f} s after it)")

    # the ledger: one run, through the writer's move
    records = goodput.read_ledger(str(ckpt / goodput.LEDGER_BASENAME))
    check(len(goodput.split_runs(records)) == 1
          and goodput.unavailability_windows(records) == [],
          "phase 11a: the ledger is not one run")
    phases = [r for r in records if r["kind"] == "phase"]
    degraded = [r for r in phases if r["phase"] == "degraded"]
    check([(d["devices_before"], d["devices_after"]) for d in degraded]
          == [(4, 2)] and degraded[0]["seconds_lost"] > 0,
          f"phase 11a: degraded records {degraded}")
    saves = [r for r in phases if r["phase"] == "drain_save"]
    restores = [r for r in phases if r["phase"] == "ckpt_restore"]
    check(len(saves) == 2 and len(restores) == 2,
          f"phase 11a: {len(saves)} drain saves, {len(restores)} restores")
    for kind, s, r in zip(("shrink", "grow"), saves, restores):
        log(f"phase 11a: {kind}: drain save {s['duration_s']:.2f} s "
            f"(device to host {s['fetch_s']:.2f} s, write "
            f"{s['write_s']:.2f} s), restore {r['duration_s']:.2f} s, "
            f"for {whole} bytes")
        stats[f"{kind}_drain_save_s"] = s["duration_s"]
        stats[f"{kind}_fetch_s"] = s["fetch_s"]
        stats[f"{kind}_write_s"] = s["write_s"]
        stats[f"{kind}_restore_s"] = r["duration_s"]
    s = goodput.summarize(records)
    log(f"phase 11a: ledger: degraded {degraded[0]['duration_s']:.1f} s at "
        f"2 of 4 ranks, priced {degraded[0]['seconds_lost']:.1f} s; "
        f"goodput {s['goodput_s']:.1f} s of {s['total_s']:.1f} s")
    stats["degraded_seconds_lost"] = degraded[0]["seconds_lost"]

    # the cold start and the planted fault (every rank of the grown group)
    twins = res[survivors[0]]
    cold = twins["cold"]
    check(cold["start"] == EL_GROW_AT and twins["planted"]["reshards"] == 1,
          f"phase 11a: the cold start began at {cold['start']}")
    for step in (5, 6):
        d = abs(cold["losses"][step] - losses[step])
        check(d <= EL_RTOL * abs(losses[step]),
              f"phase 11a: step {step} loss {losses[step]} vs the cold "
              f"start's {cold['losses'][step]}")
    cmp_cold, cmp_bad = twins["cold_vs_elastic"], twins["planted_vs_cold"]
    check(cmp_cold["close"], f"phase 11a: the parameters after the grow "
                             f"differ from the cold start's by "
                             f"{cmp_cold['max_abs']:.3e}")
    check(not cmp_bad["close"], "phase 11a: the bound passes a resize "
                                "that re-initializes the moments")
    log(f"phase 11a: cold start from step {EL_GROW_AT} at 4 ranks: losses "
        f"5-6 {cold['losses'][5]:.6f}, {cold['losses'][6]:.6f} (elastic "
        f"{losses[5]:.6f}, {losses[6]:.6f}); every parameter within "
        f"atol {EL_ATOL} + rtol {EL_RTOL}, largest difference "
        f"{cmp_cold['max_abs']:.3e}; planted moment reset: largest "
        f"{cmp_bad['max_abs']:.3e}, over the bound: caught")
    stats.update(cold_max_abs=cmp_cold["max_abs"],
                 planted_max_abs=cmp_bad["max_abs"])
    for name, r in res.items():
        log(f"phase 11a: {name} peak {r['peak'] / 2**30:.1f} GiB, launches "
            f"per kernel {r['counts'][max(r['counts'])][0]}")
        stats[f"peak_bytes_{name}"] = r["peak"]

    # 11c, the uploader: the mirror holds every finished step
    local_steps = _finalized_steps(str(ckpt))
    check(caught_up and local_steps == [str(EL_SHRINK_AT), str(EL_GROW_AT)]
          and set(local_steps) <= set(_finalized_steps(str(mirror))),
          f"phase 11c: local steps {local_steps}, mirrored "
          f"{_finalized_steps(str(mirror))}")

    # 11c: a one-rank restore from the mirror equals one from the disk
    states = []
    for root in (ckpt, mirror):
        trainer = CheckpointingTrainer(_el_cfg(), str(root), device="cuda")
        t2 = time.monotonic()
        states.append(trainer.init_or_resume(0))
        trainer.close()
        log(f"phase 11c: one-rank restore of step {EL_GROW_AT} from "
            f"{root.name}: {time.monotonic() - t2:.1f} s")
    from k8s_operator_libs_tpu_torch.models.llama import param_leaves
    x, y = states
    check(x.step == y.step == EL_GROW_AT and all(
        torch.equal(p, q) for t, u in ((x.params, y.params),
                                       (x.opt_state.mu, y.opt_state.mu),
                                       (x.opt_state.nu, y.opt_state.nu))
        for p, q in zip(param_leaves(t), param_leaves(u))),
        "phase 11c: the mirror's restore differs from the local one")
    del states, x, y
    torch.cuda.empty_cache()
    log("phase 11c: the mirror's step-4 restore equals the local one "
        "(every parameter and moment)")
    shutil.rmtree(ckpt)
    shutil.rmtree(mirror)

    # 11b: the NCCL re-formation at world size 1 (run last in phase 9's
    # NCCL rank, on 11c's tokens)
    one = NCCL_RESULTS["11b"]
    a, b = one["resized"], one["straight"]
    check(a["reshards"] == 1 and a["backend"] == "nccl"
          and a["generation"] == 1 and a["calls"]["all_gather"] > 0,
          f"phase 11b: {a['reshards']} resizes, backend {a['backend']}, "
          f"generation {a['generation']}, collectives {a['calls']}")
    check(a["losses"] == b["losses"], f"phase 11b: losses {a['losses']} "
                                      f"after the NCCL re-formation vs "
                                      f"{b['losses']} without it")
    log(f"phase 11b: NCCL re-formed at world size 1 (the only NCCL resize "
        f"one card allows), {NCCL_RESULTS['seconds']['11b']:.1f} s in phase "
        f"9's NCCL rank; step 2 loss "
        f"{a['losses'][2]:.6f} after it, {b['losses'][2]:.6f} without")
    stats["nccl_step2_loss"] = a["losses"][2]

    runs = list(res.values())
    runs += [r[k] for r in res.values() if "cold" in r
             for k in ("cold", "planted")]
    runs += [a, b]
    rows = _el_launch_rows(runs, stats)
    log(f"phase 11: A-K1-3 launches, B 1 rows (4 ranks) {rows['b1']}, "
        f"B 2 rows (2 ranks, 11b) {rows['b2']}")
    shutil.rmtree(work, ignore_errors=True)
    return stats


# ------------------------------- placed ranks and tensor-parallel decoding

# phase 12a: the port's GPU scheduler places a workload on PL_NODES
# in-script nodes of PL_GPUS GPUs (GFD's labels, the card's own product),
# and the processes the placed pods start, one per GPU, train FSDP at
# phase 11a's 4-rank shape: Llama-3-8B width, 1 layer, B 4 x T 2048;
# PL_STEPS timed steps (2 before phase 3g joined, cut to keep the
# smoke's phases under 1000 s)
PL_NODES, PL_GPUS = 2, 2
PL_LAYERS, PL_B, PL_T, PL_STEPS = 1, 4, 2048, 1
# phase 12b: tensor-parallel decoding on TPD_RANKS ranks at Llama-3-8B's
# width and TPD_LAYERS layers in bf16 (phase 3's prompts, MAX_NEW greedy
# tokens), then its fp32 twin at TPD32_LAYERS layers; ms per decode step
# by two points (a decode of MAX_NEW tokens less one of TPD_SHORT, over
# the steps between). TPD_LAYERS was 32 (full depth) before phase 3f
# joined and 16 before phase 3g did; each cut keeps the smoke's phases
# under 1000 s
TPD_RANKS, TPD_LAYERS, TPD32_LAYERS, TPD_SHORT = 2, 8, 2, 2


class PlacementCluster:
    """The nodes the GPU scheduler sees in phase 12a, and the pods and
    Services it creates there: the client surface it takes (``direct``,
    ``list_nodes``, ``list_pods``, ``create_pod``, ``create_service``,
    ``delete_pod``). Nodes are Ready and
    schedulable, labelled as GPU Feature Discovery labels a node."""

    def __init__(self, names, product, gpus):
        import types

        from k8s_operator_libs_tpu_torch.gpu import (COUNT_LABEL,
                                                     PRODUCT_LABEL)
        self.nodes = [types.SimpleNamespace(
            metadata=types.SimpleNamespace(
                name=n, labels={PRODUCT_LABEL: product,
                                COUNT_LABEL: str(gpus)}),
            spec=types.SimpleNamespace(unschedulable=False),
            is_ready=lambda: True) for n in names]
        self.pods, self.services = {}, {}

    def direct(self):
        return self

    def list_nodes(self):
        return list(self.nodes)

    def list_pods(self, namespace=None, label_selector=None):
        return [p for p in self.pods.values()
                if namespace in (None, p.metadata.namespace)
                and all(p.metadata.labels.get(k) == v
                        for k, v in (label_selector or {}).items())]

    def create_pod(self, pod):
        self.pods[pod.metadata.name] = pod
        return pod

    def create_service(self, svc):
        self.services[svc.metadata.name] = svc
        return svc

    def delete_pod(self, namespace, name):
        del self.pods[name]


def phase12_placed_rank():
    """12a in one rank started from a placed pod's env: the one-rank step
    (rank 0, then freed), FSDP's step over every rank against it, then
    PL_STEPS timed optimizer steps."""
    import torch
    import torch.distributed as dist

    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          init_params)
    from k8s_operator_libs_tpu_torch.ops import attention as fa
    from k8s_operator_libs_tpu_torch.utils import comm
    from k8s_operator_libs_tpu_torch.parallel import fsdp, launch
    from k8s_operator_libs_tpu_torch.utils.mesh import (make_mesh,
                                                        param_specs)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=PL_LAYERS, max_seq_len=PL_T)
    tokens = _tokens(torch, cfg, PL_B, PL_T, 13)
    ref = _one_rank_ref(torch, dist, lambda p, t: fsdp.causal_lm_loss(
        p, t, cfg), lambda: init_params(cfg, seed=0, device="cuda"), tokens)
    mesh = make_mesh()
    specs = param_specs()
    state = fsdp.init_train_state(cfg, seed=0, device="cuda", mesh=mesh)
    res = _path_step(torch, fsdp.fsdp_loss(cfg, mesh, specs), state.params,
                     tokens, specs, mesh, ref, MP_BF16_TOL)
    step = fsdp.make_train_step(cfg, mesh=mesh)
    torch.cuda.synchronize()
    dist.barrier()
    fa.reset_launch_counts()
    comm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.monotonic()
    for _ in range(PL_STEPS):
        state, m = step(state, tokens)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    res.update(ms_per_step=(time.monotonic() - t0) / PL_STEPS * 1e3,
               step_losses=losses, step_launches=dict(fa.LAUNCHES),
               step_routes=dict(fa.ROUTE_LAUNCHES),
               bytes_per_step={k: v // PL_STEPS
                               for k, v in comm.BYTES.items()},
               step_peak=torch.cuda.max_memory_allocated(),
               rank=dist.get_rank(), world=dist.get_world_size(),
               backend=dist.get_backend(), member=launch.membership().me)
    del state
    torch.cuda.empty_cache()
    return res


def _tp_decode_params(torch, cfg, mesh):
    """This rank's slices of the seeded one-rank parameters by
    ``tp_generate_param_specs``, each whole leaf freed as it is cut (a
    rank holds the whole tree once, briefly)."""
    from k8s_operator_libs_tpu_torch.models.generate import (
        tp_generate_param_specs)
    from k8s_operator_libs_tpu_torch.models.llama import init_params
    from k8s_operator_libs_tpu_torch.utils.mesh import shard
    whole = init_params(cfg, seed=0, device="cuda")
    specs = tp_generate_param_specs()
    out = {}
    for key in list(whole):
        if isinstance(whole[key], dict):
            blocks = whole.pop(key)
            out[key] = {}
            for name in list(blocks):
                out[key][name] = shard(blocks.pop(name), specs[key][name],
                                       mesh)
        else:
            out[key] = shard(whole.pop(key), specs[key], mesh)
    torch.cuda.empty_cache()
    return out


def _two_point_decode(torch, dist, make, params, prompt):
    """ms and bytes of one decode step: a decode of MAX_NEW tokens less
    one of TPD_SHORT, over the MAX_NEW - TPD_SHORT steps between (prefill
    and set-up cancel). The caller has decoded ``prompt`` once already:
    that is the warm-up."""
    from k8s_operator_libs_tpu_torch.utils import comm
    out = {}
    for n in (TPD_SHORT, MAX_NEW):
        gen = make(n)
        torch.cuda.synchronize()
        if dist is not None:
            dist.barrier()
        comm.reset_counts()
        t0 = time.monotonic()
        gen(params, prompt)
        torch.cuda.synchronize()
        out[n] = (time.monotonic() - t0, dict(comm.BYTES))
    steps = MAX_NEW - TPD_SHORT
    return ((out[MAX_NEW][0] - out[TPD_SHORT][0]) / steps * 1e3,
            {k: (out[MAX_NEW][1][k] - out[TPD_SHORT][1][k]) // steps
             for k in out[MAX_NEW][1]})


def phase12_tp_rank(prompts):
    """12b in one rank: tensor-parallel decoding of every prompt at
    Llama-3-8B's width, TPD_LAYERS layers in bf16, then the fp32 twin; the tokens, the
    rank's bytes held, peak memory, and ms and bytes per decode step."""
    import torch
    import torch.distributed as dist

    from k8s_operator_libs_tpu_torch.models.generate import make_tp_generate
    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          param_leaves)
    from k8s_operator_libs_tpu_torch.utils.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(tensor=dist.get_world_size(), fsdp=1)
    out = {"rank": dist.get_rank()}
    for tag, dtype, layers in (("bf16", torch.bfloat16, TPD_LAYERS),
                               ("fp32", torch.float32, TPD32_LAYERS)):
        cfg = LlamaConfig.llama3_8b(dtype=dtype, n_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        params = _tp_decode_params(torch, cfg, mesh)
        gen = make_tp_generate(cfg, mesh, max_new_tokens=MAX_NEW)
        res = {"tokens": [gen(params, torch.as_tensor([p])).tolist()[0]
                          for p in prompts],
               "held": sum(t.numel() * t.element_size()
                           for t in param_leaves(params))}
        if tag == "bf16":
            res["ms_per_step"], res["bytes_per_step"] = _two_point_decode(
                torch, dist, lambda n: make_tp_generate(
                    cfg, mesh, max_new_tokens=n), params,
                torch.as_tensor([prompts[0]]))
        res["peak"] = torch.cuda.max_memory_allocated()
        out[tag] = res
        del params, gen
        torch.cuda.empty_cache()
    return out


def phase_placed(torch):
    """12a: the GPU scheduler's placement of a 2-node x 2-GPU workload,
    its pods' env into 4 ranks over gloo (``cluster_env``), FSDP at
    Llama-3-8B width against the one-rank step."""
    import shutil
    import socket

    from k8s_operator_libs_tpu_torch.gpu import GPUScheduler, GPUWorkload
    from k8s_operator_libs_tpu_torch.parallel import launch
    from k8s_operator_libs_tpu_torch.parallel.distributed import (
        cluster_env, default_backend)

    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"phase 12: {held / 2**30:.1f} GiB of the earlier "
                        f"phases is still allocated")
    torch.cuda.empty_cache()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_placed"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    stats = {}
    product = torch.cuda.get_device_name(0).replace(" ", "-")
    cluster = PlacementCluster([f"node-{i}" for i in range(PL_NODES)],
                               product, PL_GPUS)
    wl = GPUWorkload(name="smoke", product=product, gpus_per_node=PL_GPUS,
                     num_nodes=PL_NODES)
    placement = GPUScheduler(cluster).place(wl)
    check(placement is not None
          and placement.node_names == [n.metadata.name
                                       for n in cluster.nodes]
          and "smoke" in cluster.services,
          f"phase 12a: placement {placement}, Services "
          f"{list(cluster.services)}")
    # the placed coordinator is a pod's DNS name behind the Service; one
    # machine has no cluster DNS, so it becomes localhost at a free port
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    envs = []
    for pod in cluster.list_pods():
        env = dict(pod.spec.env, JAX_COORDINATOR_ADDRESS=f"localhost:{port}")
        envs += [dict(env, LOCAL_RANK=str(i))
                 for i in range(int(env["LOCAL_WORLD_SIZE"]))]
    world = PL_NODES * PL_GPUS
    ranks = sorted(cluster_env(e)["rank"] for e in envs)
    check(ranks == list(range(world))
          and {cluster_env(e)["world_size"] for e in envs} == {world},
          f"phase 12a: the placed env gives ranks {ranks}")
    backend = default_backend("cuda", envs[0])
    check(backend == "gloo", f"phase 12a: {PL_GPUS} ranks per card chose "
                             f"{backend}")
    log(f"phase 12a: the GPU scheduler placed {placement.pods} on "
        f"{placement.node_names} ({product}, {PL_GPUS} GPUs each, "
        f"LOCAL_WORLD_SIZE {envs[0]['LOCAL_WORLD_SIZE']}); their "
        f"{len(envs)} processes are ranks {ranks} of {world} ({backend}: "
        f"the {world} ranks share the one card)")
    t0 = time.monotonic()
    results = launch.run_placed(phase12_placed_rank, envs, backend=backend,
                                timeout=MP_TIMEOUT, workdir=str(work))
    log(f"phase 12a: {world} ranks over {backend}, wall "
        f"{time.monotonic() - t0:.1f} s")
    check([(r["rank"], r["world"], r["backend"]) for r in results]
          == [(i, world, "gloo") for i in range(world)]
          and [r["member"] for r in results]
          == [f"smoke-{h}.smoke/cuda:{g}" for h in range(PL_NODES)
              for g in range(PL_GPUS)],
          f"phase 12a: ranks joined as "
          f"{[(r['rank'], r['member']) for r in results]}")
    for r, res in enumerate(results):
        _check_rank("phase 12a", r, res, world, PL_LAYERS, "fsdp")
        want = PL_STEPS * PL_LAYERS
        check(res["step_launches"] == dict.fromkeys(FLASH_NAMES, want)
              and res["step_routes"] == {"wgmma": 3 * want, "fma": 0},
              f"phase 12a: rank {r}'s {PL_STEPS} steps launched "
              f"{res['step_launches']} on {res['step_routes']}")
        for key in ("loss", "step_losses"):
            check(res[key] == results[0][key] and all(map(
                math.isfinite, res["step_losses"] + [res["loss"]])),
                f"phase 12a: rank {r}'s {key} {res[key]} vs rank 0's "
                f"{results[0][key]}")
    stats["loss_diff"] = _check_parity(
        f"phase 12a FSDP bf16 from the placed env ({world} ranks, B {PL_B} "
        f"T {PL_T}, {PL_LAYERS} layers)", results[0])
    stats["worst_grad"] = results[0]["worst"]
    stats["step_losses"] = results[0]["step_losses"]
    for r, res in enumerate(results):
        log(f"phase 12a: rank {r} ({res['member']}): "
            f"{res['ms_per_step']:.1f} ms per step ({GLOO_LABEL}), peak "
            f"memory of a train step {res['step_peak'] / 2**30:.1f} GiB")
        stats[f"ms_per_step_rank{r}"] = res["ms_per_step"]
        stats[f"peak_bytes_rank{r}"] = res["step_peak"]
    _log_bytes("phase 12a: FSDP", results[0]["bytes_per_step"], stats,
               "placed")
    stats["launches"] = {name: sum(res["step_launches"][name]
                                   for res in results)
                         for name in FLASH_NAMES}
    log(f"phase 12a: A-K1-3 launches over the {PL_STEPS} steps, summed over "
        f"the ranks: {stats['launches']} (all wgmma)")
    shutil.rmtree(work, ignore_errors=True)
    return stats


def phase_tp_decode(torch):
    """12b: tensor-parallel decoding over gloo against the one-rank
    ``generate`` of the same weights: Llama-3-8B width, TPD_LAYERS layers,
    bf16, to the first near-tie; its fp32 twin at 2 layers, token for
    token."""
    import shutil

    import numpy as np

    from k8s_operator_libs_tpu_torch.models.generate import (
        generate, make_tp_generate)
    from k8s_operator_libs_tpu_torch.models.llama import (LlamaConfig,
                                                          init_params,
                                                          param_leaves)
    from k8s_operator_libs_tpu_torch.parallel import launch
    from k8s_operator_libs_tpu_torch.utils.mesh import local_mesh

    work = Path(__file__).resolve().parent / "build" / "chip_smoke_tp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gen = np.random.default_rng(0)            # phase 3's prompts
    vocab = LlamaConfig.llama3_8b().vocab_size
    prompts = [gen.integers(0, vocab, size=n).tolist() for n in PROMPT_LENS]
    stats, ref = {}, {}
    # the one-rank references first, each freed before the ranks start
    for tag, dtype, layers in (("bf16", torch.bfloat16, TPD_LAYERS),
                               ("fp32", torch.float32, TPD32_LAYERS)):
        cfg = LlamaConfig.llama3_8b(dtype=dtype, n_layers=layers)
        params = init_params(cfg, seed=0, device="cuda")
        if tag == "bf16":
            whole = sum(t.numel() * t.element_size()
                        for t in param_leaves(params))
            embeds = sum(params[k].numel() * params[k].element_size()
                         for k in ("embed", "lm_head"))
        toks = [generate(params, torch.as_tensor([p]), cfg,
                         max_new_tokens=MAX_NEW).tolist()[0]
                for p in prompts]
        ref[tag] = {"tokens": toks, "gaps": [
            top2_gaps(torch, params, cfg, t, len(p))
            for t, p in zip(toks, prompts)]}
        if tag == "bf16":
            # the one-rank decode step, timed as the ranks time theirs (a
            # local mesh: the same forward, no sums)
            mesh = local_mesh()
            ms, _ = _two_point_decode(torch, None, lambda n: make_tp_generate(
                cfg, mesh, max_new_tokens=n), params,
                torch.as_tensor([prompts[0]]))
            stats["one_rank_ms_per_step"] = ms
        del params
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    results = launch.run(phase12_tp_rank, TPD_RANKS, prompts,
                         backend="gloo", timeout=MP_TIMEOUT,
                         workdir=str(work))
    log(f"phase 12b: {TPD_RANKS} tensor ranks over gloo, wall "
        f"{time.monotonic() - t0:.1f} s")
    for r, res in enumerate(results):
        check(res["fp32"]["tokens"] == ref["fp32"]["tokens"],
              f"phase 12b: fp32 rank {r}'s tokens differ from the one-rank "
              f"generate's at token "
              + str([first_mismatch(a[len(p):], b[len(p):]) for a, b, p in
                     zip(res["fp32"]["tokens"], ref["fp32"]["tokens"],
                         prompts)]))
        check(res["bf16"]["tokens"] == results[0]["bf16"]["tokens"],
              f"phase 12b: bf16 ranks 0 and {r} decoded different tokens")
    log(f"phase 12b: fp32, {TPD32_LAYERS} layers: every rank's tokens equal "
        f"the one-rank generate's for prompts {PROMPT_LENS}")
    notes = []
    for i, (p, got, want, gaps) in enumerate(zip(
            prompts, results[0]["bf16"]["tokens"], ref["bf16"]["tokens"],
            ref["bf16"]["gaps"])):
        ok, what, i_diff = near_tie_verdict(got, want, gaps, len(p))
        check(ok, f"phase 12b: bf16 prompt {len(p)} against the one-rank "
                  f"generate's: {what}")
        notes.append(f"prompt {len(p)}: {what}")
        stats[f"bf16_first_diff_prompt{len(p)}"] = i_diff
    log(f"phase 12b: bf16, {TPD_LAYERS} layers, "
        f"against the one-rank generate up to "
        f"the first top-2 logit gap under {SPEC_GAP_EPS}: " + "; ".join(notes))
    rep = whole - embeds
    for r, res in enumerate(results):
        b = res["bf16"]
        check(b["held"] <= embeds + rep / TPD_RANKS * 1.01,
              f"phase 12b: rank {r} holds {b['held']} bytes, over the "
              f"replicated {embeds} + 1/{TPD_RANKS} of {rep} + 1%")
        log(f"phase 12b: rank {r}: {b['ms_per_step']:.2f} ms per decode step "
            f"at B 1 ({GLOO_LABEL}; one rank alone "
            f"{stats['one_rank_ms_per_step']:.2f} ms), weights held "
            f"{b['held'] / 1e9:.3f} GB of {whole / 1e9:.3f}, peak "
            f"{b['peak'] / 2**30:.1f} GiB")
        stats[f"ms_per_step_rank{r}"] = b["ms_per_step"]
        stats[f"peak_bytes_rank{r}"] = b["peak"]
        stats[f"held_bytes_rank{r}"] = b["held"]
    _log_bytes("phase 12b: tensor-parallel decode",
               results[0]["bf16"]["bytes_per_step"], stats, "tp_decode")
    shutil.rmtree(work, ignore_errors=True)
    return stats


def _log_bytes(tag, per_step, stats, key):
    total = sum(per_step.values())
    log(f"{tag}: bytes sent per step and rank, by kind: "
        + ", ".join(f"{k} {v}" for k, v in per_step.items() if v)
        + f"; at the H100 SXM's NVLink rate ({NVLINK_BYTES_PER_S:.3g} B/s "
        f"each way) {total / NVLINK_BYTES_PER_S * 1e3:.3f} ms (a reckoning, "
        f"not measured)")
    stats[f"{key}_bytes_per_step"] = per_step
    stats[f"{key}_nvlink_ms_reckoned"] = total / NVLINK_BYTES_PER_S * 1e3


def timed(label, fn, *args):
    """``fn(*args)``, its wall seconds logged; then no workload thread
    may be left alive (:func:`check_threads_stopped`)."""
    t0 = time.monotonic()
    out = fn(*args)
    log(f"{label}: wall {time.monotonic() - t0:.1f} s")
    check_threads_stopped(label)
    return out


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
        timed("phase 1", phase_build)
        kernels = timed("phase 2 (paged decode)", phase_kernels, torch)
        kernels.update(timed("phase 2 (flash)", phase_flash, torch))
        serve = timed("phase 3 (3b-3h)", phase_serve, torch)
        parity = timed("phase 4", phase_parity, torch)
        moe_serve = timed("phase 7", phase_moe_serve, torch)
        moe_serve.update(timed("phase 7b", phase_moe_parity, torch))
        training = timed("phase 5", phase_train, torch)
        training.update(timed("phase 6", phase_train_parity, torch))
        training.update(timed("phase 6b", phase_trainer_operator, torch, smi))
        moe_train = timed("phase 8", phase_moe_train, torch)
        moe_train.update(timed("phase 8b", phase_moe_train_parity, torch))
        multi = timed("phase 9", phase_multiprocess, torch)
        composed = timed("phase 10", phase_pp_tp_ep, torch)
        elastic = timed("phase 11", phase_elastic, torch)
        placed = timed("phase 12a", phase_placed, torch)
        tp_decode = timed("phase 12b", phase_tp_decode, torch)
    except (SmokeFailure, subprocess.SubprocessError, OSError,
            RuntimeError, ValueError) as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    log(f"workload-thread checks in this process: {THREAD_CHECKS['n']}, "
        f"{THREAD_CHECKS['s'] * 1e3:.3f} ms in all ({smi})")
    rows = []
    jax_attn = f"{REFERENCE}/ops/attention.py"
    for name, source, replaces, launches in (
            ("paged_decode", "paged_decode", f"{jax_attn}:734",
             serve["launches"]),
            ("paged_decode_int8", "paged_decode", f"{jax_attn}:828",
             parity["launches_int8"]),
            ("paged_decode_speculative", "paged_decode", f"{jax_attn}:734",
             serve["spec_launches"]),
            ("paged_decode_serving_tier", "paged_decode", f"{jax_attn}:734",
             serve["fleet_launches"]),
            ("paged_decode_router", "paged_decode", f"{jax_attn}:734",
             serve["router_launches"]),
            ("paged_decode_upgrade", "paged_decode", f"{jax_attn}:734",
             serve["upgrade_launches"]),
            ("paged_decode_health", "paged_decode", f"{jax_attn}:734",
             serve["health_launches"]),
            ("paged_decode_handover", "paged_decode", f"{jax_attn}:734",
             serve["handover_launches"]),
            ("paged_decode_full_batch", "paged_decode", f"{jax_attn}:734",
             serve["launches"]),
            ("paged_decode_int8_full_batch", "paged_decode",
             f"{jax_attn}:828", parity["launches_int8"]),
            ("flash_forward", "flash_attention_tc", f"{jax_attn}:236",
             training["launches_flash_forward"]),
            ("flash_bwd_dq", "flash_attention_tc", f"{jax_attn}:439",
             training["launches_flash_bwd_dq"]),
            ("flash_bwd_dkv", "flash_attention_tc", f"{jax_attn}:519",
             training["launches_flash_bwd_dkv"]),
            *((f"{kname}_operator", "flash_attention_tc",
               f"{jax_attn}:{line}",
               training["operator_launches"][kname])
              for kname, line in (("flash_forward", 236),
                                  ("flash_bwd_dq", 439),
                                  ("flash_bwd_dkv", 519))),
            ("paged_decode_moe", "paged_decode", f"{jax_attn}:734",
             moe_serve["launches"]),
            ("flash_forward_moe", "flash_attention_tc", f"{jax_attn}:236",
             moe_train["launches_flash_forward"]),
            ("flash_bwd_dq_moe", "flash_attention_tc", f"{jax_attn}:439",
             moe_train["launches_flash_bwd_dq"]),
            ("flash_bwd_dkv_moe", "flash_attention_tc", f"{jax_attn}:519",
             moe_train["launches_flash_bwd_dkv"]),
            *((f"{kname}_{path}", "flash_attention_tc", f"{jax_attn}:{line}",
               multi["launches"][path][kname])
              for path in ("sp_ring_full", "sp_ring_diagonal", "sp_ulysses",
                           "fsdp")
              for kname, line in (("flash_forward", 236),
                                  ("flash_bwd_dq", 439),
                                  ("flash_bwd_dkv", 519)))):
        # the speculative path's draft steps, the serving tier's replicas,
        # the replicas behind the router binary, those under the rolling
        # upgrade, the quarantine-and-repair and the operator binary's
        # handover, phase 6b's trainer under the operator and the MoE
        # paths run their kernels at phase 2's shapes
        # (A-K4 at the serving shape, A-K1-3 at
        # H 32, KV 8, Dh 128, B 2, T 2048), so their rows carry phase 2's
        # measurements; phase 9's rows carry those of phase 2's cases at
        # the ranks' own shapes (FLASH_CASES), their launches summed over
        # the ranks
        k = kernels[{"paged_decode_speculative": "paged_decode",
                     "paged_decode_serving_tier": "paged_decode",
                     "paged_decode_router": "paged_decode",
                     "paged_decode_upgrade": "paged_decode",
                     "paged_decode_health": "paged_decode",
                     "paged_decode_handover": "paged_decode"}.get(
            name, name.split("_moe")[0].removesuffix("_operator"))]
        rows.append({"name": name, "route": "cuda",
                     "source": CSRC.format(source), "replaces": replaces,
                     "launches": launches, "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"],
                     "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    # phase 10's paths, each kernel measured at its rank's shape by phase
    # 2: a pipeline microbatch and an a2a rank's rows are the FSDP rank's
    # B 1 x T 2048 at 32/8 heads, a dense expert-parallel rank attends
    # the whole B 2 batch (the main shape), a tensor-parallel rank a
    # microbatch at 16/4 heads (its own case); launches summed over ranks
    for path, measured in (("pp", "_fsdp"), ("tp", "_tp"),
                           ("ep_dense", ""), ("ep_a2a", "_fsdp")):
        for kname, line in (("flash_forward", 236), ("flash_bwd_dq", 439),
                            ("flash_bwd_dkv", 519)):
            k = kernels[kname + measured]
            rows.append({"name": f"{kname}_{path}", "route": "cuda",
                         "source": CSRC.format("flash_attention_tc"),
                         "replaces": f"{jax_attn}:{line}",
                         "launches": composed["launches"][path][kname],
                         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                         "plain_ms": k["plain_ms"],
                         "bound_ms": k["bound_ms"],
                         "bound_by": k["bound_by"],
                         "library_ms": k["library_ms"]})
    # phase 11's elastic FSDP ranks: B 1 x T 2048 at 4 ranks (the FSDP
    # rank's case), B 2 at 2 ranks and in 11b (the main shape)
    for path, measured in (("elastic_b1", "_fsdp"), ("elastic_b2", "")):
        for kname, line in (("flash_forward", 236), ("flash_bwd_dq", 439),
                            ("flash_bwd_dkv", 519)):
            k = kernels[kname + measured]
            rows.append({"name": f"{kname}_{path}", "route": "cuda",
                         "source": CSRC.format("flash_attention_tc"),
                         "replaces": f"{jax_attn}:{line}",
                         "launches": elastic["launches"][path[-2:]][kname],
                         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                         "plain_ms": k["plain_ms"],
                         "bound_ms": k["bound_ms"],
                         "bound_by": k["bound_by"],
                         "library_ms": k["library_ms"]})
    # phase 12a's ranks started from the placed pods' env: B 1 x T 2048
    # each (the FSDP rank's case)
    for kname, line in (("flash_forward", 236), ("flash_bwd_dq", 439),
                        ("flash_bwd_dkv", 519)):
        k = kernels[kname + "_fsdp"]
        rows.append({"name": f"{kname}_placed", "route": "cuda",
                     "source": CSRC.format("flash_attention_tc"),
                     "replaces": f"{jax_attn}:{line}",
                     "launches": placed["launches"][kname],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": rows}))
    for key, stats in (("serving", serve), ("training", training),
                       ("moe_serving", moe_serve), ("moe_training", moe_train),
                       ("multiprocess", multi),
                       ("pipeline_tensor_expert", composed),
                       ("elastic", elastic), ("placed", placed),
                       ("tp_decode", tp_decode),
                       ("flash_backward", kernels["backward"])):
        print(json.dumps({key: {k: (round(v, 6) if isinstance(v, float)
                                    else v) for k, v in stats.items()}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
