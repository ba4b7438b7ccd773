"""Seeded chaos campaign CLI (the port's twin of the JAX package's
``tools/chaos_campaign.py``, with its flags).

Runs N seeded random scenarios (correlated multi-clique crashloops,
apiserver latency/flake/conflict injection, watch lag, leader failover
mid-phase, eviction 429 storms, spot-reclaim notices) against the full
operator stack — two leader-elected GPUOperator candidates, health
monitor, SLO engine, a simulated checkpoint-resume workload — on a fake
cluster + fake clock, continuously asserting the standing invariants.
Exit 0 only if every scenario converges with zero violations; a failure
prints the seed, the fault trace, and the shrunk minimal reproducer.

    python -m k8s_operator_libs_tpu_torch.chaos --seeds 20
    python -m k8s_operator_libs_tpu_torch.chaos --seeds 1 --base-seed 17
    python -m k8s_operator_libs_tpu_torch.chaos --scenario s.yaml --seeds 3
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

from . import parse_scenario, random_scenario, run_campaign


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", type=int, default=20, metavar="N",
                   help="number of seeded scenarios (default %(default)s)")
    p.add_argument("--base-seed", type=int, default=0,
                   help="first seed; --seeds 1 --base-seed K replays "
                        "exactly the campaign run for seed K")
    p.add_argument("--scenario", default=None, metavar="YAML",
                   help="run this scenario spec under every seed instead "
                        "of the seeded-random generator")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable per-seed results")
    p.add_argument("--require-market-trade", action="store_true",
                   help="fail unless at least one scenario exercised a "
                        "capacity-market trade (the CI smoke's guarantee "
                        "that the flash-crowd/arbiter path runs, not "
                        "just converges)")
    p.add_argument("--cached-reads", action="store_true",
                   help="run every operator candidate on the informer "
                        "read path (pumped CachedClient over the chaos "
                        "client, incremental BuildState + equivalence "
                        "oracle)")
    p.add_argument("--shard-workers", type=int, default=0, metavar="N",
                   help="sharded reconcile with N per-slice-group workers "
                        "in deterministic serial mode (seed replay stays "
                        "byte-identical)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="per-scenario fault schedules even on PASS")
    args = p.parse_args(argv)
    logging.disable(logging.CRITICAL)  # the campaign IS the log

    scenario_fn = random_scenario
    if args.scenario:
        import yaml
        spec = yaml.safe_load(Path(args.scenario).read_text())
        fixed = parse_scenario(spec)
        scenario_fn = lambda seed: fixed  # noqa: E731

    t0 = time.time()
    results = run_campaign(args.seeds, base_seed=args.base_seed,
                           scenario_fn=scenario_fn,
                           cached_reads=args.cached_reads,
                           shard_workers=args.shard_workers)
    failed = [r for r in results if r.failed]
    # attribution gate: every fault-overlapped page must have named the
    # faulted entity in its top-3 causes (recall 1.0 PER SEED), and no
    # quiet-period page may blame chaos-fault (precision) — the cause
    # engine is scored, not trusted
    misattributed = [r for r in results if r.attribution is not None
                     and (r.attribution["recall"] < 1.0
                          or not r.attribution["precision_ok"])]
    if args.as_json:
        print(json.dumps([{
            "scenario": r.scenario, "seed": r.seed,
            "converged": r.converged, "ticks": r.ticks,
            "modelled_s": r.modelled_s, "failovers": r.failovers,
            "violations": [str(v) for v in r.violations],
            "attribution": r.attribution,
            "trace": r.trace,
        } for r in results], indent=2))
    else:
        for r in results:
            if r.failed or args.verbose:
                print(r.report())
            else:
                print(r.report().splitlines()[0])
        total_ticks = sum(r.ticks for r in results)
        total_failover = sum(r.failovers for r in results)
        pages = sum((r.attribution or {}).get("pages", 0)
                    for r in results)
        attributed = sum((r.attribution or {}).get("recall_hits", 0)
                         for r in results)
        print(f"\nchaos campaign: {len(results)} scenarios, "
              f"{len(failed)} failed, {total_ticks} ticks, "
              f"{total_failover} failovers, "
              f"{time.time() - t0:.1f}s wall")
        print(f"alert attribution: {pages} pages, {attributed} "
              f"fault-overlapped pages root-caused, "
              f"{len(misattributed)} scenario(s) misattributed")
    trades = sum((r.router_stats or {}).get("market_trades", 0)
                 for r in results)
    if not args.as_json:
        print(f"capacity-market trades across the run: {trades}")
    if args.require_market_trade and trades == 0:
        print("FAIL: --require-market-trade set but no scenario "
              "exercised a capacity-market trade", file=sys.stderr)
        return 1
    if misattributed:
        for r in misattributed:
            a = r.attribution
            print(f"FAIL: seed {r.seed} attribution "
                  f"recall={a['recall']:.2f} "
                  f"precision={'ok' if a['precision_ok'] else 'violated'}:",
                  file=sys.stderr)
            for m in a["misses"]:
                print(f"  {m}", file=sys.stderr)
        return 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
