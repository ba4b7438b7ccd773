"""CLI for the crash-restart explorer (the port's twin of the JAX
package's ``python -m tools.crash``, with its flags).

    python -m k8s_operator_libs_tpu_torch.chaos.crash          # full sweep
    python -m k8s_operator_libs_tpu_torch.chaos.crash --smoke  # subset
    python -m k8s_operator_libs_tpu_torch.chaos.crash --list   # registry
    python -m k8s_operator_libs_tpu_torch.chaos.crash \
        --site health-quarantine --phase before --occurrence 2  # one point
"""

from __future__ import annotations

import argparse
import sys
import time

from .explorer import (CrashPlan, full_sweep, record_sites,
                       run_crash_point, smoke_sweep)
from .registry import SITE_WIRE_KEYS, SITES


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--site", choices=SITES, default=None,
                   help="replay one site instead of sweeping")
    p.add_argument("--phase", choices=("before", "after"),
                   default="before")
    p.add_argument("--occurrence", type=int, default=1)
    p.add_argument("--occurrences-per-site", type=int, default=2,
                   help="crash points per site in the full sweep (the "
                        "first write plus evenly-spaced later ones)")
    p.add_argument("--smoke", action="store_true",
                   help="budgeted subset (the CI gate)")
    p.add_argument("--list", action="store_true", dest="list_sites",
                   help="print the registry and the observed per-site "
                        "write counts, then exit")
    args = p.parse_args(argv)

    t0 = time.monotonic()
    if args.list_sites:
        observed = record_sites(args.seed)
        print(f"{'site':>20s}  {'writes':>6s}  wire keys")
        for site in SITES:
            keys = ", ".join(SITE_WIRE_KEYS[site]) or "(templates)"
            print(f"{site:>20s}  {observed.get(site, 0):>6d}  {keys}")
        return 0
    if args.site:
        results = [run_crash_point(
            CrashPlan(args.site, args.occurrence, args.phase),
            args.seed)]
    elif args.smoke:
        results = smoke_sweep(args.seed)
    else:
        results = full_sweep(
            args.seed, occurrences_per_site=args.occurrences_per_site)
    failed = 0
    for result in results:
        print(result.report())
        if result.failed:
            failed += 1
            for line in result.trace:
                print(f"    {line}")
    wall = time.monotonic() - t0
    print(f"\n{len(results) - failed}/{len(results)} crash points "
          f"converged ({wall:.1f}s wall, seed {args.seed})")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
