"""The explorer's command line: ``python -m k8s_operator_libs_tpu_torch.race``
(the twin of the JAX package's ``python -m tools.race``)."""

from __future__ import annotations

import argparse
import sys
import time

PLANTED = "k8s_operator_libs_tpu_torch/race/planted.py"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m k8s_operator_libs_tpu_torch.race",
        description="deterministic schedule exploration over the seven "
                    "real-component harnesses of the port")
    ap.add_argument("--harness", action="append", default=[],
                    help="harness name (repeatable; default: all seven)")
    ap.add_argument("--seeds", type=int, default=None,
                    help="schedules per harness (default 40; --smoke 6)")
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="fixed seeds under a wall-clock budget")
    ap.add_argument("--budget", type=float, default=120.0,
                    help="--smoke wall-clock budget in seconds")
    ap.add_argument("--self-test", action="store_true",
                    help="run the PLANTED bugs: the explorer must find, "
                         "shrink and replay each one")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    from . import explore, harnesses, planted, replay

    if args.list:
        for name in harnesses.HARNESSES:
            print(name)
        return 0

    if args.self_test:
        return _self_test(args)

    names = args.harness or list(harnesses.HARNESSES)
    seeds = args.seeds if args.seeds is not None else (6 if args.smoke
                                                      else 40)
    t0 = time.monotonic()
    failed = False
    for name in names:
        fn = harnesses.HARNESSES.get(name)
        if fn is None:
            print(f"unknown harness {name!r} (try --list)",
                  file=sys.stderr)
            return 2
        result = explore(fn, schedules=seeds, base_seed=args.base_seed,
                         name=name,
                         lockset_files=harnesses.LOCKSET_FILES.get(name))
        print(result.report())
        failed = failed or result.failed
        if args.smoke and time.monotonic() - t0 > args.budget:
            print(f"race-smoke: wall-clock budget ({args.budget:.0f}s) "
                  f"exceeded after {name}", file=sys.stderr)
            return 1
    dt = time.monotonic() - t0
    print(f"race[{'smoke' if args.smoke else 'full'}]: {len(names)} "
          f"harnesses x {seeds} seeds in {dt:.1f}s", file=sys.stderr)
    return 1 if failed else 0


def _self_test(args) -> int:
    """The planted bugs are the detector's own regression gate."""
    from . import explore, replay
    from . import planted

    ok = True
    result = explore(planted.racy_counter_harness, schedules=50,
                     name="planted:racy_counter",
                     lockset_files=[PLANTED])
    if not result.failed:
        print("FAIL planted racy counter was NOT detected")
        ok = False
    else:
        rep = replay(planted.racy_counter_harness, result.failing_seed,
                     result.minimal_trace,
                     lockset_files=[PLANTED])
        print(result.report())
        if not rep.failed:
            print("FAIL minimal trace did not replay the failure")
            ok = False
    clean = explore(lambda s: planted.racy_counter_harness(s, safe=True),
                    schedules=20, name="planted:safe_counter",
                    lockset_files=[PLANTED])
    print(clean.report())
    if clean.failed:
        ok = False
    flag = explore(planted.shared_flag_harness, schedules=20,
                   name="planted:shared_flag",
                   lockset_files=[PLANTED])
    print(flag.report())
    if not flag.failed:
        print("FAIL lockset checker missed the unguarded flag")
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
