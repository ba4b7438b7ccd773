"""Run one benchmark cell once; see ``benchmark/harness.py``.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. The clock for ``setup_s`` starts here,
before anything is imported.
"""

import sys
import time

T_PROCESS = time.perf_counter()

from pathlib import Path  # noqa: E402

# the checkout's root, not this directory, is where imports resolve
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
