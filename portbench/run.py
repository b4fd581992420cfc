"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`.  Prints one JSON
line on standard output; exits non-zero, printing no result, without the
cards the cell asks for or when a JAX module was loaded.
"""

import time

T_START = time.perf_counter()          # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    harness.cache_environment()
    sys.exit(harness.main(t_start=T_START))
