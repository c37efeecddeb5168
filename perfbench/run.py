"""Run one cell of the benchmark on the card and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port (`gnnla_tpu_torch`). The
last line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` also `breakdown`, and last
`checks`: each number compared with its limit). Exits 2 with no result
when the cell's cards are missing or JAX was loaded.
"""

import time

T_PROCESS = time.perf_counter()  # set-up counts from here

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
