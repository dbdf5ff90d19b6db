"""Run one cell of the benchmark of tpuprt_torch (see harness/main.py):

    python3 benchmark/run.py --workload config4_big.pool --seed 7 \\
        --seconds 30 --trace 0
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0))
