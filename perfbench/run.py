"""Run one cell of the benchmark once (see perfbench/harness/cli.py):

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""
import time

T_START = time.perf_counter()  # the process's start, as near as the script sees it

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")  # no library may load flax (JAX) on its own
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")  # one process, few threads: the host paces decode

from perfbench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
