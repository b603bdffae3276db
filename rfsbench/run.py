"""The benchmark's command: one run of one cell (see bench.py).

    python3 rfsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m rfsbench.run ...   (the same)"""

import time

T_START = time.time()

import pathlib  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from rfsbench.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
