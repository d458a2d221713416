"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by its name: ``perfbench/workloads/<name>.json``
names the configuration (``perfbench/configs/``), the traffic mix
(``perfbench/traffic/``) and the loop (``perfbench/paths/``); the per-layer
metrics are the files of ``perfbench/metrics/`` whose ``moves`` names an
end-to-end metric that the cell reports in ``BENCHMARK.json``. The last
line of standard output is one JSON object; nothing is printed there when
the run fails.
"""

import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from perfbench.harness.main import main

    sys.exit(main(sys.argv[1:], T0))
