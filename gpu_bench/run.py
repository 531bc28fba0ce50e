"""The benchmark of real2sim_eval_tpu_torch on NVIDIA cards.

Usage, from the root of a checkout:

    python3 gpu_bench/run.py --workload rope.manipulate64 --seed 7 \
        --seconds 45 --trace 0

Prints one JSON object as the last line of standard output (see
``harness/main.py``); exits non-zero, printing no result, without the
cards the cell asks for.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpu_bench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
