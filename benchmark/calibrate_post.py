#!/usr/bin/env python3
"""benchmark/calibrate.py for the post-optimization cells, with their
faults (benchmark/harness/faults_post.py) known to --fault:

    python3 benchmark/calibrate_post.py --workload post-orbit4M-1080p \
        --seeds 11 12 13 [--mode program|control] \
        [--fault post_half_batch|post_coarse_cut|post_state_unchanged]
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from benchmark import calibrate
    from benchmark.harness import faults_post
    faults_post.register()
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
