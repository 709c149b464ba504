#!/usr/bin/env python3
"""Benchmark of hlod_gaussians_torch on NVIDIA GPUs: runs one cell of
BENCHMARK.json once and prints one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The run makes its inputs from --seed, sets up
and warms up (that is `setup_s`, from process start to the first timed
unit), measures for --seconds, then checks what the window produced
against the plain reference (benchmark/harness/reference.py) and prints
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"} as the last line of stdout, each compared number beside its
limit on the last lines of stderr. With --trace 1 the first half of the
window is timed as usual and then `profile_cycles` cycles of units run
under torch.profiler; the metrics are then the cell's per-layer ones.
Without a CUDA device, or with fewer than the cell asks for, it exits 3
and prints no result; if jax, jaxlib, flax or hlod_gaussians_tpu is
loaded once the window has closed, it exits 4 and prints no result.

Adding to the benchmark takes files, and an entry in BENCHMARK.json:

* a configuration: benchmark/configs/<name>.json (its sizes; the ones
  the existing drivers read are in the two configurations here) and an
  entry under "configs" naming it;
* a traffic mix: benchmark/traffic/<name>.json, whose "driver" names a
  module of benchmark/drivers/ and whose other keys are that driver's
  parameters (cameras, tau, optimizer, checked units, and the limits of
  the comparison that decides `correct`); a cell is an entry under
  "workloads" pairing a configuration with it;
* a per-layer metric: benchmark/metrics/<name>.py with
  `read(readings) -> float | None` (see benchmark/harness/readings.py)
  and an entry under "per_layer"; one that reads kernel time lists the
  kernel names it sums;
* a new entry point: a module benchmark/drivers/<name>.py with a
  `Session` (see benchmark/harness/core.py).

Build and kernel caches stay in the checkout: the port builds its kernels
into hlod_gaussians_torch/_build/, and TORCH_EXTENSIONS_DIR,
TRITON_CACHE_DIR and CUDA_CACHE_PATH point under benchmark/.cache/.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))

    import torch
    from benchmark.harness import core

    wl, _, _ = core.cell_parts(core.load_bench(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available():
        core.log("benchmark: torch.cuda.is_available() is False — this "
                 "benchmark runs only on an NVIDIA GPU")
        return 3
    if torch.cuda.device_count() < wl["chips"]:
        core.log(f"benchmark: the cell asks for {wl['chips']} GPUs, "
                 f"{torch.cuda.device_count()} visible")
        return 3
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi unavailable"
    core.log(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
             f"peaks 67 TFLOP/s f32, 3.35 TB/s")

    result = core.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START, root=ROOT)
    bad = core.forbidden_modules()
    if bad:
        core.log(f"benchmark: these modules were loaded: {bad}")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
