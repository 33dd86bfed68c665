"""Run ``chip_smoke.py``'s data-parallel and camera-axis phases alone on
the card: the kernels' build, then ``run_data_parallel`` (the NCCL world of
one through the command line, the single-process references, two gloo
ranks, the camera-axis grids). A quick check of ``parallel/`` after a
change to it; the whole ``chip_smoke.py`` runs them too.

    python3 scripts/chip_parallel.py
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_parallel: no CUDA device", file=sys.stderr)
        return 2
    from vfdepth_tpu_torch.ops import _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    t = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    chip_smoke.run_data_parallel(torch.device("cuda", 0), {})
    print(f"data-parallel and camera-axis phases "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
