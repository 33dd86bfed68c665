"""Run ``chip_smoke.py``'s ``sampler_3d: gather`` phases alone on the card:
the kernels' build (with ptxas's register and shared-memory report of the
gather-bf16 kernels), the 6-camera bf16 gather serving and training paths
(launch counts, step 1 against the plain versions, a profiled step), then
``check_gather_forms`` on the warm-up step's own inputs (both gather-bf16
forms bit for bit against their plain versions, the plan, their times
beside ``F.grid_sample``, the hot-voxel input). A quick check of the
gather-bf16 kernels after a change to them; the whole ``chip_smoke.py``
runs the same phases.

    python3 scripts/chip_gather.py

It imports ``chip_smoke`` and the package from the checkout it sits in, so
a copy placed in another checkout's ``scripts/`` runs that checkout's
kernels: two checkouts compare on one card in one call.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def ptxas_report(built) -> None:
    """The lines of nvcc's -Xptxas -v output about the gather kernels."""
    for name in ("sample3d", "sample3d_bwd"):
        lines = built[name].log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "gather" in line:
                for more in lines[i:i + 4]:
                    print(f"ptxas {name}: {more.strip()}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_gather: no CUDA device", file=sys.stderr)
        return 2
    from vfdepth_tpu_torch.ops import _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"checkout {ROOT}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    t = time.perf_counter()
    ptxas_report(_build.build())
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    device = torch.device("cuda", 0)
    cfg = chip_smoke.mixed_precision_config()
    cfg.set("sampler_3d", "gather")
    launches = chip_smoke.launches
    _, ms, *_ = chip_smoke.run_serving_path(
        cfg, device, "6-camera bf16 gather", launches(
            **{"K1-bf16": 1, "K3-gather-bf16": 1}), "even",
        tols=(chip_smoke.BF16_FWD_RTOL, chip_smoke.BF16_POSE_ATOL))
    print(f"6-camera bf16 gather request ms {[round(m, 3) for m in ms]}",
          flush=True)
    torch.cuda.empty_cache()
    calls = {}
    _, ms = chip_smoke.run_training_path(
        cfg, device, "6-camera bf16 gather", launches(
            **{"K1-bf16": 1, "K2-bf16": 1, "K3-gather-bf16": 1,
               "K4-gather-bf16": 1, "K5-bf16": 4}), "even",
        tols=(chip_smoke.BF16_STEP_LOSS_RTOL, chip_smoke.BF16_STEP_GRAD_RTOL),
        k3k4_calls=calls, sampler="Sample3dGather")
    print(f"6-camera bf16 gather step ms {[round(m, 3) for m in ms]}",
          flush=True)
    torch.cuda.empty_cache()
    rows = chip_smoke.check_gather_forms(calls)
    print(json.dumps({"gather_rows": rows}, default=str), flush=True)
    print(f"gather phases {time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
