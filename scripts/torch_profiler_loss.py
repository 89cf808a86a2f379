"""Where a torch.profiler window loses kernel records on a card.

Grows chip_smoke.py's Higgs-shaped trees (1,000,000 x 28, 255 leaves,
the serial graph loop) under chip_smoke.py's ``device_ms`` window with
its spin-kernel markers, for several host pauses between the profiler's
start and the markers and several marker counts, and prints for each
window the records lost (``obs/devprof.py:lost_records`` over the
window's correlation ids) and the places, among the window's kernel
launches in order, of the launches whose kernel record is missing.

    python3 scripts/torch_profiler_loss.py     # needs a CUDA card
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lightgbm_tpu_torch import Dataset, train  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(cs.SEED + 1)
    x, y = cs.higgs_like(cs.N_ROWS, rng)
    params = dict(objective="binary", num_leaves=255, max_bin=cs.N_BINS,
                  min_data_in_leaf=1, min_sum_hessian_in_leaf=100,
                  learning_rate=0.1, verbose=-1, device="cuda")
    ds = Dataset(x, y, params=params).construct()
    bst = train(params, ds, 1, verbose_eval=False)
    real_sleep = time.sleep
    for settle in (0.0, 0.05, 0.2):
        for markers in (32, 256):
            cs.MARKERS = markers
            for _ in range(2):
                loss = {}
                # the pause, taken at the markers' first launch
                state = {"paused": False}
                orig = torch.cuda._sleep

                def spin(cycles):
                    if not state["paused"]:
                        state["paused"] = True
                        real_sleep(settle)
                    orig(cycles)
                torch.cuda._sleep = spin
                try:
                    cs.device_ms(bst.update, ("hist_gather",), loss=loss)
                finally:
                    torch.cuda._sleep = orig
                print(f"settle={settle} markers={markers} "
                      f"lost={loss['lost']} "
                      f"by={loss['correlation_lost_by']} "
                      f"places={loss['lost_launch_places']}", flush=True)


if __name__ == "__main__":
    main()
