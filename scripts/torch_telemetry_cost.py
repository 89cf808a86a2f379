"""What each leg of the armed telemetry plane costs a tree, on a card.

Trains chip_smoke.py's Higgs-shaped task (1,000,000 x 28, 255 leaves,
phase 3's Dataset and parameters) for 5 rounds on the serial graph loop
and on the data learner over 4x1 slots, once disarmed and once with each
leg armed alone (the trace with the memory monitor, the flight
recorder, the /metrics exporter, the model-quality plane with the flight
recorder) and all together, in turns.  Prints each run's median ms a
tree over the iterations after the first (which holds the capture), and
a cProfile of two armed iterations of each learner, by cumulative time.

    python3 scripts/torch_telemetry_cost.py      # needs a CUDA card
"""
import cProfile
import os
import pstats
import socket
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lightgbm_tpu_torch import Dataset, train  # noqa: E402

ROUNDS = 5


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def legs(tmp: str) -> dict:
    fl = os.path.join(tmp, "fl")
    return {
        "disarmed": {},
        "trace": dict(trace_path=os.path.join(tmp, "t.json")),
        "flight": dict(obs_stream_path=fl),
        "metrics": dict(metrics_port=free_port()),
        "model_quality": dict(model_quality="on", obs_stream_path=fl),
        "all": dict(trace_path=os.path.join(tmp, "t.json"),
                    obs_stream_path=fl, metrics_port=free_port(),
                    model_quality="on"),
    }


def ms_per_tree(params, ds) -> float:
    marks = []

    def mark(env):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    mark.before_iteration = True
    train(params, ds, ROUNDS, verbose_eval=False, callbacks=[mark])
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    return 1e3 * statistics.median(b - a for a, b in
                                   zip(marks[1:], marks[2:]))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rng = np.random.default_rng(cs.SEED + 1)
    x, y = cs.higgs_like(cs.N_ROWS, rng)
    params = dict(objective="binary", num_leaves=255, max_bin=cs.N_BINS,
                  min_data_in_leaf=1, min_sum_hessian_in_leaf=100,
                  learning_rate=0.1, verbose=-1, device="cuda")
    ds = Dataset(x, y, params=params).construct()
    learners = {"serial": params,
                "dp_4x1": dict(params, tree_learner="data",
                               mesh_devices=cs.MESH_SLOTS, mesh_shape="4x1")}
    for name, p in learners.items():
        with tempfile.TemporaryDirectory() as tmp:
            runs = legs(tmp)
            out = {k: [] for k in runs}
            for _ in range(2):                 # in turns, twice
                for leg, extra in runs.items():
                    out[leg].append(ms_per_tree(dict(p, **extra), ds))
            print(name, " ".join(f"{leg}={','.join(f'{v:.2f}' for v in vs)}"
                                 for leg, vs in out.items()), flush=True)
            prof = cProfile.Profile()

            def toggle(env):
                torch.cuda.synchronize()
                if env.iteration == 2:
                    prof.enable()
                elif env.iteration == 4:
                    prof.disable()
            toggle.before_iteration = True
            train(dict(p, **runs["all"]), ds, ROUNDS, verbose_eval=False,
                  callbacks=[toggle])
            print(f"cProfile of iterations 2 and 3, {name}, all armed:")
            pstats.Stats(prof).sort_stats("cumulative").print_stats(30)


if __name__ == "__main__":
    main()
