"""``python -m lightgbm_tpu_torch.obs <trace.json[l]> [more...]``: the
telemetry report (:mod:`.report`)."""
import sys

from .report import main

if __name__ == "__main__":
    sys.exit(main())
