"""Worker-side loop for :class:`TpuExecutor` (counterpart:
``horovod_tpu/runner/executor_task.py``; reference: the Ray actor's
``execute`` method body in horovod/ray/runner.py).

Invoked as ``python -m horovod_tpu_torch.runner.executor_task
<control_dir> [device]``: initializes the runtime ONCE (on ``device``,
default ``cuda:<local_rank>``), announces readiness, then serves pickled
tasks from the control directory until the stop marker appears — the
runtime and the built kernels stay warm across tasks.
"""

from __future__ import annotations

import os
import pickle
import sys
import time
import traceback

_POLL_S = 0.05


def main(control_dir: str, device=None) -> int:
    import horovod_tpu_torch as hvd
    hvd.init(device=device)
    rank = int(os.environ.get("HOROVOD_RANK", hvd.rank()))

    ready_tmp = os.path.join(control_dir, f".ready_{rank}.tmp")
    with open(ready_tmp, "w") as f:
        f.write("1")
    os.replace(ready_tmp, os.path.join(control_dir, f"ready_{rank}"))

    seq = 0
    try:
        while True:
            if os.path.exists(os.path.join(control_dir, "stop")):
                return 0
            task = os.path.join(control_dir, f"task_{seq}.pkl")
            if not os.path.exists(task):
                time.sleep(_POLL_S)
                continue
            with open(task, "rb") as f:
                fn, args, kwargs = pickle.load(f)
            try:
                result = (True, fn(*args, **kwargs))
            except Exception:  # noqa: BLE001 - report to the driver
                result = (False, traceback.format_exc())
            tmp = os.path.join(control_dir, f".result_{seq}_{rank}.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(result, f)
            os.replace(tmp, os.path.join(control_dir,
                                         f"result_{seq}_{rank}.pkl"))
            seq += 1
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
