"""Worker-side entry for ``horovod_tpu_torch.runner.run``.

Counterpart: ``horovod_tpu/runner/run_task.py`` (reference:
horovod/runner/run_task.py + task_fn pickling in launch.py ``_run``).
Invoked as ``python -m horovod_tpu_torch.runner.run_task <payload.pkl>
<results_dir> [device]``: loads the pickled (fn, args, kwargs),
initializes the runtime on ``device`` (default ``cuda:<local_rank>``),
calls fn, and writes this rank's return value to
``results_dir/rank_<i>.pkl`` for the caller to collect.
"""

from __future__ import annotations

import os
import pickle
import sys


def main(payload_path: str, results_dir: str, device=None) -> int:
    with open(payload_path, "rb") as f:
        fn, args, kwargs = pickle.load(f)
    import horovod_tpu_torch as hvd
    hvd.init(device=device)
    rank = int(os.environ.get("HOROVOD_RANK", hvd.rank()))
    try:
        result = fn(*args, **kwargs)
    finally:
        hvd.shutdown()
    tmp = os.path.join(results_dir, f".rank_{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(results_dir, f"rank_{rank}.pkl"))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
