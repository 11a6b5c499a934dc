"""``python -m horovod_tpu_torch.runner`` == ``hvdrun-torch``."""

import sys

from .launch import main

if __name__ == "__main__":
    sys.exit(main())
