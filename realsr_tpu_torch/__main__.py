"""``python -m realsr_tpu_torch`` — the reference CLI surface (see cli.py)."""

import sys

from realsr_tpu_torch.cli import main

if __name__ == "__main__":
    rc = main()
    sys.exit(255 if rc == -1 else rc)
