"""``python -m trlx_tpu_torch.analysis.census`` entry point (see cli.py)."""

import sys

from trlx_tpu_torch.analysis.census.cli import main

if __name__ == "__main__":
    sys.exit(main())
