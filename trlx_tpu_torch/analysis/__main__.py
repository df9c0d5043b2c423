"""``python -m trlx_tpu_torch.analysis`` entry point (see cli.py for the flags)."""

import sys

from trlx_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
