"""``python -m ics_tpu_torch ...``: the port's command line (see cli.py)."""

import sys

from ics_tpu_torch.cli import main

sys.exit(main())
