"""``python -m path_trace_golang_tpu_torch`` == the reference CLI (``cli.py``)."""

import sys

from .cli import main

sys.exit(main())
