"""python3 -m bench_h100: one run of one cell (bench_h100/run.py)."""

import sys

from bench_h100.run import main

sys.exit(main())
