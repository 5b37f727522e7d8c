"""The benchmark's own tests: python -m pytest jxlbench/tests (from the
checkout's root), on the CPU.  The control at the cells' own sizes runs on
the card through `python3 -m jxlbench.control`."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

