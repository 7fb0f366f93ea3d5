"""The benchmark's own tests: on the CPU at small sizes, except those
marked `gpu`, which skip without a card. Run from the repository root:

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
