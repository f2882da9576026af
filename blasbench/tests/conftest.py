"""The benchmark's CPU tests: ``python -m pytest blasbench/tests`` from the
root of a checkout. They run the harness on the CPU at small sizes, where
the port runs its plain versions; the ``cuda``-marked ones need a card."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
