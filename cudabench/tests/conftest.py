"""CPU tests of the benchmark: ``python -m pytest cudabench/tests`` from the repo root.
Tests marked ``cuda`` run only where a card is; each decides that inside itself."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
