"""Tests of the benchmark, on the CPU:

    python -m pytest portbench/tests -q -p no:cacheprovider

They drive the harness with the program's host engine (``NativeEngine``,
the same streams as the card's) at small sizes, since the card's route
cannot run here."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
