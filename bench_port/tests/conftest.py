"""The benchmark's own tests, on the CPU: ``python -m pytest bench_port/tests``
from the repository root."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
