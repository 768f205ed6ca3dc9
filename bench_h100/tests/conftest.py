"""The benchmark's modules import each other by their file names, as
run.py does: put the harness's directory and the checkout's root first
on the path."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parents[1])]
