"""The repository root on the path, so that `portbench` and the port import
as they do under `python3 portbench/run.py`."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
