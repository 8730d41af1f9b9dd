"""The harness's own tests (not under the repository's ``tests/``; run
them with ``python -m pytest portbench/tests``)."""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO), str(Path(__file__).resolve().parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
