"""The benchmark's own tests: ``python -m pytest portbench/tests`` from
the repository root (the repository's ``tests/`` are another suite).
Tests marked ``cuda`` need the card and skip elsewhere."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for path in (HERE, HERE.parent, HERE.parent.parent):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
