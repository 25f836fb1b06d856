"""Warn-once parsing of the mode-selecting environment variables.

The counterpart of ``chunkflow_tpu/core/envmode.py``: recognized values
map to a mode, case-insensitively; an unknown value runs a safe default
and prints one stderr note per distinct value. Callers keep their own
warned-set, so one variable's typos never mute another's.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Tuple

__all__ = ["resolve"]


def resolve(var: str, choices: Dict[str, Tuple[str, ...]],
            default: str, note: str, warned: set,
            aliases: Optional[Dict[str, str]] = None) -> str:
    """The mode ``var`` selects, case-insensitively (``aliases`` folded
    in after lowercasing); ``default`` with one stderr note per unknown
    value otherwise. ``note`` says which path the fallback runs."""
    raw = os.environ.get(var, "")
    env = raw.lower()
    if aliases:
        env = aliases.get(env, env)
    for mode, values in choices.items():
        if env in values:
            return mode
    if env not in warned:
        warned.add(env)
        expected = ", ".join("/".join(v for v in values if v) or "(unset)"
                             for values in choices.values())
        print(f"{var}={raw!r} is not a recognized value (expected one of "
              f"{expected}); {note}", file=sys.stderr)
    return default
