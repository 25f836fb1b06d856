"""The forward precision: ``precision=`` and ``CHUNKFLOW_PRECISION``.

The counterpart of ``resolve_precision`` in
``chunkflow_tpu/inference/precision.py``, with its names, aliases and
rules: an explicit ``precision`` is strict (an unknown value raises
``ValueError``); otherwise ``CHUNKFLOW_PRECISION`` is read, and an
unknown value there prints one note on stderr (once per value) and runs
float32, so a typo never selects a quantized forward. Only float32 is
ported: the inferencer raises for anything else rather than run float32
where the JAX package would quantize.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

PRECISIONS = ("float32", "bfloat16", "int8")

_ALIASES = {"f32": "float32", "fp32": "float32", "bf16": "bfloat16",
            "i8": "int8"}

# the env values each precision answers to ("" is the unset variable)
_ENV_CHOICES = {
    "float32": ("", "float32"),
    "bfloat16": ("bfloat16",),
    "int8": ("int8",),
}

# unknown env values already reported (one note per value per process)
_WARNED_VALUES: set = set()


def resolve_precision(value: Optional[str] = None) -> str:
    """The effective forward precision: ``float32``, ``bfloat16`` or
    ``int8``."""
    if value is not None:
        v = str(value).lower()
        v = _ALIASES.get(v, v)
        if v not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS} (got {value!r})")
        return v
    raw = os.environ.get("CHUNKFLOW_PRECISION", "")
    env = _ALIASES.get(raw.lower(), raw.lower())
    for mode, values in _ENV_CHOICES.items():
        if env in values:
            return mode
    if env not in _WARNED_VALUES:
        _WARNED_VALUES.add(env)
        expected = ", ".join("/".join(v for v in values if v) or "(unset)"
                             for values in _ENV_CHOICES.values())
        print(f"CHUNKFLOW_PRECISION={raw!r} is not a recognized value "
              f"(expected one of {expected}); running the float32 default "
              f"— a typo must not silently select a quantized forward",
              file=sys.stderr)
    return "float32"
