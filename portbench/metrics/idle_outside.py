"""Percent of the traced window in which no kernel ran on the card while
the dispatching thread was in none of ``pipeline/dispatch``,
``scheduler/load`` and ``scheduler/wait_result``: the caller's code
between results, or program code no span covers. One of the three
shares that split ``device_idle`` (see ``idle_in_dispatch``)."""
from pathlib import Path

import harness


def read(ctx):
    split = harness.load_module(
        Path(__file__).with_name("idle_in_dispatch.py"), "metric").shares(ctx)
    return None if split is None else split["outside"]
