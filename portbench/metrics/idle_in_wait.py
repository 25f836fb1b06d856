"""Percent of the traced window in which no kernel ran on the card while
the dispatching thread was inside ``scheduler/load`` (waiting for a
staged chunk) or ``scheduler/wait_result`` (waiting for the oldest
result): the card waited while the executor waited on its own queues.
One of the three shares that split ``device_idle`` (see
``idle_in_dispatch``)."""
from pathlib import Path

import harness


def read(ctx):
    split = harness.load_module(
        Path(__file__).with_name("idle_in_dispatch.py"), "metric").shares(ctx)
    return None if split is None else split["wait"]
