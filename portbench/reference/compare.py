"""The numbers ``correct`` rests on: the gap between the program's output
and the plain reference's, voxel by voxel, over the tasks compared."""
from __future__ import annotations

import torch


class Gaps:
    """Mean and largest absolute gap, in the output's [0, 1] scale (a
    uint8 output counts in levels of 1/255). A shape that differs from
    the reference's is an infinite gap."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.worst = 0.0
        self.tasks = 0

    def add(self, got: torch.Tensor, ref: torch.Tensor) -> None:
        self.tasks += 1
        if tuple(got.shape) != tuple(ref.shape):
            self.worst = float("inf")
            self.total = float("inf")
            return
        if got.dtype == torch.uint8:
            got = got.float() / 255.0
            ref = ref.float() / 255.0
        gap = (got.float() - ref.float()).abs()
        self.total += gap.sum(dtype=torch.float64).item()
        self.count += gap.numel()
        self.worst = max(self.worst, gap.max().item())

    def numbers(self) -> dict:
        empty = float("inf")
        return {"mean_abs_gap": self.total / self.count if self.count
                else empty,
                "max_abs_gap": self.worst if self.count else empty,
                "tasks_compared": self.tasks}
