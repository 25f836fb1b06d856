"""The readings the limits of a cell's check are set from, in one
process: the program's sound runs on many seeds, the control on a few,
and each fault the cell can have planted in the program on a few.

    python3 portbench/readings.py --workload <cell> --seconds 4 \\
        --seeds <n> ... --control-seeds <n> ... --fault-seeds <n> ...

Each run is a whole run of the cell (``harness.execute``) with a short
window; the check compares as many tasks as a benchmark run does. The
control is the program's own int8 path (``CHUNKFLOW_PRECISION=int8``,
``CHUNKFLOW_INT8=real``: int8 operands and exact integer sums in place
of each bfloat16 convolution), the nearest precision below the
configurations' bfloat16. The faults are those of
``tests/test_faults.py``. Prints one JSON line per run. The benchmark's
own runs never run this.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CONTROL = {"CHUNKFLOW_PRECISION": "int8", "CHUNKFLOW_INT8": "real"}


class Patches:
    """A minimal ``monkeypatch``: the faults' ``setattr``, undone by
    :meth:`undo`."""

    def __init__(self):
        self._saved = []

    def setattr(self, target, name, value):
        self._saved.append((target, name, getattr(target, name)))
        setattr(target, name, value)

    def undo(self):
        while self._saved:
            target, name, value = self._saved.pop()
            setattr(target, name, value)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--root", type=Path, default=ROOT,
                   help="a checkout's root (a copy at other sizes)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for name in [k for k in os.environ if k.startswith("CHUNKFLOW_")]:
        del os.environ[name]
    sys.path[:0] = [str(BENCH / "tests"), str(BENCH), str(ROOT)]
    import harness
    import test_faults

    cell = harness.Cell(args.workload, args.root, args.root / "portbench")
    faults = [f for name, f in test_faults.CASES if name == args.workload]
    runs = ([("sound", s) for s in args.seeds]
            + [("control", s) for s in args.control_seeds]
            + [(f, s) for f in faults for s in args.fault_seeds])
    for what, seed in runs:
        patches = Patches()
        if what == "control":
            os.environ.update(CONTROL)
        elif what != "sound":
            test_faults.FAULTS[what](patches)
        t = time.monotonic()
        try:
            result = harness.execute(cell, seed, args.seconds, False,
                                     device=args.device)
        finally:
            patches.undo()
            for name in CONTROL:
                os.environ.pop(name, None)
        print(json.dumps({
            "workload": args.workload, "run": what, "seed": seed,
            "seconds": round(time.monotonic() - t, 1),
            "tasks": result["attempted"],
            **{k: v["value"] for k, v in result["checked"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
