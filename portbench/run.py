"""Benchmark of ``chunkflow_tpu_torch`` on the card: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. Prints, after the run, the card's name
and power limit, then, as its last line, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` (with ``busy_s`` and ``window_s`` when traced),
``breakdown`` when traced, and last
``checked``: each number compared with the plain reference beside its
limit, which also end standard error. Exits non-zero, printing no
result, without a CUDA device (or with fewer than the cell asks for), or
when a module of the JAX stack or of the JAX package is loaded at the
end.
"""
import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # the program runs as its configuration says: no inherited switch of
    # the program's may change its precision, scheduler or blend
    for name in [k for k in os.environ if k.startswith("CHUNKFLOW_")]:
        del os.environ[name]
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import harness

    started = harness.process_start()
    if started is None or not 0 <= STARTED - started < 120:
        started = STARTED
    cell = harness.Cell(args.workload, ROOT, BENCH)
    try:
        result = harness.execute(cell, args.seed, args.seconds,
                                 bool(args.trace), started=started)
    except harness.NoDevice as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    print(f"card: {harness.power_line()}", flush=True)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}; no result",
              file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"checked {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
