"""``python -m chunkflow_tpu_torch``: the port's chained CLI."""
import sys

from chunkflow_tpu_torch.flow.cli import main

if __name__ == "__main__":
    sys.exit(main())
