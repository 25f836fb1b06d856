"""Print the largest segment id (the JAX package's
``plugins/print_max_id.py``)."""
import numpy as np


def execute(chunk):
    print(f"max id: {int(np.asarray(chunk.host()).max())}")
