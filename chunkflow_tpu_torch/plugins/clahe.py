"""Per-section CLAHE contrast enhancement (the JAX package's
``plugins/clahe.py``, which calls ``cv2.createCLAHE(clip_limit,
(tile_size, tile_size)).apply`` on each section): the port's host C++,
bitwise cv2 (``ops/clahe.py``)."""
import numpy as np

from chunkflow_tpu_torch.ops.clahe import clahe


def execute(chunk, clip_limit: float = 2.0, tile_size: int = 8):
    arr = np.asarray(chunk.host())
    if arr.dtype != np.uint8:
        raise ValueError("CLAHE needs a uint8 image chunk")
    return clahe(arr, clip_limit, tile_size)
