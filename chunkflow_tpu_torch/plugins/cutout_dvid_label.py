"""Cut a label chunk out of a DVID server (the JAX package's
``plugins/cutout_dvid_label.py``): needs the server at call time."""
from urllib.request import urlopen

import numpy as np

from chunkflow_tpu_torch.chunk import Segmentation


def execute(bbox, server: str = None, uuid: str = None,
            instance: str = "segmentation", supervoxels: bool = False):
    if server is None or uuid is None:
        raise ValueError("cutout_dvid_label needs server=... and uuid=...")
    size = tuple(s for s in bbox.shape)           # zyx
    offset = tuple(int(s) for s in bbox.start)
    # the DVID raw API orders x, y, z
    url = (
        f"{server}/api/node/{uuid}/{instance}/raw/0_1_2/"
        f"{size[2]}_{size[1]}_{size[0]}/"
        f"{offset[2]}_{offset[1]}_{offset[0]}"
        f"?supervoxels={'true' if supervoxels else 'false'}"
    )
    with urlopen(url) as response:
        blob = response.read()
    array = np.frombuffer(blob, dtype=np.uint64).reshape(size)
    return Segmentation(array.copy(), voxel_offset=bbox.start)
