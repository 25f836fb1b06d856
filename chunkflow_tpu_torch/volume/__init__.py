"""Volume storage: the block plane and neuroglancer precomputed volumes."""
