"""Pixel classification via a napari-assistant/apoc classifier file (the
JAX package's ``plugins/napari_pixel_classifier.py``). Requires the
optional ``apoc`` package; errors clearly when absent."""


def execute(chunk, classifier_path: str = None):
    try:
        import apoc
    except ImportError as e:
        raise ImportError(
            "napari_pixel_classifier needs the 'apoc' package, which is not "
            "installed in this environment"
        ) from e
    import numpy as np

    from chunkflow_tpu_torch.chunk.probability_map import ProbabilityMap

    clf = apoc.PixelClassifier(opencl_filename=classifier_path)
    out = np.asarray(clf.predict(image=np.asarray(chunk.host())))
    return ProbabilityMap(
        out.astype(np.float32),
        voxel_offset=chunk.voxel_offset,
        voxel_size=chunk.voxel_size,
    )
