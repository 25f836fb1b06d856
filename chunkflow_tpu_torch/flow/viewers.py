"""Viewers: in-process neuroglancer and napari layers (the counterpart
of ``chunkflow_tpu/flow/viewers.py``).

``build_layers`` appends one layer config per entry: a chunk by its
layer type (image, segmentation, probability map, affinity map) with the
JAX package's shaders, synapses as pre-to-post line annotations and a
T-bar point layer, point clouds, and a dict of skeletons (objects with
``vertices`` and ``edges``) as line annotations. A chunk on the card is
read once to the host. Only ``serve_neuroglancer`` touches the real
server, so the layers are testable with a stub ``neuroglancer`` module.
"""
from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np

from chunkflow_tpu_torch.annotations.point_cloud import PointCloud
from chunkflow_tpu_torch.annotations.synapses import Synapses
from chunkflow_tpu_torch.chunk.base import Chunk, LayerType

_ANNOTATION_SHADER = """
void main() {
  setColor(prop_color());
  setPointMarkerSize(prop_size());
}
"""

_GRAYSCALE_SHADER = """#uicontrol invlerp normalized
void main() {
  emitGrayscale(normalized());
}"""

_MULTICHANNEL_SHADER = """#uicontrol int channel slider(min=0, max=4)
#uicontrol vec3 color color(default="white")
#uicontrol float brightness slider(min=-1, max=1)
#uicontrol float contrast slider(min=-3, max=3, step=0.01)
void main() {
  emitRGB(color *
          (toNormalized(getDataValue(channel)) + brightness) *
          exp(contrast));
}"""


def _rgb_shader(nchan: int, color: Optional[str] = None) -> str:
    """Probability-map shaders by channel count."""
    if nchan == 1:
        if color is not None:
            return (
                '#uicontrol vec3 color color(default="%s")\n'
                "#uicontrol float brightness slider(min=-1, max=1)\n"
                "#uicontrol float contrast slider(min=-3, max=3, step=0.01)\n"
                "void main() {\n"
                "  emitRGB(color * (toNormalized(getDataValue(0)) + "
                "brightness) * exp(contrast));\n}" % color
            )
        return "void main() {\nemitGrayscale(toNormalized(getDataValue(0)));\n}"
    if nchan == 2:
        return (
            "void main() {\nemitRGB(vec3(toNormalized(getDataValue(0)),\n"
            "            toNormalized(getDataValue(1)),\n            0.));\n}"
        )
    return (
        "void main() {\nemitRGB(vec3(toNormalized(getDataValue(0)),\n"
        "            toNormalized(getDataValue(1)),\n"
        "            toNormalized(getDataValue(2))));\n}"
    )


def _chunk_voxel_size(chunk, override) -> tuple:
    if override:
        return tuple(override)
    vs = tuple(chunk.voxel_size)
    return vs if any(v != 0 for v in vs) else (1, 1, 1)


def _annotation_properties(ng):
    return [
        ng.AnnotationPropertySpec(id="color", type="rgb", default="red"),
        ng.AnnotationPropertySpec(id="size", type="float32", default=5),
    ]


def _annotation_layer(ng, annotations, scales=(1, 1, 1)):
    return ng.LocalAnnotationLayer(
        dimensions=ng.CoordinateSpace(
            names=["x", "y", "z"], units="nm", scales=tuple(scales)
        ),
        annotation_properties=_annotation_properties(ng),
        annotations=annotations,
        shader=_ANNOTATION_SHADER,
    )


def _append_image_layer(ng, txn, name, chunk, voxel_size):
    arr = np.asarray(chunk.host())
    vs = _chunk_voxel_size(chunk, voxel_size)
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim == 3:
        dimensions = ng.CoordinateSpace(
            names=["x", "y", "z"], units="nm", scales=vs[::-1]
        )
        txn.layers.append(
            name=name,
            layer=ng.LocalVolume(
                data=arr.transpose(),  # zyx -> xyz
                dimensions=dimensions,
                voxel_offset=tuple(chunk.voxel_offset)[::-1],
            ),
            shader=_GRAYSCALE_SHADER,
        )
    else:  # czyx -> xyzc
        dimensions = ng.CoordinateSpace(
            names=["x", "y", "z", "c"],
            units=["nm", "nm", "nm", ""],
            scales=(*vs[::-1], 1),
        )
        txn.layers.append(
            name=name,
            layer=ng.LocalVolume(
                data=arr.transpose(),  # czyx -> xyzc
                dimensions=dimensions,
                voxel_offset=(*tuple(chunk.voxel_offset)[::-1], 0),
            ),
            shader=_MULTICHANNEL_SHADER,
        )


def _append_segmentation_layer(ng, txn, name, chunk, voxel_size):
    arr = np.asarray(chunk.host())
    if arr.ndim == 4:
        arr = arr[0]
    # neuroglancer does not accept bool/int64/uint8 segmentation dtypes
    if arr.dtype == bool:
        arr = arr.astype(np.uint8)
    if np.issubdtype(arr.dtype, np.signedinteger):
        arr = arr.astype(np.uint64)
    elif arr.dtype == np.uint8:
        arr = arr.astype(np.uint32)
    vs = _chunk_voxel_size(chunk, voxel_size)
    dimensions = ng.CoordinateSpace(
        names=["x", "y", "z"], units="nm", scales=vs[::-1]
    )
    txn.layers.append(
        name=name,
        layer=ng.LocalVolume(
            data=arr.transpose(),  # zyx -> xyz
            dimensions=dimensions,
            voxel_offset=tuple(chunk.voxel_offset)[::-1],
        ),
    )


def _append_probability_map_layer(ng, txn, name, chunk, voxel_size,
                                  color=None):
    arr = np.asarray(chunk.host())
    if arr.ndim == 3:
        arr = arr[None]
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    vs = _chunk_voxel_size(chunk, voxel_size)
    dimensions = ng.CoordinateSpace(
        names=["x", "y", "z", "c^"],
        units=["nm", "nm", "nm", ""],
        scales=(*vs[::-1], 1),
    )
    txn.layers.append(
        name=name,
        layer=ng.LocalVolume(
            data=arr.transpose(),  # czyx -> xyzc
            dimensions=dimensions,
            voxel_offset=(*tuple(chunk.voxel_offset)[::-1], 0),
        ),
        shader=_rgb_shader(arr.shape[0], color=color),
    )


def _append_point_layer(ng, txn, name, points: PointCloud,
                        color="#ff0", size=8):
    annotations = [
        ng.PointAnnotation(
            id=str(i),
            point=points.points[i, :].tolist()[::-1],
            props=[color, size],
        )
        for i in range(len(points))
    ]
    txn.layers.append(
        name=name,
        layer=_annotation_layer(
            ng, annotations, scales=tuple(points.voxel_size)[::-1]
        ),
    )


def _append_synapse_layers(ng, txn, name, synapses: Synapses):
    """Pre→post line annotations + a distinct T-bar point layer."""
    res = np.asarray(tuple(synapses.resolution), dtype=np.float64)
    pre_nm = synapses.pre * res
    annotations = []
    if synapses.post is not None:
        post_nm = synapses.post[:, 1:] * res
        for i in range(synapses.post_num):
            pre_idx = int(synapses.post[i, 0])
            annotations.append(
                ng.LineAnnotation(
                    id=str(i),
                    pointA=pre_nm[pre_idx].tolist()[::-1],
                    pointB=post_nm[i].tolist()[::-1],
                    props=["#0ff", 5],
                )
            )
    txn.layers.append(name=name, layer=_annotation_layer(ng, annotations))
    _append_point_layer(
        ng, txn, name + "_pre",
        PointCloud(pre_nm, voxel_size=(1, 1, 1)),
    )


def _append_skeleton_layer(ng, txn, name, oid2skel: dict):
    """Skeletons as line annotations. Accepts a dict of object id ->
    skeleton with ``vertices`` [N,3] and ``edges`` [M,2]."""
    annotations = []
    for oid, skel in oid2skel.items():
        vertices = np.asarray(skel.vertices, dtype=np.float64).copy()
        # swap x and y to align with the image, as the reference does
        vertices[:, [0, 1]] = vertices[:, [1, 0]]
        for p1, p2 in np.asarray(skel.edges, dtype=np.int64):
            annotations.append(
                ng.LineAnnotation(
                    id=str(oid),
                    pointA=vertices[p1, :].tolist(),
                    pointB=vertices[p2, :].tolist(),
                    props=["red", 2],
                )
            )
    txn.layers.append(name=name, layer=_annotation_layer(ng, annotations))


def build_layers(txn, datas: Dict[str, object],
                 voxel_size: Optional[tuple] = None) -> int:
    """Append one neuroglancer layer config per entry; returns the count.

    The JAX package's dispatch: Chunk by layer type, Synapses,
    PointCloud, dict of skeletons, bare [N,3] point arrays.
    """
    ng = sys.modules.get("neuroglancer")
    if ng is None:  # pragma: no cover - imported by the CLI
        import neuroglancer as ng
    count = 0
    for name, data in datas.items():
        if data is None:
            continue
        if isinstance(data, PointCloud):
            _append_point_layer(ng, txn, name, data)
        elif isinstance(data, Synapses):
            _append_synapse_layers(ng, txn, name, data)
        elif isinstance(data, dict):
            _append_skeleton_layer(ng, txn, name, data)
        elif isinstance(data, np.ndarray) and data.ndim == 2 \
                and data.shape[1] == 3:
            _append_point_layer(ng, txn, name, PointCloud(data))
        elif isinstance(data, Chunk):
            # Chunk.__init__ always infers a layer_type, so the predicates
            # are exhaustive for real chunks
            if data.is_segmentation:
                _append_segmentation_layer(ng, txn, name, data, voxel_size)
            elif data.is_probability_map:
                _append_probability_map_layer(ng, txn, name, data, voxel_size)
            else:  # image / affinity map / unknown float data
                _append_image_layer(ng, txn, name, data, voxel_size)
        else:
            raise ValueError(f"cannot render {name!r} of type {type(data)}")
        count += 1
    return count


def serve_neuroglancer(
    datas: Dict[str, object],
    port: int = 0,
    voxel_size: Optional[tuple] = None,
    blocking: bool = True,
) -> "object":
    import neuroglancer

    neuroglancer.set_server_bind_address(
        bind_address="0.0.0.0", bind_port=port
    )
    viewer = neuroglancer.Viewer()
    with viewer.txn() as txn:
        build_layers(txn, datas, voxel_size=voxel_size)
    print(f"neuroglancer viewer at {viewer.get_viewer_url()}")
    if blocking:  # pragma: no cover - interactive
        input("press Enter to stop serving...")
    return viewer


def add_napari_layers(viewer, datas: Dict[str, object]) -> int:
    """One napari layer per chunk: labels for a segmentation, else an
    image."""
    count = 0
    for name, chunk in datas.items():
        if chunk is None:
            continue
        arr = np.asarray(chunk.host())
        if getattr(chunk, "layer_type", None) is LayerType.SEGMENTATION:
            viewer.add_labels(arr, name=name)
        else:
            viewer.add_image(arr, name=name)
        count += 1
    return count
