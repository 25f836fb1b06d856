"""``load_tensorstore``'s other kvstores and its image drivers in the port
(``plugins/load_tensorstore.py``, ``volume/kvstores.py``) against the JAX
plugin, which opens them through tensorstore, on the CPU.

A zarr, zarr v3, N5 or precomputed dataset that tensorstore writes inside
an ``ocdbt`` kvstore, under a local ``http.server`` (an ``http`` kvstore)
or in a zip archive (a ``zip`` kvstore), each with a ``path`` in it,
reads equal to the JAX plugin's cutout and to the plain file's. The image
drivers (``png``, ``jpeg``, ``bmp``, ``tiff``, ``webp``, ``avif``) read
Pillow-written grayscale and RGB images on a strict sub-box bitwise the
JAX plugin (jpeg too: both decoders are libjpeg-turbo), and a 16-bit png
or tiff raises ``NotImplementedError`` in both, as tensorstore reads only
uint8 images. The ``auto`` driver finds each format. What tensorstore
refuses (``cast``, ``downsample``, the ``http://`` and ``zip://``
shorthands, ``memory`` kvstores, an unregistered kvstore driver, an OCDBT
root with no format in it) raises ``ValueError`` in both.
"""
import functools
import http.server
import io
import socket
import threading
import zipfile

import numpy as np
import pytest
import torch

from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
from chunkflow_tpu.flow.plugin import load_plugin as jax_load_plugin
from chunkflow_tpu_torch import BoundingBox
from chunkflow_tpu_torch.flow.plugin import load_plugin
from chunkflow_tpu_torch.volume import storage

ts = pytest.importorskip("tensorstore")
Image = pytest.importorskip("PIL.Image")

torch.set_num_threads(1)

DATA = np.random.default_rng(11).integers(0, 3000, (6, 20, 24)).astype(
    np.uint16)
BOX = ((1, 2, 3), (5, 18, 20))


@pytest.fixture(autouse=True)
def _fresh():
    storage.reset_shared_cache()
    yield


def both(box, **args):
    """(the JAX plugin's cutout, the port's), or the exception each
    raised."""
    out = []
    for load, make in ((jax_load_plugin, JaxBox), (load_plugin, BoundingBox)):
        try:
            chunk = load("load_tensorstore")(make(*box), **args)
            out.append(np.asarray(chunk.array))
        except Exception as exc:  # compared below
            out.append(exc)
    return out


def assert_same(box, **args):
    ref, got = both(box, **args)
    assert isinstance(ref, np.ndarray), ref
    assert isinstance(got, np.ndarray), got
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    return got


def _write(driver, kvstore):
    """DATA as tensorstore writes it with ``driver`` into ``kvstore``; the
    box that cuts BOX out of it."""
    spec = {"driver": driver, "kvstore": kvstore}
    if driver == "neuroglancer_precomputed":
        spec.update(multiscale_metadata={"type": "image",
                                         "data_type": "uint16",
                                         "num_channels": 1},
                    scale_metadata={"size": [24, 20, 6],
                                    "resolution": [4, 4, 40],
                                    "encoding": "raw",
                                    "chunk_size": [16, 16, 4]})
        ts.open(spec, create=True).result()[...] = \
            DATA.transpose(2, 1, 0)[..., None]
        return tuple(b[::-1] for b in BOX)
    ts.open(spec, create=True, dtype="uint16", shape=DATA.shape,
            chunk_layout=ts.ChunkLayout(write_chunk_shape=[4, 8, 8])
            ).result()[...] = DATA
    return BOX


def _want(driver):
    want = DATA[1:5, 2:18, 3:20]
    if driver == "neuroglancer_precomputed":
        want = want.transpose(2, 1, 0)[..., None]
    return want


class _Quiet(http.server.SimpleHTTPRequestHandler):
    """Keep-alive, each answer sent at once (no Nagle wait between its
    header and body writes), no log."""

    protocol_version = "HTTP/1.1"

    def setup(self):
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        super().setup()

    def log_message(self, *args):
        pass


@pytest.fixture
def served(tmp_path):
    """A local ``http.server`` over ``tmp_path/www``: its base URL."""
    root = tmp_path / "www"
    root.mkdir()
    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(_Quiet, directory=str(root)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield root, f"http://127.0.0.1:{server.server_address[1]}/"
    server.shutdown()
    server.server_close()


def _zip(directory, archive):
    with zipfile.ZipFile(archive, "w") as zf:
        for path in sorted(directory.rglob("*")):
            if path.is_file():
                zf.write(path, path.relative_to(directory).as_posix())
    return archive


DRIVERS = ["zarr", "zarr3", "n5", "neuroglancer_precomputed"]


@pytest.mark.parametrize("driver", DRIVERS)
def test_an_ocdbt_kvstore_is_the_jax_plugin(tmp_path, driver):
    kvstore = {"driver": "ocdbt", "base": f"file://{tmp_path}/db/",
               "path": "inner/set/"}
    box = _write(driver, kvstore)
    got = assert_same(box, driver=driver, kvstore=kvstore)
    assert np.array_equal(got, _want(driver))


@pytest.mark.parametrize("driver", DRIVERS)
def test_an_http_kvstore_is_the_jax_plugin(served, driver):
    """Ranged GETs to a server that answers them whole (``http.server``):
    the port cuts the ranges out."""
    root, url = served
    box = _write(driver, f"file://{root}/set/")
    for kvstore in ({"driver": "http", "base_url": url + "set/"},
                    {"driver": "http", "base_url": url, "path": "set/"}):
        got = assert_same(box, driver=driver, kvstore=kvstore)
        assert np.array_equal(got, _want(driver))


@pytest.mark.parametrize("driver", DRIVERS)
def test_a_zip_kvstore_is_the_jax_plugin(tmp_path, driver):
    box = _write(driver, f"file://{tmp_path}/set/")
    _zip(tmp_path / "set", tmp_path / "set.zip")
    _zip(tmp_path, tmp_path.parent / f"{tmp_path.name}-all.zip")
    file_read = assert_same(box, driver=driver,
                            kvstore=f"file://{tmp_path}/set/")
    for kvstore in ({"driver": "zip", "base": f"file://{tmp_path}/set.zip"},
                    {"driver": "zip", "base": {
                        "driver": "file",
                        "path": f"{tmp_path.parent}/{tmp_path.name}-all.zip"},
                     "path": "set/"}):
        got = assert_same(box, driver=driver, kvstore=kvstore)
        assert np.array_equal(got, file_read)
    assert np.array_equal(file_read, _want(driver))


# ---------------------------------------------------------------------------
# the image drivers
# ---------------------------------------------------------------------------
def _image(kind):
    y, x = np.mgrid[0:40, 0:52]
    noise = np.random.default_rng(2).normal(0, 6, (40, 52))
    gray = (np.sin(x / 5) * 60 + np.cos(y / 7) * 50 + 128 + noise).clip(
        0, 255).astype(np.uint8)
    return gray if kind == "gray" else np.stack(
        [gray, gray[::-1], gray[:, ::-1]], -1)


IMAGE_DRIVERS = ["png", "jpeg", "bmp", "tiff", "webp", "avif"]


@pytest.mark.parametrize("kind", ["gray", "rgb"])
@pytest.mark.parametrize("driver", IMAGE_DRIVERS)
def test_image_drivers_are_the_jax_plugin(tmp_path, driver, kind):
    from PIL import features

    if driver in ("webp", "avif"):
        assert features.check(driver)  # this box's Pillow decodes both
    pixels = _image(kind)
    path = tmp_path / f"im.{driver}"
    Image.fromarray(pixels).save(path)
    box = ((3, 4, 0), (35, 47, 1 if kind == "gray" else 3))
    got = assert_same(box, driver=driver, kvstore=f"file://{path}")
    whole = ts.open({"driver": driver, "kvstore": f"file://{path}"}
                    ).result().read().result()
    # webp and avif decode grayscale as three channels: the box keeps one
    assert np.array_equal(got, whole[3:35, 4:47, :box[1][2]])
    if driver in ("png", "bmp", "tiff"):  # lossless
        assert np.array_equal(got[..., 0] if kind == "gray" else got,
                              pixels[3:35, 4:47])
    assert np.array_equal(assert_same(box, driver="auto",
                                      kvstore=f"file://{path}"), got)


@pytest.mark.parametrize("driver", ["png", "tiff"])
def test_16_bit_images_raise_as_tensorstore(tmp_path, driver):
    path = tmp_path / f"im.{driver}"
    Image.fromarray(_image("gray").astype(np.uint16) * 200).save(path)
    ref, got = both(((0, 0, 0), (4, 4, 1)), driver=driver,
                    kvstore=f"file://{path}")
    assert isinstance(ref, NotImplementedError), ref
    assert isinstance(got, NotImplementedError), got


def test_an_image_over_http_and_in_a_zip(served, tmp_path):
    root, url = served
    Image.fromarray(_image("rgb")).save(root / "im.png")
    box = ((3, 4, 0), (35, 47, 3))
    want = assert_same(box, driver="png", kvstore=f"file://{root}/im.png")
    got = assert_same(box, driver="png", kvstore={
        "driver": "http", "base_url": url, "path": "im.png"})
    assert np.array_equal(got, want)
    with zipfile.ZipFile(tmp_path / "im.zip", "w") as zf:
        buffer = io.BytesIO()
        Image.fromarray(_image("rgb")).save(buffer, format="PNG")
        zf.writestr("d/im.png", buffer.getvalue())
    got = assert_same(box, driver="png", kvstore={
        "driver": "zip", "base": f"file://{tmp_path}/im.zip",
        "path": "d/im.png"})
    assert np.array_equal(got, want)


@pytest.mark.parametrize("driver", DRIVERS + ["zip"])
def test_the_auto_driver_is_the_jax_plugin(tmp_path, driver):
    if driver == "zip":
        box = _write("zarr", f"file://{tmp_path}/set/")
        kvstore = f"file://{_zip(tmp_path / 'set', tmp_path / 'set.zip')}"
    else:
        box = _write(driver, f"file://{tmp_path}/set/")
        kvstore = f"file://{tmp_path}/set/"
    got = assert_same(box, driver="auto", kvstore=kvstore)
    assert np.array_equal(got, _want(driver if driver != "zip" else "zarr"))


# ---------------------------------------------------------------------------
# what tensorstore refuses
# ---------------------------------------------------------------------------
REFUSED = {
    "cast": dict(driver="cast"),
    "downsample": dict(driver="downsample"),
    "unregistered-driver": dict(driver="jpeg_xl"),
    "http-shorthand": dict(kvstore="http://127.0.0.1:9/set/"),
    "zip-shorthand": dict(kvstore="zip://{root}/set.zip"),
    "memory-shorthand": dict(kvstore="memory://set/"),
    "memory-spec": dict(kvstore={"driver": "memory", "path": "set/"}),
    "unregistered-kvstore": dict(kvstore={"driver": "ftp", "path": "set/"}),
    "auto-on-an-ocdbt-root": dict(driver="auto", kvstore={
        "driver": "file", "path": "{root}/db/"}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_tensorstore_refuses_raises_its_class(tmp_path, case):
    _write("zarr", f"file://{tmp_path}/set/")
    _write("zarr", {"driver": "ocdbt", "base": f"file://{tmp_path}/db/",
                    "path": "inner/"})
    _zip(tmp_path / "set", tmp_path / "set.zip")
    args = dict(driver="zarr", kvstore=f"file://{tmp_path}/set/")
    for key, value in REFUSED[case].items():
        if isinstance(value, str):
            value = value.format(root=tmp_path)
        elif isinstance(value, dict):
            value = {k: v.format(root=tmp_path) for k, v in value.items()}
        args[key] = value
    ref, got = both(BOX, **args)
    assert isinstance(ref, ValueError), ref
    assert isinstance(got, ValueError), got
    assert "tensorstore refuses" in str(got)
