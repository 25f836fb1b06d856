"""The precomputed block codecs on the CPU, against tensorstore and the JAX
package.

tensorstore is the JAX package's codec; here it writes and reads the same
small volumes (16x64x64, blocks of 8 to 32 voxels a side) as the port:

* ``jpeg``: the port's block files are tensorstore's byte for byte (1 and
  3 channels), and each package decodes the other's files as it decodes
  its own;
* ``png``: tensorstore's files (every row filter) decode bitwise, and the
  port's files (no row filter, another zlib stream) read in tensorstore
  bitwise;
* ``compressed_segmentation``: the block payloads byte for byte, edge
  blocks and several channels included; the host C++ is its numpy plain
  version at every bit width;
* the JAX package and the port agree case by case, ``create`` then
  ``save`` then ``cutout``, with the block cache on and off: the same
  arrays, or the same exception type at the same call;
* the three behaviours of the JAX package that the port keeps, each under
  a test named for it;
* the CLI (``create-info -e``, ``setup-env --encoding``, ``load-precomputed
  | save-precomputed``) and a volume-reference request to the server,
  through both packages.

``tests/data/jpeg_blocks.npz`` holds two seeded blocks, tensorstore's
jpeg files of them and its readings of those files; ``chip_smoke.py``
encodes and decodes them with the card machine's Pillow and prints
whether it gives the same bytes and arrays.
``python -m tests.test_torch_encodings`` rewrites it.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

ts = pytest.importorskip("tensorstore")

from click.testing import CliRunner

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
from chunkflow_tpu.flow.cli import main as jax_main
from chunkflow_tpu.volume import storage as jax_storage
from chunkflow_tpu.volume.precomputed import PrecomputedVolume as JaxVolume
from chunkflow_tpu_torch import BoundingBox, Chunk, native
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.volume import codecs, storage
from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = Path(__file__).resolve().parent / "data" / "jpeg_blocks.npz"
SIZE = (16, 64, 64)
BLOCK = (8, 32, 32)
OFFSET = (0, 0, 0)
FULL = BoundingBox(OFFSET, SIZE)
SHARDING = {"@type": "neuroglancer_uint64_sharded_v1", "preshift_bits": 1,
            "hash": "murmurhash3_x86_128", "minishard_bits": 1,
            "shard_bits": 1, "minishard_index_encoding": "gzip",
            "data_encoding": "gzip"}
RAW_SHARDING = dict(SHARDING, minishard_index_encoding="raw",
                    data_encoding="raw")


@pytest.fixture(autouse=True)
def fresh_caches(monkeypatch):
    for var in ("CHUNKFLOW_STORAGE", "CHUNKFLOW_STORAGE_CACHE_MB",
                "CHUNKFLOW_STORAGE_CONCURRENCY"):
        monkeypatch.delenv(var, raising=False)
    storage.reset_shared_cache()
    jax_storage.reset_shared_cache()
    yield
    storage.reset_shared_cache()
    jax_storage.reset_shared_cache()


def _data(dtype, channels, shape=SIZE, seed=0, high=None):
    rng = np.random.default_rng(seed)
    shape = ((channels,) if channels > 1 else ()) + tuple(shape)
    if np.dtype(dtype).kind == "f":
        return rng.random(shape, dtype=np.float32)
    if high is None:
        high = min(np.iinfo(dtype).max, 1 << 40)
    return rng.integers(0, high, shape).astype(dtype)


def _write_info(path, encoding, dtype, channels, size=SIZE, block=BLOCK,
                **scale):
    """An info file of one scale (xyz), as a user or tensorstore writes."""
    os.makedirs(path, exist_ok=True)
    info = {"type": "segmentation" if encoding == "compressed_segmentation"
            else "image", "data_type": dtype, "num_channels": channels,
            "scales": [dict({"key": "s", "size": list(size[::-1]),
                             "resolution": [4, 4, 40],
                             "voxel_offset": [0, 0, 0],
                             "chunk_sizes": [list(block[::-1])],
                             "encoding": encoding}, **scale)]}
    with open(os.path.join(path, "info"), "w") as f:
        json.dump(info, f)


def _ts(path, mip=0):
    return ts.open({"driver": "neuroglancer_precomputed",
                    "kvstore": {"driver": "file", "path": str(path)},
                    "scale_index": mip}).result()


def _ts_write(path, czyx):
    arr = czyx if czyx.ndim == 4 else czyx[None]
    _ts(path).write(np.transpose(arr, (3, 2, 1, 0))).result()


def _ts_read(path, mip=0):
    arr = np.transpose(_ts(path, mip).read().result(), (3, 2, 1, 0))
    return arr[0] if arr.shape[0] == 1 else arr


def _port_read(path, mip=0):
    storage.reset_shared_cache()
    vol = PrecomputedVolume(str(path))
    return vol.cutout(vol.bounds(mip), mip=mip).array


def _block_files(path):
    scale = os.path.join(path, "s")
    return {n: open(os.path.join(scale, n), "rb").read()
            for n in sorted(os.listdir(scale)) if not n.endswith(".lock")}


# ---------------------------------------------------------------------------
# jpeg
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("quality", [None, 90])
def test_jpeg_blocks_are_tensorstores_byte_for_byte(tmp_path, channels,
                                                    quality):
    scale = {} if quality is None else {"jpeg_quality": quality}
    data = _data("uint8", channels)
    for tag in ("ts", "port"):
        _write_info(tmp_path / tag, "jpeg", "uint8", channels, **scale)
    _ts_write(tmp_path / "ts", data)
    PrecomputedVolume(str(tmp_path / "port")).save(Chunk(data))
    assert _block_files(tmp_path / "port") == _block_files(tmp_path / "ts")
    assert np.array_equal(_port_read(tmp_path / "ts"),
                          _ts_read(tmp_path / "ts"))
    # the loss is real, and the same in both
    assert np.abs(_ts_read(tmp_path / "ts").astype(int) - data).max() > 0


def _jpeg_fixture_blocks():
    rng = np.random.default_rng(17)
    gray = rng.integers(0, 256, (1, 8, 32, 32), dtype=np.uint8)
    rgb = rng.integers(0, 256, (3, 8, 32, 32), dtype=np.uint8)
    return gray, rgb


def _tensorstore_jpeg(tmp, block):
    """tensorstore's jpeg file of one block, and its reading of it."""
    _write_info(tmp, "jpeg", "uint8", block.shape[0], size=block.shape[1:],
                block=block.shape[1:])
    _ts_write(tmp, block)
    (data,) = _block_files(tmp).values()
    decoded = _ts_read(tmp)
    return data, decoded if decoded.ndim == 4 else decoded[None]


def test_jpeg_fixture_is_tensorstores_and_the_ports(tmp_path):
    """The committed blocks ``chip_smoke.py`` holds the card machine's
    Pillow to: tensorstore's files and readings here, and the port's."""
    fixture = np.load(FIXTURE)
    for name, block in zip(("gray", "rgb"), _jpeg_fixture_blocks()):
        assert np.array_equal(fixture[name], block)
        stored = fixture[f"{name}_jpeg"].tobytes()
        data, decoded = _tensorstore_jpeg(tmp_path / name, block)
        assert data == stored
        assert np.array_equal(fixture[f"{name}_decoded"], decoded)
        assert codecs.JpegCodec().encode(block) == stored
        assert np.array_equal(
            codecs.JpegCodec().decode(stored, block.shape), decoded)


def write_jpeg_fixture(tmp):
    gray, rgb = _jpeg_fixture_blocks()
    arrays = {"gray": gray, "rgb": rgb}
    for name, block in list(arrays.items()):
        data, decoded = _tensorstore_jpeg(Path(tmp) / name, block)
        arrays[f"{name}_jpeg"] = np.frombuffer(data, dtype=np.uint8)
        arrays[f"{name}_decoded"] = decoded
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)


# ---------------------------------------------------------------------------
# png
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reads_bitwise_both_ways(tmp_path, dtype, channels):
    data = _data(dtype, channels, high=200 if dtype == "uint8" else 60000)
    for tag in ("ts", "port"):
        _write_info(tmp_path / tag, "png", dtype, channels)
    _ts_write(tmp_path / "ts", data)
    PrecomputedVolume(str(tmp_path / "port")).save(Chunk(data))
    for tag in ("ts", "port"):
        assert np.array_equal(_port_read(tmp_path / tag), data)
        assert np.array_equal(_ts_read(tmp_path / tag), data)
    # tensorstore's files use the row filters that predict from the
    # previous pixel and row (Average, Paeth); the port's none
    filters = set()
    for blob in _block_files(tmp_path / "ts").values():
        filters |= _png_filters(blob)
    assert filters & {3, 4}
    for blob in _block_files(tmp_path / "port").values():
        assert _png_filters(blob) == {0}


def _png_filters(blob):
    import struct
    import zlib

    pos, idat, header = 8, b"", None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", blob[pos + 8:pos + 21])
        if kind == b"IDAT":
            idat += blob[pos + 8:pos + 8 + n]
        pos += 12 + n
    width, height, depth, colour = header[:4]
    stride = width * {0: 1, 4: 2, 2: 3, 6: 4}[colour] * depth // 8
    raw = zlib.decompress(idat)
    return {raw[r * (stride + 1)] for r in range(height)}


@pytest.mark.parametrize("bpp", [1, 2, 3, 8])
def test_png_unfilter_is_its_plain_version(bpp):
    rng = np.random.default_rng(bpp)
    rows, stride = 12, 5 * bpp
    filtered = rng.integers(0, 256, (rows, stride + 1), dtype=np.uint8)
    filtered[:, 0] = np.arange(rows) % 5  # every filter, twice and more
    assert np.array_equal(
        native.png_unfilter(filtered.reshape(-1), rows, stride, bpp),
        codecs.png_unfilter_plain(filtered.reshape(-1), rows, stride, bpp))
    filtered[3, 0] = 5
    for fn in (native.png_unfilter, codecs.png_unfilter_plain):
        with pytest.raises(ValueError, match="row 3"):
            fn(filtered.reshape(-1), rows, stride, bpp)


# ---------------------------------------------------------------------------
# compressed_segmentation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["uint32", "uint64"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("size, block", [
    (SIZE, BLOCK),
    ((13, 50, 45), (8, 16, 32)),   # edge blocks clipped to the volume
])
def test_compressed_segmentation_is_tensorstores_byte_for_byte(
        tmp_path, dtype, channels, size, block):
    data = _data(dtype, channels, shape=size, high=9)
    if dtype == "uint64":
        data = data + np.uint64(3 << 33)
    data[..., :4, :8, :8] = 5    # single-valued blocks: 0 bits
    cseg = {"compressed_segmentation_block_size": [8, 4, 2]}
    for tag in ("ts", "port"):
        _write_info(tmp_path / tag, "compressed_segmentation", dtype,
                    channels, size=size, block=block, **cseg)
    _ts_write(tmp_path / "ts", data)
    vol = PrecomputedVolume(str(tmp_path / "port"))
    vol.save(Chunk(data))
    assert _block_files(tmp_path / "port") == _block_files(tmp_path / "ts")
    storage.reset_shared_cache()
    assert np.array_equal(vol.cutout(BoundingBox((0, 0, 0), size)).array,
                          _ts_read(tmp_path / "ts"))


# the numbers of distinct labels that give each bit width
BIT_WIDTHS = {0: 1, 1: 2, 2: 3, 4: 9, 8: 200, 16: 3000, 32: 70000}


@pytest.mark.parametrize("dtype", ["uint32", "uint64"])
@pytest.mark.parametrize("bits", sorted(BIT_WIDTHS))
def test_host_codec_is_its_plain_version(dtype, bits):
    """Every bit width, ids above 2^32 (uint64), edge blocks and two
    channels; a 32-bit block needs more than 65536 labels in one block."""
    block = {32: (16, 64, 128), 16: (8, 16, 32)}.get(bits, (4, 8, 8))
    shape = (2, 2 * block[0] - 3, 2 * block[1] - 5, 2 * block[2] - 1)
    rng = np.random.default_rng(bits)
    labels = rng.integers(0, BIT_WIDTHS[bits], shape).astype(dtype)
    # the first block holds every label: its width is the one under test
    first = labels[:, :block[0], :block[1], :block[2]].reshape(2, -1)
    first[:, :BIT_WIDTHS[bits]] = np.arange(BIT_WIDTHS[bits])
    labels[:, :block[0], :block[1], :block[2]] = first.reshape(
        2, *block)
    if dtype == "uint64":
        labels = labels * np.uint64(1 << 33) + np.uint64(7)
    data = native.compressed_segmentation_encode(labels, block)
    assert data == codecs.encode_compressed_segmentation_plain(labels,
                                                               block)
    header = np.frombuffer(data, "<u4")
    assert int(header[header[0]]) >> 24 == bits
    for decode in (native.compressed_segmentation_decode,
                   codecs.decode_compressed_segmentation_plain):
        assert np.array_equal(decode(data, labels.shape, dtype, block),
                              labels)


def test_a_corrupt_encoded_block_raises(tmp_path):
    for name, encoding, dtype, extra in (
            ("j", "jpeg", "uint8", {}),
            ("p", "png", "uint16", {}),
            ("c", "compressed_segmentation", "uint32",
             {"compressed_segmentation_block_size": [8, 8, 8]})):
        _write_info(tmp_path / name, encoding, dtype, 1, **extra)
        PrecomputedVolume(str(tmp_path / name)).save(
            Chunk(_data(dtype, 1, high=50)))
        path = tmp_path / name / "s" / "0-32_0-32_0-8"
        path.write_bytes(path.read_bytes()[:40])
        for fill in (True, False):
            with pytest.raises(storage.CorruptBlockError,
                               match="corrupt block"):
                _port_read(tmp_path / name)


# ---------------------------------------------------------------------------
# the JAX package and the port, case by case
# ---------------------------------------------------------------------------
CSEG = {"compressed_segmentation_block_size": [8, 8, 4]}
MATRIX = [
    # (encoding, dtype, channels, scale entries written into the info)
    ("raw", "uint8", 1, {}),
    ("raw", "float32", 3, {}),
    ("jpeg", "uint8", 1, {}),
    ("jpeg", "uint8", 3, {}),
    ("png", "uint8", 2, {}),
    ("png", "uint16", 1, {}),
    ("png", "uint16", 4, {}),
    ("compressed_segmentation", "uint32", 1, CSEG),
    ("compressed_segmentation", "uint64", 2, CSEG),
    ("compressed_segmentation", "uint64", 1, {}),   # no block size
    ("jpeg", "float32", 1, {}),
    ("jpeg", "uint8", 2, {}),
    ("png", "float32", 1, {}),
    ("compressed_segmentation", "uint8", 1, CSEG),
    ("raw", "float32", 1, {"sharding": SHARDING}),
    ("jpeg", "uint8", 1, {"sharding": SHARDING}),
    ("png", "uint16", 3, {"sharding": SHARDING}),
    ("compressed_segmentation", "uint64", 1, dict(CSEG, sharding=SHARDING)),
]


def _through(package, path, encoding, dtype, channels, extra, data):
    """create, then the scale entries into the info, save, cutout: the
    cutout, or (exception type, the call that raised)."""
    cls, chunk, box = ((JaxVolume, JaxChunk, JaxBox) if package == "jax"
                       else (PrecomputedVolume, Chunk, BoundingBox))
    vol = cls.create(str(path), volume_size=SIZE, voxel_size=(40, 4, 4),
                     num_channels=channels, dtype=dtype, block_size=BLOCK,
                     encoding=encoding)
    if extra:
        info = json.loads((path / "info").read_text())
        info["scales"][0].update(extra)
        (path / "info").write_text(json.dumps(info))
        vol = cls(str(path))
    try:
        vol.save(chunk(data))
    except Exception as exc:  # noqa: BLE001 - the type is compared
        return type(exc), "save"
    try:
        return np.asarray(vol.cutout(box(OFFSET, SIZE)).array)
    except Exception as exc:  # noqa: BLE001
        return type(exc), "cutout"


@pytest.mark.parametrize("cache_mb", ["0", "256"])
@pytest.mark.parametrize("encoding, dtype, channels, extra", MATRIX,
                         ids=lambda v: v if isinstance(v, (str, int))
                         else "+".join(sorted(v)) or "-")
def test_the_jax_package_and_the_port_agree(tmp_path, monkeypatch, cache_mb,
                                            encoding, dtype, channels,
                                            extra):
    monkeypatch.setenv("CHUNKFLOW_STORAGE_CACHE_MB", cache_mb)
    data = _data(dtype, channels, high=200 if dtype == "uint8" else 1000)
    got = {pkg: _through(pkg, tmp_path / pkg, encoding, dtype, channels,
                         extra, data) for pkg in ("jax", "port")}
    if isinstance(got["jax"], tuple):
        assert got["port"] == got["jax"]
        assert got["jax"][0] is ValueError
    else:
        assert isinstance(got["port"], np.ndarray)
        assert got["port"].dtype == got["jax"].dtype
        assert np.array_equal(got["port"], got["jax"])


@pytest.mark.parametrize("encoding, dtype, channels", [
    ("jpeg", "uint8", 1), ("png", "uint16", 2),
    ("compressed_segmentation", "uint64", 1)])
def test_create_writes_the_jax_packages_info(tmp_path, encoding, dtype,
                                             channels):
    kwargs = dict(volume_size=SIZE, voxel_size=(40, 4, 4), num_channels=channels,
                  dtype=dtype, block_size=BLOCK, encoding=encoding,
                  num_mips=2, voxel_offset=(1, 2, 3))
    JaxVolume.create(str(tmp_path / "jax"), **kwargs)
    PrecomputedVolume.create(str(tmp_path / "port"), **kwargs)
    assert ((tmp_path / "port" / "info").read_bytes()
            == (tmp_path / "jax" / "info").read_bytes())
    # the port's own arguments add only their entries
    PrecomputedVolume.create(str(tmp_path / "more"), sharding=SHARDING,
                             compressed_segmentation_block_size=(4, 8, 8),
                             **kwargs)
    more = json.loads((tmp_path / "more" / "info").read_text())
    for scale in more["scales"]:
        assert scale.pop("sharding") == SHARDING
        assert scale.pop("compressed_segmentation_block_size") == [8, 8, 4]
    assert more == json.loads((tmp_path / "jax" / "info").read_text())


# ---------------------------------------------------------------------------
# the JAX package's behaviours that the port keeps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cache_mb", ["0", "256"])
def test_quirk_write_through_cache_hides_the_jpeg_loss(tmp_path, monkeypatch,
                                                       cache_mb):
    """The block cache sits above the codec: with it on, a cutout after a
    save in the same process returns the array saved, not its jpeg
    decoding; with it off, the decoding."""
    monkeypatch.setenv("CHUNKFLOW_STORAGE_CACHE_MB", cache_mb)
    data = _data("uint8", 1)
    got = {pkg: _through(pkg, tmp_path / pkg, "jpeg", "uint8", 1, {}, data)
           for pkg in ("jax", "port")}
    assert np.array_equal(got["port"], got["jax"])
    loss = np.abs(got["port"].astype(int) - data).max()
    assert (loss == 0) == (cache_mb == "256")
    assert np.array_equal(_port_read(tmp_path / "port"),
                          _ts_read(tmp_path / "jax"))


def test_quirk_create_compressed_segmentation_writes_no_block_size(tmp_path):
    """The info ``create`` writes has no
    ``compressed_segmentation_block_size``, which tensorstore needs: the
    first save and the first cutout raise ValueError, in both."""
    for pkg, cls, chunk, box in (("jax", JaxVolume, JaxChunk, JaxBox),
                                 ("port", PrecomputedVolume, Chunk,
                                  BoundingBox)):
        vol = cls.create(str(tmp_path / pkg), volume_size=SIZE,
                         voxel_size=(40, 4, 4), dtype="uint64",
                         block_size=BLOCK, layer_type="segmentation",
                         encoding="compressed_segmentation")
        scale = vol.info["scales"][0]
        assert "compressed_segmentation_block_size" not in scale
        with pytest.raises(ValueError):
            vol.save(chunk(_data("uint64", 1)))
        with pytest.raises(ValueError):
            cls(str(tmp_path / pkg)).cutout(box(OFFSET, SIZE))
    assert ((tmp_path / "port" / "info").read_bytes()
            == (tmp_path / "jax" / "info").read_bytes())


def test_quirk_has_all_blocks_is_false_on_a_sharded_scale(tmp_path):
    """On a sharded scale, ``has_all_blocks`` looks for unsharded block
    files: False with every chunk in its shard, so a strict cutout raises
    FileNotFoundError in both packages; a filling one reads the data."""
    data = _data("uint64", 1, high=30)
    _write_info(tmp_path, "compressed_segmentation", "uint64", 1,
                sharding=SHARDING, **CSEG)
    _ts_write(tmp_path, data)
    for cls, box in ((JaxVolume, JaxBox), (PrecomputedVolume, BoundingBox)):
        vol = cls(str(tmp_path))
        assert not vol.has_all_blocks(box(OFFSET, SIZE))
        with pytest.raises(FileNotFoundError):
            vol.cutout(box(OFFSET, SIZE), fill_missing=False)
        assert np.array_equal(
            np.asarray(vol.cutout(box(OFFSET, SIZE)).array), data)


# ---------------------------------------------------------------------------
# the CLI and the server
# ---------------------------------------------------------------------------
def _port(args):
    assert cli.main(["--device", "cpu", *args]) == 0


def _jax(args):
    result = CliRunner().invoke(jax_main, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output


@pytest.mark.parametrize("encoding, dtype", [
    ("jpeg", "uint8"), ("png", "uint16"),
    ("compressed_segmentation", "uint32")])
def test_create_info_encoding_through_both_clis(tmp_path, encoding, dtype):
    for tag, runner in (("jax", _jax), ("port", _port)):
        runner(["create-info", "-v", str(tmp_path / tag), "-s", "16", "64",
                "64", "--dtype", dtype, "-e", encoding, "--max-mip", "1"])
    assert ((tmp_path / "port" / "info").read_bytes()
            == (tmp_path / "jax" / "info").read_bytes())


def test_setup_env_encoding_through_both_clis(tmp_path):
    """The output volume takes the encoding; the thumbnail stays raw."""
    for tag, runner in (("jax", _jax), ("port", _port)):
        runner(["setup-env", "--volume-start", "0", "0", "0",
                "--volume-size", "32", "256", "256", "-l",
                str(tmp_path / tag), "-z", "20", "128", "128",
                "--output-patch-overlap", "4", "32", "32", "--channel-num",
                "1", "--dtype", "uint8", "--encoding", "jpeg",
                "--max-mip", "2", "--thumbnail-mip", "2", "--overwrite-info"])
        info = json.loads((tmp_path / tag / "info").read_text())
        assert {s["encoding"] for s in info["scales"]} == {"jpeg"}
        thumb = json.loads((tmp_path / tag / "thumbnail" / "info")
                           .read_text())
        assert {s["encoding"] for s in thumb["scales"]} == {"raw"}
    for sub in ("info", "thumbnail/info"):
        assert ((tmp_path / "port" / sub).read_bytes()
                == (tmp_path / "jax" / sub).read_bytes())


def test_load_and_save_precomputed_through_both_clis(tmp_path):
    """One jpeg image volume read by both CLIs and written into a png
    volume of three mips (``--create-thumbnail``) and a sharded
    compressed_segmentation volume (``raw`` data and index): the same
    arrays at every mip, and the same shard files."""
    image = tmp_path / "image"
    _write_info(image, "jpeg", "uint8", 1)
    _ts_write(image, _data("uint8", 1))
    box = ["--chunk-start", "0", "0", "0", "--chunk-size", *map(str, SIZE)]
    for tag, runner in (("jax", _jax), ("port", _port)):
        png, seg = tmp_path / f"png-{tag}", tmp_path / f"seg-{tag}"
        runner(["create-info", "-v", str(png), "-s", *map(str, SIZE),
                "-e", "png", "--block-size", *map(str, BLOCK),
                "--max-mip", "2"])
        _write_info(seg, "compressed_segmentation", "uint32", 1,
                    sharding=RAW_SHARDING, **CSEG)
        runner(["load-precomputed", "-v", str(image), *box,
                "save-precomputed", "-v", str(png), "--create-thumbnail"])
        runner(["load-precomputed", "-v", str(image), *box,
                "save-precomputed", "-v", str(seg)])
    for kind, mips in (("png", 3), ("seg", 1)):
        port, jax = tmp_path / f"{kind}-port", tmp_path / f"{kind}-jax"
        for mip in range(mips):
            want = _ts_read(jax, mip)
            assert want.any()
            assert np.array_equal(_port_read(port, mip), want)
            assert np.array_equal(_ts_read(port, mip), want)
    assert _block_files(tmp_path / "seg-port") == _block_files(
        tmp_path / "seg-jax")


def test_volume_reference_request_on_a_jpeg_volume(tmp_path):
    """The server reads a jpeg volume's blocks as the JAX server reads
    them: the decoded response is bitwise the JAX package's."""
    import base64

    from chunkflow_tpu.inference import Inferencer as JaxInferencer
    from chunkflow_tpu.serve.frontend import LocalBackend as JaxBackend
    from chunkflow_tpu.serve.frontend import ServingService as JaxService
    from chunkflow_tpu_torch.inference.inferencer import Inferencer
    from chunkflow_tpu_torch.serve import LocalBackend, ServingService

    path = tmp_path / "image"
    _write_info(path, "jpeg", "uint8", 1)
    _ts_write(path, _data("uint8", 1))
    kwargs = dict(input_patch_size=(4, 16, 16),
                  output_patch_overlap=(2, 8, 8), num_output_channels=3,
                  framework="identity", batch_size=4,
                  crop_output_margin=False)
    port = LocalBackend(Inferencer(device="cpu", **kwargs), workers=1)
    jax_ = JaxBackend(JaxInferencer(**kwargs), workers=1)
    body = json.dumps({"volume_path": str(path), "bbox_start": [4, 8, 16],
                       "bbox_size": [8, 32, 32]}).encode()
    try:
        answers = [ServingService(port).handle("POST", "/infer", body),
                   JaxService(jax_).handle("POST", "/infer", body)]
    finally:
        port.close()
        jax_.close()
    (s1, p1), (s2, p2) = answers
    assert s1 == s2 == 200, (p1, p2)
    arrays = [np.frombuffer(base64.b64decode(p["data_b64"]),
                            dtype=p["dtype"]).reshape(p["shape"])
              for p in (p1, p2)]
    assert np.array_equal(*arrays)


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        write_jpeg_fixture(tmp)
    print(f"wrote {FIXTURE}")
