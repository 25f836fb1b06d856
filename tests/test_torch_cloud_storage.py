"""``gs://`` and ``s3://`` volumes: the port against the JAX package on
local fakes of the two object stores.

The JAX package reaches the same fakes through tensorstore:
``TENSORSTORE_GCS_HTTP_URL`` for ``gs://``, and for ``s3://`` a test-side
patch of ``chunkflow_tpu.volume.precomputed._kvstore_spec`` that adds the
fake's ``endpoint``, environment credentials and a region to the spec
(tensorstore's s3 driver honours no endpoint variable). The GCS fake
requires bearer tokens, which both packages fetch from its metadata
server (tensorstore's service-account flow posts to a fixed Google host,
which no test may reach); the S3 fake checks every SigV4 signature,
tensorstore's included.

Every volume is written by one package and read by the other, for
``raw``, ``jpeg`` and ``compressed_segmentation``, unsharded and sharded,
at two mips: the cutouts are bitwise, the objects byte for byte (the
bytes ``test_torch_encodings.py`` and ``test_torch_sharding.py`` hold on
local disk: tensorstore's), ``info`` bytes equal,
existence checks and strict cutouts agree. Then the cloud plane's own
behaviour: concurrent writers of one shard (threads and processes), the
ranged reads of a sharded chunk, retries through 503s and a dropped
connection, a 403 that raises at once.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("tensorstore")

from chunkflow_tpu.chunk.base import Chunk as JaxChunk  # noqa: E402
from chunkflow_tpu.core.bbox import BoundingBox as JaxBox  # noqa: E402
from chunkflow_tpu.volume import precomputed as jax_precomputed  # noqa: E402

from chunkflow_tpu_torch import BoundingBox, Chunk  # noqa: E402
from chunkflow_tpu_torch.cloud.http import HTTPError  # noqa: E402
from chunkflow_tpu_torch.core import telemetry  # noqa: E402
from chunkflow_tpu_torch.flow import cli  # noqa: E402
from chunkflow_tpu_torch.testing import cloud_fakes  # noqa: E402
from chunkflow_tpu_torch.volume import storage  # noqa: E402
from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume  # noqa: E402
from chunkflow_tpu_torch.volume.sharding import (  # noqa: E402
    ShardedChunks,
    ShardingSpec,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
KEY = str(ROOT / "tests" / "data" / "gcs_test_key.pem")
SIZE = (16, 64, 60)          # zyx at mip 0; ragged in x against the chunks
OFFSET = (5, 0, 6)
CHUNK = (8, 16, 16)
FACTOR = (1, 2, 2)
ENCODINGS = [("raw", "float32", 2, {}), ("jpeg", "uint8", 1, {}),
             ("compressed_segmentation", "uint64", 1,
              {"compressed_segmentation_block_size": [8, 8, 4]})]
SHARDING = {"@type": "neuroglancer_uint64_sharded_v1", "preshift_bits": 1,
            "hash": "murmurhash3_x86_128", "minishard_bits": 2,
            "shard_bits": 1, "minishard_index_encoding": "gzip",
            "data_encoding": "raw"}


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    """One GCS fake (bearer tokens from its metadata server required) and
    one S3 fake (SigV4 checked) for the module: tensorstore keeps the
    first credentials it finds for the life of the process."""
    home = tmp_path_factory.mktemp("home")
    gcs = cloud_fakes.FakeGCS(key=KEY).start()
    s3 = cloud_fakes.FakeS3(secrets={cloud_fakes.ACCESS_KEY:
                                     cloud_fakes.SECRET_KEY}).start()
    spec_of = jax_precomputed._kvstore_spec

    def spec_with_endpoint(path):
        spec = spec_of(path)
        if spec["driver"] == "s3":
            spec.update(endpoint=s3.url, aws_region="us-east-1",
                        aws_credentials={"type": "environment"})
        return spec

    with pytest.MonkeyPatch.context() as mp:
        env = cloud_fakes.cloud_env(gcs=gcs.url, s3=s3.url,
                                    metadata=gcs.url[len("http://"):])
        for key, value in env.items():
            mp.setenv(key, value)
        mp.setenv("HOME", str(home))
        mp.delenv("GOOGLE_APPLICATION_CREDENTIALS", raising=False)
        mp.delenv("CLOUDSDK_CONFIG", raising=False)
        mp.setenv("CHUNKFLOW_STORAGE_CACHE_MB", "0")
        mp.setattr(jax_precomputed, "_kvstore_spec", spec_with_endpoint)
        yield SimpleNamespace(gcs=gcs, s3=s3, env=env)
    gcs.stop()
    s3.stop()


@pytest.fixture(autouse=True)
def _fresh(cloud):
    storage.reset_shared_cache()
    yield


_COUNTER = iter(range(10 ** 6))


def _url(scheme: str, tag: str) -> str:
    return f"{scheme}://test-bucket/{tag}-{next(_COUNTER)}"


def _objects(cloud, url: str) -> dict:
    """name (relative to the volume root) -> bytes, of one volume."""
    scheme, bucket, prefix = storage.split_url(url)
    store = cloud.gcs if scheme == "gs" else cloud.s3
    prefix += "/"
    with store.lock:
        return {name[len(prefix):]: value[0]
                for (b, name), value in store.objects.items()
                if b == bucket and name.startswith(prefix)}


def _info(encoding, dtype, channels, extra, sharded) -> dict:
    scales, size, res, offset = [], SIZE, (40, 4, 4), OFFSET
    for mip in range(2):
        scale = {"key": f"s{mip}", "size": list(size[::-1]),
                 "resolution": list(res[::-1]),
                 "voxel_offset": list(offset[::-1]),
                 "chunk_sizes": [list(CHUNK[::-1])], "encoding": encoding}
        scale.update(extra)
        if sharded:
            scale["sharding"] = dict(SHARDING)
        scales.append(scale)
        size = tuple(-(-s // f) for s, f in zip(size, FACTOR))
        res = tuple(r * f for r, f in zip(res, FACTOR))
        offset = tuple(o // f for o, f in zip(offset, FACTOR))
    return {"type": "segmentation" if encoding == "compressed_segmentation"
            else "image", "data_type": dtype, "num_channels": channels,
            "scales": scales}


def _data(info, mip, seed):
    scale = info["scales"][mip]
    shape = tuple(scale["size"][::-1])
    channels = info["num_channels"]
    rng = np.random.default_rng(seed)
    high = 9 if info["data_type"] == "uint64" else 200
    arr = rng.integers(1, high, ((channels,) if channels > 1 else ())
                       + shape).astype(info["data_type"])
    if info["data_type"] == "uint64":
        arr += np.uint64(3 << 33)
    offset = tuple(scale["voxel_offset"][::-1])
    return arr, offset


def _box(arr, offset):
    return (offset, tuple(o + s for o, s in zip(offset, arr.shape[-3:])))


def _port_write(url, info):
    storage.open_kv(url).write_bytes("info", json.dumps(info).encode())
    vol = PrecomputedVolume(url)
    for mip in range(2):
        arr, offset = _data(info, mip, seed=mip)
        vol.save(Chunk(arr, voxel_offset=offset), mip=mip)


def _jax_write(url, info):
    storage.open_kv(url).write_bytes("info", json.dumps(info).encode())
    vol = jax_precomputed.PrecomputedVolume(url)
    for mip in range(2):
        arr, offset = _data(info, mip, seed=mip)
        vol.save(JaxChunk(arr, voxel_offset=offset), mip=mip)


def _port_read(url, mip, box, strict=False):
    storage.reset_shared_cache()
    return PrecomputedVolume(url).cutout(BoundingBox(*box), mip=mip,
                                         fill_missing=not strict).array


def _jax_read(url, mip, box, strict=False):
    return np.asarray(jax_precomputed.PrecomputedVolume(url).cutout(
        JaxBox(*box), mip=mip, fill_missing=not strict).array)


# ---------------------------------------------------------------------------
# each package reads the other's volumes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sharded", [False, True], ids=["unsharded",
                                                         "sharded"])
@pytest.mark.parametrize("encoding, dtype, channels, extra", ENCODINGS,
                         ids=[e[0] for e in ENCODINGS])
@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_each_package_reads_the_others_volume(cloud, scheme, encoding,
                                              dtype, channels, extra,
                                              sharded):
    info = _info(encoding, dtype, channels, extra, sharded)
    by_port, by_jax = _url(scheme, "port"), _url(scheme, "jax")
    _port_write(by_port, info)
    _jax_write(by_jax, info)
    for mip in range(2):
        arr, offset = _data(info, mip, seed=mip)
        box = _box(arr, offset)
        # each volume reads the same in both packages
        for url in (by_port, by_jax):
            port, jax = _port_read(url, mip, box), _jax_read(url, mip, box)
            assert port.dtype == jax.dtype and np.array_equal(port, jax)
            if encoding != "jpeg":  # lossy: the blocks' own decoding
                assert np.array_equal(port, arr)
    # the objects are tensorstore's byte for byte
    assert _objects(cloud, by_port) == _objects(cloud, by_jax)
    # existence and strict reads agree (a sharded scale: never all there,
    # in both packages: a kept quirk of the reference)
    arr, offset = _data(info, 0, seed=0)
    box = _box(arr, offset)
    for url in (by_port, by_jax):
        port_all = PrecomputedVolume(url).has_all_blocks(BoundingBox(*box))
        jax_all = jax_precomputed.PrecomputedVolume(url).has_all_blocks(
            JaxBox(*box))
        assert port_all == jax_all == (not sharded)
        if sharded:
            with pytest.raises(FileNotFoundError):
                _port_read(url, 0, box, strict=True)
            with pytest.raises(FileNotFoundError):
                _jax_read(url, 0, box, strict=True)
        else:
            assert np.array_equal(_port_read(url, 0, box, strict=True),
                                  _jax_read(url, 0, box, strict=True))


@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_a_missing_block_reads_as_zeros_and_fails_strict(cloud, scheme):
    info = _info("raw", "uint16", 1, {}, False)
    url = _url(scheme, "partial")
    storage.open_kv(url).write_bytes("info", json.dumps(info).encode())
    arr = np.full(CHUNK, 7, np.uint16)
    PrecomputedVolume(url).save(Chunk(arr, voxel_offset=OFFSET))
    box = (OFFSET, tuple(o + 2 * c for o, c in zip(OFFSET, CHUNK)))
    port, jax = _port_read(url, 0, box), _jax_read(url, 0, box)
    assert np.array_equal(port, jax) and int(port.sum()) == 7 * arr.size
    one = (OFFSET, tuple(o + c for o, c in zip(OFFSET, CHUNK)))
    for bbox, want in ((box, False), (one, True)):
        assert PrecomputedVolume(url).has_all_blocks(BoundingBox(*bbox)) \
            == jax_precomputed.PrecomputedVolume(url).has_all_blocks(
                JaxBox(*bbox)) == want
    with pytest.raises(FileNotFoundError):
        _port_read(url, 0, box, strict=True)
    with pytest.raises(FileNotFoundError):
        _jax_read(url, 0, box, strict=True)


@pytest.mark.parametrize("encoding", ["raw", "jpeg"])
@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_create_writes_the_jax_packages_info(cloud, scheme, encoding):
    kwargs = dict(volume_size=(16, 64, 64), voxel_size=(40, 4, 4),
                  voxel_offset=(2, 4, 8), num_channels=1, dtype="uint8",
                  block_size=(8, 32, 32), num_mips=3, encoding=encoding)
    by_port, by_jax = _url(scheme, "port"), _url(scheme, "jax")
    PrecomputedVolume.create(by_port, **kwargs)
    jax_precomputed.PrecomputedVolume.create(by_jax, **kwargs)
    assert _objects(cloud, by_port) == _objects(cloud, by_jax)
    assert list(_objects(cloud, by_port)) == ["info"]


def test_create_on_a_cloud_root_makes_no_directory(cloud, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    for scheme in ("gs", "s3"):
        PrecomputedVolume.create(_url(scheme, "nodir"), volume_size=(8, 16,
                                                                      16),
                                 voxel_size=(1, 1, 1))
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_upload_log_on_a_cloud_volume_writes_nothing(cloud, tmp_path,
                                                     monkeypatch, scheme):
    """``save-precomputed --upload-log`` keeps a local log only, as the
    JAX CLI does."""
    monkeypatch.chdir(tmp_path)
    url = _url(scheme, "log")
    PrecomputedVolume.create(url, volume_size=(8, 32, 32),
                             voxel_size=(1, 1, 1), block_size=(8, 16, 16))
    assert cli.main(["--device", "cpu", "create-chunk", "--size", "8", "32",
                     "32", "save-precomputed", "-v", url,
                     "--upload-log"]) == 0
    names = set(_objects(cloud, url))
    assert "info" in names and not any(n.startswith("log") for n in names)
    assert os.listdir(tmp_path) == []


def test_the_cloud_requests_were_authorized(cloud):
    """Every request of both packages carried a valid bearer token or
    SigV4 signature (tensorstore's included); both packages took tokens
    from the metadata server."""
    for fake in (cloud.gcs, cloud.s3):
        stats = fake.snapshot()
        assert stats["auth_refused"] == 0 and sum(stats["requests"]
                                                  .values()) > 0
    assert cloud.gcs.grants.get("metadata", 0) >= 1


# ---------------------------------------------------------------------------
# the cloud plane: ranged reads, races, faults
# ---------------------------------------------------------------------------
def _kv(scheme, tag):
    return storage.open_kv(_url(scheme, tag))


@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_a_sharded_chunk_is_read_by_three_ranges(cloud, scheme):
    kv = _kv(scheme, "ranges")
    chunks = ShardedChunks(kv, "s0", ShardingSpec(SHARDING))
    blobs = {cid: bytes([cid % 251]) * 5000 for cid in range(40)}
    chunks.write(blobs)
    fake = cloud.gcs if scheme == "gs" else cloud.s3
    fake.reset_stats()
    assert chunks.read(17) == blobs[17]
    stats = fake.snapshot()
    assert stats["requests"] == {"GET": 3}
    assert stats["status"] == {"206": 3}
    assert stats["bytes_out"] < 6000     # not the ~100 KB shard


def _race(chunks, first, count, errors):
    try:
        for cid in range(first, count, 2):
            chunks.write({cid: (b"%d:" % cid) * 40})
    except BaseException as exc:  # noqa: BLE001 - reported by the test
        errors.append(exc)


@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_two_threads_writing_one_shard_lose_no_chunk(cloud, scheme):
    spec = ShardingSpec(dict(SHARDING, shard_bits=0))   # one shard
    kv = _kv(scheme, "threads")
    fake = cloud.gcs if scheme == "gs" else cloud.s3
    fake.reset_stats()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    errors = []
    try:
        threads = [threading.Thread(target=_race, args=(
            ShardedChunks(kv, "s0", spec), first, 120, errors))
            for first in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    chunks = ShardedChunks(kv, "s0", spec)
    for cid in range(120):
        assert chunks.read(cid) == (b"%d:" % cid) * 40
    assert fake.snapshot()["status"].get("412", 0) > 0


_WRITER = """
import sys
from chunkflow_tpu_torch.volume import storage
from chunkflow_tpu_torch.volume.sharding import ShardedChunks, ShardingSpec
import json
chunks = ShardedChunks(storage.open_kv(sys.argv[1]), "s0",
                       ShardingSpec(json.loads(sys.argv[2])))
print("ready", flush=True)
sys.stdin.readline()             # both start together
for cid in range(int(sys.argv[3]), 120, 2):
    chunks.write({cid: (b"%d:" % cid) * 40})
"""


@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_two_processes_writing_one_shard_lose_no_chunk(cloud, scheme):
    spec = dict(SHARDING, shard_bits=0)
    url = _url(scheme, "procs")
    fake = cloud.gcs if scheme == "gs" else cloud.s3
    fake.reset_stats()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, url,
                               json.dumps(spec), str(first)], env=env,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              text=True) for first in (0, 1)]
    try:
        assert [p.stdout.readline() for p in procs] == ["ready\n"] * 2
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        assert [p.wait(timeout=120) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    chunks = ShardedChunks(storage.open_kv(url), "s0", ShardingSpec(spec))
    for cid in range(120):
        assert chunks.read(cid) == (b"%d:" % cid) * 40
    assert fake.snapshot()["status"].get("412", 0) > 0


@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_a_forced_race_is_retried(cloud, scheme):
    """The fake's forced 412 on one shard: the rewrite reads it again and
    writes once more; the port counts the conflict."""
    kv = _kv(scheme, "forced")
    chunks = ShardedChunks(kv, "s0", ShardingSpec(SHARDING))
    chunks.write({0: b"a" * 10})
    fake = cloud.gcs if scheme == "gs" else cloud.s3
    name = kv.prefix + "s0/" + ShardingSpec(SHARDING).shard_name(
        ShardingSpec(SHARDING).locate(2)[0])
    fake.configure({"race": [name]})
    telemetry.reset()
    chunks.write({2: b"b" * 10})
    assert fake.snapshot()["forced_412"] >= 1
    assert telemetry.snapshot()["counters"]["storage/shard_conflicts"] == 1
    assert chunks.read(2) == b"b" * 10


@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_faults_leave_the_results_unchanged(cloud, scheme):
    """5% seeded 503s and a dropped connection: a save and a cutout equal
    the fault-free ones."""
    info = _info("raw", "float32", 2, {}, True)
    clean, faulty = _url(scheme, "clean"), _url(scheme, "faulty")
    _port_write(clean, info)
    fake = cloud.gcs if scheme == "gs" else cloud.s3
    telemetry.reset()
    fake.configure({"fail_rate": 0.05, "seed": 5, "drop_next": 1,
                    "reset_stats": True})
    try:
        _port_write(faulty, info)
        got = [_port_read(faulty, mip, _box(*_data(info, mip, mip)))
               for mip in range(2)]
    finally:
        fake.configure({"fail_rate": 0.0, "drop_next": 0})
    stats = fake.snapshot()
    assert stats["faults_503"] > 0 and stats["dropped"] == 1
    counters = telemetry.snapshot()["counters"]
    assert counters["storage/http/retries"] >= stats["faults_503"] + 1
    for mip in range(2):
        assert np.array_equal(got[mip], _port_read(clean, mip, _box(
            *_data(info, mip, mip))))
    assert _objects(cloud, faulty) == _objects(cloud, clean)


@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_a_refused_request_raises_at_once(cloud, scheme, monkeypatch):
    """A 403 (S3, a wrong secret) or 401 (GCS, no token) raises with its
    status and body after one request."""
    fake = cloud.gcs if scheme == "gs" else cloud.s3
    if scheme == "s3":
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "not-the-secret")
    else:
        monkeypatch.setenv("GCE_METADATA_HOST", "127.0.0.1:9")
    fake.reset_stats()
    kv = _kv(scheme, "refused")
    with pytest.raises(HTTPError) as err:
        kv.read_bytes("info")
    assert err.value.status == (403 if scheme == "s3" else 401)
    assert err.value.body and str(err.value.status) in str(err.value)
    assert sum(fake.snapshot()["requests"].values()) == 1


@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_exists_many_is_one_listing(cloud, scheme):
    """One listing over the tight key range, paged by the fake (3 keys a
    page), never a value read."""
    kv = _kv(scheme, "exists")
    for i in range(10):
        kv.write_bytes(f"s0/{i:02d}", b"x")
    kv.write_bytes("s1/00", b"x")
    fake = cloud.gcs if scheme == "gs" else cloud.s3
    fake.reset_stats()
    got = kv.exists_many(["s0/02", "s0/05", "s0/07", "s0/99", "s0/06"])
    assert got == {"s0/02": True, "s0/05": True, "s0/07": True,
                   "s0/99": False, "s0/06": True}
    stats = fake.snapshot()
    assert set(stats["requests"]) == {"GET"} and stats["requests"]["GET"] >= 2
    assert stats["bytes_out"] < 5000


def test_setup_env_on_a_cloud_volume(cloud):
    """``setup-env --overwrite-info`` writes the JAX package's info and
    thumbnail info to a cloud root; without it, the port finds an existing
    cloud info through the KV plane, where the JAX package looks for a
    local file and raises (a fault of the reference, not followed)."""
    from chunkflow_tpu.flow import setup_env as jax_setup
    from chunkflow_tpu_torch.flow import setup_env as port_setup

    kwargs = dict(dry_run=False, volume_start=(0, 0, 0), volume_stop=None,
                  volume_size=(32, 256, 256), max_ram_size=15.0,
                  output_patch_size=(20, 128, 128), input_patch_size=None,
                  channel_num=1, dtype="uint8",
                  output_patch_overlap=(4, 32, 32), crop_chunk_margin=None,
                  mip=0, thumbnail_mip=2, max_mip=2, thumbnail=True,
                  encoding="raw", voxel_size=(40, 4, 4))
    urls = {}
    for tag, module in (("port", port_setup), ("jax", jax_setup)):
        urls[tag] = _url("gs", f"setup-{tag}")
        module.setup_environment(volume_path=urls[tag], overwrite_info=True,
                                 **kwargs)
    assert _objects(cloud, urls["port"]) == _objects(cloud, urls["jax"])
    assert set(_objects(cloud, urls["port"])) == {"info", "thumbnail/info"}
    plan = port_setup.setup_environment(volume_path=urls["jax"],
                                        overwrite_info=False, **kwargs)
    assert len(plan.bboxes) > 0
    with pytest.raises(FileNotFoundError, match="no existing info"):
        jax_setup.setup_environment(volume_path=urls["port"],
                                    overwrite_info=False, **kwargs)


@pytest.mark.parametrize("driver", ["zarr", "zarr3", "n5",
                                    "neuroglancer_precomputed",
                                    "zarr3-sharded"])
@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_load_tensorstore_on_buckets_is_the_jax_plugin(cloud, scheme,
                                                       driver):
    """A dataset tensorstore writes into a bucket (its default codecs:
    blosc for zarr and N5; ``zarr3-sharded``: shards of 8x16x16 with a
    crc32c index at their end, read by a suffix range and inner-chunk
    ranges): the port's ``load_tensorstore`` over ``scheme://`` and over
    tensorstore's kvstore spec equals the JAX plugin's cutout."""
    import tensorstore as ts

    from chunkflow_tpu.flow.plugin import load_plugin as jax_load_plugin
    from chunkflow_tpu_torch.flow.plugin import load_plugin

    url = _url(scheme, driver)
    kvstore = jax_precomputed._kvstore_spec(url)  # the fake's endpoint
    data = np.random.default_rng(5).integers(0, 4000, (16, 40, 48)).astype(
        np.uint16)
    spec = {"driver": driver, "kvstore": kvstore}
    if driver == "neuroglancer_precomputed":
        spec.update(multiscale_metadata={"type": "image",
                                         "data_type": "uint16",
                                         "num_channels": 1},
                    scale_metadata={"size": [48, 40, 16],
                                    "resolution": [4, 4, 40],
                                    "encoding": "raw",
                                    "chunk_size": [16, 16, 8]})
        store = ts.open(spec, create=True).result()
        store[...] = data.transpose(2, 1, 0)[..., None]
    elif driver == "zarr3-sharded":
        driver = spec["driver"] = "zarr3"
        spec["metadata"] = {
            "shape": list(data.shape), "data_type": "uint16",
            "chunk_grid": {"name": "regular", "configuration": {
                "chunk_shape": [8, 16, 16]}},
            "codecs": [{"name": "sharding_indexed", "configuration": {
                "chunk_shape": [4, 8, 8], "codecs": [{"name": "bytes"}],
                "index_codecs": [{"name": "bytes"}, {"name": "crc32c"}],
                "index_location": "end"}}]}
        store = ts.open(spec, create=True).result()
        store[...] = data
    else:
        store = ts.open(spec, create=True, dtype="uint16", shape=data.shape,
                        chunk_layout=ts.ChunkLayout(
                            write_chunk_shape=[8, 16, 16])).result()
        store[...] = data
    box = ((2, 3, 5), (14, 37, 45))
    if driver == "neuroglancer_precomputed":  # indexed x, y, z
        box = tuple(b[::-1] for b in box)
    ref = jax_load_plugin("load_tensorstore")(JaxBox(*box), driver=driver,
                                              kvstore=kvstore)
    for where in (url, kvstore):
        got = load_plugin("load_tensorstore")(BoundingBox(*box),
                                              driver=driver, kvstore=where)
        assert np.array_equal(got.array, np.asarray(ref.array))
    want = data[2:14, 3:37, 5:45]
    if driver == "neuroglancer_precomputed":
        want = want.transpose(2, 1, 0)[..., None]
    assert np.array_equal(got.array, want)


@pytest.mark.parametrize("scheme", ["gs", "s3"])
def test_load_tensorstore_shorthand_on_buckets_is_refused_by_the_jax_plugin(
        cloud, scheme):
    """A fault of the reference the port does not follow: the JAX plugin
    turns ``gs://bucket/store`` into a kvstore of the driver ``gs``, which
    tensorstore does not register, and ``s3://bucket/store`` into one
    without its bucket, and raises ``ValueError`` on both; the port reads
    both shorthands equal to the spec form."""
    import tensorstore as ts

    from chunkflow_tpu.flow.plugin import load_plugin as jax_load_plugin
    from chunkflow_tpu_torch.flow.plugin import load_plugin

    url = _url(scheme, "shorthand")
    kvstore = jax_precomputed._kvstore_spec(url)
    data = np.random.default_rng(6).integers(0, 200, (6, 20, 24)).astype(
        np.uint8)
    ts.open({"driver": "zarr", "kvstore": kvstore}, create=True,
            dtype="uint8", shape=data.shape).result()[...] = data
    box = ((1, 2, 3), (5, 18, 20))
    with pytest.raises(ValueError):
        jax_load_plugin("load_tensorstore")(JaxBox(*box), kvstore=url)
    ref = jax_load_plugin("load_tensorstore")(JaxBox(*box), kvstore=kvstore)
    got = load_plugin("load_tensorstore")(BoundingBox(*box), kvstore=url)
    assert np.array_equal(got.array, np.asarray(ref.array))
    assert np.array_equal(got.array, data[1:5, 2:18, 3:20])
