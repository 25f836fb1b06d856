"""The port's cross-request PatchPacker against per-chunk inference.

The cases of ``tests/serve/test_packer.py`` (but its lint gate) and the
packer cases of ``tests/inference/test_precision.py``, on the CPU, where
the kernels run their plain versions: packed results are bitwise the
port's ``Inferencer.__call__`` on ragged mixed-size traffic, under
concurrent submitters, with bucketing, crop margins and uint8 output,
at float32, bf16 and int8 (fake, real); and, on the identity engine,
bitwise the JAX package's per-chunk results. The kill switch, fold,
deadlines, teardown and the bounded queue behave as in the JAX package.
The JAX package's program-cache checks become call counts: one gather
per request's share of a batch, one forward per batch, and the
pre-weighted accumulation replaying each request's stack.
"""
import threading
import time

import numpy as np
import pytest
import torch

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.inference.inferencer import Inferencer as JaxInferencer
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.inference import precision
from chunkflow_tpu_torch.inference.inferencer import Inferencer
from chunkflow_tpu_torch.ops import accumulate, gather
from chunkflow_tpu_torch.serve import packer as packer_mod
from chunkflow_tpu_torch.serve.packer import (
    PackerClosed,
    PatchPacker,
    RequestExpired,
    serve_enabled,
)

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

PIN = (4, 16, 16)

#: exact patch size, mid-size, and shapes that snap their last patch
#: flush against the boundary
RAGGED_SHAPES = [(8, 32, 32), (6, 20, 28), (4, 16, 16), (9, 33, 35),
                 (5, 17, 30)]


@pytest.fixture
def clean(monkeypatch):
    for var in ("CHUNKFLOW_TELEMETRY", "CHUNKFLOW_SERVE",
                "CHUNKFLOW_PRECISION", "CHUNKFLOW_INT8"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(precision, "_INT8_WARNED", set())
    telemetry.reset()
    yield monkeypatch
    telemetry.reset()


def _kwargs(**kwargs):
    defaults = dict(input_patch_size=PIN, output_patch_overlap=(2, 8, 8),
                    num_output_channels=3, framework="identity",
                    batch_size=4, crop_output_margin=False)
    defaults.update(kwargs)
    return defaults


def make_inferencer(**kwargs):
    return Inferencer(device="cpu", **_kwargs(**kwargs))


def _host(chunk):
    return chunk.host().array


def _parity_check(inferencer, chunks, max_wait_ms=1.0):
    """Per-chunk references, then the same chunks through the packer
    concurrently: bitwise equal."""
    refs = [_host(inferencer(c)) for c in chunks]
    packer = PatchPacker(inferencer, max_wait_ms=max_wait_ms)
    try:
        handles = [packer.submit(c) for c in chunks]
        outs = [h.result(timeout=60) for h in handles]
    finally:
        packer.close()
    for chunk, ref, out in zip(chunks, refs, outs):
        got = _host(out)
        assert got.dtype == ref.dtype, chunk.shape
        assert np.array_equal(got, ref), (
            f"chunk {tuple(chunk.shape)}: packed output diverged (max |d| "
            f"{np.abs(got.astype(np.float64) - ref.astype(np.float64)).max()})")
    return refs, outs


def _ragged(seed, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype) == np.uint8:
        return [Chunk((rng.random(s) * 255).astype(np.uint8),
                      voxel_offset=(64 * i, 0, 0))
                for i, s in enumerate(shapes)]
    return [Chunk(rng.random(s).astype(dtype), voxel_offset=(64 * i, 0, 0))
            for i, s in enumerate(shapes)]


def test_packed_bit_identical_ragged_float32(clean):
    inferencer = make_inferencer()
    chunks = _ragged(7, RAGGED_SHAPES)
    refs, _ = _parity_check(inferencer, chunks)
    # and the JAX package's per-chunk path, bitwise (identity engine)
    jax_inf = JaxInferencer(**_kwargs())
    for chunk, ref in zip(chunks, refs):
        jax_ref = np.asarray(jax_inf(JaxChunk(chunk.array)).array)
        assert np.array_equal(ref, jax_ref)


def test_packed_bit_identical_uint8_and_bucket_boundaries(clean,
                                                          monkeypatch):
    """uint8 input and output, shape bucketing on and one voxel past the
    bucket boundary; one gather per request's share of each batch."""
    inferencer = make_inferencer(
        output_patch_size=(2, 8, 8), output_patch_overlap=(1, 2, 2),
        num_output_channels=2, output_dtype="uint8",
        shape_bucket=(4, 16, 16))
    chunks = _ragged(3, [(8, 32, 32), (7, 31, 30), (4, 16, 16),
                         (5, 17, 16)], np.uint8)
    refs = [_host(inferencer(c)) for c in chunks]
    shares = []
    plain = gather.gather_patches

    def counted(chunk, starts, pin):
        shares.append(len(starts))
        return plain(chunk, starts, pin)

    monkeypatch.setattr(packer_mod.gather, "gather_patches", counted)
    packer = PatchPacker(inferencer, max_wait_ms=1.0)
    outs = [packer.submit(c).result(timeout=60) for c in chunks]
    packer.close()
    for ref, out in zip(refs, outs):
        assert ref.dtype == np.uint8 and np.array_equal(_host(out), ref)
    snap = telemetry.snapshot()["counters"]
    assert sum(shares) == snap["serving/packed_patches"]
    assert len(shares) >= snap["serving/batches"]


def test_packed_bit_identical_with_crop_margin(clean):
    inferencer = make_inferencer(output_patch_size=(2, 8, 8),
                                 output_patch_overlap=(1, 4, 4),
                                 crop_output_margin=True)
    _parity_check(inferencer, _ragged(11, [(8, 32, 32), (6, 24, 28)]))


def test_packed_bit_identical_under_concurrent_submitters(clean):
    inferencer = make_inferencer()
    rng = np.random.default_rng(5)
    chunks = [Chunk(rng.random(RAGGED_SHAPES[i % len(RAGGED_SHAPES)])
                    .astype(np.float32), voxel_offset=(64 * i, 0, 0))
              for i in range(12)]
    refs = [_host(inferencer(c)) for c in chunks]
    packer = PatchPacker(inferencer, max_wait_ms=1.0)
    results = [None] * len(chunks)

    def submit(i):
        results[i] = packer.submit(chunks[i]).result(timeout=60)

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(chunks))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    packer.close()
    for ref, out in zip(refs, results):
        assert out is not None and np.array_equal(_host(out), ref)


def test_all_zero_chunk_takes_blank_path(clean):
    inferencer = make_inferencer()
    chunk = Chunk(np.zeros((8, 32, 32), dtype=np.float32))
    ref = inferencer(chunk)
    packer = PatchPacker(inferencer)
    out = packer.infer(chunk, timeout=30)
    packer.close()
    assert np.array_equal(_host(out), _host(ref))
    assert out.array.dtype == ref.array.dtype


# ---------------------------------------------------------------------------
# kill switch and fallbacks
# ---------------------------------------------------------------------------
def test_kill_switch_restores_per_chunk_path(clean):
    """CHUNKFLOW_SERVE=0: every request takes the per-chunk path, bitwise,
    and no packed batch runs."""
    clean.setenv("CHUNKFLOW_SERVE", "0")
    assert not serve_enabled()
    inferencer = make_inferencer()
    chunks = _ragged(9, RAGGED_SHAPES[:3])
    refs = [_host(inferencer(c)) for c in chunks]
    packer = PatchPacker(inferencer, max_wait_ms=1.0)
    outs = [packer.submit(c).result(timeout=30) for c in chunks]
    packer.close()
    for ref, out in zip(refs, outs):
        assert np.array_equal(_host(out), ref)
    assert packer._thread is None
    snap = telemetry.snapshot()
    assert snap["counters"].get("serving/fallbacks", 0) == len(chunks)
    assert "serving/batches" not in snap["counters"]


def test_sharded_and_fold_inferencers_fall_back(clean):
    inferencer = make_inferencer(blend="fold")
    chunk = _ragged(2, [(8, 32, 32)])[0]
    ref = _host(inferencer(chunk))
    packer = PatchPacker(inferencer)
    out = packer.infer(chunk, timeout=60)
    packer.close()
    assert np.array_equal(_host(out), ref)
    assert telemetry.snapshot()["counters"].get("serving/fallbacks") == 1


# ---------------------------------------------------------------------------
# occupancy telemetry
# ---------------------------------------------------------------------------
def test_occupancy_telemetry_and_one_forward_per_batch(clean, monkeypatch):
    """3-patch requests against batch 8: every slot accounted (real +
    filler = batches * B), strictly fewer batches than requests, one
    forward per batch at the fixed batch shape, and the pre-weighted
    accumulation replaying the stacks."""
    inferencer = make_inferencer(output_patch_overlap=(0, 0, 0),
                                 batch_size=8)
    chunks = [Chunk(np.random.default_rng(1).random((4, 16, 48)).astype(
        np.float32), voxel_offset=(8 * i, 0, 0)) for i in range(8)]
    shapes, flavours = [], []
    forward = inferencer._forward
    plain = accumulate.fused_accumulate_patches

    def counted_forward(patches):
        shapes.append(tuple(patches.shape))
        return forward(patches)

    def counted_accumulate(*args, pre_weighted=False):
        flavours.append(pre_weighted)
        return plain(*args, pre_weighted=pre_weighted)

    monkeypatch.setattr(inferencer, "_forward", counted_forward)
    monkeypatch.setattr(packer_mod.accumulate, "fused_accumulate_patches",
                        counted_accumulate)
    packer = PatchPacker(inferencer, max_wait_ms=20.0)
    handles = [packer.submit(c) for c in chunks]
    for h in handles:
        h.result(timeout=60)
    packer.close()
    snap = telemetry.snapshot()
    counters = snap["counters"]
    batches = counters["serving/batches"]
    assert counters["serving/packed_patches"] == 24
    assert (counters["serving/packed_patches"]
            + counters.get("serving/filler_slots", 0)) == batches * 8
    assert batches < len(chunks)
    assert counters["serving/packed_patches"] / (batches * 8) > 0.5
    assert shapes == [(8, 1) + PIN] * batches
    assert flavours and all(flavours)
    assert "serving/queue_age" in snap["hists"]
    assert "serving/occupancy" in snap["gauges"]
    assert "serving/forward" in snap["hists"]


# ---------------------------------------------------------------------------
# deadlines and teardown
# ---------------------------------------------------------------------------
def test_expired_request_fails_with_request_expired(clean):
    inferencer = make_inferencer()
    chunk = _ragged(0, [(8, 32, 32)])[0]
    packer = PatchPacker(inferencer, max_wait_ms=1.0)
    handle = packer.submit(chunk, deadline=time.time() - 1.0)
    with pytest.raises(RequestExpired):
        handle.result(timeout=30)
    ref = _host(inferencer(chunk))
    out = packer.infer(chunk, timeout=30)
    packer.close()
    assert np.array_equal(_host(out), ref)


def test_close_without_drain_fails_queued_requests(clean):
    inferencer = make_inferencer()
    rng = np.random.default_rng(0)
    packer = PatchPacker(inferencer, max_wait_ms=60_000.0)
    handle = packer.submit(Chunk(rng.random((4, 16, 16)).astype(np.float32)))
    packer.close(drain=False)
    with pytest.raises((PackerClosed, RequestExpired)):
        handle.result(timeout=10)
    late = packer.submit(Chunk(rng.random((4, 16, 16)).astype(np.float32)))
    with pytest.raises(PackerClosed):
        late.result(timeout=10)


def test_request_larger_than_queue_bound_completes(clean):
    inferencer = make_inferencer()
    chunk = _ragged(11, [(8, 32, 32)])[0]
    ref = _host(inferencer(chunk))
    packer = PatchPacker(inferencer, max_wait_ms=1.0, max_queue_patches=2)
    done = threading.Event()
    out = {}

    def go():
        out["chunk"] = packer.submit(chunk).result(timeout=30)
        done.set()

    thread = threading.Thread(target=go, daemon=True)
    thread.start()
    assert done.wait(30), "submit hung on a request larger than the bound"
    packer.close()
    assert np.array_equal(_host(out["chunk"]), ref)


# ---------------------------------------------------------------------------
# at every precision
# ---------------------------------------------------------------------------
def _three_chunks():
    rng = np.random.default_rng(3)
    return [Chunk(rng.random((4, 16, 48), dtype=np.float32),
                  voxel_offset=(8 * i, 0, 0)) for i in range(3)]


@pytest.mark.parametrize("precision_", ["bfloat16", "int8"])
def test_packed_serve_parity_survives_precision(clean, precision_):
    """Packed vs per-chunk, bitwise, at a narrow precision: the packer
    runs the inferencer's wrapped forward; and the per-chunk result is
    the JAX package's (identity engine)."""
    inferencer = make_inferencer(precision=precision_)
    chunks = _three_chunks()
    refs, _ = _parity_check(inferencer, chunks, max_wait_ms=2.0)
    jax_inf = JaxInferencer(precision=precision_, **_kwargs())
    for chunk, ref in zip(chunks, refs):
        jax_ref = np.asarray(jax_inf(JaxChunk(chunk.array)).array)
        if precision_ == "int8":
            # XLA's fused multiply-adds (tests/test_torch_precision.py)
            np.testing.assert_array_max_ulp(ref, jax_ref, maxulp=4)
        else:
            assert np.array_equal(ref, jax_ref)


def test_packed_serve_parity_survives_real_int8(clean):
    clean.setenv("CHUNKFLOW_INT8", "real")
    inferencer = make_inferencer(precision="int8")
    chunks = _three_chunks()
    refs, _ = _parity_check(inferencer, chunks, max_wait_ms=2.0)
    jax_inf = JaxInferencer(precision="int8", **_kwargs())
    for chunk, ref in zip(chunks, refs):
        assert np.array_equal(
            ref, np.asarray(jax_inf(JaxChunk(chunk.array)).array))


@pytest.mark.parametrize("precision_, leg", [
    ("float32", None), ("bfloat16", None), ("int8", "fake"),
    ("int8", "real")], ids=["float32", "bf16", "fake", "real"])
def test_packed_convnet_bit_identical(clean, precision_, leg):
    """A convnet (``tpu``, bfloat16 compute, batch 4) at each precision:
    mixed requests share batches, and each result is bitwise its own
    per-chunk result — every op of the forward is per row, and the int8
    scales are per row."""
    if leg is not None:
        clean.setenv("CHUNKFLOW_INT8", leg)
    inferencer = make_inferencer(framework="pytorch", model_variant="tpu",
                                 dtype="bfloat16", precision=precision_)
    chunks = _ragged(13, [(4, 16, 16), (6, 24, 28), (5, 17, 30)], np.uint8)
    shares = []
    plain = gather.gather_patches

    def counted(chunk, starts, pin):
        shares.append(len(starts))
        return plain(chunk, starts, pin)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(packer_mod.gather, "gather_patches", counted)
        _parity_check(inferencer, chunks, max_wait_ms=500.0)
    # some batch held rows of two requests (two gathers in one batch)
    assert len(shares) > telemetry.snapshot()["counters"]["serving/batches"]
