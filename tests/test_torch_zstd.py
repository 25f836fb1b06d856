"""The port's zstd decoders (``csrc/host/zstd.cpp`` and its plain Python
version, ``volume/zstd.py:decompress_plain``) against ``zstandard`` on
the CPU: frames at levels -5, 1, 3 and 19, with and without the content
checksum and the content size, inputs larger than one 128 KB block,
incompressible, all-equal and empty inputs, direct Huffman weights, raw
and RLE blocks, concatenated and skippable frames; both decoders give the
bytes ``zstandard`` was given. A frame without its content size decodes
into an output that grows up to its bound. A flipped checksum, a
truncated frame and a dictionary id raise, and no corrupted frame decodes
out of bounds. The port's own zstd frames are held in
``tests/test_torch_encoders.py``.
"""
import struct

import numpy as np
import pytest
import torch

from chunkflow_tpu_torch import native
from chunkflow_tpu_torch.volume import zstd

zstandard = pytest.importorskip("zstandard")

# the suite runs in several pytest-xdist workers on one machine
torch.set_num_threads(1)

_RNG = np.random.default_rng(0)
_NOISY = (np.arange(200_000) % 251).astype(np.uint8)
_NOISY[_RNG.integers(0, 200_000, 2000)] = 7
INPUTS = {
    "text": b" ".join(_RNG.choice([b"alpha", b"beta", b"gamma", b"delta",
                                   b"x" * 7, b"zz"], 600).tolist()),
    "incompressible": _RNG.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
    "all-equal": b"\x05" * 5000,
    "empty": b"",
    # more than one 128 KB block, compressible: few literals, so the plain
    # version decodes it quickly
    "two-blocks": _NOISY.tobytes(),
    "float32": _RNG.normal(size=700).astype(np.float32).tobytes(),
    # a 16-symbol alphabet: zstd writes its Huffman weights directly
    "nibbles": _RNG.choice(16, 3000, p=np.r_[[0.3, 0.2, 0.1, 0.1],
                                             [0.025] * 12]).astype(
        np.uint8).tobytes(),
}
DECODERS = {"cpp": lambda frame, size: zstd.decompress(frame, size),
            "plain": lambda frame, size: zstd.decompress_plain(frame)}


def _frame(data, level=3, checksum=True, content_size=True):
    return zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=content_size).compress(data)


@pytest.mark.parametrize("decoder", sorted(DECODERS))
@pytest.mark.parametrize("content_size", [True, False],
                         ids=["size", "nosize"])
@pytest.mark.parametrize("checksum", [True, False], ids=["ck", "nock"])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
def test_frames_decode_to_what_zstandard_was_given(level, checksum,
                                                   content_size, decoder):
    for name, data in INPUTS.items():
        frame = _frame(data, level, checksum, content_size)
        assert DECODERS[decoder](frame, len(data)) == data, name


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_raw_and_rle_blocks(decoder):
    """An incompressible block is stored raw, an all-equal one after the
    first block as an RLE block."""
    data = _RNG.integers(0, 256, 140_000, dtype=np.uint8).tobytes() \
        + b"\x07" * 300_000
    frame = _frame(data, 1)
    kinds, pos = [], zstd._frame_header(frame, 0)[1]
    while True:
        header = int.from_bytes(frame[pos:pos + 3], "little")
        kinds.append((header >> 1) & 3)
        pos += 3 + (1 if (header >> 1) & 3 == 1 else header >> 3)
        if header & 1:
            break
    assert 0 in kinds and 1 in kinds
    assert DECODERS[decoder](frame, len(data)) == data


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_concatenated_and_skippable_frames(decoder):
    a, b = INPUTS["text"], INPUTS["float32"]
    skippable = struct.pack("<II", 0x184D2A5E, 5) + b"12345"
    frames = _frame(a, 1) + skippable + _frame(b, 19, content_size=False)
    assert DECODERS[decoder](frames, len(a) + len(b)) == a + b
    # the C++ decoder needs a size or a bound when a frame has none
    assert zstd.content_size(frames) is None
    assert zstd.decompress(frames, max_size=1 << 20) == a + b


@pytest.mark.parametrize("fits", [True, False], ids=["grows", "bound"])
def test_frames_without_a_size_grow_the_output_up_to_the_bound(fits):
    """The C++ decoder's output starts at 8 times the frames' size and
    grows while they do not fit it; past ``max_size`` they raise."""
    data = INPUTS["all-equal"] * 200 + INPUTS["text"]  # ~1 MB, 400:1
    frame = _frame(data, 3, content_size=False)
    assert 8 * len(frame) < len(data)
    if fits:
        assert zstd.decompress(frame, max_size=1 << 30) == data
    else:
        with pytest.raises(native.ZstdOutputFull):
            zstd.decompress(frame, max_size=len(data) - 1)
        # a stated content size above the bound raises before decoding
        with pytest.raises(ValueError, match="bound"):
            zstd.decompress(_frame(data, 3), max_size=len(data) - 1)


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_bad_frames_raise(decoder):
    data = INPUTS["text"]
    frame = bytearray(_frame(data, 3, checksum=True))
    flipped = bytes(frame[:-1]) + bytes([frame[-1] ^ 0x40])
    with pytest.raises(ValueError, match="checksum"):
        DECODERS[decoder](flipped, len(data))
    for cut in (4, 9, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ValueError):
            DECODERS[decoder](bytes(frame[:cut]), len(data))
    # a frame naming dictionary 5: the dictionary-id flag and its byte
    # after the window descriptor
    plain = _frame(data, 3, checksum=False, content_size=False)
    assert plain[4] & 0x23 == 0  # no dictionary, not single segment
    with_dict = plain[:4] + bytes([plain[4] | 1]) + plain[5:6] + b"\x05" \
        + plain[6:]
    with pytest.raises(ValueError, match="dictionary"):
        DECODERS[decoder](with_dict, len(data))


def test_corrupted_frames_never_decode_out_of_bounds():
    """Each of 400 frames with one bit flipped either raises or decodes
    to bytes of the size asked for."""
    data = INPUTS["text"] + INPUTS["float32"]
    frame = _frame(data, 3, checksum=False)
    rng = np.random.default_rng(3)
    for _ in range(400):
        bad = bytearray(frame)
        k = int(rng.integers(0, len(bad)))
        bad[k] ^= 1 << int(rng.integers(0, 8))
        try:
            out = native.zstd_decompress(bytes(bad), len(data))
        except ValueError:
            continue
        assert len(out) == len(data)


def test_xxh64_is_the_frame_checksum():
    for data in (b"", b"a", INPUTS["text"], INPUTS["float32"][:37]):
        frame = _frame(data, 1, checksum=True)
        assert zstd.xxh64(data) & 0xFFFFFFFF == \
            struct.unpack("<I", frame[-4:])[0]
