"""The port's block compression (ceph_tpu_torch/compressor.py and
ceph_tpu_torch/ops/compression_kernel.py) held against the JAX package's on
the CPU.

Mirrors the bit-plane and compressor cases of tests/test_bluestore_data.py
and the compressor cases of tests/test_services.py on the port with
``device="cpu"`` (the plain torch planes), holds the plain planes against
JAX's jitted ``_jit_planes`` and the numpy oracle on seeded (S, W) batches up
to BlueStore's (1,024, 4,096) and a 64 KiB row, and checks that the two
packages' ``tpu_bitplane`` plugins write the same bytes and each decodes the
other's.  Exact equality throughout: the planes are a permutation of bits.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ceph_tpu import compressor as ref_comp
from ceph_tpu.ops import compression_kernel as jk
from ceph_tpu_torch import compressor
from ceph_tpu_torch.ops import compression_kernel as bk
from ceph_tpu_torch.ops import telemetry

BLOCK = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plugin(**kw):
    return compressor.create("tpu_bitplane", device="cpu", **kw)


def _blocks(seed: int) -> list[bytes]:
    """4 KiB blocks of the kinds a store sees: 7-bit text, mostly-zero
    small integers, 6-bit data, random bytes, a repeated random record
    (every plane live, so zlib's), zeros, and a short tail."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 8, BLOCK, dtype=np.uint8)
    small[rng.random(BLOCK) < 0.8] = 0
    return [bytes(rng.integers(32, 127, BLOCK, dtype=np.uint8)),
            small.tobytes(),
            bytes(rng.integers(0, 64, BLOCK, dtype=np.uint8)),
            bytes(rng.integers(0, 256, BLOCK, dtype=np.uint8)),
            bytes(rng.integers(0, 256, 64, dtype=np.uint8)) * 64,
            bytes(BLOCK), b"tail" * 77]


# -- the planes ----------------------------------------------------------------

@pytest.mark.parametrize("s,w", [(1, 8), (37, 4096), (1024, 4096),
                                 (3, 65536)])
def test_plain_planes_equal_jit_planes(s, w):
    """bitplane_planes_plain == JAX's _jit_planes (on the CPU) == the numpy
    oracle, on seeded rows of mixed content."""
    rng = np.random.default_rng(s * 7 + w)
    top = rng.choice([256, 128, 8, 2], size=(s, 1))
    batch = (rng.integers(0, 256, (s, w)) % top).astype(np.uint8)
    got = bk.bitplane_planes_plain(torch.from_numpy(batch)).numpy()
    assert np.array_equal(got, np.asarray(jk._jit_planes()(batch)))
    assert np.array_equal(got, jk.bitplane_planes_ref(batch))
    assert np.array_equal(bk.bitplane_planes_ref(batch),
                          jk.bitplane_planes_ref(batch))


def test_planes_device_matches_ref():
    """The batched entry on a CPU tensor runs the plain version, timed
    under the bitplane_pack family."""
    rng = np.random.default_rng(9)
    batch = rng.integers(0, 256, (5, 96), dtype=np.uint8)
    before = telemetry.dump().get("bitplane_pack", {}).get("calls", 0)
    dev = bk.bitplane_planes_batched(torch.from_numpy(batch))
    assert not dev.is_cuda
    assert np.array_equal(dev.numpy(), bk.bitplane_planes_ref(batch))
    assert np.array_equal(bk.bitplane_planes_batched(batch).numpy(),
                          bk.bitplane_planes_ref(batch))
    assert telemetry.dump()["bitplane_pack"]["calls"] == before + 2
    with pytest.raises(ValueError):
        bk.bitplane_planes_batched(np.zeros((2, 12), np.uint8))


def test_encode_decode_roundtrip_property():
    rng = np.random.default_rng(11)
    blobs = [b"", b"\x00" * 100, b"a" * 999,
             bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),
             bytes(rng.integers(0, 64, 4097, dtype=np.uint8)),
             b"the quick brown fox " * 37]
    blobs += [bytes(rng.integers(0, 128, int(s), dtype=np.uint8))
              for s in rng.integers(1, 3000, 8)]
    for device in ("cpu", False):
        planes = bk.pack_planes(blobs, device=device)
        for b, p in zip(blobs, planes):
            body = bk.encode_block(b, p)
            assert bk.decode_block(body) == b
            assert body == jk.encode_block(b, p)


def test_pack_planes_on_the_card_by_default(monkeypatch):
    """``device`` True or None means the card: without one it raises
    (nothing falls back to the host); False is the numpy oracle."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (True, None):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bk.pack_planes([b"abc"], device=device)
    assert bk.pack_planes([b"abc"], device=False)[0].shape == (8, 1)


# -- the tpu_bitplane plugin -----------------------------------------------------

def test_plugin_roundtrip_and_ratio_win_on_structured():
    """6-bit data has two provably-zero planes: the plugin must
    round-trip byte-identical AND beat the raw size clearly."""
    rng = np.random.default_rng(13)
    c = _plugin()
    data = bytes(rng.integers(0, 64, BLOCK, dtype=np.uint8))
    comp = c.compress(data)
    assert c.decompress(comp) == data
    assert len(comp) <= BLOCK * 0.8
    # random data keeps all planes: stored raw-tagged, one byte of
    # overhead, still round-trips
    rnd = bytes(rng.integers(0, 256, BLOCK, dtype=np.uint8))
    comp = c.compress(rnd)
    assert c.decompress(comp) == rnd
    assert len(comp) == BLOCK + 1


def test_compress_batch_matches_single():
    c = _plugin()
    blobs = _blocks(15) + [b"", bytes(70000)]
    batch = c.compress_batch(blobs)
    for b, body in zip(blobs, batch):
        assert c.decompress(body) == b
        assert body == c.compress(b)


def test_corrupt_bodies_raise_compression_error():
    c = _plugin()
    good = c.compress(b"hello bitplane world" * 40)
    assert good[:1] == b"\x01"
    with pytest.raises(compressor.CompressionError):
        c.decompress(b"")                    # empty payload
    with pytest.raises(compressor.CompressionError):
        c.decompress(b"\x07whatever")        # unknown scheme tag
    with pytest.raises(compressor.CompressionError):
        c.decompress(good[:1])               # chopped header
    with pytest.raises(compressor.CompressionError):
        c.decompress(good[:-3])              # truncated planes
    with pytest.raises(compressor.CompressionError):
        c.decompress(b"\x02not-zlib-data")   # corrupt zlib body


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plugin_bytes_equal_across_packages(seed):
    """The same blocks through both packages' plugins (the port's plain
    planes, the JAX package's jitted ones and its numpy oracle) give the
    same bytes, one by one and batched, and each package decodes the
    other's."""
    blobs = _blocks(seed)
    port = _plugin()
    for ref in (ref_comp.create("tpu_bitplane"),
                ref_comp.create("tpu_bitplane", device=False)):
        mine = port.compress_batch(blobs)
        theirs = ref.compress_batch(blobs)
        assert mine == theirs
        assert [port.compress(b) for b in blobs] == theirs
        for b, m, t in zip(blobs, mine, theirs):
            assert ref.decompress(m) == b
            assert port.decompress(t) == b
    tags = {m[:1] for m in mine}
    assert tags == {b"\x00", b"\x01", b"\x02"}


def test_plugin_device_kwarg():
    """``device`` takes the reference's bool (False: the numpy oracle) and
    a torch device; the bytes are the same."""
    blobs = _blocks(4)
    assert compressor.create("tpu_bitplane", device=False).device is False
    want = _plugin().compress_batch(blobs)
    for device in (False, torch.device("cpu")):
        c = compressor.create("tpu_bitplane", device=device)
        assert c.compress_batch(blobs) == want


# -- the compressor registry -----------------------------------------------------

def test_unknown_kwarg_names_accepted_set():
    with pytest.raises(ValueError, match="accepted kwargs"):
        compressor.create("zlib", levle=3)
    with pytest.raises(ValueError, match="tpu_bitplane"):
        compressor.create("tpu_bitplane", mode="fast")
    # valid kwargs still construct
    assert compressor.create("zlib", level=1).level == 1


def test_lzma_honors_level():
    """preset follows the kwarg: preset 0 and 9 produce different streams
    for compressible data, each the JAX package's bytes."""
    data = b"abcdefgh" * 4096
    fast = compressor.create("lzma", level=0).compress(data)
    small = compressor.create("lzma", level=9).compress(data)
    assert fast != small
    assert compressor.create("lzma").decompress(fast) == data
    assert compressor.create("lzma").decompress(small) == data
    assert fast == ref_comp.create("lzma", level=0).compress(data)


def test_corrupt_input_raises_typed_error():
    for name in ("zlib", "lzma"):
        with pytest.raises(compressor.CompressionError):
            compressor.create(name).decompress(b"\xff" * 32)


def test_registry_roundtrip():
    data = b"compressible " * 1000
    # the JAX package's own plugins: a test that ran earlier in this
    # process may have left one of its own in that registry
    # (tests/test_services.py registers "rot13" and keeps it)
    builtin = sorted(n for n in ref_comp.names()
                     if ref_comp._FACTORIES[n].__module__
                     == ref_comp.__name__)
    assert compressor.names() == builtin
    for name in compressor.names():
        kw = {"device": "cpu"} if name == "tpu_bitplane" else {}
        c = compressor.create(name, **kw)
        assert c.decompress(c.compress(data)) == data
        assert c.compress(data) == ref_comp.create(
            name, **({"device": False} if kw else {})).compress(data)
    with pytest.raises(KeyError):
        compressor.create("snappy")


def test_custom_plugin_registration():
    class Rot13(compressor.Compressor):
        name = "rot13"

        def compress(self, data):
            return bytes((b + 13) % 256 for b in data)

        def decompress(self, data):
            return bytes((b - 13) % 256 for b in data)

    compressor.register("rot13", Rot13)
    try:
        c = compressor.create("rot13")
        assert c.decompress(c.compress(b"abc")) == b"abc"
    finally:
        with compressor._LOCK:
            compressor._FACTORIES.pop("rot13", None)
