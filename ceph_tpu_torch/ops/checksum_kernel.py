"""Batched object-integrity digests — the deep-scrub checksum kernel.

Deep scrub is a checksum workload: every object's payload and omap blob
hashes into the (size, data_crc, omap_crc) scrub-map triple
(``osd.ec_util.shard_crc``; the reference's chunky-scrub digests in
src/osd/PGBackend::be_deep_scrub).  A PG's digests go to the card as ONE
batched call riding the dispatch engine's ``scrub_digest`` channel.

Two digests per row, both over row[:L] of a zero-padded (S, W) batch:

* **crc32** (zlib's, reflected polynomial 0xEDB88320).  The register
  update for one byte is GF(2)-linear in (register, byte), so with Z the
  update for a ZERO byte:

  - the padding is stripped exactly: r_true = Z^-(W-L) r_padded (the
    per-row ``mats`` of ``digest_operands``);
  - the register is linear across a split: started from 0,
    crc(A‖B) = Z^|B|·crc(A) ⊕ crc(B), and the initial register
    0xFFFFFFFF contributes the constant Z^W·0xFFFFFFFF.

* **the GF(2^8) shard digest**: 4 Horner lanes d = α·d ⊕ byte (lane l
  takes bytes l, l+4, ...).  t trailing zero steps multiply a lane by
  α^t, undone by ``invp`` = α^-t, and across a split
  g(A‖B) = α^(|B|/4)·g(A) ⊕ g(B).

So the card never runs the W/4 sequential steps of the reference's scan
(``ceph_tpu/ops/checksum_kernel.py`` ``_jit_digest``).  The plain version
here (``scrub_digest_plain``) cuts each row into segments of
``segment_bytes(W)``, digests every segment from zero in parallel, and
joins neighbouring segments by a tree with the shift operands of
``shift_operands`` (Z^(s·2^j) and α^(s/4·2^j) for level j).  The CUDA
kernel ``csrc/digest.cu`` (``digest_cuda.scrub_digest``) cuts rows by the
same identities into the card's shapes: warp items whose lanes interleave
16-byte chunks (``chunk_gap_tables``), joined by ``tree_tables`` and
``shift_operands`` at the run it is given.  ``scrub_digest_batched`` picks
by the tensor's device — a CUDA tensor launches the kernel or raises, a
CPU tensor runs the plain version.  The host oracle ``scrub_digest_ref``
is the literal per-row loop.

Importing this module builds nothing: torch tensors of the tables are made
on first use, per device, and the kernel is built at its first launch.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

from ceph_tpu_torch.gf.tables import gf_exp, mul_table
from ceph_tpu_torch.ops import telemetry

#: crc32 (zlib/ISO-HDLC) reflected polynomial; the repo's shard_crc is
#: zlib.crc32
_CRC_POLY = 0xEDB88320
_CRC_INIT = 0xFFFFFFFF

#: GF(2^8) Horner evaluation point for the shard digest (alpha = x)
_GF_ALPHA = 2

#: minimum padded row width (pow2, multiple of the 4-byte scan step)
MIN_WIDTH = 8

#: rows wider than this take the scalar host path.  The reference capped
#: rows at 2^18 because its scan runs W/4 sequential steps; the segmented
#: digest has no such chain (a 4 MiB row is 65,536 independent 64-byte
#: segments and a 16-level join), so the port's cap is a whole 4 MiB
#: object — rados bench's default, every copy of a replicated pool's
#: object and every 512 KiB shard of a k=8 pool's digest on the card.
#: The cap bounds one batch's padded staging (rows x W bytes)
MAX_WIDTH = 1 << 22

#: bytes of a row one segment digests from zero (the CUDA kernel's thread
#: and the plain version's loop); narrower rows are one segment each
SEG_BYTES = 64


# ---------------------------------------------------------------------------
# host oracle — ground truth for the bit-exactness tests
# ---------------------------------------------------------------------------

def gf_digest_ref(row: np.ndarray) -> int:
    """4-lane GF(2^8) Horner digest of one row, packed little-endian:
    lane l evaluates bytes row[l::4] at alpha (the literal per-byte
    loop — the definition the batched kernel must reproduce)."""
    mt = mul_table()
    alpha_row = mt[_GF_ALPHA]
    packed = 0
    for lane in range(4):
        d = 0
        for b in row[lane::4].tolist():
            d = int(alpha_row[d]) ^ int(b)
        packed |= d << (8 * lane)
    return packed


def scrub_digest_ref(batch, lengths, *_aux) -> np.ndarray:
    """Bit-exact host oracle: per row i, col 0 is ``shard_crc`` of
    row[:L_i] and col 1 the packed GF Horner digest.  Extra aux operands
    (the device path's unpad matrices) are accepted and ignored so the
    engine's fallback ladder can call this with the full aux tuple."""
    # analysis: allow[blocking] -- host oracle: inputs are host numpy by contract
    batch = np.asarray(batch, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int64)
    out = np.zeros((batch.shape[0], 2), dtype=np.uint32)
    for i in range(batch.shape[0]):
        row = batch[i, : int(lengths[i])]
        out[i, 0] = zlib.crc32(row.tobytes()) & 0xFFFFFFFF
        out[i, 1] = gf_digest_ref(row)
    return out


# ---------------------------------------------------------------------------
# table prep (host, cached)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _crc_tables() -> np.ndarray:
    """(4, 256) uint32 slicing-by-4 tables; row 0 is the classic
    byte-at-a-time table."""
    t0 = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_CRC_POLY if c & 1 else 0)
        t0[i] = c
    tabs = [t0]
    for _ in range(3):
        prev = tabs[-1]
        tabs.append(((prev >> np.uint32(8)) ^ t0[prev & 0xFF])
                    .astype(np.uint32))
    return np.stack(tabs)


def _apply_cols(cols: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """GF(2) matrix (32 uint32 columns) applied to uint32 value(s):
    out = XOR of columns selected by the set bits of each value."""
    vals = np.asarray(vals, dtype=np.uint32)
    out = np.zeros_like(vals)
    for j in range(32):
        bit = (vals >> np.uint32(j)) & np.uint32(1)
        out ^= cols[j] * bit
    return out


@functools.lru_cache(maxsize=1)
def _zero_cols() -> np.ndarray:
    """Columns of Z, the crc-register update for one ZERO byte:
    Z(c) = (c >> 8) ^ T0[c & 0xFF]."""
    t0 = _crc_tables()[0]
    cols = np.zeros(32, dtype=np.uint32)
    for j in range(32):
        c = np.uint32(1 << j)
        cols[j] = (c >> np.uint32(8)) ^ t0[int(c) & 0xFF]
    return cols


@functools.lru_cache(maxsize=1)
def _zero_inv_cols() -> np.ndarray:
    """Z^-1 columns via GF(2) Gaussian elimination (Z is invertible:
    the crc register after a zero byte determines the register
    before)."""
    n = 32
    cols = _zero_cols()
    m = np.zeros((n, 2 * n), dtype=np.uint8)
    for j in range(n):
        for i in range(n):
            m[i, j] = (int(cols[j]) >> i) & 1
        m[j, n + j] = 1
    for col in range(n):
        piv = next(r for r in range(col, n) if m[r, col])
        if piv != col:
            m[[col, piv]] = m[[piv, col]]
        for r in range(n):
            if r != col and m[r, col]:
                m[r] ^= m[col]
    inv = np.zeros(n, dtype=np.uint32)
    for j in range(n):
        v = 0
        for i in range(n):
            if m[i, n + j]:
                v |= 1 << i
        inv[j] = v
    return inv


@functools.lru_cache(maxsize=4096)
def _unpad_cols(k: int) -> np.ndarray:
    """Columns of Z^-k (square-and-multiply over the composition
    _apply_cols): strips k trailing zero bytes from a crc register."""
    if k == 0:
        return (np.uint32(1) << np.arange(32, dtype=np.uint32))
    half = _unpad_cols(k // 2)
    sq = _apply_cols(half, half)
    if k % 2:
        return _apply_cols(_zero_inv_cols(), sq)
    return sq


#: widest padded width whose full Z^-k table is precomputed (one compose
#: per entry, ~0.1 ms each); wider batches build only the DISTINCT pad
#: counts they need via square-and-multiply (_unpad_cols, O(log k)
#: composes, memoized)
_TABLE_WIDTH_MAX = 4096


@functools.lru_cache(maxsize=16)
def _unpad_table(width: int) -> np.ndarray:
    """(width + 1, 32) uint32: Z^-k columns for every pad count a batch
    of this width can need, built once per width, so the per-call
    operand build is one numpy gather."""
    out = np.zeros((width + 1, 32), dtype=np.uint32)
    out[0] = _unpad_cols(0)
    zinv = _zero_inv_cols()
    for k in range(1, width + 1):
        out[k] = _apply_cols(zinv, out[k - 1])
    return out


@functools.lru_cache(maxsize=32)
def _gf_inv_pows(n: int) -> np.ndarray:
    """(n + 1,) uint8: alpha^-t for t in 0..n (undoes t trailing zero
    Horner steps on one lane).  alpha = 2 generates the field 0x11d, so
    alpha^-t = exp[(-t) mod 255]: one gather, not n table steps."""
    t = np.arange(n + 1, dtype=np.int64)
    return gf_exp()[(-t) % 255].astype(np.uint8)


def digest_operands(lengths, width: int):
    """The per-row epilogue operands for a padded batch of ``width``:
    (mats (S, 32) uint32 — Z^-(W-L) columns per row; invp (S, 4) uint8 —
    alpha^-t per GF lane).  Submitters build these host-side from the
    lengths; they ride the engine's aux channel in lockstep with the
    data rows."""
    lengths = np.asarray(lengths, dtype=np.int64)
    pads = width - lengths
    if width <= _TABLE_WIDTH_MAX:
        mats = _unpad_table(width)[pads]
    else:
        lut = {int(k): _unpad_cols(int(k)) for k in np.unique(pads)}
        mats = np.stack([lut[int(k)] for k in pads]) if len(pads) \
            else np.zeros((0, 32), dtype=np.uint32)
    steps = width // 4
    pows = _gf_inv_pows(steps)
    lanes = np.arange(4, dtype=np.int64)[None, :]
    # lane l holds ceil((L - l) / 4) real bytes; the rest of its
    # width/4 Horner steps consumed padding zeros
    n_real = np.clip(-(-(lengths[:, None] - lanes) // 4), 0, steps)
    invp = pows[(steps - n_real).astype(np.int64)]
    return mats, invp.astype(np.uint8)


def row_width(max_len: int) -> int:
    """Shared pow-2 padded width for a digest batch (>= MIN_WIDTH so the
    4-byte scan step always divides it): concurrent scrubs bucket their
    rows to the same widths, so different PGs coalesce."""
    if max_len <= MIN_WIDTH:
        return MIN_WIDTH
    return 1 << (int(max_len) - 1).bit_length()


# ---------------------------------------------------------------------------
# the segment join's operands
# ---------------------------------------------------------------------------

def segment_bytes(width: int, run: int = SEG_BYTES) -> int:
    """Bytes one segment of a row of ``width`` covers, for segments of
    ``run`` bytes (the plain version's SEG_BYTES, or the CUDA kernel's run
    a lane)."""
    return min(int(run), int(width))


@functools.lru_cache(maxsize=32)
def _zero_pow2_cols(i: int) -> np.ndarray:
    """Columns of Z^(2^i): moves a crc register across 2^i zero bytes."""
    if i == 0:
        return _zero_cols()
    half = _zero_pow2_cols(i - 1)
    return _apply_cols(half, half)


def _check_width(width: int) -> int:
    width = int(width)
    if width < MIN_WIDTH or width & (width - 1):
        raise ValueError(f"row width {width} is not a power of two "
                         f">= {MIN_WIDTH}")
    return width.bit_length() - 1


@functools.lru_cache(maxsize=64)
def shift_operands(width: int, run: int = SEG_BYTES
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The join tree's operands for rows of ``width``: (zcols (L, 32)
    uint32, alpha (L,) uint8) with L = log2(width / s) levels for
    segments of s = ``segment_bytes(width, run)``.  Level j joins two spans of
    s·2^j bytes: zcols[j] are the columns of Z^(s·2^j), which moves the
    left span's crc register across the right span, and alpha[j] is
    α^(s/4·2^j), which moves each GF lane across its s/4·2^j Horner
    steps."""
    lg = _check_width(width)
    seg = segment_bytes(width, run)
    if seg < 4 or seg & (seg - 1):
        raise ValueError(f"segment of {seg} bytes is not a power of two "
                         f">= 4")
    lg_seg = seg.bit_length() - 1
    levels = lg - lg_seg
    zcols = np.zeros((levels, 32), dtype=np.uint32)
    alpha = np.zeros(levels, dtype=np.uint8)
    exp = gf_exp()
    for j in range(levels):
        zcols[j] = _zero_pow2_cols(lg_seg + j)
        alpha[j] = exp[((seg // 4) << j) % 255]
    return zcols, alpha


#: levels of the CUDA kernel's in-warp join tree (log2 of a warp's lanes)
TREE_LEVELS = 5


@functools.lru_cache(maxsize=16)
def tree_tables(run: int) -> np.ndarray:
    """(TREE_LEVELS, 4, 256) uint32: the in-warp join levels' Z^(run·2^k)
    byte-sliced, entry [k, b, v] = Z^(run·2^k) applied to v << 8b, so that
    a register c crosses 2^k runs of zeros as the XOR of four lookups, one
    a byte of c (the same split as the slicing-by-4 crc tables)."""
    run = int(run)
    if run < 1 or run & (run - 1):
        raise ValueError(f"run of {run} bytes is not a power of two")
    lg = run.bit_length() - 1
    vals = np.arange(256, dtype=np.uint32)
    out = np.zeros((TREE_LEVELS, 4, 256), dtype=np.uint32)
    for k in range(TREE_LEVELS):
        cols = _zero_pow2_cols(lg + k)
        for b in range(4):
            out[k, b] = _apply_cols(cols, vals << np.uint32(8 * b))
    return out


#: bytes one lane of the CUDA kernel loads at once, and the lanes of a warp
#: that interleave their chunks (csrc/digest.cu kChunk, kLanes)
CHUNK_BYTES = 16
LANES = 32


def _zero_pow_cols(n: int) -> np.ndarray:
    """Columns of Z^n for any n >= 0 (a product of the Z^(2^i))."""
    cols = _unpad_cols(0)
    for i in range(int(n).bit_length()):
        if (int(n) >> i) & 1:
            cols = _apply_cols(_zero_pow2_cols(i), cols)
    return cols


def slicing_tables(shift: int) -> np.ndarray:
    """(4, 256) uint32: Z^shift of each byte of a word in the slicing-by-4
    layout, entry [k, v] = Z^shift (v << 8(3 - k)); at shift 4 these are
    the crc tables themselves."""
    cols = _zero_pow_cols(shift)
    vals = np.arange(256, dtype=np.uint32)
    return np.stack([_apply_cols(cols, vals << np.uint32(8 * (3 - k)))
                     for k in range(4)])


@functools.lru_cache(maxsize=1)
def chunk_gap_tables() -> np.ndarray:
    """(1280,) uint32: what the CUDA kernel's lanes need to cross the other
    lanes' chunks.  A warp reads 512 contiguous bytes a load, lane l the
    16-byte chunks l, l + 32, ..., so between two of its chunks lie 31 of
    the others' (496 bytes, 124 words).  [0:1024]: ``slicing_tables(4 +
    496)``, the crc step of a chunk's last word followed by that gap;
    [1024:1280]: alpha^124 · b for each byte b, repeated in all four bytes
    of the word (each GF lane across the gap)."""
    mt = mul_table()
    a124 = int(gf_exp()[(LANES - 1) * CHUNK_BYTES // 4 % 255])
    prod = mt[a124].astype(np.uint32)
    gf = prod * np.uint32(0x01010101)
    return np.concatenate([slicing_tables(4 + (LANES - 1) * CHUNK_BYTES)
                           .reshape(-1), gf]).astype(np.uint32)


@functools.lru_cache(maxsize=32)
def init_term(width: int) -> int:
    """Z^W·0xFFFFFFFF: what the initial register contributes to the crc
    register after W bytes (the segments start from 0)."""
    lg = _check_width(width)
    return int(_apply_cols(_zero_pow2_cols(lg), np.uint32(_CRC_INIT)))


# ---------------------------------------------------------------------------
# the plain version (torch, any device)
# ---------------------------------------------------------------------------

_TABLES: dict = {}


def _device_tables(device: torch.device) -> dict:
    """The plain version's lookup tables as int64 tensors on ``device``."""
    key = str(device)
    tabs = _TABLES.get(key)
    if tabs is None:
        tabs = {"crc": torch.from_numpy(_crc_tables().astype(np.int64))
                .to(device),
                "mul": torch.from_numpy(mul_table().astype(np.int64))
                .to(device)}
        _TABLES[key] = tabs
    return tabs


def _apply_cols_t(cols: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """GF(2) matrix-vector over 32 columns, elementwise: ``cols`` (32,)
    (one matrix) or (..., 32) (one per element of ``v``)."""
    out = torch.zeros_like(v)
    for i in range(32):
        out ^= cols[..., i] * ((v >> i) & 1)
    return out


def _gf_scale4(row: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Each of the 4 packed GF lanes of ``g`` times the constant whose
    product row is ``row`` (256,)."""
    out = torch.zeros_like(g)
    for lane in range(4):
        out |= row[(g >> (8 * lane)) & 0xFF] << (8 * lane)
    return out


def _as_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as a uint32 tensor (through their int32
    bit pattern, a view on every device)."""
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32).view(
        torch.uint32)


def _i64(t: torch.Tensor) -> torch.Tensor:
    """A uint8/uint32 operand's values as int64."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


def scrub_digest_plain(data: torch.Tensor, mats: torch.Tensor,
                       invp: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch, by the kernel's algorithm: every
    segment of every row digested from zero by one step-by-step loop (all
    segments at once), then log2(segments) join levels, then the
    epilogue.  (S, W) uint8, (S, 32) uint32, (S, 4) uint8 -> (S, 2)
    uint32."""
    s, w = data.shape
    dev = data.device
    tabs = _device_tables(dev)
    crc_t, mt = tabs["crc"], tabs["mul"]
    seg = segment_bytes(w)
    nseg = w // seg
    words = (data.contiguous().view(torch.int32).to(torch.int64)
             & 0xFFFFFFFF).reshape(s * nseg, seg // 4)
    crc = torch.zeros(s * nseg, dtype=torch.int64, device=dev)
    g = torch.zeros_like(crc)
    for t in range(seg // 4):
        wd = words[:, t]
        x = crc ^ wd
        crc = (crc_t[3][x & 0xFF] ^ crc_t[2][(x >> 8) & 0xFF]
               ^ crc_t[1][(x >> 16) & 0xFF] ^ crc_t[0][x >> 24])
        hi = (g >> 7) & 0x01010101
        g = ((g << 1) & 0xFEFEFEFE) ^ (hi * 0x1D) ^ wd
    crc = crc.reshape(s, nseg)
    g = g.reshape(s, nseg)
    zcols, alpha = shift_operands(w)
    zc = torch.from_numpy(zcols.astype(np.int64)).to(dev)
    for j in range(zcols.shape[0]):
        crc = _apply_cols_t(zc[j], crc[:, 0::2]) ^ crc[:, 1::2]
        g = _gf_scale4(mt[int(alpha[j])], g[:, 0::2]) ^ g[:, 1::2]
    crc = crc[:, 0] ^ init_term(w)
    true = _apply_cols_t(_i64(mats), crc) ^ _CRC_INIT
    ip = _i64(invp)
    gf = torch.zeros_like(true)
    for lane in range(4):
        b = (g[:, 0] >> (8 * lane)) & 0xFF
        gf |= mt.reshape(-1)[b * 256 + ip[:, lane]] << (8 * lane)
    return _as_u32(torch.stack([true, gf], dim=1))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def _operands(data, mats, invp, lens=None):
    """The operands as tensors (host numpy becomes CPU tensors),
    shape-checked; ``lens`` stays None when not given."""
    def t(x, dtype):
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))
    data, mats, invp = t(data, np.uint8), t(mats, np.uint32), t(invp,
                                                                  np.uint8)
    if lens is not None:
        lens = t(lens, np.int32)
        if tuple(lens.shape) != (data.shape[0],) or lens.dtype not in (
                torch.int32, torch.int64):
            raise ValueError(f"lens must be ({data.shape[0]},) int32")
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError("data must be (S, W) uint8")
    s, w = data.shape
    _check_width(w)
    if w > MAX_WIDTH:
        raise ValueError(f"row width {w} above MAX_WIDTH {MAX_WIDTH}")
    if tuple(mats.shape) != (s, 32) or mats.dtype != torch.uint32:
        raise ValueError(f"mats must be ({s}, 32) uint32")
    if tuple(invp.shape) != (s, 4) or invp.dtype != torch.uint8:
        raise ValueError(f"invp must be ({s}, 4) uint8")
    return data, mats, invp, lens


def _digest_batched(kname: str, data, mats, invp, lens) -> torch.Tensor:
    data, mats, invp, lens = _operands(data, mats, invp, lens)
    s, w = data.shape
    if data.is_cuda:
        from ceph_tpu_torch.ops import digest_cuda

        def run():
            return digest_cuda.scrub_digest(data, mats, invp, lens)
    else:
        def run():
            return scrub_digest_plain(data, mats, invp)
    return telemetry.timed_kernel(
        kname, run, batch=int(s),
        bytes_in=int(s) * int(w) + int(s) * (32 * 4 + 4),
        bytes_out=int(s) * 8, signature=(kname, int(s), int(w)))


def scrub_digest_batched(data, mats, invp, lens=None) -> torch.Tensor:
    """One batched digest call: data (S, W) uint8 zero-padded rows,
    mats/invp from ``digest_operands``, ``lens`` (S,) the rows' lengths
    (optional: every byte of each row past its length is zero, so the
    kernel reads each row only up to its length; without them it reads
    whole rows).  Returns (S, 2) uint32 on the data's device — col 0 crc32
    (== shard_crc of the unpadded row), col 1 the packed GF Horner digest —
    bit-exact with ``scrub_digest_ref``.  A CUDA tensor launches
    ``csrc/digest.cu`` (and raises on a fault); a CPU tensor (or host
    numpy) runs ``scrub_digest_plain`` over the whole padded rows."""
    return _digest_batched("scrub_digest", data, mats, invp, lens)


def bluestore_digest_batched(data, mats, invp, lens=None) -> torch.Tensor:
    """The objectstore's flavor of the batched digest: the same launch of
    the same kernel (one checksum definition for store and scrub), timed
    under the ``bluestore_data`` telemetry family so the store's write and
    read path shows apart from background scrub.  BlueStore's rows are its
    stored payloads: 4 KiB blocks, or compressed bodies shorter than their
    row, whose ``lens`` the kernel reads up to."""
    return _digest_batched("bluestore_data", data, mats, invp, lens)
