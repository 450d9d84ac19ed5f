"""Batched GF(2^8) erasure-code kernels.

The reference's hot loop is ``ec_encode_data(blocksize, k, m, tbls, data, coding)``
(ISA-L, called from src/erasure-code/isa/ErasureCodeIsa.cc:118-130) — a GF(2^8)
matrix-vector product applied independently to every byte column of a stripe, which the
OSD invokes per 4-64 KiB stripe in a loop (src/osd/ECUtil.cc:120-159).  Here that whole
loop is one batched device call.

One kernel serves encode, recovery and the heterogeneous decode:
``gf_matvec(tab, pidx, data, t)`` multiplies each stripe by the matrix of its
pattern ``pidx[s]`` out of a stacked (P, t, k) table.  Encode is P = 1; recovery
is the same product with a recovery matrix (``gf.recovery_matrix``); a decode
batch that mixes erasure patterns is still one launch.  The matrix operand is
the packed-product table (``pack_rows``): one 32-bit word per (pass of four
outputs, input, byte value) holding the four products, built on the host once
per coding matrix (``make_encoder``) or per decode call.

* On a CUDA tensor ``gf_matvec`` launches the hand-written kernel
  (csrc/gf_matvec.cu); it never falls back.
* On a CPU tensor it runs ``gf_matvec_plain``: the same packed lookups as
  torch gathers, XOR-accumulated over the k inputs, split into bytes, and
  chunked over stripes so the gathered index tensor stays bounded.

Decode mirrors the reference's structure (ErasureCodeIsa.cc:150-310): a host-side
inverted k x k sub-matrix, then the same batched product.

Every encode and decode call is timed under ``ops.telemetry`` ("ec_encode",
"ec_decode").  The reference counts jit retraces per call; eager torch
compiles nothing per shape, so the counterpart is the set of distinct launch
signatures each entry point has seen — (kernel instance, stripe count,
trailing shape), ``_jit_entries`` for encode and ``_decode_jit_entries`` for
decode (which adds the pattern table's rows).  The dispatch engine's pow-2
stripe buckets bound both sets by the bucket table.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch._device import resolve
from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.gf.tables import bit_matrix, mul_table
from ceph_tpu_torch.ops import _build, telemetry


# ---------------------------------------------------------------------------
# numpy oracle — ground truth for bit-exactness tests
# ---------------------------------------------------------------------------

def ec_encode_ref(coeff: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Reference GF(2^8) encode on host.

    coeff : (m, k) uint8 coding matrix
    data  : (..., k, B) uint8 data chunks
    returns (..., m, B) uint8 parity chunks
    """
    # analysis: allow[blocking] -- host oracle: inputs are host numpy by contract (fallback/verification path)
    coeff = np.asarray(coeff, dtype=np.uint8)
    # analysis: allow[blocking] -- host oracle: inputs are host numpy by contract (fallback/verification path)
    data = np.asarray(data, dtype=np.uint8)
    mt = mul_table()
    # prods[..., i, j, b] = coeff[i, j] * data[..., j, b]
    prods = mt[coeff[..., :, :, None], data[..., None, :, :]]
    return np.bitwise_xor.reduce(prods, axis=-2)


def ec_decode_ref(tables: np.ndarray, pidx: np.ndarray,
                  data: np.ndarray) -> np.ndarray:
    """Reference heterogeneous-matrix decode on host.

    tables : (P, t, k) uint8 stacked recovery matrices
    pidx   : (S,) integer pattern index per stripe
    data   : (S, k, B) uint8 surviving chunks
    returns (S, t, B) uint8 — stripe i rebuilt with tables[pidx[i]]
    """
    tables = np.asarray(tables, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    mats = tables[np.asarray(pidx)]            # (S, t, k)
    mt = mul_table()
    prods = mt[mats[:, :, :, None], data[:, None, :, :]]  # (S, t, k, B)
    return np.bitwise_xor.reduce(prods, axis=2)


# ---------------------------------------------------------------------------
# table prep
# ---------------------------------------------------------------------------

def decode_bit_table(mats) -> np.ndarray:
    """Stack per-pattern recovery matrices into ``ec_decode_batched``'s table
    operand: [(t, k) uint8, ...] -> (len(mats), k*8, t*8) int8."""
    return np.stack([bit_matrix(np.asarray(m, dtype=np.uint8))
                     for m in mats])


def coeffs_from_bit_table(tables_bits: np.ndarray, k: int,
                          t: int) -> np.ndarray:
    """(P, k*8, t*8) GF(2) bit matrices -> the (P, t, k) GF(2^8) matrices
    they are images of.  Row j*8 of ``bit_matrix(c)`` is the bits of c[:, j]
    times 2^0; raises ValueError if a table is not such an image."""
    w = np.asarray(tables_bits).astype(np.int64)
    if w.ndim != 3 or w.shape[1:] != (k * 8, t * 8):
        raise ValueError(f"tables_bits must be (P, {k * 8}, {t * 8}), "
                         f"got {w.shape}")
    bits = w[:, 0::8, :].reshape(-1, k, t, 8)          # (P, k, t, 8)
    coeffs = np.sum(bits << np.arange(8), axis=-1).transpose(0, 2, 1)
    coeffs = coeffs.astype(np.uint8)
    for p in range(coeffs.shape[0]):
        if not np.array_equal(bit_matrix(coeffs[p]), w[p]):
            raise ValueError(f"tables_bits[{p}] is not the GF(2) image of "
                             "a GF(2^8) matrix")
    return coeffs


def mul_rows(mats: np.ndarray) -> np.ndarray:
    """(P, t, k) GF(2^8) matrices -> (P, t, k, 256) uint8 multiply rows,
    rows[p, i, j, x] = mats[p, i, j] * x."""
    mats = np.asarray(mats, dtype=np.uint8)
    return np.ascontiguousarray(mul_table()[mats[..., None], np.arange(256)])


#: outputs per packed word, one byte each
PACK = 4


def pack_rows(mats: np.ndarray) -> np.ndarray:
    """(P, t, k) GF(2^8) matrices -> the kernel's (P, ceil(t/4), k, 256)
    int32 packed-product table: byte ii of word [p, q, j, x] is
    mats[p, 4q + ii, j] * x, zero past row t."""
    rows = mul_rows(mats).astype(np.uint32)                # (P, t, k, 256)
    p, t, k, _ = rows.shape
    nq = -(-t // PACK)
    full = np.zeros((p, nq * PACK, k, 256), dtype=np.uint32)
    full[:, :t] = rows
    shifts = (8 * np.arange(PACK, dtype=np.uint32))[None, None, :, None, None]
    packed = np.bitwise_or.reduce(
        full.reshape(p, nq, PACK, k, 256) << shifts, axis=2)
    return np.ascontiguousarray(packed).view(np.int32)


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------

#: elements of the gathered (stripes, t, B) outputs per plain chunk
_PLAIN_CHUNK = 1 << 22

#: bytes of packed table one launch may hold: the kernel keeps its whole
#: table in shared memory, at most 227 KiB a block on the H100
TABLE_LIMIT = 227 * 1024


def gf_matvec_plain(tab: torch.Tensor, pidx: torch.Tensor,
                    data: torch.Tensor, t: int) -> torch.Tensor:
    """The kernel's function in torch: (P, ceil(t/4), k, 256) int32 packed
    table, (S,) pattern indices, (S, k, B) uint8 data -> (S, t, B) uint8."""
    _, nq, k, _ = tab.shape
    s, _, b = data.shape
    out = torch.empty((s, t, b), dtype=torch.uint8, device=data.device)
    shifts = 8 * torch.arange(PACK, device=data.device)[None, None, :, None]
    step = max(1, _PLAIN_CHUNK // max(1, t * b))
    for lo in range(0, s, step):
        hi = min(s, lo + step)
        tb = tab[pidx[lo:hi].long()]                      # (cs, nq, k, 256)
        acc = torch.zeros((hi - lo, nq, b), dtype=torch.int32,
                          device=data.device)
        for j in range(k):
            idx = data[lo:hi, j].long()[:, None, :].expand(-1, nq, -1)
            acc ^= torch.gather(tb[:, :, j, :], 2, idx)
        outs = (acc[:, :, None, :] >> shifts) & 0xFF      # (cs, nq, 4, B)
        out[lo:hi] = outs.reshape(hi - lo, nq * PACK, b)[:, :t]
    return out


def gf_matvec(tab: torch.Tensor, pidx: torch.Tensor, data: torch.Tensor,
              t: int) -> torch.Tensor:
    """Per-stripe GF(2^8) matrix product: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.

    tab  : (P, ceil(t/4), k, 256) int32 packed-product table (``pack_rows``)
    pidx : (S,) int32 pattern index per stripe, each in [0, P)
    data : (S, k, B) uint8
    t    : outputs per stripe
    returns (S, t, B) uint8
    """
    if data.dtype != torch.uint8 or data.dim() != 3:
        raise ValueError("data must be (S, k, B) uint8")
    if tab.dtype != torch.int32 or tab.dim() != 4 or tab.shape[3] != 256:
        raise ValueError("tab must be (P, ceil(t/4), k, 256) int32")
    s, k, b = data.shape
    _, nq, tk, _ = tab.shape
    if tk != k:
        raise ValueError(f"tab is for k={tk}, data has k={k}")
    if nq != -(-t // PACK):
        raise ValueError(f"tab holds {nq} passes of {PACK}, t={t}")
    if pidx.shape != (s,):
        raise ValueError(f"pidx must be ({s},), got {tuple(pidx.shape)}")
    if not data.is_cuda:
        return gf_matvec_plain(tab, pidx, data, t)
    if nq * k * PACK * 256 > TABLE_LIMIT:
        raise ValueError(f"{nq * k} KiB of packed table exceed shared memory")
    if not (tab.is_cuda and pidx.is_cuda):
        raise ValueError("tab, pidx and data must all lie on the card")
    data = data.contiguous()
    tab = tab.contiguous()
    pidx = pidx.to(torch.int32).contiguous()
    out = torch.empty((s, t, b), dtype=torch.uint8, device=data.device)
    if s == 0 or b == 0 or t == 0:
        return out
    _build.launch("gf_matvec", "gf_matvec_launch",
                  data.data_ptr(), tab.data_ptr(), pidx.data_ptr(),
                  out.data_ptr(), s, k, t, b)
    return out


# ---------------------------------------------------------------------------
# launch signatures (the reference's jit compile-cache counts)
# ---------------------------------------------------------------------------

_SIG_LOCK = lockdep.make_lock("gf_kernel::signatures")
_ENCODE_SIGS: set = set()
_DECODE_SIGS: set = set()


def _instance(k: int) -> str:
    """The kernel instance a launch of k inputs runs (csrc/gf_matvec.cu:
    a template instance for k = 8, a run-time-k loop otherwise)."""
    return "gf_matvec<8>" if k == 8 else "gf_matvec<0>"


def _note(sigs: set, sig) -> None:
    with _SIG_LOCK:
        sigs.add(sig)


def _jit_entries() -> int:
    """Distinct encode launch signatures seen by this process — the
    telemetry miss counter differences this around each call."""
    with _SIG_LOCK:
        return len(_ENCODE_SIGS)


def _decode_jit_entries() -> int:
    """Distinct decode launch signatures (kept separate from
    _jit_entries so encode-side accounting is untouched)."""
    with _SIG_LOCK:
        return len(_DECODE_SIGS)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _as_u8(data, device: torch.device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8:
            raise ValueError(f"data must be uint8, got {data.dtype}")
        return data.to(device)
    return torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8)
                            ).to(device)


def cut_tables(coeff: np.ndarray, device: torch.device,
               table_limit: int | None = None) -> list:
    """The packed tables of the (t, k) matrix ``coeff`` on ``device``, each
    at most ``table_limit`` bytes (``TABLE_LIMIT`` by default):
    [(r0, r1, [(j0, j1, table), ...]), ...], a group of rows [r0, r1) and,
    in it, a table per group of inputs [j0, j1).  A group takes all k
    inputs and as many passes of four rows as fit, or, where k alone is
    over the limit, one pass and as many inputs as fit."""
    coeff = np.asarray(coeff, dtype=np.uint8)
    t, k = coeff.shape
    kib = (TABLE_LIMIT if table_limit is None else table_limit) // 1024
    if kib < 1:
        raise ValueError("table_limit must be at least 1 KiB")
    inputs = min(k, kib)
    rows = max(1, min(t, PACK * (kib // inputs)))
    return [(r0, min(t, r0 + rows),
             [(j0, min(k, j0 + inputs), torch.from_numpy(pack_rows(
                 coeff[None, r0:r0 + rows, j0:j0 + inputs])).to(device))
              for j0 in range(0, k, inputs)])
            for r0 in range(0, max(t, 1), rows)]


def apply_tables(groups: list, data: torch.Tensor, t: int,
                 matvec=None) -> torch.Tensor:
    """(S, k, B) uint8 data times the matrix ``cut_tables`` cut into
    ``groups`` -> (S, t, B): one ``matvec`` call (``gf_matvec`` by default;
    its plain version, say) per table, a group's partial products over its
    inputs XOR-accumulated into its rows of the output."""
    matvec = matvec or gf_matvec
    pidx = torch.zeros((data.shape[0],), dtype=torch.int32,
                       device=data.device)
    if len(groups) == 1 and len(groups[0][2]) == 1:
        return matvec(groups[0][2][0][2], pidx, data, t)
    out = torch.empty((data.shape[0], t, data.shape[2]), dtype=torch.uint8,
                      device=data.device)
    for r0, r1, parts in groups:
        for i, (j0, j1, tab) in enumerate(parts):
            part = matvec(tab, pidx, data if len(parts) == 1
                          else data[:, j0:j1], r1 - r0)
            if i == 0:
                out[:, r0:r1] = part
            else:
                out[:, r0:r1] ^= part
    return out


def make_encoder(coeff: np.ndarray, device=None, *,
                 table_limit: int | None = None):
    """Return encode(data (S, k, B) uint8) -> (S, t, B) uint8 with the
    packed-product tables of the (t, k) matrix ``coeff`` resident on
    ``device`` (the card by default).  ``coeff`` is a coding matrix, or a
    recovery matrix, which makes the same call a recovery.

    A matrix whose packed table exceeds ``table_limit`` bytes is cut above
    the kernel (``cut_tables``): groups of rows, a launch each, and where k
    alone is over the limit also groups of inputs, whose partial products
    are XOR-accumulated into the output.  Every group goes through
    ``gf_matvec``."""
    dev = resolve(device)
    coeff = np.asarray(coeff, dtype=np.uint8)
    t, k = coeff.shape
    groups = cut_tables(coeff, dev, table_limit)

    def encode(data) -> torch.Tensor:
        d = _as_u8(data, dev)
        if d.dim() != 3 or d.shape[1] != k:
            raise ValueError(f"data must be (S, {k}, B), got "
                             f"{tuple(d.shape)}")
        s, _, b = d.shape

        def run():
            _note(_ENCODE_SIGS, (_instance(k), s, k, t, b))
            return apply_tables(groups, d, t)

        return telemetry.timed_kernel(
            "ec_encode", run, batch=s, bytes_in=s * k * b,
            bytes_out=s * t * b, cache_entries=_jit_entries,
            signature=("ec", k, t, s, b))

    return encode


def ec_encode(coeff: np.ndarray, data, device=None, *,
              table_limit: int | None = None) -> torch.Tensor:
    """One-shot GF(2^8) product: (t, k) uint8 matrix, (S, k, B) or (k, B)
    uint8 data -> (S, t, B) or (t, B) uint8 on ``device`` (the card by
    default).  Builds and uploads the tables each call (``make_encoder``
    keeps them resident); cuts them to ``table_limit`` as it does."""
    encode = make_encoder(coeff, device, table_limit=table_limit)
    squeeze = (data.dim() if isinstance(data, torch.Tensor)
               else np.ndim(data)) == 2
    out = encode(data[None] if squeeze else data)
    return out[0] if squeeze else out


def ec_decode_packed(tab: torch.Tensor, pidx: torch.Tensor,
                     data: torch.Tensor, t: int) -> torch.Tensor:
    """Heterogeneous-matrix decode with a resident packed table: one
    ``gf_matvec`` launch for stripes spanning MIXED erasure patterns.

    tab  : (P, ceil(t/4), k, 256) int32 packed table on data's device
           (``pack_rows`` of the stacked (P, t, k) recovery matrices; P
           pow-2 padded by the caller so the signatures stay bounded by
           the table bucket, not the pattern population)
    pidx : (S,) int pattern index per stripe
    data : (S, k, B) uint8 surviving chunks
    returns (S, t, B) uint8 (padded target rows are zeros).
    """
    s, k, b = data.shape
    p = tab.shape[0]

    def run():
        _note(_DECODE_SIGS, (_instance(k), p, s, k, t, b))
        return gf_matvec(tab, pidx, data, t)

    # the table operand is device-resident across calls (the codec
    # caches it per snapshot), so only the per-call operands count as
    # h2d traffic
    return telemetry.timed_kernel(
        "ec_decode", run, batch=s, bytes_in=s * k * b + s * 4,
        bytes_out=s * t * b, cache_entries=_decode_jit_entries,
        signature=("ec_decode", k, t, s, b, p))


def ec_decode_batched(tables_bits: np.ndarray, pidx, data, *,
                      k: int, t: int, device=None) -> torch.Tensor:
    """Heterogeneous-matrix batched decode: one device call for stripes
    spanning MIXED erasure patterns.

    tables_bits : (P, k*8, t*8) — stacked bit matrices (decode_bit_table)
    pidx        : (S,) int — pattern index per stripe
    data        : (S, k, B) uint8 surviving chunks
    returns (S, t, B) uint8 (padded target rows are zeros).
    """
    dev = resolve(device)
    coeffs = coeffs_from_bit_table(tables_bits, k, t)
    pidx_np = np.asarray(pidx.cpu() if isinstance(pidx, torch.Tensor)
                         else pidx).astype(np.int64)
    if pidx_np.size and (pidx_np.min() < 0
                         or pidx_np.max() >= coeffs.shape[0]):
        raise ValueError("pattern index out of range of the table")
    tab = torch.from_numpy(pack_rows(coeffs)).to(dev)
    pidx_t = torch.from_numpy(pidx_np.astype(np.int32)).to(dev)
    return ec_decode_packed(tab, pidx_t, _as_u8(data, dev), t)
