"""Batched GF(2^8) erasure-code kernels.

The reference's hot loop is ``ec_encode_data(blocksize, k, m, tbls, data, coding)``
(ISA-L, called from src/erasure-code/isa/ErasureCodeIsa.cc:118-130) — a GF(2^8)
matrix-vector product applied independently to every byte column of a stripe, which the
OSD invokes per 4-64 KiB stripe in a loop (src/osd/ECUtil.cc:120-159).  Here that whole
loop is one batched device call.

One kernel serves encode, recovery and the heterogeneous decode:
``gf_matvec(rows, pidx, data)`` multiplies each stripe by the matrix of its
pattern ``pidx[s]`` out of a stacked (P, t, k) table.  Encode is P = 1; recovery
is the same product with a recovery matrix (``gf.recovery_matrix``); a decode
batch that mixes erasure patterns is still one launch.  The matrix operand is
the multiply rows ``rows[p, i, j, x] = M_p[i, j] * x`` (``mul_rows``).

* On a CUDA tensor ``gf_matvec`` launches the hand-written kernel
  (csrc/gf_matvec.cu); it never falls back.
* On a CPU tensor it runs ``gf_matvec_plain``: the same table lookups as torch
  gathers, XOR-accumulated over the k inputs and chunked over stripes so the
  gathered (stripes, t, B) index tensor stays bounded.

Decode mirrors the reference's structure (ErasureCodeIsa.cc:150-310): a host-side
inverted k x k sub-matrix, then the same batched product.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch._device import resolve
from ceph_tpu_torch.gf.tables import bit_matrix, mul_table
from ceph_tpu_torch.ops import _build


# ---------------------------------------------------------------------------
# numpy oracle — ground truth for bit-exactness tests
# ---------------------------------------------------------------------------

def ec_encode_ref(coeff: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Reference GF(2^8) encode on host.

    coeff : (m, k) uint8 coding matrix
    data  : (..., k, B) uint8 data chunks
    returns (..., m, B) uint8 parity chunks
    """
    coeff = np.asarray(coeff, dtype=np.uint8)
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
    rows[p, i, j, x] = mats[p, i, j] * x: the kernel's table operand."""
    mats = np.asarray(mats, dtype=np.uint8)
    return np.ascontiguousarray(mul_table()[mats[..., None], np.arange(256)])


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------

#: elements of the gathered (stripes, t, B) index tensor per plain chunk
_PLAIN_CHUNK = 1 << 22


def gf_matvec_plain(rows: torch.Tensor, pidx: torch.Tensor,
                    data: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch: (P, t, k, 256) rows, (S,) pattern
    indices, (S, k, B) uint8 data -> (S, t, B) uint8."""
    _, t, k, _ = rows.shape
    s, _, b = data.shape
    out = torch.empty((s, t, b), dtype=torch.uint8, device=data.device)
    step = max(1, _PLAIN_CHUNK // max(1, t * b))
    for lo in range(0, s, step):
        hi = min(s, lo + step)
        tab = rows[pidx[lo:hi].long()]                    # (cs, t, k, 256)
        acc = torch.zeros((hi - lo, t, b), dtype=torch.uint8,
                          device=data.device)
        for j in range(k):
            idx = data[lo:hi, j].long()[:, None, :].expand(-1, t, -1)
            acc ^= torch.gather(tab[:, :, j, :], 2, idx)
        out[lo:hi] = acc
    return out


def gf_matvec(rows: torch.Tensor, pidx: torch.Tensor,
              data: torch.Tensor) -> torch.Tensor:
    """Per-stripe GF(2^8) matrix product: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.

    rows : (P, t, k, 256) uint8 multiply rows (``mul_rows``)
    pidx : (S,) int32 pattern index per stripe, each in [0, P)
    data : (S, k, B) uint8
    returns (S, t, B) uint8
    """
    if data.dtype != torch.uint8 or data.dim() != 3:
        raise ValueError("data must be (S, k, B) uint8")
    if rows.dtype != torch.uint8 or rows.dim() != 4 or rows.shape[3] != 256:
        raise ValueError("rows must be (P, t, k, 256) uint8")
    s, k, b = data.shape
    p, t, rk, _ = rows.shape
    if rk != k:
        raise ValueError(f"rows are for k={rk}, data has k={k}")
    if pidx.shape != (s,):
        raise ValueError(f"pidx must be ({s},), got {tuple(pidx.shape)}")
    if not data.is_cuda:
        return gf_matvec_plain(rows, pidx, data)
    if t * k * 256 > 227 * 1024:
        raise ValueError(f"t*k={t * k} multiply rows exceed shared memory")
    if not (rows.is_cuda and pidx.is_cuda):
        raise ValueError("rows, pidx and data must all lie on the card")
    data = data.contiguous()
    rows = rows.contiguous()
    pidx = pidx.to(torch.int32).contiguous()
    out = torch.empty((s, t, b), dtype=torch.uint8, device=data.device)
    if s == 0 or b == 0 or t == 0:
        return out
    vec = int(b % 16 == 0 and data.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    _build.launch("gf_matvec", "gf_matvec_launch",
                  data.data_ptr(), rows.data_ptr(), pidx.data_ptr(),
                  out.data_ptr(), s, k, t, b, vec)
    return out


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


def make_encoder(coeff: np.ndarray, device=None):
    """Return encode(data (S, k, B) uint8) -> (S, m, B) uint8 with the coding
    matrix's multiply rows resident on ``device`` (the card by default).
    ``coeff`` is the (m, k) coding matrix — or a (t, k) recovery matrix,
    which makes the same call a recovery."""
    dev = resolve(device)
    coeff = np.asarray(coeff, dtype=np.uint8)
    rows = torch.from_numpy(mul_rows(coeff[None])).to(dev)

    def encode(data) -> torch.Tensor:
        d = _as_u8(data, dev)
        pidx = torch.zeros((d.shape[0],), dtype=torch.int32, device=dev)
        return gf_matvec(rows, pidx, d)

    return encode


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
    rows = torch.from_numpy(mul_rows(coeffs)).to(dev)
    pidx_t = torch.from_numpy(pidx_np.astype(np.int32)).to(dev)
    return gf_matvec(rows, pidx_t, _as_u8(data, dev))
