"""The approx-filter root of the CRUSH fast path: f32 ln table, its certified
bound, and the plain torch version of the filter kernel.

The counterpart of the approx-filter half of ceph_tpu/ops/straw2_u32.py
(``_ln_f32_error_bound``, ``straw2_choose_index_approx``) and of
ceph_tpu/ops/pallas_straw2.py's ``_ln_f32_bound`` and ``_froot_kernel``:

  ln_f32_table(device)  (65536,) f32 2^44*log2(u+1); on the card from
                        csrc/straw2_filter.cu ln_f32_table
  ln_f32_bound(device)  D = max |table - f32(crush_ln(u))|, on the card
                        reduced by the same launch that writes the table
  ln_f32_table_plain    the plain version of that launch: torch.log2 and
                        the bound reduced in torch (ln_bound_plain)
  froot_columns_plain   the plain version of csrc/straw2_filter.cu
                        straw2_froot (CudaColumns.froot_columns launches it)

The filter prices every root item with an f32 quotient and a band that holds
the exact one, keeps the K = 4 items of least lower end, and verifies them
exactly; a flag per x says that more than K items fell inside the band, and
the caller (crush.fastpath) then re-runs the exact root kernel.  The
certificate holds only if D is measured with the same f32 log the filter
runs: on the card the table comes from the kernel that shares the filter's
log2f, on the CPU from ``torch.log2``, and the plain version reads its ln
values from that table.  The TPU's u32-limb crush_ln and magic division are
not ported: the card divides in u64.
"""

from __future__ import annotations

import functools

import torch

from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops.crush_kernel import crush_ln, hash32_3, ln_tables, \
    straw2_draws

#: candidates verified exactly per (x, r)
K = 4
#: the TPU kernel's lane pack per column: R columns fit one 128-lane block
#: when R * KPACK <= 128.  The port keeps the JAX gate on it
#: (crush.fastpath) so that the same batches take the same branch
KPACK = 8

_TWO_48 = float(2 ** 48)
_BIG = 3.0e38


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def ln_bound_plain(table: torch.Tensor) -> torch.Tensor:
    """max |table - crush_ln(u)| over every 16-bit u, as a 0-d f32 tensor
    on the table's device: crush_ln rounded to f32, the gaps and their
    maximum in f32, as pallas_straw2._ln_f32_bound reduces them."""
    exact = crush_ln(torch.arange(65536, device=table.device)
                     ).to(torch.float32)
    return (table - exact).abs().max()


def ln_f32_table_plain(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the ln_f32_table kernel: the (65536,) f32
    table from torch.log2 and its bound D (0-d f32)."""
    u = torch.arange(65536, dtype=torch.float32, device=device)
    table = torch.log2(u + 1.0) * torch.tensor(2.0 ** 44)
    return table, ln_bound_plain(table)


@functools.lru_cache(maxsize=None)
def _table(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(table, D) on ``device``: on the card one ln_f32_table launch writes
    both, D as the bit pattern of an f32 in an int32 word."""
    if device.type != "cuda":
        return ln_f32_table_plain(device)
    out = torch.empty((65536,), dtype=torch.float32, device=device)
    d_bits = torch.empty((1,), dtype=torch.int32, device=device)
    ln_tab = torch.cat(ln_tables(device)).contiguous()
    with torch.cuda.device(device):
        _build.launch("ln_f32_table", "ln_f32_table_launch",
                      ln_tab.data_ptr(), out.data_ptr(), d_bits.data_ptr(),
                      65536)
    return out, d_bits.view(torch.float32)[0]


def ln_f32_table(device) -> torch.Tensor:
    """The (65536,) f32 values 2^44*log2(u+1) on ``device``: from the
    ln_f32_table kernel on the card (one launch per device and process),
    from torch.log2 on the CPU."""
    return _table(_key(device))[0]


@functools.lru_cache(maxsize=None)
def _bound(device: torch.device) -> float:
    return float(_table(device)[1])


def ln_f32_bound(device) -> float:
    """The certificate's D: max |ln_f32_table(device) - crush_ln(u)| over
    every 16-bit u, reduced in f32 as pallas_straw2._ln_f32_bound does; on
    the card the table's own launch reduces it (one sync to read it)."""
    return _bound(_key(device))


def froot_columns_plain(xs: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                        R: int, table: torch.Tensor, D: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xs (N,) u32 in int64; ids (S,) int32; w (S,) int64 -> (pos, ids)
    each (R, N) int32 and the (N,) int32 flag: the straw2 winner among the
    K items of least band lower end, and 1 where some column had more than
    K items inside the band (the winner is then not certified)."""
    n, S = xs.shape[0], ids.shape[0]
    dev = xs.device
    f32 = torch.float32
    w = w.to(torch.int64)
    wz = w <= 0
    wf = w.clamp(min=1).to(f32)
    mbase = (torch.tensor(D, dtype=f32) + torch.tensor(2.0 ** 25, dtype=f32)
             ).to(dev) / wf                                   # (S,)
    k = min(K, S)
    pos_cols, id_cols = [], []
    ovf = torch.zeros((n,), dtype=torch.bool, device=dev)
    for r in range(R):
        rv = torch.full_like(xs, r)
        u = hash32_3(xs[:, None], ids, rv[:, None]) & 0xFFFF     # (N, S)
        q = (torch.tensor(_TWO_48, dtype=f32, device=dev) - table[u]) / wf
        m = (mbase + q * torch.tensor(2.0 ** -20, dtype=f32, device=dev)) \
            + torch.tensor(4.0, dtype=f32, device=dev)
        q = torch.where(wz, torch.tensor(_BIG, dtype=f32, device=dev), q)
        m = torch.where(wz, torch.tensor(0.0, dtype=f32, device=dev), m)
        lo, hi = q - m, q + m
        min_hi = hi.min(dim=1).values
        lo_sorted, order = torch.sort(lo, dim=1, stable=True)
        if S > K:
            ovf |= lo_sorted[:, K] <= min_hi
        # the K candidates in position order, so that the first maximal
        # exact draw is the first minimum by (quotient, position)
        cand = order[:, :k].sort(dim=1).values                  # (N, k)
        draws = straw2_draws(xs, ids.to(torch.int64)[cand], rv, w[cand])
        best = torch.gather(cand, 1, draws.argmax(dim=1, keepdim=True))[:, 0]
        pos_cols.append(best)
        id_cols.append(ids[best])
    pos = torch.stack(pos_cols).to(torch.int32)
    return pos, torch.stack(id_cols).to(torch.int32), ovf.to(torch.int32)
