"""Fixed-point log tables for straw2 (crush_ln).

The straw2 draw is ``crush_ln(hash & 0xffff) - 2^48`` divided by the 16.16 item
weight (src/crush/mapper.c:334-359), where crush_ln computes 2^44*log2(x+1) via two
table lookups (mapper.c:248-290).  The tables (src/crush/crush_ln_table.h) are
*protocol constants*: every Ceph client/OSD/kernel on earth evaluates placement with
exactly these values, so bit-identical placement requires bit-identical tables.

Their defining math (documented in the reference header) is:

    RH_LH[2k]   = 2^48 / (1 + k/128)        (reciprocal, k = 0..128)
    RH_LH[2k+1] = 2^48 * log2(1 + k/128)
    LL[k]       = 2^48 * log2(1 + k/2^15)   (k = 0..255)

We generate the tables from that math (verified rounding: RH is ceiling, LH/LL are
floor) — but the historically shipped tables deviate from the math in frozen,
load-bearing ways that changed placement forever once deployed:

* LH[128] shipped as 0xffff00000000 instead of 2^48.
* 212 of the 256 LL entries shipped with a constant excess of 0x147700000
  (an artifact of whatever generator produced them; ~0.44 LSB of the input scale);
  21 entries are exact; 23 entries hold unrelated stray values.

The deviations are reproduced here as explicit override data with the indices spelled
out, because matching deployed-placement behaviour requires them.  (The tables
and the full 16-bit crush_ln domain are pinned by tests/golden/crush_golden.npz,
checked in tests/test_torch_crush.py.)
"""

from __future__ import annotations

import functools
from decimal import Decimal, localcontext

import numpy as np

_LL_EXCESS = 0x147700000

# LL indices whose shipped value is the exact floor (no excess).
_LL_EXACT = frozenset(
    [0, 1, 203, 216, 222, 233, 237, 238, 239, 243, 244, 245, 246, 248, 249,
     250, 251, 252, 253, 254, 255]
)

# LL indices whose shipped value is neither floor nor floor+excess: frozen strays.
_LL_STRAY = {
    56: 0xA2B07F3458, 127: 0x16DF6CA19BD, 134: 0x182B07F3458,
    181: 0x209C06E6212, 184: 0x212B07F3458, 188: 0x21D6A73A78F,
    193: 0x22C23679B4E, 198: 0x23A2C3B0EA4, 199: 0x23D13EE805B,
    200: 0x24035E9221F, 207: 0x25492644D65, 210: 0x25D13EE805B,
    212: 0x26296453882, 225: 0x287BDBF5255, 227: 0x28D13EE805B,
    228: 0x29035E9221F, 229: 0x29296453882, 231: 0x29902A37AAB,
    235: 0x2A4C7605D61, 236: 0x2A7BDBF5255, 240: 0x2B296453882,
    241: 0x2B5D022D80F, 247: 0x2C61A5E8F4C,
}

_LH_128 = 0xFFFF00000000  # shipped value; the math gives 2^48


def _floor_log2_scaled(num: int, den: int) -> int:
    """floor(2^48 * log2(num/den)) with enough precision to round correctly."""
    with localcontext() as ctx:
        ctx.prec = 60
        val = (Decimal(num) / Decimal(den)).ln() / Decimal(2).ln()
        return int((val * (1 << 48)).to_integral_value(rounding="ROUND_FLOOR"))


@functools.lru_cache(maxsize=None)
def _tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rh = np.zeros(129, dtype=np.int64)
    lh = np.zeros(129, dtype=np.int64)
    for k in range(129):
        # ceil(2^48 * 128 / (128 + k))
        num, den = (1 << 48) * 128, 128 + k
        rh[k] = -((-num) // den)
        lh[k] = _floor_log2_scaled(128 + k, 128)
    lh[128] = _LH_128
    ll = np.zeros(256, dtype=np.int64)
    for k in range(256):
        if k in _LL_STRAY:
            ll[k] = _LL_STRAY[k]
        else:
            base = _floor_log2_scaled((1 << 15) + k, 1 << 15)
            ll[k] = base if k in _LL_EXACT else base + _LL_EXCESS
    for t in (rh, lh, ll):
        t.flags.writeable = False
    return rh, lh, ll


def rh_table() -> np.ndarray:
    """RH[k] = reciprocal entries, k = 0..128 (int64, read-only)."""
    return _tables()[0]


def lh_table() -> np.ndarray:
    """LH[k] = 2^48*log2(1+k/128) entries, k = 0..128 (int64, read-only)."""
    return _tables()[1]


def ll_table() -> np.ndarray:
    """LL[k] = 2^48*log2(1+k/2^15) entries, k = 0..255 (int64, read-only)."""
    return _tables()[2]
