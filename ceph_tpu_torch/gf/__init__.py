"""GF(2^8) algebra over the polynomial 0x11d (x^8 + x^4 + x^3 + x^2 + 1).

This is the finite field used by the reference's erasure-code plugins (ISA-L's
ec_base and gf-complete's w=8 default both use 0x11d).  Everything here is host-side
numpy: table construction, matrix generators, and Gauss-Jordan inversion.  The device
kernels in ceph_tpu_torch.ops consume the tables produced here.
"""

from .tables import (
    GF_POLY,
    gf_exp,
    gf_log,
    gf_mul,
    gf_div,
    gf_inv,
    gf_pow,
    mul_table,
    bit_matrix,
)
from .matrix import (
    gen_cauchy1_matrix,
    gen_rs_vandermonde_matrix,
    gf_matmul,
    gf_invert_matrix,
    recovery_matrix,
)

__all__ = [
    "GF_POLY",
    "gf_exp",
    "gf_log",
    "gf_mul",
    "gf_div",
    "gf_inv",
    "gf_pow",
    "mul_table",
    "bit_matrix",
    "gen_cauchy1_matrix",
    "gen_rs_vandermonde_matrix",
    "gf_matmul",
    "gf_invert_matrix",
    "recovery_matrix",
]
