"""isa-family plugin (Intel ISA-L semantics, executed on the card).

The reference's isa plugin (src/erasure-code/isa/ErasureCodeIsa.{h,cc}) wraps
ISA-L's `ec_encode_data` with two matrix flavours and caches decode tables.
Here the matrices come from ceph_tpu_torch.gf.matrix (same constructions
ISA-L's gf_gen_rs_matrix / gf_gen_cauchy1_matrix publish) and encode/decode
lower to the batched GF(2^8) product via the ErasureCode base, whose
recovery-matrix cache plays the role of ErasureCodeIsaTableCache (327 LoC of
mutex-guarded LRU in the reference).

Matrix guard: the reference restricts Vandermonde to k <= 32 and m <= 4, where
that construction is known MDS, and silently switches m > 4 requests to Cauchy
(ErasureCodeIsa.cc:330-361); mirrored here.
"""

from __future__ import annotations

from ceph_tpu_torch.gf.matrix import (
    gen_cauchy1_matrix, gen_rs_vandermonde_matrix)

from .base import ErasureCode
from .registry import register


class ErasureCodeIsaDefault(ErasureCode):
    """technique= reed_sol_van (default) or cauchy."""

    def _default_k(self) -> int:
        return 7

    def _default_m(self) -> int:
        return 3

    def parse(self, profile):
        super().parse(profile)
        self.technique = profile.get("technique", "reed_sol_van")
        if self.technique not in ("reed_sol_van", "cauchy"):
            raise ValueError(
                f"isa technique {self.technique!r} unknown; "
                f"known: ['reed_sol_van', 'cauchy']")
        if self.technique == "reed_sol_van":
            if self.m > 4:
                # reference behaviour: fall back to cauchy beyond the proven-
                # MDS region rather than erroring (ErasureCodeIsa.cc:330-361)
                self.technique = "cauchy"
            elif self.k > 32:
                raise ValueError(
                    f"isa reed_sol_van requires k <= 32, got k={self.k}")

    def _build_generator(self):
        if self.technique == "cauchy":
            return gen_cauchy1_matrix(self.k, self.m)
        return gen_rs_vandermonde_matrix(self.k, self.m)


register("isa", lambda profile: ErasureCodeIsaDefault())
