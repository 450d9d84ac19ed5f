"""SHEC — Shingled Erasure Code plugin (src/erasure-code/shec/ analog).

Profile (k, m, c): k data chunks, m local parities, durability goal c.
Each parity covers a sliding window ("shingle") of l = ceil(k*c/m) data
chunks, the windows overlapping around the ring so a SINGLE failure is
repaired from one window — l chunk reads instead of k, the
recovery-bandwidth trade SHEC exists for (ErasureCodeShec.cc).

Window coefficients come from a Cauchy construction restricted to the
window, so any square subsystem drawn from full windows is invertible.
SHEC is not MDS: decode solves the surviving parity equations for ALL
erased data chunks by GF(2^8) Gauss-Jordan and reports cleanly when a
pattern is unrecoverable; erased parities are then re-encoded from the
restored data.  minimum_to_decode prefers the smallest covering window
(ErasureCodeShec::minimum_to_decode semantics: cheapest recovery set).

The batched compute path is shared with every other plugin: encode is
the (S, k, B) GF(2^8) product (the generator simply has zeros outside the
windows), decode multiplies by the solved recovery matrix — on the cuda
runtime one launch with one stripe, then an explicit copy to the host.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np

from ceph_tpu_torch.gf.tables import gf_inv, gf_mul, mul_table

from .base import ErasureCode, to_host
from .interface import ErasureCodeProfile
from .registry import register


def _mul_vec(coef: int, arr: np.ndarray) -> np.ndarray:
    """scalar * vector over GF(2^8), one table-row gather."""
    return mul_table()[coef][arr]


def _gf_solve(a: np.ndarray, b: np.ndarray):
    """Gauss-Jordan over GF(2^8): solve a x = b; None if singular.
    a (n, n), b (n, w) uint8."""
    n = a.shape[0]
    a = a.astype(np.int64).copy()
    b = b.astype(np.int64).copy()
    for col in range(n):
        piv = None
        for row in range(col, n):
            if a[row, col]:
                piv = row
                break
        if piv is None:
            return None
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            b[[col, piv]] = b[[piv, col]]
        inv = gf_inv(int(a[col, col]))
        a[col] = [gf_mul(int(v), inv) for v in a[col]]
        b[col] = [gf_mul(int(v), inv) for v in b[col]]
        for row in range(n):
            if row != col and a[row, col]:
                f = int(a[row, col])
                a[row] ^= np.array([gf_mul(int(v), f) for v in a[col]],
                                   dtype=np.int64)
                b[row] ^= np.array([gf_mul(int(v), f) for v in b[col]],
                                   dtype=np.int64)
    return b.astype(np.uint8)


class ErasureCodeShec(ErasureCode):
    _PROFILE_KEYS = ErasureCode._PROFILE_KEYS + ("c",)

    supports_rmw_striping = False

    def __init__(self):
        super().__init__()
        self.c = 0
        #: (frozenset targets, frozenset available) -> recovery plan;
        #: the combinatorial search must not re-run per degraded read
        #: (_decode_cache pattern, base.py)
        self._plan_cache: dict = {}

    def _default_k(self) -> int:
        return 4

    def _default_m(self) -> int:
        return 3

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.c = self.to_int("c", profile, 2)
        if not (1 <= self.c <= self.m <= self.k):
            raise ValueError(
                f"shec requires 1 <= c={self.c} <= m={self.m} <= k={self.k}")

    # -- shingle geometry -----------------------------------------------------

    def window(self, j: int) -> list[int]:
        """Data chunks covered by parity j (the j-th shingle)."""
        k, m, c = self.k, self.m, self.c
        length = -(-k * c // m)             # ceil(k*c/m): shingle width
        start = (j * k) // m
        return [(start + i) % k for i in range(length)]

    def _build_generator(self) -> np.ndarray:
        k, m = self.k, self.m
        g = np.zeros((k + m, k), dtype=np.uint8)
        g[:k] = np.eye(k, dtype=np.uint8)
        # Cauchy coefficients 1/(x_j ^ y_i) with disjoint supports: every
        # square submatrix of a Cauchy matrix is invertible, which keeps
        # overlapping-window systems solvable whenever ranks allow
        for j in range(m):
            for i in self.window(j):
                g[k + j, i] = gf_inv((k + j) ^ 255 ^ i)
        return g

    # -- recovery planning ----------------------------------------------------

    def _recovery_plan(self, target_data: set, available: set):
        """(rows, unknowns, rmat): chunks to read (`rows`, in order) and
        the GF matrix mapping them to sorted(unknowns), where unknowns
        is the smallest erased-data set covering `target_data` that the
        chosen parity equations close over; None if unrecoverable.

        Every erased data chunk REFERENCED by a selected parity is an
        unknown — equations are never used "partially" (dropping erased
        terms corrupts output) — but erased chunks outside all selected
        windows stay out of the system entirely, which is what makes
        single-window local repair possible.
        """
        targets = sorted(target_data)
        if not targets:
            return [], [], np.zeros((0, 0), dtype=np.uint8)
        cache_key = (frozenset(targets), frozenset(available))
        if cache_key in self._plan_cache:
            return self._plan_cache[cache_key]
        if len(self._plan_cache) > 256:
            self._plan_cache.clear()
        g = self.generator
        erased_data = {i for i in range(self.k) if i not in available}
        parities = [p for p in sorted(available) if p >= self.k]
        for n_par in range(1, len(parities) + 1):
            for combo in combinations(parities, n_par):
                unknowns = sorted(
                    {d for p in combo for d in self.window(p - self.k)
                     if d in erased_data} | set(targets))
                if len(combo) < len(unknowns):
                    continue
                a = np.array([[g[p, d] for d in unknowns] for p in combo],
                             dtype=np.uint8)
                for eqs in combinations(range(n_par), len(unknowns)):
                    sub = a[list(eqs)]
                    inv = _gf_solve(sub,
                                    np.eye(len(unknowns), dtype=np.uint8))
                    if inv is None:
                        continue
                    sel = [combo[e] for e in eqs]
                    known = sorted({i for p in sel
                                    for i in self.window(p - self.k)
                                    if i not in erased_data})
                    if not all(i in available for i in known):
                        continue
                    rows = known + sel
                    rmat = np.zeros((len(unknowns), len(rows)),
                                    dtype=np.uint8)
                    for out_i in range(len(unknowns)):
                        for eq_i, p in enumerate(sel):
                            coef = int(inv[out_i, eq_i])
                            if not coef:
                                continue
                            rmat[out_i, rows.index(p)] ^= coef
                            for d in known:
                                gpd = int(g[p, d])
                                if gpd:
                                    rmat[out_i, rows.index(d)] ^= gf_mul(
                                        coef, gpd)
                    plan = (rows, unknowns, rmat)
                    self._plan_cache[cache_key] = plan
                    return plan
        self._plan_cache[cache_key] = None
        return None

    # -- minimum_to_decode (shec flavor: cheapest covering set) ---------------

    def _targets_for(self, want_to_read: set, available: set) -> set:
        """Erased data chunks that must be restored to serve the read:
        the wanted ones, plus the window data behind any wanted parity
        (a parity re-encodes from its window only — zeros elsewhere)."""
        targets = {i for i in want_to_read
                   if i < self.k and i not in available}
        for p in want_to_read:
            if p >= self.k and p not in available:
                targets |= {d for d in self.window(p - self.k)
                            if d not in available}
        return targets

    def minimum_to_decode(self, want_to_read: set, available: set) -> set:
        got = want_to_read & available
        missing = want_to_read - available
        if not missing:
            return set(got)
        targets = self._targets_for(want_to_read, available)
        need: set = set()
        if targets:
            plan = self._recovery_plan(targets, available)
            if plan is None:
                raise IOError(f"shec cannot decode {sorted(missing)}")
            need |= set(plan[0])
        # a lost parity additionally reads its surviving window data
        for p in missing:
            if p >= self.k:
                need |= {d for d in self.window(p - self.k)
                         if d in available}
        return (need | got) - missing

    def minimum_to_decode_with_cost(self, want_to_read: set,
                                    available: dict) -> tuple[set, int]:
        chosen = self.minimum_to_decode(set(want_to_read), set(available))
        return chosen, sum(available.get(i, 1) for i in chosen)

    # -- decode ---------------------------------------------------------------

    def decode(self, want_to_read: set, chunks: dict) -> dict:
        available = set(chunks)
        out = {i: chunks[i] for i in want_to_read & available}
        missing = sorted(want_to_read - available)
        if not missing:
            return out
        data: dict[int, np.ndarray] = {
            i: np.frombuffer(chunks[i], dtype=np.uint8)
            for i in range(self.k) if i in available}
        targets = self._targets_for(set(want_to_read), available)
        if targets:
            plan = self._recovery_plan(targets, available)
            if plan is None:
                raise IOError(f"shec cannot decode {missing}")
            rows, unknowns, rmat = plan
            arr = np.stack([np.frombuffer(chunks[i], dtype=np.uint8)
                            for i in rows])
            rebuilt = to_host(self._product(rmat, arr[None]))[0]
            for idx, i in enumerate(unknowns):
                data[i] = rebuilt[idx]
        for i in missing:
            if i < self.k:
                out[i] = data[i].tobytes()
        # a lost parity re-encodes from its window (zeros elsewhere)
        g = self.generator
        for p in missing:
            if p < self.k:
                continue
            acc = None
            for d in self.window(p - self.k):
                term_coef = int(g[p, d])
                term = np.zeros_like(next(iter(data.values()))) \
                    if term_coef == 0 else _mul_vec(term_coef, data[d])
                acc = term if acc is None else (acc ^ term)
            out[p] = acc.tobytes()
        return out


register("shec", lambda profile: ErasureCodeShec())
