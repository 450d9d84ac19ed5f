"""Performance counters (src/common/perf_counters.h:59,150 analog).

Components build a counter set with PerfCountersBuilder (u64 counters,
time-averages with count+sum, histograms), registered in the context's
collection and dumped via the admin socket (`perf dump`) — the surface the
reference's mgr scrapes via MMgrReport.
"""

from __future__ import annotations

from ceph_tpu_torch.common import lockdep

U64 = "u64"
TIME_AVG = "time_avg"
HISTOGRAM = "histogram"


class PerfCounters:
    def __init__(self, name: str):
        self.name = name
        self._lock = lockdep.make_lock(f"PerfCounters::lock({name})")
        self._types: dict[str, str] = {}
        self._u64: dict[str, int] = {}
        self._avg: dict[str, tuple[int, float]] = {}   # (count, sum)
        self._hist: dict[str, list[int]] = {}
        self._hist_bounds: dict[str, list[float]] = {}
        self._hist_sum: dict[str, float] = {}

    # -- mutation -------------------------------------------------------------

    def inc(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._u64[name] += amount

    def dec(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._u64[name] -= amount

    def set(self, name: str, value: int) -> None:
        with self._lock:
            self._u64[name] = value

    def tinc(self, name: str, seconds: float) -> None:
        """Accumulate a latency sample (perf_counters time avg)."""
        with self._lock:
            c, s = self._avg[name]
            self._avg[name] = (c + 1, s + seconds)

    def hinc(self, name: str, value: float) -> None:
        with self._lock:
            bounds = self._hist_bounds[name]
            # bounds are UPPER-inclusive (`le`) limits, matching the
            # Prometheus bucket model the exposition emits them as
            bucket = sum(1 for b in bounds if value > b)
            self._hist[name][bucket] += 1
            self._hist_sum[name] += value

    # -- reading --------------------------------------------------------------

    def value(self, name: str):
        with self._lock:
            t = self._types[name]
            if t == U64:
                return self._u64[name]
            if t == TIME_AVG:
                return self._avg[name]
            return list(self._hist[name])

    def avg(self, name: str) -> float:
        c, s = self._avg[name]
        return s / c if c else 0.0

    def dump(self) -> dict:
        """`perf dump` shape: {counter: value or {avgcount, sum}}."""
        with self._lock:
            out = {}
            for n, t in self._types.items():
                if t == U64:
                    out[n] = self._u64[n]
                elif t == TIME_AVG:
                    c, s = self._avg[n]
                    out[n] = {"avgcount": c, "sum": s}
                else:
                    out[n] = {"bounds": self._hist_bounds[n],
                              "buckets": list(self._hist[n]),
                              "sum": self._hist_sum[n]}
            return out


class PerfCountersBuilder:
    """Declare-then-build, like the reference's add_u64/add_time_avg chain."""

    def __init__(self, name: str):
        self._pc = PerfCounters(name)

    def add_u64(self, name: str, description: str = ""):
        self._pc._types[name] = U64
        self._pc._u64[name] = 0
        return self

    def add_time_avg(self, name: str, description: str = ""):
        self._pc._types[name] = TIME_AVG
        self._pc._avg[name] = (0, 0.0)
        return self

    def add_histogram(self, name: str, bounds: list[float],
                      description: str = ""):
        self._pc._types[name] = HISTOGRAM
        self._pc._hist_bounds[name] = list(bounds)
        self._pc._hist[name] = [0] * (len(bounds) + 1)
        self._pc._hist_sum[name] = 0.0
        return self

    def create_perf_counters(self) -> PerfCounters:
        return self._pc


class PerfCountersCollection:
    """All counter sets of one context (perf_counters_collection_t)."""

    def __init__(self):
        self._lock = lockdep.make_lock("PerfCountersCollection::lock")
        self._sets: dict[str, PerfCounters] = {}

    def add(self, pc: PerfCounters) -> None:
        with self._lock:
            self._sets[pc.name] = pc

    def remove(self, name: str) -> None:
        with self._lock:
            self._sets.pop(name, None)

    def get(self, name: str) -> PerfCounters | None:
        with self._lock:
            return self._sets.get(name)

    def dump(self) -> dict:
        with self._lock:
            return {name: pc.dump() for name, pc in self._sets.items()}
