"""pg_autoscaler module (pybind/mgr/pg_autoscaler analog, reduced to
the grow path our mon supports).

The reference sizes every pool's pg_num from its share of cluster
capacity: each pool's usage ratio times the cluster PG budget
(osd count x mon_target_pg_per_osd), divided by the pool's replication
factor, rounded to a power of two — and only acts when the pool is off
by more than a 3x threshold, so pg_num is not churned on noise.

Our mon only ever GROWS pg_num (PG merge does not exist here, as in
pre-Nautilus reference clusters), so the scaler raises undersized pools
and reports — but does not apply — shrink recommendations.
"""

from __future__ import annotations

import json
import time

from ceph_tpu_torch.mgr.module import MgrModule


def _pow2_at_most(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class Module(MgrModule):
    NAME = "pg_autoscaler"
    COMMANDS = [{"prefix": "osd pool autoscale-status",
                 "help": "per-pool pg_num recommendations"}]
    MODULE_OPTIONS = [
        {"name": "target_pgs_per_osd", "default": 100},
        {"name": "threshold", "default": 3.0},
        {"name": "sleep_interval", "default": 5.0},
    ]

    def __init__(self, mgr):
        super().__init__(mgr)
        self._last_run = 0.0
        self._last_status: list[dict] = []

    # -- sizing model ---------------------------------------------------------

    def _pool_bytes(self) -> dict[int, int]:
        """Stored bytes per pool from the per-PG stat rows (pgid is
        'pool.ps')."""
        out: dict[int, int] = {}
        for row in self.get("pg_dump")["pg_stats"]:
            pid = int(row["pgid"].split(".")[0])
            out[pid] = out.get(pid, 0) + int(row.get("bytes", 0))
        return out

    def recommendations(self) -> list[dict]:
        m = self.get_osdmap()
        n_osd = sum(1 for o in range(m.max_osd) if m.is_up(o))
        if n_osd == 0 or not m.pools:
            return []
        budget = n_osd * int(self.get_module_option(
            "target_pgs_per_osd", 100))
        usage = self._pool_bytes()
        total = sum(usage.values())
        rows = []
        for pid, pool in sorted(m.pools.items()):
            size = max(getattr(pool, "size", 1), 1)
            if total > 0:
                ratio = usage.get(pid, 0) / total
            else:
                ratio = 1.0 / len(m.pools)   # empty cluster: equal share
            target = _pow2_at_most(max(
                int(ratio * budget / size), 1))
            rows.append({"pool": pid, "pg_num": pool.pg_num,
                         "bytes": usage.get(pid, 0),
                         "capacity_ratio": round(ratio, 4),
                         "target_pg_num": target})
        return rows

    def maybe_scale(self) -> list[dict]:
        """One pass: apply grow recommendations past the threshold.
        Returns the rows it acted on (tests + autoscale-status)."""
        threshold = float(self.get_module_option("threshold", 3.0))
        acted = []
        rows = self.recommendations()
        for row in rows:
            cur, target = row["pg_num"], row["target_pg_num"]
            row["action"] = "none"
            if target >= cur * threshold:
                rc, out = self.mon_command({
                    "prefix": "osd pool set", "pool": row["pool"],
                    "var": "pg_num", "val": target})
                row["action"] = ("grown" if rc == 0
                                 else f"grow failed rc={rc}")
                if rc == 0:
                    self.log(1, "pool %d pg_num %d -> %d "
                             "(capacity_ratio %.3f)", row["pool"],
                             cur, target, row["capacity_ratio"])
                    acted.append(row)
            elif cur > target * threshold:
                # shrink would need PG merge; recommend only
                row["action"] = "would-shrink (merge unsupported)"
        self._last_status = rows
        return acted

    # -- host hooks -----------------------------------------------------------

    def tick(self, now: float) -> None:
        if now - self._last_run < float(
                self.get_module_option("sleep_interval", 5.0)):
            return
        self._last_run = now
        self.maybe_scale()

    def handle_command(self, cmd: dict) -> tuple[str, int]:
        if not self._last_status:
            self._last_status = self.recommendations()
        return json.dumps({"pools": self._last_status}), 0
