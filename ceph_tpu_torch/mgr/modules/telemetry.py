"""Telemetry module (src/pybind/mgr/telemetry analog): anonymized
cluster-shape report — no object names, no addresses; counts, sizes,
states, pool shapes only, like the reference's opt-in payload."""

from __future__ import annotations

import json

from ceph_tpu_torch.mgr.module import MgrModule


class Module(MgrModule):
    NAME = "telemetry"
    COMMANDS = [{"prefix": "telemetry show",
                 "help": "the anonymized report payload"}]

    def report(self) -> dict:
        m = self.get_osdmap()
        pools = [{"pool": pid, "pg_num": p.pg_num,
                  "type": ("erasure" if p.is_erasure()
                           else "replicated"),
                  "size": getattr(p, "size", 0),
                  "cache_tier": p.tier_of >= 0}
                 for pid, p in m.pools.items()]
        df = self.get("df")
        return {
            "report_version": 1,
            "osd": {"count": sum(1 for o in range(m.max_osd)
                                 if m.exists(o)),
                    "up": sum(1 for o in range(m.max_osd)
                              if m.is_up(o))},
            "osdmap_epoch": m.epoch,
            "pools": pools,
            "pg_states": self.get("pg_summary"),
            "usage": {"total_objects": df["total_objects"],
                      "total_bytes_used": df["total_bytes_used"]},
            "health": self.get("health")["status"],
        }

    def handle_command(self, cmd: dict) -> tuple[str, int]:
        return json.dumps(self.report()), 0
