"""iostat module (src/pybind/mgr/iostat analog): cluster I/O rates from
successive MMgrReport counter samples."""

from __future__ import annotations

import json
import time

from ceph_tpu_torch.mgr.module import MgrModule


class Module(MgrModule):
    NAME = "iostat"
    COMMANDS = [{"prefix": "iostat",
                 "help": "per-osd and total wr/rd op rates"}]

    def rates(self) -> dict:
        """Per-osd and total wr/rd ops per second over each osd's last
        report interval."""
        out: dict = {"osds": {}, "total_wr_ops_s": 0.0,
                     "total_rd_ops_s": 0.0}
        now = time.time()
        samples = self.get("io_samples")
        for osd, (t, counters) in samples["current"].items():
            if now - t > 10.0:
                # a dead osd's last interval is not a current rate:
                # stale reporters drop out instead of reporting their
                # final rate forever
                continue
            prev = samples["prev"].get(osd)
            if prev is None:
                continue
            pt, pc = prev
            dt = t - pt
            if dt <= 1e-3:
                # two reports bunched within a millisecond (timer
                # starvation under load) are not a rate window
                continue
            wr = (counters.get("op_w", 0) - pc.get("op_w", 0)) / dt
            rd = (counters.get("op_r", 0) - pc.get("op_r", 0)) / dt
            out["osds"][osd] = {"wr_ops_s": round(max(wr, 0.0), 3),
                                "rd_ops_s": round(max(rd, 0.0), 3),
                                "interval_s": round(dt, 3)}
            out["total_wr_ops_s"] += max(wr, 0.0)
            out["total_rd_ops_s"] += max(rd, 0.0)
        out["total_wr_ops_s"] = round(out["total_wr_ops_s"], 3)
        out["total_rd_ops_s"] = round(out["total_rd_ops_s"], 3)
        return out

    def handle_command(self, cmd: dict) -> tuple[str, int]:
        return json.dumps(self.rates()), 0
