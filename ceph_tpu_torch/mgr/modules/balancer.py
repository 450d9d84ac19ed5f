"""Balancer module (src/pybind/mgr/balancer/module.py analog, upmap
mode): plans mon upmap commands that flatten the per-OSD PG histogram
of the mgr's current osdmap.  Placements and the what-if scoring of
candidate moves come from the mgr context's mapping service; a fault of
the card fails the command (the mgr's command tier answers non-zero
with its text) and no plan is made on the host instead."""

from __future__ import annotations

import json
import time

from ceph_tpu_torch.mgr.module import MgrModule


class Module(MgrModule):
    NAME = "balancer"
    COMMANDS = [
        {"prefix": "balancer status",
         "help": "mode + last optimize outcome + pool spread scores"},
        {"prefix": "balancer optimize",
         "help": "plan upmap commands flattening the PG histogram"},
    ]

    def __init__(self, mgr):
        super().__init__(mgr)
        self._last: dict = {}

    def plan(self, **kw) -> list[dict]:
        from ceph_tpu_torch.balancer import plan_commands
        cmds = plan_commands(self.get_osdmap(), ctx=self.mgr.ctx, **kw)
        self._last = {"time": time.time(), "commands": len(cmds),
                      "pool_spread": self._spread_scores()}
        return cmds

    def _spread_scores(self) -> dict:
        from ceph_tpu_torch.balancer import spread
        m = self.get_osdmap()    # snapshot: dispatch may swap the map
        return {pid: dict(zip(("min", "max"),
                              spread(m, pid, ctx=self.mgr.ctx)))
                for pid in list(m.pools)}

    def status(self) -> dict:
        return {"mode": "upmap", "active": True,
                "last_optimize": dict(self._last),
                "pool_spread": self._spread_scores()}

    def handle_command(self, cmd: dict) -> tuple[str, int]:
        if cmd.get("prefix") == "balancer status":
            return json.dumps(self.status()), 0
        if cmd.get("prefix") == "balancer optimize":
            return json.dumps({"commands": self.plan()}), 0
        return f"unknown balancer command {cmd.get('prefix')!r}", -22
