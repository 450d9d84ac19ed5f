"""Insights module — cluster-wide slow-trace and slow-op aggregation
(src/pybind/mgr/insights reduced to the observability tier this repo
needs).

Every daemon ships its tail-sampled slow traces (completed span trees
whose root crossed ``tracing_slow_threshold``), its historic slow-op
digests, and its pipeline-profile phase digest in MMgrReport v4; this
module merges them across the cluster, ranks the slowest, and serves
five mgr commands:

  * ``tracing ls``        — slowest retained traces cluster-wide
  * ``tracing show <id>`` — one trace's stitched span TREE (rows from
                            every reporting daemon merged by span_id)
  * ``slow_ops``          — slowest completed ops across all daemons
  * ``profile phases``    — cluster-wide where-did-the-time-go: phase
                            seconds/shares per engine × kernel family,
                            compile ledger, mapping epoch split
  * ``profile top``       — top-N (engine, kernel, phase) stalls by
                            cluster-total seconds

The in-process MiniCluster shares one tracing table so every daemon
reports the same ring (merged here by trace_id); multi-process daemons
each ship only their own spans and the merge stitches the cross-daemon
tree, exactly like zipkin collectors joining on trace id.  Profile
digests merge by SUMMING phase seconds across daemons (multi-process
daemons have distinct telemetry registries, so engine pipelines are
distinct), with one dedup rule mirroring the tracing/slow-op merges:
daemons shipping a byte-identical digest are reading ONE shared
process-global registry (the in-process MiniCluster topology), so
they contribute once, with every reporter listed — otherwise an
N-daemon in-process cluster would inflate every total N-fold.
"""

from __future__ import annotations

import json

from ceph_tpu_torch.mgr.module import MgrModule


class Module(MgrModule):
    NAME = "insights"
    COMMANDS = [
        {"prefix": "tracing ls",
         "help": "slowest tail-retained traces across all daemons"},
        {"prefix": "tracing show",
         "help": "render one trace's stitched span tree "
                 "(trace_id=<id>)"},
        {"prefix": "slow_ops",
         "help": "slowest completed ops across all daemons"},
        {"prefix": "profile phases",
         "help": "cluster-wide pipeline phase attribution per engine "
                 "and kernel family (seconds + shares, compile "
                 "ledger, mapping epoch split)"},
        {"prefix": "profile top",
         "help": "top-N (engine, kernel, phase) stalls by "
                 "cluster-total seconds (limit=<n>)"},
        {"prefix": "integrity",
         "help": "cluster-wide background-integrity rollup: per-osd "
                 "deep-scrub counters (objects checked, batched vs "
                 "scalar digests, inconsistencies found, repairs "
                 "verified/unverified, missing-peer scrubs) and the "
                 "cluster totals"},
    ]

    # -- aggregation ----------------------------------------------------------

    def _feed(self) -> dict:
        return self.get("insights_feed")

    def traces(self) -> dict[int, dict]:
        """trace_id -> merged digest: rows unioned across reporting
        daemons (dedup by (kind, span_id, event, t)), root metadata
        from the richest report."""
        merged: dict[int, dict] = {}
        seen: dict[int, set] = {}
        for osd, feed in sorted(self._feed().items()):
            for digest in feed.get("slow_traces", []):
                tid = digest.get("trace_id")
                if tid is None:
                    continue
                cur = merged.get(tid)
                if cur is None:
                    cur = {"trace_id": tid,
                           "root": digest.get("root"),
                           "daemon": digest.get("daemon"),
                           "duration": digest.get("duration", 0.0),
                           "completed_at": digest.get("completed_at"),
                           "reported_by": [],
                           "rows": []}
                    merged[tid] = cur
                    seen[tid] = set()
                cur["reported_by"].append(osd)
                cur["duration"] = max(cur["duration"],
                                      digest.get("duration", 0.0))
                for r in digest.get("rows", []):
                    key = (r.get("kind"), r.get("span_id"),
                           r.get("event"), r.get("t"))
                    if key in seen[tid]:
                        continue
                    seen[tid].add(key)
                    cur["rows"].append(r)
        for cur in merged.values():
            cur["rows"].sort(key=lambda r: r.get("t", 0.0))
        return merged

    def tracing_ls(self, limit: int = 20) -> list[dict]:
        ranked = sorted(self.traces().values(),
                        key=lambda tr: -tr["duration"])[:limit]
        return [{"trace_id": tr["trace_id"], "root": tr["root"],
                 "daemon": tr["daemon"],
                 "duration": tr["duration"],
                 "n_rows": len(tr["rows"]),
                 "reported_by": tr["reported_by"]}
                for tr in ranked]

    def tracing_show(self, trace_id: int) -> dict | None:
        from ceph_tpu_torch.common.tracing import tree_from_rows
        tr = self.traces().get(trace_id)
        if tr is None:
            return None
        return {"trace_id": trace_id, "duration": tr["duration"],
                "reported_by": tr["reported_by"],
                "tree": tree_from_rows(tr["rows"])}

    def slow_ops(self, limit: int = 20) -> list[dict]:
        ops = []
        for _osd, feed in sorted(self._feed().items()):
            ops.extend(feed.get("slow_ops", []))
        # in-process daemons never collide (per-daemon trackers), but a
        # re-reported digest from consecutive reports must not rank twice
        uniq = {(o.get("daemon"), o.get("description"),
                 o.get("initiated_at")): o for o in ops}
        return sorted(uniq.values(),
                      key=lambda o: -o.get("duration", 0.0))[:limit]

    # -- pipeline-profile aggregation -----------------------------------------

    def profile_phases(self) -> dict:
        """Cluster-merged where-did-the-time-go: per engine × kernel
        family, phase seconds summed across every reporting daemon
        (shares recomputed over the merged totals), the compile
        ledger, utilization per daemon, and the mapping epoch split."""
        engines: dict = {}
        compile_: dict = {}
        util: dict = {}
        mapping = {"seconds": {}, "epochs": 0}
        # dedup byte-identical digests (shared in-process registry —
        # see module docstring): one contribution, every reporter
        by_digest: dict = {}
        for osd, feed in sorted(self._feed().items()):
            prof = feed.get("profile") or {}
            if not prof:
                continue
            key = json.dumps(prof, sort_keys=True)
            entry = by_digest.setdefault(key, (prof, []))
            entry[1].append(osd)
        for prof, osds in by_digest.values():
            for engine in ("encode", "decode"):
                d = prof.get(engine) or {}
                for kernel, row in (d.get("kernels") or {}).items():
                    cur = engines.setdefault(engine, {}).setdefault(
                        kernel, {"seconds": {}, "batches": 0,
                                 "reported_by": []})
                    for ph, s in (row.get("seconds") or {}).items():
                        cur["seconds"][ph] = \
                            cur["seconds"].get(ph, 0.0) + s
                    cur["batches"] += row.get("batches", 0)
                    cur["reported_by"].extend(osds)
                for kernel, c in (d.get("compile") or {}).items():
                    cc = compile_.setdefault(engine, {}).setdefault(
                        kernel, {"seconds": 0.0, "events": 0,
                                 "reported_by": []})
                    cc["seconds"] += c.get("seconds", 0.0)
                    cc["events"] += c.get("events", 0)
                    cc["reported_by"].extend(osds)
                if d:
                    for o in osds:   # gauges, not sums: safe to
                        # repeat for every daemon sharing the digest
                        util.setdefault(engine, {})[f"osd.{o}"] = {
                            "busy_seconds": d.get("busy_seconds", 0.0),
                            "utilization": d.get("utilization", 0.0),
                            "devices_seen": d.get("devices_seen", 1)}
            mp = prof.get("mapping") or {}
            for ph, s in (mp.get("seconds") or {}).items():
                mapping["seconds"][ph] = \
                    mapping["seconds"].get(ph, 0.0) + s
            mapping["epochs"] += mp.get("epochs", 0)
        for per in engines.values():
            for cur in per.values():
                total = sum(cur["seconds"].values())
                cur["share"] = {
                    ph: (round(s / total, 4) if total else 0.0)
                    for ph, s in cur["seconds"].items()}
        return {"engines": engines, "compile": compile_,
                "utilization": util, "mapping": mapping}

    def profile_top(self, limit: int = 10) -> list[dict]:
        """Ranked (engine, kernel, phase) rows by cluster-total
        seconds — the top stalls.  Compile cost ranks too, as its own
        ``compile`` phase row, so a retrace storm surfaces next to a
        queue-wait stall instead of hiding in a separate ledger."""
        merged = self.profile_phases()
        rows = []
        for engine, per in merged["engines"].items():
            for kernel, cur in per.items():
                total = sum(cur["seconds"].values())
                for ph, s in cur["seconds"].items():
                    rows.append({
                        "engine": engine, "kernel": kernel,
                        "phase": ph, "seconds": round(s, 6),
                        "share": (round(s / total, 4) if total
                                  else 0.0),
                        "reported_by": cur["reported_by"]})
        for engine, per in merged["compile"].items():
            for kernel, c in per.items():
                rows.append({
                    "engine": engine, "kernel": kernel,
                    "phase": "compile",
                    "seconds": round(c["seconds"], 6),
                    "share": None,
                    "events": c["events"],
                    "reported_by": c["reported_by"]})
        rows.sort(key=lambda r: -r["seconds"])
        return rows[:limit]

    # -- background integrity -------------------------------------------------

    def integrity(self) -> dict:
        """Cluster-wide scrub rollup from the MMgrReport v5 scrub
        tail: per-daemon counters plus summed totals.  The headline
        invariant the operator watches: ``repair_unverified`` stays 0
        — every repair the scrub path fired had its digest re-fetched
        and matched."""
        try:
            feed = self.get("scrub_feed")
        except Exception:
            feed = {}
        totals: dict = {}
        per_osd = {}
        for osd, entry in sorted(feed.items()):
            per_osd[f"osd.{osd}"] = dict(entry)
            for k, v in entry.items():
                if isinstance(v, (int, float)):
                    totals[k] = totals.get(k, 0) + v
        return {"totals": totals, "per_osd": per_osd}

    # -- command tier ---------------------------------------------------------

    def handle_command(self, cmd: dict) -> tuple[str, int]:
        prefix = cmd.get("prefix", "")
        if prefix == "tracing ls":
            limit = int(cmd.get("limit", 20))
            return json.dumps({"traces": self.tracing_ls(limit)}), 0
        if prefix == "tracing show":
            raw = cmd.get("trace_id")
            if raw is None:
                return "tracing show needs trace_id=<id>", -22
            out = self.tracing_show(int(raw))
            if out is None:
                return f"no retained trace {raw}", -2
            return json.dumps(out), 0
        if prefix == "slow_ops":
            limit = int(cmd.get("limit", 20))
            return json.dumps({"ops": self.slow_ops(limit)}), 0
        if prefix == "profile phases":
            return json.dumps(self.profile_phases()), 0
        if prefix == "profile top":
            limit = int(cmd.get("limit", 10))
            return json.dumps({"stalls": self.profile_top(limit)}), 0
        if prefix == "integrity":
            return json.dumps(self.integrity()), 0
        return f"module {self.NAME} has no command {prefix!r}", -22
