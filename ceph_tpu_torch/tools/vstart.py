"""vstart-style in-process cluster harness (src/vstart.sh +
qa/standalone/ceph-helpers.sh analog).

Starts one mon and N osds in this process over the chosen messenger stack,
returns a handle with run_mon/run_osd/kill_osd/wait_for_clean-style helpers,
and a connected RadosClient factory — the surface the standalone QA tier
drives (SURVEY.md §4 tier 3).

Every daemon and client builds its own context on ``device`` (the CUDA card
by default; the tests pass ``device="cpu"``), the mgr's included;
``ProcCluster`` passes the device to every daemon process.  The MDS and RGW
daemons and the ici stack are not ported yet and raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import threading
import time

from ceph_tpu_torch.client import RadosClient
from ceph_tpu_torch.mon import Monitor
from ceph_tpu_torch.osd.daemon import OSDDaemon


class MiniCluster:
    _instances = 0

    def __init__(self, n_osds: int = 3, ms_type: str = "async",
                 store_type: str = "memstore", base_path: str = "",
                 heartbeats: bool = False, n_mons: int = 1,
                 auth_key=None, cephx: bool = False,
                 osd_conf: dict | None = None, device=None):
        # namespace loopback addresses per cluster: sequential tests reuse
        # names like "mon.0", and a timer from a dying daemon of the
        # previous cluster must never reach this one
        MiniCluster._instances += 1
        self._ns = f"c{MiniCluster._instances}."
        self.ms_type = ms_type
        #: the torch device every daemon's and client's context runs on
        self.device = device
        self.store_type = store_type
        self.base_path = base_path
        self.heartbeats = heartbeats
        self.mons: dict[int, Monitor] = {}
        self.monmap: list[str] = []
        #: the mgr OSDs started afterwards report to (mgr.0, else the first
        #: started), and every running mgr by id
        self.mgr = None
        self.mgrs: dict = {}
        self.osds: dict[int, OSDDaemon] = {}
        self.clients: list[RadosClient] = []
        self._n_initial = n_osds
        self._n_mons = n_mons
        self.auth_key = auth_key
        #: startup config overrides applied to every OSD's context at
        #: construction (vstart.sh -o analog): knobs read before the
        #: first map lands (osd_op_queue, shard count, qos timeouts)
        self.osd_conf = dict(osd_conf or {})
        #: full cephx mode: per-entity keys + tickets (wire stacks).
        #: The seed keyring (mon keys + admin) is generated here — the
        #: `ceph-authtool` bootstrap step
        self.cephx = cephx
        self.keyring: dict[str, str] = {}
        self._admin = None
        if cephx:
            from ceph_tpu_torch.auth.cephx import new_secret
            for i in range(n_mons):
                self.keyring[f"mon.{i}"] = new_secret()
            self.keyring["client.admin"] = new_secret()

    def _is_wire(self) -> bool:
        """TCP-style stacks bind host:port; loopback/ici bind names."""
        return self.ms_type not in ("loopback", "ici")

    @property
    def mon(self) -> Monitor:
        """A live monitor (prefer the leader — its map is freshest)."""
        for m in self.mons.values():
            if m.is_leader():
                return m
        return next(iter(self.mons.values()))

    @property
    def mon_host(self) -> str:
        return ",".join(self.monmap)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "MiniCluster":
        # bind all mons first (TCP ports are ephemeral), then hand every
        # mon the complete monmap so elections can begin
        for i in range(self._n_mons):
            self.run_mon(i, defer_monmap=True)
        self.monmap = [self.mons[i].addr for i in range(self._n_mons)]
        for m in self.mons.values():
            m.set_monmap(self.monmap)
        for i in range(self._n_initial):
            self.run_osd(i)
        return self

    def run_mon(self, mon_id: int, defer_monmap: bool = False) -> Monitor:
        addr = ("127.0.0.1:0" if self._is_wire()
                else f"{self._ns}mon.{mon_id}")
        path = (f"{self.base_path}/mon.{mon_id}" if self.base_path else None)
        mon = Monitor(mon_id=mon_id, ms_type=self.ms_type, addr=addr,
                      store_path=path, auth_key=self.auth_key,
                      cephx_keyring=self.keyring if self.cephx else None,
                      device=self.device)
        if defer_monmap:
            mon.init(monmap=[])   # bind only; set_monmap comes later
        else:
            # rejoin: reuse the recorded monmap slot (loopback addrs are
            # stable; TCP rejoin needs the same port, so record it)
            mon.init(monmap=[])
            if self.monmap:
                self.monmap[mon_id] = mon.addr
                monmap = list(self.monmap)
                mon.set_monmap(monmap)
                for other in self.mons.values():
                    other.monmap[mon_id] = mon.addr
        self.mons[mon_id] = mon
        return mon

    def kill_mon(self, mon_id: int) -> None:
        mon = self.mons.pop(mon_id)
        mon.shutdown()

    def add_mon(self, mon_id: int, timeout: float = 30.0) -> Monitor:
        """GROW the mon cluster at runtime (`ceph mon add` + probe):
        the new mon starts probing the existing quorum, the membership
        commits through paxos, and this returns once the joiner has
        entered the committed monmap and elections settled."""
        import json as _json
        import time as _time
        addr = ("127.0.0.1:0" if self._is_wire()
                else f"{self._ns}mon.{mon_id}")
        path = (f"{self.base_path}/mon.{mon_id}" if self.base_path
                else None)
        seeds = [m.addr for m in self.mons.values()]
        mon = Monitor(mon_id=mon_id, ms_type=self.ms_type, addr=addr,
                      store_path=path, auth_key=self.auth_key,
                      cephx_keyring=self.keyring if self.cephx else None,
                      device=self.device)
        mon.init(probe=seeds)
        client = self.client(timeout=20.0)
        rc, out = client.mon_command({"prefix": "mon add",
                                      "id": mon_id, "addr": mon.addr})
        if rc != 0:
            mon.shutdown()
            raise RuntimeError(f"mon add failed: {out}")
        self.mons[mon_id] = mon
        while len(self.monmap) <= mon_id:
            self.monmap.append("")
        self.monmap[mon_id] = mon.addr
        deadline = _time.time() + timeout
        while _time.time() < deadline:
            if mon.elector is not None and not mon.elector.electing \
                    and mon.mon_id in (mon.quorum() or []):
                return mon
            _time.sleep(0.1)
        self.mons.pop(mon_id, None)
        mon.shutdown()
        raise TimeoutError(
            f"mon.{mon_id} did not join quorum: elector="
            f"{mon.elector is not None}, quorum={mon.quorum()}")

    def replace_mon(self, mon_id: int, timeout: float = 30.0) -> Monitor:
        """Kill a mon, WIPE its store, and rejoin it via probe +
        store-sync (the dead-mon-replacement flow: the fresh store pulls
        the paxos tail from the quorum before electing)."""
        import shutil
        import time as _time
        if mon_id in self.mons:
            self.kill_mon(mon_id)
        path = (f"{self.base_path}/mon.{mon_id}" if self.base_path
                else None)
        if path:
            shutil.rmtree(path, ignore_errors=True)
        addr = ("127.0.0.1:0" if self._is_wire()
                else f"{self._ns}mon.{mon_id}")
        seeds = [m.addr for m in self.mons.values()]
        mon = Monitor(mon_id=mon_id, ms_type=self.ms_type, addr=addr,
                      store_path=path, auth_key=self.auth_key,
                      cephx_keyring=self.keyring if self.cephx else None,
                      device=self.device)
        mon.init(probe=seeds)
        if self._is_wire():
            # the wiped mon's new ephemeral port must replace the old
            # monmap entry before the probe can match it
            client = self.client(timeout=20.0)
            client.mon_command({"prefix": "mon add", "id": mon_id,
                                "addr": mon.addr})
        self.mons[mon_id] = mon
        if mon_id < len(self.monmap):
            self.monmap[mon_id] = mon.addr
        deadline = _time.time() + timeout
        while _time.time() < deadline:
            if mon.elector is not None and not mon.elector.electing:
                return mon
            _time.sleep(0.1)
        # clean up the half-joined mon: leaving it registered (and its
        # threads running) would let a later run_mon bind a SECOND
        # monitor over the same address/store
        self.mons.pop(mon_id, None)
        mon.shutdown()
        raise TimeoutError(f"replaced mon.{mon_id} did not rejoin")

    def run_mgr(self, mgr_id: int = 0):
        """Start a manager; OSDs started AFTERWARDS stream reports to
        the one the mon names active (restart existing ones to pick it
        up).  Additional mgr_ids are standbys the mon promotes when the
        active's session dies."""
        from ceph_tpu_torch.mgr import MgrDaemon
        addr = ("127.0.0.1:0" if self._is_wire()
                else f"{self._ns}mgr.{mgr_id}")
        cephx = None
        if self.cephx:
            who = f"mgr.{mgr_id}"
            key = self.keyring.get(who) or self.provision_key(who)
            cephx = (who, key)
        mgr = MgrDaemon(self.mon_host, ms_type=self.ms_type,
                        addr=addr, auth_key=self.auth_key,
                        cephx=cephx, mgr_id=mgr_id, device=self.device)
        mgr.init()
        self.mgrs[mgr_id] = mgr
        if mgr_id == 0 or self.mgr is None:
            self.mgr = mgr
        return mgr

    def kill_mgr(self, mgr_id: int = 0):
        mgr = self.mgrs.pop(mgr_id, None)
        if mgr is None:
            return
        if self.mgr is mgr:
            self.mgr = next(iter(self.mgrs.values()), None)
        mgr.shutdown()

    def run_mds(self, metadata_pool: int, data_pool: int):
        raise NotImplementedError(
            "the MDS daemon is not ported yet (ROADMAP.md Queue 1 item 7.4)")

    def run_fs_mds(self, n: int = 1):
        raise NotImplementedError(
            "the MDS daemon is not ported yet (ROADMAP.md Queue 1 item 7.4)")

    def provision_key(self, entity: str) -> str:
        """`ceph auth get-or-create` as admin; returns the secret.  One
        admin client serves every call (each client maps every pool of
        every epoch, so one a key would load the host for nothing)."""
        if self._admin is None:
            self._admin = self.client()
        admin = self._admin
        rc, out = admin.mon_command({"prefix": "auth get-or-create",
                                     "entity": entity})
        assert rc == 0, out
        rc, key = admin.mon_command({"prefix": "auth print-key",
                                     "entity": entity})
        assert rc == 0, key
        self.keyring[entity] = key
        return key

    def run_osd(self, osd_id: int) -> OSDDaemon:
        addr = (f"127.0.0.1:0" if self._is_wire()
                else f"{self._ns}osd.{osd_id}")
        path = (f"{self.base_path}/osd.{osd_id}" if self.base_path else "")
        cephx = None
        if self.cephx:
            ent = f"osd.{osd_id}"
            key = self.keyring.get(ent) or self.provision_key(ent)
            cephx = (ent, key)
        osd = OSDDaemon(osd_id, self.mon_host, store_type=self.store_type,
                        store_path=path, ms_type=self.ms_type, addr=addr,
                        heartbeats=self.heartbeats,
                        auth_key=self.auth_key, cephx=cephx,
                        mgr_addr=self.mgr.addr if self.mgr else None,
                        conf=self.osd_conf, device=self.device)
        osd.init()
        self.osds[osd_id] = osd
        return osd

    def kill_osd(self, osd_id: int) -> None:
        """Hard kill (Thrasher kill_osd analog)."""
        osd = self.osds.pop(osd_id)
        osd.shutdown()

    def client(self, timeout: float = 10.0) -> RadosClient:
        cephx = (("client.admin", self.keyring["client.admin"])
                 if self.cephx else None)
        c = RadosClient(self.mon_host, ms_type=self.ms_type,
                        timeout=timeout, auth_key=self.auth_key,
                        cephx=cephx, device=self.device)
        c.connect()
        self.clients.append(c)
        return c

    def client_as(self, entity: str, key: str,
                  timeout: float = 10.0) -> RadosClient:
        """A client with SPECIFIC cephx credentials (not admin)."""
        c = RadosClient(self.mon_host, ms_type=self.ms_type,
                        timeout=timeout, cephx=(entity, key),
                        device=self.device)
        c.connect()
        self.clients.append(c)
        return c

    def stop(self) -> None:
        for c in self.clients:
            c.shutdown()
        for osd in list(self.osds.values()):
            osd.shutdown()
        self.osds.clear()
        for mgr_id in list(self.mgrs):
            self.kill_mgr(mgr_id)
        for mon in list(self.mons.values()):
            mon.shutdown()
        self.mons.clear()

    # -- helpers (ceph-helpers.sh analog) -------------------------------------

    def wait_for_epoch(self, epoch: int, timeout: float = 10.0) -> None:
        """All live daemons have seen at least `epoch`."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if all(o.osdmap.epoch >= epoch for o in self.osds.values()):
                return
            time.sleep(0.02)
        raise TimeoutError(f"cluster did not reach epoch {epoch}")

    def wait_for_osd_count(self, n: int, timeout: float = 10.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.mon.status()["num_up_osds"] == n:
                return
            time.sleep(0.02)
        raise TimeoutError(f"never saw {n} up osds")

    def create_pool(self, client: RadosClient, *,
                    epoch_timeout: float = 10.0, **cmd) -> int:
        """``epoch_timeout``: a new pool's first map application can
        pay a cold jit trace+compile inside _handle_map (the fused
        placement ladder, when osdmap_mapping_min_pgs admits toy
        pools) — tens of seconds on a 1-core host; callers running
        fused-on-toy-pools setups pass a compile-sized timeout."""
        res, out = client.mon_command(
            dict({"prefix": "osd pool create"}, **cmd))
        assert res == 0, out
        pool_id = int(out.split()[1])
        epoch = self.mon.osdmap.epoch
        self.wait_for_epoch(epoch, timeout=epoch_timeout)
        client.wait_for_epoch(epoch)
        return pool_id


class ProcCluster:
    """Multi-PROCESS cluster harness: every mon/OSD is a separate OS
    process over the TCP stack (the reference's tier-3 QA model —
    vstart.sh spawns real daemons; qa/standalone/ceph-helpers.sh
    run_mon:437 / run_osd:596).  kill_osd(9) is real SIGKILL process
    death; the filestore survives for the restart.

    Every daemon process runs on ``device`` (``--device``; the CUDA card
    when None, and a process that finds no card exits, so ``_spawn``
    raises "failed to start").  A daemon's stderr goes to
    ``<base_path>/<role>.<id>.log``.
    """

    def __init__(self, n_osds: int = 3, n_mons: int = 1,
                 base_path: str = "", auth_key: str = "",
                 ms_type: str = "async", device=None):
        import tempfile
        if ms_type == "ici":
            raise NotImplementedError(
                "the cross-process ici-wire stack is not ported yet "
                "(ROADMAP.md Queue 1 item 7.6)")
        self.n_osds = n_osds
        self.n_mons = n_mons
        self.base_path = base_path or tempfile.mkdtemp(prefix="proccluster-")
        self.auth_key = auth_key
        self.ms_type = ms_type
        #: the torch device of every daemon process and client
        self.device = device
        self.procs: dict[str, object] = {}   # "mon.0" / "osd.2" -> Popen
        self.mon_addrs: list[str] = []
        self.clients: list[RadosClient] = []

    @property
    def mon_host(self) -> str:
        return ",".join(self.mon_addrs)

    def _spawn(self, role: str, rid: int, extra: list[str]):
        import os as _os
        import selectors
        import subprocess
        import sys
        cmd = [sys.executable, "-m", "ceph_tpu_torch.tools.daemon_main",
               "--role", role, "--id", str(rid),
               "--store-path", f"{self.base_path}/{role}.{rid}"]
        if self.auth_key:
            cmd += ["--auth-key", self.auth_key]
        if self.device is not None:
            cmd += ["--device", str(self.device)]
        cmd += extra
        _os.makedirs(self.base_path, exist_ok=True)
        log_path = f"{self.base_path}/{role}.{rid}.log"
        with open(log_path, "ab") as log:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=log, text=True)
        # wait for the readiness line (bounded: a wedged daemon must
        # fail the harness, not hang it — including one that emits a
        # partial line), then keep the pipe drained so later daemon
        # output cannot fill the buffer and block it
        fd = proc.stdout.fileno()
        _os.set_blocking(fd, False)
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        buf = b""
        deadline = time.time() + 60.0
        while b"\n" not in buf and time.time() < deadline:
            if sel.select(timeout=max(0.05, deadline - time.time())):
                chunk = _os.read(fd, 4096)
                if not chunk:
                    break
                buf += chunk
        sel.close()
        _os.set_blocking(fd, True)
        line = buf.split(b"\n", 1)[0].decode(errors="replace")
        if not line.startswith("ready"):
            proc.kill()
            proc.wait()
            with open(log_path, "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            raise RuntimeError(
                f"{role}.{rid} failed to start: {line!r}; its log "
                f"{log_path} ends:\n{tail}")
        threading.Thread(target=proc.stdout.read, daemon=True).start()
        #: the full ready line
        proc.ready_line = line
        self.procs[f"{role}.{rid}"] = proc
        return proc

    def start(self) -> "ProcCluster":
        from ceph_tpu_torch.common import free_port
        self.mon_addrs = [f"127.0.0.1:{free_port()}"
                          for _ in range(self.n_mons)]
        monmap = ",".join(self.mon_addrs)
        for i in range(self.n_mons):
            self._spawn("mon", i, ["--addr", self.mon_addrs[i],
                                   "--monmap", monmap])
        for i in range(self.n_osds):
            self.run_osd(i)
        return self

    def run_osd(self, osd_id: int):
        extra = ["--mon-host", self.mon_host, "--heartbeats"]
        if self.ms_type != "async":
            extra += ["--ms-type", self.ms_type]
        return self._spawn("osd", osd_id, extra)

    def kill_osd(self, osd_id: int) -> None:
        """SIGKILL — crash-grade process death (Thrasher kill_osd)."""
        proc = self.procs.pop(f"osd.{osd_id}")
        proc.kill()
        proc.wait(timeout=10)

    def run_rgw(self, pool: int, rgw_id: int = 0) -> str:
        raise NotImplementedError(
            "the RGW daemon is not ported yet (ROADMAP.md Queue 1 item 7.4)")

    def client(self, timeout: float = 20.0) -> RadosClient:
        c = RadosClient(self.mon_host, ms_type="async", timeout=timeout,
                        auth_key=self.auth_key.encode()
                        if self.auth_key else None, device=self.device)
        c.connect()
        self.clients.append(c)
        return c

    def wait_for_osd_count(self, n: int, timeout: float = 30.0) -> None:
        import json
        deadline = time.time() + timeout
        client = self.clients[0] if self.clients else self.client()
        while time.time() < deadline:
            try:
                rc, out = client.mon_command({"prefix": "status"})
                if rc == 0 and json.loads(out)["num_up_osds"] == n:
                    return
            except (TimeoutError, OSError, ValueError, KeyError):
                pass
            time.sleep(0.25)
        raise TimeoutError(f"never saw {n} up osds")

    def create_pool(self, client: RadosClient, **cmd) -> int:
        import json
        res, out = client.mon_command(
            dict({"prefix": "osd pool create"}, **cmd))
        assert res == 0, out
        pool_id = int(out.split()[1])
        rc, st = client.mon_command({"prefix": "status"})
        assert rc == 0, st
        client.wait_for_epoch(json.loads(st)["epoch"])
        return pool_id

    def stop(self) -> None:
        for c in self.clients:
            try:
                c.shutdown()
            except Exception:
                pass
        self.clients.clear()
        for name, proc in list(self.procs.items()):
            proc.terminate()
        for name, proc in list(self.procs.items()):
            try:
                proc.wait(timeout=10)
            except Exception:
                proc.kill()
        self.procs.clear()
