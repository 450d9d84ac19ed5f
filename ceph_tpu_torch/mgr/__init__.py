"""Manager package, ported one slice at a time: the two messages the mon
and the OSD speak (MMgrReport, MMgrBeacon).  MgrDaemon and the module
host come later."""

from ceph_tpu_torch.mgr.daemon import MMgrBeacon, MMgrReport

__all__ = ["MMgrBeacon", "MMgrReport"]
