"""Manager daemon package: the module host (daemon), the MgrModule
framework (module), and the module ecosystem (modules/)."""

from ceph_tpu_torch.mgr.daemon import MgrDaemon, MMgrBeacon, MMgrReport
from ceph_tpu_torch.mgr.module import MgrModule, ModuleHost

__all__ = ["MgrDaemon", "MMgrBeacon", "MMgrReport", "MgrModule",
           "ModuleHost"]
