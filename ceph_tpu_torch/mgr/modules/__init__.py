"""Mgr module ecosystem (src/pybind/mgr/* analogs).  Every submodule
exports a ``Module`` class subclassing
:class:`ceph_tpu_torch.mgr.module.MgrModule`; the host loads them by name
from the always-on set plus the mon-persisted enabled list."""
