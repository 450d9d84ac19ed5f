"""Erasure-code plugin framework.

Mirrors the reference's plugin architecture (src/erasure-code/): an abstract
interface contract (ErasureCodeInterface.h:170-462), a base class with shared
chunk math (ErasureCode.{h,cc}), a named-plugin registry (ErasureCodePlugin.cc),
and the plugin families jerasure / isa / shec / lrc / clay.  Every plugin's
encode/decode lowers to the batched GF(2^8) product of
ceph_tpu_torch.ops.gf_kernel (gf_matvec: the CUDA kernel on the card), instead
of per-stripe SIMD calls; the numpy oracle (runtime=cpu) is the bit-exactness
ground truth and the C encode (runtime=native) the single-core yardstick.
"""

from .interface import ErasureCodeInterface
from .base import ErasureCode
from .registry import ErasureCodePluginRegistry, instance as registry_instance
from . import jerasure as _jerasure  # noqa: F401  (registers plugins on import)
from . import isa as _isa  # noqa: F401
from . import shec as _shec  # noqa: F401
from . import lrc as _lrc  # noqa: F401
from . import clay as _clay  # noqa: F401

__all__ = [
    "ErasureCodeInterface",
    "ErasureCode",
    "ErasureCodePluginRegistry",
    "registry_instance",
]
