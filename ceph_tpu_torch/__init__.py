"""ceph_tpu_torch — the PyTorch and CUDA port of ceph_tpu's numeric data path.

Ported so far: the flagship pipeline — batched GF(2^8) erasure encode and
recovery (ops.gf_kernel) and bulk straw2 CRUSH placement by the
chooseleaf-firstn fast path (crush.fastpath), each running hand-written CUDA
kernels for sm_90a (csrc/) on the card, with a plain torch version of every
kernel beside it; ``entry.entry()`` drives both halves.  Around them: the
torch rule interpreter (crush.mapper_torch), the erasure-code plugin layer
(ec: jerasure, isa, shec, lrc, clay) with its C yardstick (native), the
EC stripe math (osd.ec_util), the tools (crush_test, ec_benchmark,
ec_non_regression), and the device dispatch engine (ops.dispatch, with
ops.telemetry and common's context, config, failpoints, tracing, logging,
perf counters, admin socket and named locks) that coalesces concurrent EC
encodes, decodes and CRUSH remaps into padded calls on the card.

Importing the package sets no global configuration and builds nothing: the
kernels are compiled with nvcc at their first CUDA call (ops._build).
"""

__all__ = ["common", "convert", "crush", "ec", "entry", "gf", "native", "ops",
           "osd", "tools"]
