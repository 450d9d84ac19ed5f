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
encodes, decodes, CRUSH remaps and placement tails into padded calls on the
card.  Above it: the OSDMap, its wire codec (msg.encoding, osd.map_codec),
crushtool's text format (crush.text, crush.classes), and the shared PG
mapping service (osd.mapping) with its fused placement tail
(ops.placement_kernel, the pg_finish_ladder kernel) and its tools
(crushtool, osdmap_test, psim).

Importing the package sets no global configuration and builds nothing: the
kernels are compiled with nvcc at their first CUDA call (ops._build).
"""

__all__ = ["common", "convert", "crush", "ec", "entry", "gf", "msg", "native",
           "ops", "osd", "tools"]
