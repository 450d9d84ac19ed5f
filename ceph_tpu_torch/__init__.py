"""ceph_tpu_torch — the PyTorch and CUDA port of ceph_tpu's numeric data path.

The slice ported so far is the flagship pipeline: batched GF(2^8) erasure
encode and recovery (ops.gf_kernel) and bulk straw2 CRUSH placement by the
chooseleaf-firstn fast path (crush.fastpath), each running hand-written CUDA
kernels for sm_90a (csrc/) on the card, with a plain torch version of every
kernel beside it.  ``entry.entry()`` drives both halves.

Importing the package sets no global configuration and builds nothing: the
kernels are compiled with nvcc at their first CUDA call (ops._build).
"""

__all__ = ["convert", "crush", "entry", "gf", "ops"]
