"""Device kernels of the port and their plain torch versions.

gf_kernel    GF(2^8) encode / recovery / heterogeneous decode (gf_matvec),
             tables cut to fit its shared memory (make_encoder, ec_encode).
crush_kernel rjenkins hashes, crush_ln, straw2 draws, is_out (plain torch).
straw2_cuda  the CRUSH fast path's root, leaf and consume column kernels.
_build       nvcc build of csrc/*.cu, ctypes binding, launch counts.
"""
