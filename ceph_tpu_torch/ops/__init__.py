"""Device kernels of the port, their plain torch versions, and the engine
that batches calls to them.

gf_kernel    GF(2^8) encode / recovery / heterogeneous decode (gf_matvec),
             tables cut to fit its shared memory (make_encoder, ec_encode).
crush_kernel rjenkins hashes, crush_ln, straw2 draws, is_out (plain torch);
             flat_firstn (the plain loop, or the column kernels on the card).
straw2_cuda  the CRUSH fast path's root, leaf and consume column kernels.
placement_kernel  the fused placement tail (upmap, up filter, primary
             affinity, temps): ladder_ref (numpy), ladder_plain (torch), the
             dense operands; placement_cuda its pg_finish_ladder kernel.
checksum_kernel  the deep-scrub digest (crc32 + GF(2^8) Horner) of zero-padded
             rows: operands, the segmented plain version, the oracle;
             digest_cuda its scrub_digest kernel.
dispatch     the coalescing dispatch engine and its EC, CRUSH, pg_finish and
             scrub_digest channels.
telemetry    kernel, dispatch, phase and tenant ledgers.
_build       nvcc build of csrc/*.cu, ctypes binding, launch counts.
"""
