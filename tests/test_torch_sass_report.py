"""tools.sass_report on hand-written cuobjdump text: the parser that
chip_smoke.py's build phase uses to check that the straw2 kernels call no
64-bit divide and no function per item, and to count the GF kernel's
instructions per lookup (cuobjdump itself runs only where the CUDA toolkit
is)."""

import pytest

from ceph_tpu_torch.tools import sass_report as sr

ROOT = "_ZN41_GLOBAL__N__b2407e84_9_straw2_cu_66a8e9ee18straw2_root_kernelEPKjii"
FROOT = ("_ZN49_GLOBAL__N__57b003aa_16_straw2_filter_cu_acc68f7e19"
         "straw2_froot_kernelEPKjii")

SASS = f"""
	code for sm_90a
		Function : {ROOT}
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe40000000800 */
        /*0010*/                   IADD3 R8, -R6, 0x38740, -R7 ;  /* 0x0 */
        /*0020*/                   SHF.R.U32.HI R9, RZ, 0xd, R6 ;
        /*0030*/                   LOP3.LUT R9, R8, R9, RZ, 0x3c, !PT ;
        /*0040*/                   IMAD.SHL.U32 R8, R9, 0x100, RZ ;
        /*0050*/                   CALL.REL.NOINC 0x80 ;
        /*0060*/               @!P1 BRA 0x10 ;
        /*0070*/                   EXIT ;
        /*0080*/                   I2F.U64.RP R20, R4 ;
        /*0090*/                   RET.REL.NODEC R18 0x0 ;
		Function : {FROOT}
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   IADD3 R8, -R6, 0x38740, -R7 ;
        /*0010*/                   IADD3 R8, -R6, 0x38740, -R7 ;
        /*0020*/                   LDG.E.CONSTANT R2, desc[UR6][R6.64] ;
        /*0030*/                   FCHK P0, R2, R0 ;
        /*0040*/               @!P0 BRA 0x60 ;
        /*0050*/                   CALL.REL.NOINC 0xa0 ;
        /*0060*/                   FMNMX R13, R0, R13, PT ;
        /*0070*/               @!P1 BRA 0x0 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x90 ;
        /*00a0*/                   SHF.R.U32.HI R20, RZ, 0x17, R0 ;
        /*00b0*/                   RET.REL.NODEC R6 0x0 ;
"""

RES = f"""
Resource usage:
 Common:
  GLOBAL:0
 Function {ROOT}:
  REG:28 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:592 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_kernel_names_demangled():
    assert set(sr.parse_sass(SASS)) == {"straw2_root_kernel",
                                        "straw2_froot_kernel"}
    assert sr.parse_res_usage(RES) == {"straw2_root_kernel": {
        "registers": 28, "stack": 0, "shared": 0, "local": 0}}


def test_root_item_loop_and_its_divide_call():
    ins = sr.parse_sass(SASS)["straw2_root_kernel"]
    loop = sr.item_loop(ins)
    assert loop["address"] == "0x0010-0x0060"
    assert loop["instructions"] == 6 and loop["hashes"] == 1
    assert loop["per_item"] == {"alu": 3.0, "control": 2.0, "fma": 1.0}
    assert loop["calls"] == [{"kind": "u64 divide", "instructions": 2}]


def test_filter_loop_counts_two_items_and_the_fchk_slow_path():
    ins = sr.parse_sass(SASS)["straw2_froot_kernel"]
    loop = sr.item_loop(ins)
    assert loop["address"] == "0x0000-0x0070" and loop["hashes"] == 2
    assert loop["per_item_total"] == 4.0
    assert [c["kind"] for c in loop["calls"]] == ["f32 divide slow path"]


@pytest.mark.parametrize("op,pipe", [
    ("IADD3", "alu"), ("LOP3.LUT", "alu"), ("SHF.R.U32.HI", "alu"),
    ("IMAD.HI.U32", "fma"), ("IMAD.MOV.U32", "fma"), ("FFMA", "fma"),
    ("LDS.64", "mio"), ("SHFL.BFLY", "mio"), ("MUFU.RCP", "xu"),
    ("CALL.REL.NOINC", "control"), ("UIADD3", "uniform"),
    ("VIADD", "viadd"), ("S2UR", "other")])
def test_pipe_groups(op, pipe):
    assert sr.pipe_of(op) == pipe


GF8 = ("_ZN45_GLOBAL__N__a0827642_12_gf_matvec_cu_23a4928f16gf_matvec_kernel"
       "ILi8EEEvPKhPKjPKiPhiiiii")
GF0 = GF8.replace("ILi8EE", "ILi0EE")

GF_SASS = f"""
		Function : {GF8}
        /*0000*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0010*/                   PRMT R9, R4, 0x7770, RZ ;
        /*0020*/                   LDS R10, [R9.X4+0x400] ;
        /*0030*/                   PRMT R11, R4, 0x7771, RZ ;
        /*0040*/                   LDS R12, [R11.X4+0x400] ;
        /*0050*/                   LOP3.LUT R20, R20, R10, R12, 0x96, !PT ;
        /*0060*/               @!P0 BRA 0x10 ;
        /*0070*/               @!P1 BRA 0x0 ;
        /*0080*/                   EXIT ;
		Function : {GF0}
        /*0000*/                   EXIT ;
"""


def test_gf_template_instances_and_lookup_loop():
    kernels = sr.parse_sass(GF_SASS)
    assert set(kernels) == {"gf_matvec_kernel<8>", "gf_matvec_kernel<0>"}
    loop = sr.lookup_loop(kernels["gf_matvec_kernel<8>"])
    assert loop["address"] == "0x0010-0x0060"
    assert loop["instructions"] == 6 and loop["lookups"] == 2
    assert loop["per_lookup"] == 3.0
    assert loop["per_byte_column"] == 3.0 * sr.GF_LOOKUPS_PER_COLUMN
    assert loop["by_pipe"] == {"alu": 3, "control": 1, "mio": 2}
    assert sr.lookup_loop(kernels["gf_matvec_kernel<0>"]) is None
