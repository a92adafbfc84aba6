"""The SASS counter of rawaudiovae_kelsey_tpu_torch/probes/sass_count.py on
a canned ``cuobjdump -sass`` listing: the functions split out, the path to
the first unpredicated EXIT, the counts by class and the issue bound.  The
probe itself disassembles the built library on the card."""

import pytest

from rawaudiovae_kelsey_tpu_torch.probes import sass_count

LISTING = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_119philox_words_kernelEjjPjii
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe20000000800 */
        /*0010*/                   EXIT ;                                 /* 0x000000000000794d */
                                                                          /* 0x000fea0003800000 */
                Function : _ZN12_GLOBAL__N_121reparameterize_kernelEjjPKfS1_Pfii
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_CTAID.X ;                   /* 0x0000000000007919 */
        /*0020*/                   IMAD.WIDE.U32 R2, R0, 0x100, RZ ;      /* 0x0000010000027825 */
        /*0030*/                   ISETP.GE.U32.AND P0, PT, R2, R4, PT ;  /* 0x000000040200720c */
        /*0040*/               @P0 EXIT ;                                 /* 0x000000000000094d */
        /*0050*/                   IMAD.HI.U32 R5, R2, -0x2daee0ad, RZ ;  /* 0xd25120ad02057827 */
        /*0060*/                   LOP3.LUT R6, R5, R7, R8, 0x96, !PT ;   /* 0x0000000705067212 */
        /*0070*/                   MUFU.LG2 R9, R6 ;                      /* 0x0000000600097308 */
        /*0080*/              @!P1 BRA 0xc0 ;                             /* 0x0000000000009947 */
        /*0090*/                   FFMA R10, R9, R9, R9 ;                 /* 0x0000000909097223 */
        /*00a0*/                   STG.E desc[UR4][R2.64], R10 ;          /* 0x0000000a02007986 */
        /*00b0*/                   EXIT ;                                 /* 0x000000000000794d */
        /*00c0*/                   FMUL R9, R9, 0.5 ;                     /* 0x3f00000009097820 */
        /*00d0*/                   BRA 0x90 ;                             /* 0xfffffffc00007947 */
        /*00e0*/                   BRA 0xe0;                              /* 0xfffffff000007947 */
"""


def test_functions_are_split_out_with_their_predicates():
    found = sass_count.functions(LISTING)
    assert list(found) == [
        "_ZN12_GLOBAL__N_119philox_words_kernelEjjPjii",
        "_ZN12_GLOBAL__N_121reparameterize_kernelEjjPKfS1_Pfii"]
    body = found["_ZN12_GLOBAL__N_121reparameterize_kernelEjjPKfS1_Pfii"]
    assert len(body) == 15
    assert body[4] == ("@P0", "EXIT")
    assert body[8] == ("@!P1", "BRA")
    assert body[3][1] == "ISETP.GE.U32.AND"


def test_the_path_runs_to_the_first_unpredicated_exit():
    body = sass_count.functions(LISTING)[
        "_ZN12_GLOBAL__N_121reparameterize_kernelEjjPKfS1_Pfii"]
    path = sass_count.main_path(body)
    assert len(path) == 12 and path[-1] == ("", "EXIT")
    assert sass_count.by_class(path) == {
        "EXIT": 2, "LDC": 1, "S2R": 1, "IMAD": 2, "ISETP": 1, "LOP3": 1,
        "MUFU": 1, "BRA": 1, "FFMA": 1, "STG": 1}
    # no unpredicated EXIT: the whole function
    assert sass_count.main_path(body[:4]) == body[:4]


@pytest.mark.parametrize("instructions,elements,sms,mhz,want_ms", [
    # 32768 warps x 200 instructions over 4 x 132 issue slots at 1980 MHz
    (200, 4096 * 256, 132, 1980.0, 32768 * 200 / (4 * 132 * 1980e6) * 1e3),
    (1, 33, 1, 1000.0, 2 / 4e9 * 1e3),          # a ragged last warp
])
def test_the_issue_bound(instructions, elements, sms, mhz, want_ms):
    assert sass_count.issue_bound_ms(instructions, elements, sms, mhz) == \
        pytest.approx(want_ms)
