"""The kernel build's report, parsed on the CPU from nvcc's own output
lines (no nvcc here): which kernel each -Xptxas -v line describes, which
kernels spilled registers, and which lines are warnings or performance
notes. ``chip_smoke.py``'s build phase fails on a spill and prints the
notes."""
from repro_torch.kernels import build

LOG = """\
ptxas info    : Compiling entry function '_Z22flash_fwd_wgmma_kernelILi128EEv14CUtensorMap_stS0_S0_P13__nv_bfloat16iiiiiifi' for 'sm_90a'
ptxas info    : Function properties for _Z22flash_fwd_wgmma_kernelILi128EEv14CUtensorMap_stS0_S0_P13__nv_bfloat16iiiiiifi
    128 bytes stack frame, 208 bytes spill stores, 208 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 128 bytes cumulative stack size
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '_Z22flash_fwd_wgmma_kernelILi128EEv14CUtensorMap_stS0_S0_P13__nv_bfloat16iiiiiifi'
ptxas info    : Compiling entry function '_Z16flash_fwd_kernelIfLi128EEvPKT_S2_S2_PS0_iiiiiiifi' for 'sm_90a'
ptxas info    : Function properties for _Z16flash_fwd_kernelIfLi128EEvPKT_S2_S2_PS0_iiiiiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z20bucket_assign_kernelPKfS0_Piiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 10 bytes spill loads
ptxas info    : Used 25 registers, used 1 barriers
nvcc warning : Support for offline compilation for architectures prior to '<compute/sm/lto>_75' will be removed in a future release
"""


def test_ptxas_lines_are_keyed_by_kernel_and_template_instance():
    lines = build._ptxas_lines(LOG)
    assert set(lines) == {"flash_fwd_wgmma_kernel[Li128E]",
                          "flash_fwd_kernel[fLi128E]",
                          "bucket_assign_kernel"}
    assert lines["flash_fwd_wgmma_kernel[Li128E]"][0].startswith(
        "128 bytes stack frame")
    assert "Used 127 registers" in lines["flash_fwd_kernel[fLi128E]"][1]


def test_spilled_names_only_kernels_with_nonzero_spills():
    assert build.spilled(build._ptxas_lines(LOG)) == [
        "bucket_assign_kernel", "flash_fwd_wgmma_kernel[Li128E]"]
    assert build.spilled({"k": ["0 bytes stack frame, 0 bytes spill stores, "
                                "0 bytes spill loads"]}) == []


def test_notes_keep_warnings_and_performance_losses_only():
    notes = build._notes(LOG)
    assert len(notes) == 2
    assert "wgmma.mma_async instructions are serialized" in notes[0]
    assert notes[1].startswith("nvcc warning")
