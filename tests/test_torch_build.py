"""The port's CUDA build on the CPU (no nvcc needed): the library's name
carries a hash of everything that goes into it — the kernel source, every
shared header under csrc/ and the flags — so an edited header is rebuilt
and never loaded stale. And `chip_smoke.parse_ptxas` reads the register
and spill report that `nvcc -Xptxas -v` writes to `ops/build/<name>.log`.
"""

import pytest

pytest.importorskip("torch")

from ray_tpu_torch.ops import _build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "one.cu").write_text('#include "shared.cuh"\nint one;\n')
    (src / "two.cu").write_text("int two;\n")
    (src / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_sources_are_the_cu_files(csrc):
    assert _build.sources() == ["one", "two"]


def test_library_path_is_stable_and_under_build_dir(csrc):
    path = _build.library_path("one")
    assert path == _build.library_path("one")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libone-") and path.suffix == ".so"
    assert path != _build.library_path("two")


def test_editing_a_header_changes_the_library_path(csrc):
    before = _build.library_path("one")
    (csrc / "shared.cuh").write_text("#pragma once\n#define TILE 64\n")
    assert _build.library_path("one") != before


def test_adding_a_header_changes_the_library_path(csrc):
    before = _build.library_path("one")
    (csrc / "more.cuh").write_text("#pragma once\n")
    assert _build.library_path("one") != before


def test_editing_the_source_changes_the_library_path(csrc):
    before = _build.library_path("one")
    (csrc / "one.cu").write_text('#include "shared.cuh"\nint one = 1;\n')
    assert _build.library_path("one") != before


def test_flags_and_include_paths_change_the_library_path(csrc, monkeypatch):
    before = _build.library_path("one")
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        (*_build.NVCC_FLAGS, "-Iextra/include"))
    assert _build.library_path("one") != before


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__97fe6771_22_flash_attention_fwd_cu_2c1389798fwd_sm90I13__nv_bfloat16Li64EEEv14CUtensorMap_stS2_S2_PT_Pfiiilllfi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__97fe6771_22_flash_attention_fwd_cu_2c1389798fwd_sm90I13__nv_bfloat16Li64EEEv14CUtensorMap_stS2_S2_PT_Pfiiilllfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 106 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__0c6f2567_22_flash_attention_bwd_cu_107c2caf10bwd_dq_f32IfLi16EEEvPKT_S3_S3_S3_PKfS5_PS1_NS_7StridesEiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__0c6f2567_22_flash_attention_bwd_cu_107c2caf10bwd_dq_f32IfLi16EEEvPKT_S3_S3_S3_PKfS5_PS1_NS_7StridesEiiifi
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 8 bytes cumulative stack size, 256 bytes smem
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__0c6f2567_22_flash_attention_bwd_cu_107c2caf8dkv_sm90I6__halfLi128EEEv14CUtensorMap_stS2_S2_S2_PKfS4_PT_S6_lllllliiiffi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 195 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__97fe6771_22_flash_attention_fwd_cu_2c1389798fwd_sm90I6__halfLi32ELi2EEEv14CUtensorMap_stS2_S2_PT_Pfiiilllfi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 99 registers, used 1 barriers
"""


def test_parse_ptxas_reads_each_kernel_instance():
    chip_smoke = pytest.importorskip("chip_smoke")
    rows = chip_smoke.parse_ptxas(PTXAS_LOG)
    assert [(r["fn"], r["dtype"], r["head_dim"], r["warpgroups"])
            for r in rows] == [
        ("fwd_sm90", "bfloat16", 64, 1), ("bwd_dq_f32", "float32", 16, 1),
        ("dkv_sm90", "float16", 128, 1), ("fwd_sm90", "float16", 32, 2)]
    assert [r["registers"] for r in rows] == [106, 48, 195, 99]
    assert rows[0]["spill_store_bytes"] == rows[0]["spill_load_bytes"] == 0
    assert (rows[1]["stack_bytes"], rows[1]["spill_store_bytes"],
            rows[1]["spill_load_bytes"]) == (8, 4, 12)
    assert rows[1]["smem_static_bytes"] == 256
    assert rows[2]["smem_static_bytes"] == 0
