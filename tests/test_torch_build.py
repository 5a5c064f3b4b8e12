"""Building the CUDA kernels (no nvcc here): the build command, where it
reads and writes, and that a missing compiler raises instead of falling
back to the plain version."""

from pathlib import Path

import pytest
import torch

from dmlp_tpu_torch import kernels
from dmlp_tpu_torch.ops import dist_segmin as ds
from dmlp_tpu_torch.ops import extract as ex

PKG = Path(kernels.__file__).resolve().parents[1]


def test_every_kernel_source_is_built():
    """K1/K2 (with the merge of their split lists) and K3, one source
    each; build_all starts one nvcc per source. The merge has a launch
    count of its own."""
    assert kernels.SOURCES == ("extract_topk", "dist_segmin")
    assert set(kernels.LAUNCHES) == {"fused_topk", "extract_topk",
                                     "extract_merge", "fused_dist_segmin"}


@pytest.mark.parametrize("name", kernels.SOURCES)
def test_build_command_targets_sm90a_and_stays_in_the_package(name):
    argv, tmp = kernels.build_command(name, nvcc="nvcc")
    assert argv[0] == "nvcc"
    assert "-arch=sm_90a" in argv
    src = Path(argv[-1])
    assert src == PKG / "kernels" / f"{name}.cu" and src.is_file()
    out = Path(argv[argv.index("-o") + 1])
    assert out == tmp and out.parent == PKG / "_build"
    lib = kernels.library_path(name)
    assert lib.parent == PKG / "_build" and lib.suffix == ".so"


def test_library_name_tracks_source_and_flags(monkeypatch):
    before = kernels.library_path("extract_topk")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert kernels.library_path("extract_topk") != before


def _hide_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(kernels, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(kernels, "_loaded", {})


def test_missing_nvcc_raises_and_writes_nothing(monkeypatch, tmp_path):
    _hide_nvcc(monkeypatch, tmp_path)
    build = PKG / "_build"
    existing = set(build.iterdir()) if build.exists() else set()
    monkeypatch.setattr(kernels, "library_path",
                        lambda n: build / f"{n}-absent.so")
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        kernels.find_nvcc()
    with pytest.raises(kernels.KernelBuildError):
        kernels.load("extract_topk")
    with pytest.raises(kernels.KernelBuildError):
        ex._kernel_lib()
    assert kernels._loaded == {}
    after = set(build.iterdir()) if build.exists() else set()
    assert after == existing


# source: the tile constants its wrapper sizes outputs by
TILES = {"extract_topk": (f"TQ = {ex.QUERY_TILE};", f"TN = {ex.BLOCK_ROWS};"),
         "dist_segmin": (f"SEG = {ds.SEG};", f"TQ = {ds.QUERY_TILE};",
                         f"CTAS_PER_SM = {ds.CTAS_PER_SM};",
                         "__launch_bounds__(NT, CTAS_PER_SM)")}


@pytest.mark.parametrize("name", kernels.SOURCES)
def test_kernel_source_is_hand_written_cuda(name):
    """No library kernel for the product: only the CUDA runtime and math
    headers, no cuBLAS / cuDNN, no tensor-core instruction (so no TF32);
    the tiles match the wrapper's."""
    src = (PKG / "kernels" / f"{name}.cu").read_text()
    includes = [ln.split()[1] for ln in src.splitlines()
                if ln.startswith("#include")]
    assert includes[0] == "<cuda_runtime.h>" and set(includes) <= {
        "<cuda_runtime.h>", "<cuda_bf16.h>", "<math.h>", "<stdint.h>"}
    for banned in ("cublas", "cudnn", "wmma", "mma_sync", "mma.sync"):
        assert banned not in src.lower(), banned
    assert all(t in src for t in TILES[name])
    assert 'extern "C"' in src and "cudaGetLastError" in src


def test_cpu_tensors_take_the_plain_version_only(monkeypatch, tmp_path):
    """On the CPU the wrapper never touches the kernel library; nothing
    decides by probing."""
    _hide_nvcc(monkeypatch, tmp_path)
    q, d = torch.rand(16, 4), torch.rand(512, 4)
    before = dict(kernels.LAUNCHES)
    od, oi, it = ex.extract_topk(q, d[:256], n_real=256, kc=8)
    assert od.shape == (16, 8) and it.shape == (1, 1)
    od, oi, it = ex.extract_topk(q, d, od, oi, n_real=512, kc=8, splits=2)
    assert od.shape == (16, 8) and it.shape == (1, 2)
    pd, pi = od.expand(2, -1, -1), oi.expand(2, -1, -1)
    assert ex.merge_partials(None, None, pd, pi)[0].shape == (16, 8)
    d = d[:256]
    dist, segmin = ds.fused_dist_segmin(q, d, torch.arange(256))
    assert dist.shape == (16, 256) and segmin.shape == (16, 2)
    assert kernels._loaded == {} and kernels.LAUNCHES == before


def test_segmin_kernel_runs_on_the_cuda_cores_only():
    """K3's product stays IEEE f32 FMAs on the CUDA cores: no tensor-core
    instruction in any form, no TF32, and one body for both precisions
    (the bf16 operands are rounded by the wrapper)."""
    src = (PKG / "kernels" / "dist_segmin.cu").read_text()
    for banned in ("mma", "tf32", "bfloat16"):
        assert banned not in src.lower(), banned
    assert "fmaf(" in src and "cp.async" in src and "__stcs(" in src
