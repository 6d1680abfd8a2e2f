"""The kernel build helper and launch counters, on the CPU (no nvcc, no
card): what can be checked without compiling."""
import sys
import threading

import pytest

from repro_torch.kernels import build


def test_library_path_is_keyed_by_sources_and_flags():
    a = build.library_path("paged_attention")
    assert a == build.library_path("paged_attention")
    assert a.parent == build.BUILD_DIR and a.suffix == ".so"
    assert a.name.startswith("paged_attention-")
    assert a != build.library_path("flash_attention")
    m = build.library_path("mamba_scan")
    assert m.name.startswith("mamba_scan-") and m not in (a, build.library_path("flash_attention"))
    assert set(build.ENTRY_POINTS) == {p.stem for p in build.CSRC.glob("*.cu")}
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


@pytest.mark.parametrize("rc,match", [(-1, "dtype"), (-2, "head_dim"), (-3, "grouping"),
                                      (-4, "shape"), (-5, "state size")])
def test_argument_errors_raise(rc, match):
    with pytest.raises(ValueError, match=match):
        build.check(rc, "paged_attention")
    build.check(0, "paged_attention")          # success is silent


def test_launch_counter_loses_no_update_under_threads():
    """Stage workers all launch kernels: 16 threads hammer one counter
    with a tiny switch interval; every add must land."""
    counter = build.LaunchCounter()
    n_threads, n_adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counter.add() for _ in range(n_adds)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.value == n_threads * n_adds
    counter.reset()
    assert counter.value == 0
