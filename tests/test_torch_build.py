"""The port's kernel build (ray_tpu_torch.ops._build), on the CPU: the
library a source builds into is named by a hash of that source and of
every shared header, so an edit to either gives a new library path and a
stale library is never loaded.  No nvcc runs here."""

import pytest

from ray_tpu_torch.ops import _build


@pytest.fixture
def src(tmp_path, monkeypatch):
    """A csrc/ of two kernels that share one header."""
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text('#include "shared.cuh"\nint b;\n')
    (tmp_path / "shared.cuh").write_text("#pragma once\nint shared;\n")
    return tmp_path


@pytest.mark.parametrize("edit", ["header", "source", "new_header"])
def test_library_path_follows_sources_and_headers(src, edit):
    before = {n: _build.library_path(n) for n in ("a", "b")}
    assert before["a"].parent == src / "_build"
    assert before["a"].name.startswith("liba-") and before["a"] != before["b"]
    assert _build.library_path("a") == before["a"]        # stable
    if edit == "header":
        (src / "shared.cuh").write_text("#pragma once\nint shared2;\n")
        changed = {"a", "b"}
    elif edit == "source":
        (src / "a.cu").write_text('#include "shared.cuh"\nint a2;\n')
        changed = {"a"}
    else:
        (src / "other.cuh").write_text("#pragma once\n")
        changed = {"a", "b"}
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert {n for n in after if after[n] != before[n]} == changed


@pytest.mark.parametrize("name, dtypes", [("flash_attention", (0, 1)),
                                          ("splash_attention", (0, 1)),
                                          ("paged_attention", ())])
def test_wrapper_head_dims_match_the_kernel_dispatch(name, dtypes):
    """A wrapper's ``_HEAD_DIMS`` (the head_dims it lets through to the
    launch) equal the ``hd == N`` cases of its kernel's launch dispatch,
    read from the source: for flash and splash in fp32 (dtype 0) and in
    bf16 (dtype 1) alike, and for the usage queries.  A head_dim the
    wrapper takes that the dispatch lacks would end in a CUDA error on
    the card instead of a ValueError here."""
    import importlib
    import re
    module = importlib.import_module(
        "ray_tpu_torch.ops." + ("splash" if name == "splash_attention"
                                else name))
    want = set(module._HEAD_DIMS)
    text = (_build.SRC_DIR / f"{name}.cu").read_text()
    assert {int(n) for n in re.findall(r"\bhd == (\d+)\)", text)} == want
    for dtype in dtypes:
        cases = re.findall(rf"dtype == {dtype} && hd == (\d+)\) return run<",
                           text)
        assert {int(n) for n in cases} == want, (name, dtype)
