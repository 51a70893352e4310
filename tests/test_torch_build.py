"""The kernel build's cache key (``ops/_build.py::source_digest``): a
library is named by a hash of its source, every ``csrc/*.cuh`` header and
the flags, so an edit to a header that a source includes builds it anew
instead of loading a stale library."""

from distrl_llm_tpu_torch.ops import _build


def test_digest_follows_the_source_the_headers_and_the_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\nint f() { return 1; }\n')
    (tmp_path / "common.cuh").write_text("#pragma once\nconstexpr int kTile = 64;\n")
    first = _build.source_digest("k")
    assert _build.source_digest("k") == first  # unchanged: the cached library
    (tmp_path / "common.cuh").write_text("#pragma once\nconstexpr int kTile = 32;\n")
    after_header = _build.source_digest("k")
    assert after_header != first
    (tmp_path / "other.cuh").write_text("#pragma once\n")  # a new header
    after_new = _build.source_digest("k")
    assert after_new != after_header
    (tmp_path / "k.cu").write_text('#include "common.cuh"\nint f() { return 2; }\n')
    after_source = _build.source_digest("k")
    assert after_source != after_new
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.source_digest("k") != after_source


def test_every_kernel_source_has_a_digest():
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert {"paged_attention", "paged_verify"} <= set(names)
    assert sorted(_build.CSRC.glob("*.cuh"))  # the shared paged body
    digests = {n: _build.source_digest(n) for n in names}
    assert len(set(digests.values())) == len(names)


def test_digest_follows_the_defines(tmp_path, monkeypatch):
    """A measurement's variant (``load(name, defines)``) is a library of its
    own: no define keeps the package's key, each define makes another."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("int f() { return K; }\n")
    plain = _build.source_digest("k")
    assert _build.source_digest("k", ()) == plain
    one = _build.source_digest("k", ("K=1",))
    four = _build.source_digest("k", ("K=4",))
    assert len({plain, one, four}) == 3
    assert _build._flags(("K=4",))[-1] == "-DK=4"
