"""The kernel-variant profiler's patches (segmentation_tpu_torch/
profile_variants.py), on CPU: each variant's patches find their text in
today's sources exactly as often as they expect, the patched Python still
compiles, and a variant's copy holds the patched files and no build."""

import pytest

from segmentation_tpu_torch import profile_variants as pv


@pytest.mark.parametrize("name", list(pv.VARIANTS))
def test_variant_patches_apply(name):
    files = pv.patched(name)
    assert bool(files) == (name != "base")
    for rel, text in files.items():
        assert text != (pv.PKG / rel).read_text()
        if rel.endswith(".py"):
            compile(text, rel, "exec")


def test_variant_copy(tmp_path):
    root = pv.make("no_pingpong", tmp_path)
    pkg = root / pv.PKG.name
    assert (pkg / pv.FWD).read_text() == pv.patched("no_pingpong")[pv.FWD]
    # one plan serves the four forward wrappers
    flat = (pkg / pv.FLAT).read_text()
    assert flat.count("{128: 256, 256: 128}[o4]") == 1
    assert flat.count("_fwd_plan(") >= 5
    assert not (pkg / "csrc" / "build").exists()
    assert (pkg / "csrc" / "sm90_igemm.cuh").read_text() == \
        (pv.PKG / pv.SM90).read_text()


def test_only_the_cut_outs_skip_the_check():
    assert set(pv.CUTS) < set(pv.VARIANTS)
    assert all(pv.VARIANTS[c] for c in pv.CUTS)


def test_unknown_text_raises(monkeypatch):
    monkeypatch.setitem(pv.VARIANTS, "bad",
                        [(pv.FWD, "no such text", "x", 1)])
    with pytest.raises(ValueError, match="0 times"):
        pv.patched("bad")


def test_parent_copy_is_unpatched(tmp_path):
    """``parent`` copies another checkout's package as it is."""
    src = tmp_path / "parent" / pv.PKG.name
    (src / "csrc" / "build").mkdir(parents=True)
    (src / "csrc" / "packed_conv2x2_fwd.cuh").write_text("the parent's\n")
    (src / "csrc" / "build" / "lib.so").write_text("stale")
    root = pv.make(pv.PARENT, tmp_path / "work", src)
    pkg = root / pv.PKG.name
    assert (pkg / pv.FWD).read_text() == "the parent's\n"
    assert not (pkg / "csrc" / "build").exists()


def test_parent_needs_a_path():
    with pytest.raises(SystemExit, match="needs --parent"):
        pv.main(["--variants", "base,parent"])
