"""The port's native load plane against the JAX package's.

``distel_tpu_torch/native/distel_loader.cpp`` is a byte-for-byte copy of
``native/distel_loader.cpp``; built by the port (``build/torch_native``)
it must give the same :class:`IndexedOntology` as the JAX package's
``native_loader.load_indexed``, array for array and name for name, and
the same closure and taxonomy by name as the port's Python load plane.
``ELClassifier`` takes it by default (phase ``load(native)``), and a
failed build raises instead of falling back.
"""

import dataclasses
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from distel_tpu.owl import native_loader as ref_native
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.frontend.ontology_tools import (
    chain_tailed_ontology,
    snomed_shaped_ontology,
    synthetic_ontology,
)
from distel_tpu_torch.owl import native_loader
from distel_tpu_torch.runtime.checkpoint import load_snapshot_state, save_snapshot
from distel_tpu_torch.runtime.classifier import ELClassifier
from test_engine_dense import _random_ontology
from test_native_loader import CASES

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = sorted((ROOT / "tests" / "golden").glob("*.ofn"))
GENERATED = ("distel:gensym#", "distel:aux#")


def _assert_same_index(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def _by_name(res):
    """Named subsumer sets of every non-generated concept."""
    idx = res.idx
    s = res.result.s
    n = idx.n_concepts
    out = {}
    for name, cid in idx.concept_ids.items():
        if name.startswith(GENERATED):
            continue
        out[name] = {
            idx.concept_names[j] for j in np.nonzero(s[cid, :n])[0]
            if not idx.concept_names[j].startswith(GENERATED)
        }
    return out


def _tax_key(tax):
    return (tax.parents, tax.equivalents, sorted(tax.unsatisfiable))


def _classify(text, native):
    cfg = ClassifierConfig(use_native_loader=native)
    return ELClassifier(cfg, device="cpu").classify_text(text)


def test_source_is_a_verbatim_copy():
    assert (ROOT / "distel_tpu_torch" / "native" / "distel_loader.cpp").read_bytes() \
        == (ROOT / "native" / "distel_loader.cpp").read_bytes()


def test_builds_its_own_library():
    """The port builds its copy under build/torch_native, never the JAX
    package's library under native/build."""
    path = native_loader.build()
    assert Path(path).parent == ROOT / "build" / "torch_native"
    assert "native/build" not in path and Path(path).exists()


def _corpora():
    out = [pytest.param(p.read_text(), id=p.stem) for p in GOLDEN]
    out += [pytest.param(c, id=f"case-{i}") for i, c in enumerate(CASES)]
    out += [
        pytest.param(snomed_shaped_ontology(n_classes=400, n_roles=24),
                     id="snomed"),
        pytest.param(chain_tailed_ontology(200, 8), id="chain-tailed"),
        pytest.param(synthetic_ontology(n_classes=150, n_anatomy=40,
                                        n_locations=40, n_definitions=20),
                     id="synthetic"),
    ]
    for seed in range(4):
        out.append(pytest.param(_random_ontology(random.Random(seed * 31 + 7)),
                                id=f"random-{seed}"))
    return out


@pytest.mark.parametrize("text", _corpora())
def test_index_equals_reference_native_plane(text):
    _assert_same_index(native_loader.load_indexed(text),
                       ref_native.load_indexed(text))


@pytest.mark.parametrize("text", [
    pytest.param(snomed_shaped_ontology(n_classes=500, seed=11), id="snomed"),
    pytest.param(chain_tailed_ontology(300, 8), id="chain-tailed"),
    pytest.param((ROOT / "tests" / "golden" / "19-bottom-chain.ofn").read_text(),
                 id="bottom-chain"),
    pytest.param(_random_ontology(random.Random(5)), id="random"),
])
def test_closure_and_taxonomy_equal_the_python_plane(text):
    native, python = _classify(text, True), _classify(text, False)
    assert "load(native)" in native.timer.phases
    assert "parse" not in native.timer.phases and native.norm is None
    assert "load(native)" not in python.timer.phases
    assert _by_name(native) == _by_name(python)
    assert _tax_key(native.taxonomy) == _tax_key(python.taxonomy)
    # derivations count generated concepts too, which the planes may
    # name and number differently; with the same concepts they agree
    if native.idx.n_concepts == python.idx.n_concepts:
        assert native.result.derivations == python.result.derivations


def test_default_classify_reports_the_native_phase():
    res = ELClassifier(device="cpu").classify_text(
        "SubClassOf(A B)\nSubClassOf(C ObjectUnionOf(D E))"
    )
    assert list(res.timer.phases)[0] == "load(native)"
    assert res.summary()["removed_axioms"] == 1


def test_python_plane_when_verifying_or_caching(tmp_path):
    """verify=True and a normalizer cache take the Python plane, as the
    reference does; the cache is written and read back."""
    text = chain_tailed_ontology(40, 4)
    res = ELClassifier(device="cpu").classify_text(text, verify=True)
    assert "parse" in res.timer.phases and "verify" in res.timer.phases
    cache = tmp_path / "norm.json"
    cfg = ClassifierConfig(normalize_cache_path=str(cache))
    first = ELClassifier(cfg, device="cpu").classify_text(text)
    assert "load(native)" not in first.timer.phases and cache.exists()
    again = ELClassifier(cfg, device="cpu").classify_text(text)
    assert _tax_key(again.taxonomy) == _tax_key(first.taxonomy)


def test_removed_report_matches_reference():
    text = ("SubClassOf(A ObjectUnionOf(B C))\nHasKey(A () (p))\n"
            "ReflexiveObjectProperty(r)")
    got = native_loader.removed_report(text)
    assert got == ref_native.removed_report(text)
    assert got.get("SubClassOf(non-EL)") == 1 and got.get("HasKey") == 1


def test_parse_errors_raise():
    with pytest.raises(ValueError, match="native parse error"):
        native_loader.load_indexed("SubClassOf(A <unclosed")
    with pytest.raises(ValueError, match="native parse error"):
        ELClassifier(device="cpu").classify_text("SubClassOf(A <unclosed")


def test_failed_build_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """A compiler that fails names its command; classify raises rather
    than running the Python plane."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setenv("DISTEL_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false -O2 -std=c\\+\\+17"):
        ELClassifier(device="cpu").classify_text("SubClassOf(A B)")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native_loader.load_indexed("SubClassOf(A B)")


@pytest.mark.parametrize("direction", ["python-to-native", "native-to-python"])
def test_cross_plane_snapshot_resume(direction, tmp_path):
    """A snapshot saved on one plane resumes against the other plane's
    numbering: generated entities are dropped at alignment (their names
    collide across planes while denoting different expressions) and
    re-derived, so the named closure equals a fresh run's."""
    text = snomed_shaped_ontology(n_classes=300, n_roles=16)
    src_native = direction == "native-to-python"
    src, dst = _classify(text, src_native), _classify(text, not src_native)
    snap = str(tmp_path / "s.npz")
    save_snapshot(snap, src.result)
    state, _ = load_snapshot_state(snap, idx=dst.idx)
    resumed = RowPackedSaturationEngine(dst.idx, device="cpu").saturate(
        initial=state
    )
    fresh = dst.result
    orig = set(dst.idx.original_classes.tolist())
    for c in dst.idx.original_classes.tolist():
        a = {x for x in resumed.subsumers(c) if x in orig}
        b = {x for x in fresh.subsumers(c) if x in orig}
        assert a == b, dst.idx.concept_names[c]
