"""The port's dense engine and its differential check.

The dense ``SaturationEngine`` of ``distel_tpu_torch/core/engine.py``
against the JAX package's (CPU, both at ``unroll=1``): S, R, the iteration
count and the derivations must be equal, and so must the port's
row-packed closure on the same index.  ``verify=True`` and the ``diff``
command hold a closure against the CPU oracle, whose copy in the port
equals the reference's apart from its imports, and they must report a
planted wrong bit.
"""

import random
from pathlib import Path

import numpy as np
import pytest
import torch

from distel_tpu.core.engine import SaturationEngine as RefDense
from distel_tpu.core.indexing import index_ontology
from distel_tpu.frontend.normalizer import normalize
from distel_tpu.frontend.ontology_tools import (
    chain_tailed_ontology,
    snomed_shaped_ontology,
)
from distel_tpu.owl import parser
from distel_tpu_torch import cli
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core.engine import SaturationEngine
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.frontend.normalizer import normalize as port_normalize
from distel_tpu_torch.owl import parser as port_parser
from distel_tpu_torch.runtime.classifier import ELClassifier
from distel_tpu_torch.testing.differential import (
    classify_and_diff,
    diff_engine_vs_oracle,
)
from test_engine_dense import _random_ontology
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = sorted((ROOT / "tests" / "golden").glob("*.ofn"))

CORPORA = {
    "snomed": lambda: snomed_shaped_ontology(n_classes=600),
    "chain-tailed": lambda: chain_tailed_ontology(400, 12),
    "bottom-chain": lambda: (ROOT / "tests" / "golden" / "19-bottom-chain.ofn")
    .read_text(),
    "random-0": lambda: _random_ontology(random.Random(11)),
    "random-1": lambda: _random_ontology(random.Random(12), n_classes=30,
                                         n_roles=4, n_axioms=70),
}


def _index(text):
    return index_ontology(normalize(parser.parse(text)))


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_dense_engine_matches_reference_and_rowpacked(corpus):
    idx = _index(CORPORA[corpus]())
    want = RefDense(idx, unroll=1).saturate()
    got = SaturationEngine(idx, device="cpu", unroll=1).saturate()
    assert np.array_equal(got.s, np.asarray(want.s))
    assert np.array_equal(got.r, np.asarray(want.r))
    assert got.iterations == want.iterations
    assert got.derivations == want.derivations
    row = RowPackedSaturationEngine(idx, device="cpu").saturate()
    for x, y in zip(got.wire(), row.wire()):
        assert np.array_equal(x, y)
    assert row.derivations == got.derivations


def test_dense_resume_matches_reference():
    """A resume from a partial closure (x-major bool, as the
    reference's ``embed_state`` takes it) finishes to the reference's,
    in as many rounds; a cut run raises unless allowed."""
    idx = _index(CORPORA["chain-tailed"]())
    with pytest.raises(RuntimeError, match="did not converge"):
        SaturationEngine(idx, device="cpu").saturate(3)
    part = RefDense(idx, unroll=1).saturate(3, allow_incomplete=True)
    assert not part.converged
    state = (np.asarray(part.s), np.asarray(part.r))
    want = RefDense(idx, unroll=1).saturate(initial=state)
    got = SaturationEngine(idx, device="cpu", unroll=1).saturate(initial=state)
    assert np.array_equal(got.s, np.asarray(want.s))
    assert (got.iterations, got.derivations) == (want.iterations,
                                                 want.derivations)
    with pytest.raises(TypeError, match="uint32"):
        SaturationEngine(idx, device="cpu").embed_state(*got.wire())


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_verify_passes_on_the_goldens(path):
    for engine in ("dense", "rowpacked"):
        clf = ELClassifier(ClassifierConfig(engine=engine), device="cpu")
        res = clf.classify_file(str(path), verify=True)
        assert "verify" in res.timer.phases


def test_diff_reports_a_planted_wrong_bit():
    text = "SubClassOf(A B)\nSubClassOf(B C)\nSubClassOf(D ObjectSomeValuesFrom(r A))"
    norm = port_normalize(port_parser.parse(text))
    result, report = classify_and_diff(norm, device="cpu")
    assert report.ok() and report.compared > 0
    idx = result.idx
    a, c = idx.concept_ids["A"], idx.concept_ids["C"]
    s = result.s.copy()
    s[a, c] = False                         # A ⊑ C lost
    s[idx.concept_ids["C"], idx.concept_ids["A"]] = True  # C ⊑ A invented
    result._s = s
    bad = diff_engine_vs_oracle(norm, result)
    assert not bad.ok() and bad.miss_count == 2
    assert bad.missing == {"A": {"C"}} and bad.extra == {"C": {"A"}}
    assert "MISMATCH: 2 differences" in bad.summary()


def test_verify_raises_on_a_wrong_closure(monkeypatch):
    from distel_tpu_torch.testing import differential

    real = differential.diff_engine_vs_oracle

    def planted(norm, result, oracle_result=None):
        idx = result.idx
        s = result.s.copy()
        s[idx.concept_ids["A"], idx.concept_ids["C"]] = False
        result._s = s
        return real(norm, result, oracle_result)

    monkeypatch.setattr(differential, "diff_engine_vs_oracle", planted)
    with pytest.raises(AssertionError, match="engine missing"):
        ELClassifier(device="cpu").classify_text(
            "SubClassOf(A B)\nSubClassOf(B C)", verify=True
        )


def test_cli_diff_and_verify(tmp_path, capsys):
    src = tmp_path / "onto.ofn"
    src.write_text((ROOT / "tests" / "golden" / "11-disjoint.ofn").read_text())
    assert cli.main(["diff", str(src), "--device", "cpu"]) == 0
    assert "OK:" in capsys.readouterr().out
    props = tmp_path / "dense.properties"
    props.write_text("engine = dense\n")
    assert cli.main(["classify", str(src), "--device", "cpu", "--config",
                     str(props), "--verify"]) == 0
    assert '"derivations"' in capsys.readouterr().out


def test_oracle_is_a_copy_apart_from_imports():
    def body(path):
        return [
            ln for ln in path.read_text().splitlines()
            if not ln.startswith(("from distel_tpu", "import distel_tpu"))
        ]

    ref = ROOT / "distel_tpu" / "core" / "oracle.py"
    port = ROOT / "distel_tpu_torch" / "core" / "oracle.py"
    assert body(port) == body(ref)
    imports = [ln for ln in port.read_text().splitlines()
               if ln.startswith("from distel_tpu")]
    assert imports and all(ln.startswith("from distel_tpu_torch.") for ln in imports)
