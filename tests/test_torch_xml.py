"""The port's RDF/XML and OWL/XML readers against the reference's.

Every XML document of ``tests/test_xml_readers.py`` (read off its
source, so a document added there is held here too) and every real
corpus under ``tests/corpora/`` goes through both packages' readers:
the same axioms in the same order, the same errors on a bad document,
the same ``IndexedOntology``; and through both classifiers
(``classify_text``, the port on ``device="cpu"``), the same taxonomy,
derivations and iterations.  Equality is exact everywhere.
"""

import ast
from pathlib import Path

import pytest
import torch

import test_xml_readers
from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.core.indexing import index_ontology as ref_index
from distel_tpu.frontend.normalizer import normalize as ref_normalize
from distel_tpu.frontend.profile_checker import check_profile as ref_check
from distel_tpu.owl import loader as ref_loader
from distel_tpu.runtime.classifier import ELClassifier as RefClassifier
from distel_tpu_torch.core.indexing import index_ontology
from distel_tpu_torch.frontend.normalizer import normalize
from distel_tpu_torch.frontend.profile_checker import check_profile
from distel_tpu_torch.owl import loader, owlxml, rdfxml
from distel_tpu_torch.runtime.classifier import ELClassifier
from test_torch_frontend import _assert_same_index
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)

TESTS = Path(__file__).parent
CORPORA = TESTS / "corpora"


def _reader_documents():
    """Every string literal of ``test_xml_readers.py`` that is an XML
    document or fragment, evaluated with the module's names (f-strings
    included)."""
    names = {**vars(test_xml_readers),
             "xsd_int": "http://www.w3.org/2001/XMLSchema#integer"}
    tree = ast.parse(Path(test_xml_readers.__file__).read_text())
    docs = []
    for node in ast.walk(tree):
        if isinstance(node, ast.JoinedStr):
            text = eval(compile(ast.Expression(node), "<doc>", "eval"), names)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            text = node.value
        else:
            continue
        if text.lstrip().startswith("<") and text not in docs:
            docs.append(text)
    return docs


DOCS = _reader_documents()
FILES = sorted(CORPORA.glob("*.owl")) + sorted(CORPORA.rglob("sygenia/**/*.owl"))


def _corpus(path):
    return path.read_text(encoding="utf-8-sig")


def _load_both(text):
    """``(reference ontology, port ontology)``; a document the reference
    refuses must be refused by the port with the same error."""
    try:
        want = ref_loader.load(text)
    except Exception as err:  # noqa: BLE001 — the port must match it
        with pytest.raises(type(err)) as got:
            loader.load(text)
        assert str(got.value) == str(err)
        return None, None
    return want, loader.load(text)


def test_every_reader_document_is_found():
    assert len(DOCS) >= 10
    for name in ("RDFXML", "OWLXML"):
        assert getattr(test_xml_readers, name) in DOCS
    assert {loader.detect_format(d) for d in DOCS} == {"rdfxml", "owlxml"}


@pytest.mark.parametrize("text", DOCS, ids=lambda t: f"doc{DOCS.index(t)}")
def test_reader_document_matches_reference(text):
    assert loader.detect_format(text) == ref_loader.detect_format(text)
    want, got = _load_both(text)
    if want is None:
        return
    assert [repr(a) for a in got.axioms] == [repr(a) for a in want.axioms]
    assert check_profile(got) == ref_check(want)
    if not want.axioms:
        return
    _assert_same_index(ref_index(ref_normalize(want)), index_ontology(normalize(got)))


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_corpus_reader_matches_reference(path):
    text = _corpus(path)
    assert loader.detect_format(text) == "rdfxml"
    want, got = _load_both(text)
    assert [repr(a) for a in got.axioms] == [repr(a) for a in want.axioms]
    assert repr(rdfxml.parse(text).axioms) == repr(got.axioms)
    assert check_profile(got) == ref_check(want)
    _assert_same_index(ref_index(ref_normalize(want)), index_ontology(normalize(got)))


@pytest.mark.parametrize("path", FILES[:2], ids=lambda p: p.stem)
def test_owlxml_writer_round_trip_matches_reference(path):
    """The copied OWL/XML writer serializes a corpus as the reference's
    does, and both readers read the text back to the same axioms."""
    from distel_tpu.owl import owlxml as ref_owlxml

    want, got = _load_both(_corpus(path))
    text = owlxml.ontology_to_str(got)
    assert text == ref_owlxml.ontology_to_str(want)
    assert [repr(a) for a in owlxml.parse(text).axioms] == [
        repr(a) for a in ref_owlxml.parse(text).axioms]


def _classify_both(text):
    ref = RefClassifier(RefConfig(shape_buckets=False)).classify_text(text)
    got = ELClassifier(device="cpu").classify_text(text)
    assert got.norm is not None and "parse" in got.timer.phases
    assert (got.taxonomy.parents, got.taxonomy.equivalents,
            sorted(got.taxonomy.unsatisfiable)) == (
        ref.taxonomy.parents, ref.taxonomy.equivalents,
        sorted(ref.taxonomy.unsatisfiable))
    assert got.result.derivations == ref.result.derivations
    assert got.result.iterations == ref.result.iterations
    return ref, got


@pytest.mark.parametrize(
    "text",
    [test_xml_readers.RDFXML, test_xml_readers.OWLXML],
    ids=["rdfxml", "owlxml"],
)
def test_classify_xml_matches_reference_and_ofn(text):
    """The default classify reads XML through the Python plane, and
    gives the taxonomy of the same ontology written as OFN."""
    _ref, got = _classify_both(text)
    ofn = ELClassifier(device="cpu").classify_text(test_xml_readers.OFN)
    assert got.taxonomy.parents == ofn.taxonomy.parents
    assert got.taxonomy.equivalents == ofn.taxonomy.equivalents


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_classify_corpus_matches_reference(path):
    _classify_both(_corpus(path))


def test_lubm_inverse_is_reported_and_dropped():
    onto = loader.load_file(str(CORPORA / "lubm_univ_bench.owl"))
    kept, removed = check_profile(onto)
    assert removed == {"InverseObjectProperties": 2}
    assert kept + 2 == len(onto.axioms)
    assert normalize(onto).removed["InverseObjectProperties"] == 2



def test_smoke_reads_the_reader_documents():
    """``chip_smoke.py`` reads the three serializations off this test
    module's source (it may not import the JAX package)."""
    import chip_smoke

    docs = chip_smoke.xml_reader_documents()
    for name in ("OFN", "RDFXML", "OWLXML"):
        assert docs[name] == getattr(test_xml_readers, name)


@pytest.mark.parametrize("path", FILES[:2], ids=lambda p: p.stem)
def test_smoke_el_part_round_trips_through_ofn(path):
    """The smoke's OFN form of an XML corpus (its EL part, relative IRIs
    bracketed) reads back as that EL part and classifies to the XML
    run's taxonomy and derivations."""
    import chip_smoke
    from distel_tpu_torch.frontend.ontology_tools import strip_non_el

    onto = loader.load(_corpus(path))
    text = chip_smoke.el_part_as_ofn(onto)
    assert [repr(a) for a in loader.load(text).axioms] == [
        repr(a) for a in strip_non_el(onto).axioms]
    xml = ELClassifier(device="cpu").classify_text(_corpus(path))
    ofn = ELClassifier(device="cpu").classify_text(text)
    assert xml.taxonomy.parents == ofn.taxonomy.parents
    assert xml.result.derivations == ofn.result.derivations
