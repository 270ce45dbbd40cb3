"""The port's parse → normalize → index against the reference's.

Every ``IndexedOntology`` array and name table must be equal, on every
golden fixture and on the synthetic corpora the engine tests use; the
port's copy of the CR6 live-tile schedule builder must give the
reference's schedule on the same tables; and every module the port
copies from the reference is the reference's text apart from its
import lines (``tests/test_torch_xml.py`` holds the XML readers to the
reference on every XML document of the tests).
"""

import inspect
from pathlib import Path

import numpy as np
import pytest

from distel_tpu.core import hybrid as ref_hybrid
from distel_tpu.core.cr6_tiles import build_cr6_tile_schedule as ref_schedule
from distel_tpu.core.indexing import index_ontology as ref_index
from distel_tpu.frontend import ontology_tools as ref_tools
from distel_tpu.frontend.normalizer import normalize as ref_normalize
from distel_tpu.owl import parser as ref_parser
from distel_tpu_torch.core import hybrid
from distel_tpu_torch.core.cr6_tiles import build_cr6_tile_schedule
from distel_tpu_torch.core.indexing import index_ontology
from distel_tpu_torch.frontend import ontology_tools as tools
from distel_tpu_torch.frontend.normalizer import normalize
from distel_tpu_torch.owl import loader, parser

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = sorted((Path(__file__).parent / "golden").glob("*.ofn"))
#: modules the port keeps as copies of the reference's
COPIES = ("owl/owlxml.py", "owl/rdfxml.py", "owl/loader.py",
          "frontend/profile_checker.py", "frontend/ontology_tools.py",
          "runtime/stats.py", "core/retract.py",
          "obs/flight.py", "serve/scheduler.py", "serve/client.py",
          "serve/traces.py", "serve/storage/__init__.py",
          "serve/query/__init__.py", "serve/fleet/__init__.py",
          "serve/fleet/router.py")
ARRAYS = ("nf1", "nf2", "nf3", "nf4", "links", "chain_pairs", "role_closure",
          "original_classes")
SCALARS = ("n_concepts", "n_roles", "concept_names", "concept_ids",
           "role_names", "role_ids", "has_bottom_axioms")


def _both(text):
    return (
        ref_index(ref_normalize(ref_parser.parse(text))),
        index_ontology(normalize(loader.load(text))),
    )


def _assert_same_index(r, p):
    for name in ARRAYS:
        a, b = np.asarray(getattr(r, name)), np.asarray(getattr(p, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert (a == b).all(), name
    for name in SCALARS:
        assert getattr(r, name) == getattr(p, name), name


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_index_matches_reference(path):
    _assert_same_index(*_both(path.read_text()))


@pytest.mark.parametrize(
    "text",
    [
        pytest.param(lambda: tools.chain_tailed_ontology(400, 12), id="chain-tailed"),
        pytest.param(lambda: tools.snomed_shaped_ontology(1200, seed=5), id="snomed"),
        pytest.param(lambda: tools.synthetic_ontology(500, 60, 40, 30), id="synthetic"),
    ],
)
def test_synthetic_index_matches_reference(text):
    _assert_same_index(*_both(text()))


def test_generators_are_copies():
    for args in ((300, 10), (50, 0)):
        assert tools.chain_tailed_ontology(*args) == ref_tools.chain_tailed_ontology(*args)
    for seed in (0, 42):
        assert tools.snomed_shaped_ontology(700, seed=seed) == \
            ref_tools.snomed_shaped_ontology(700, seed=seed)
        assert tools.synthetic_ontology(300, seed=seed) == \
            ref_tools.synthetic_ontology(300, seed=seed)


def test_parser_round_trip_and_xml_refused():
    """The name is historical: the port refused XML until it had the
    readers; now it loads an XML document as the reference does."""
    from distel_tpu.owl import loader as ref_loader

    text = "SubClassOf(A ObjectSomeValuesFrom(r B))"
    assert repr(parser.parse(text)) == repr(ref_parser.parse(text))
    for doc in ("<?xml version='1.0'?>"
                '<rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#"'
                ' xmlns:rdfs="http://www.w3.org/2000/01/rdf-schema#"'
                ' xmlns:owl="http://www.w3.org/2002/07/owl#">'
                '<owl:Class rdf:about="http://e/A">'
                '<rdfs:subClassOf rdf:resource="http://e/B"/></owl:Class></rdf:RDF>',
                '<Ontology xmlns="http://www.w3.org/2002/07/owl#">'
                '<SubClassOf><Class IRI="http://e/A"/><Class IRI="http://e/B"/>'
                "</SubClassOf></Ontology>"):
        assert loader.detect_format(doc) == ref_loader.detect_format(doc)
        assert repr(loader.load(doc)) == repr(ref_loader.load(doc))
        assert len(loader.load(doc)) == 1


def _body(path):
    """A module's lines without its import lines of either package."""
    return [
        ln for ln in path.read_text().splitlines()
        if not ln.lstrip().startswith(("from distel_tpu", "import distel_tpu"))
    ]


@pytest.mark.parametrize("rel", COPIES)
def test_module_is_a_copy_apart_from_imports(rel):
    port = ROOT / "distel_tpu_torch" / rel
    assert _body(port) == _body(ROOT / "distel_tpu" / rel)
    imports = [ln.strip() for ln in port.read_text().splitlines()
               if ln.lstrip().startswith(("from distel_tpu", "import distel_tpu"))]
    assert imports and all(ln.startswith("from distel_tpu_torch.") for ln in imports)


#: copied modules that import nothing of either package, pinned byte
#: for byte
VERBATIM = ("core/program_cache.py",)


@pytest.mark.parametrize("rel", VERBATIM)
def test_import_free_module_is_a_verbatim_copy(rel):
    port = (ROOT / "distel_tpu_torch" / rel).read_text()
    assert "distel_tpu" not in "\n".join(
        ln for ln in port.splitlines() if ln.lstrip().startswith(("from ", "import ")))
    assert port == (ROOT / "distel_tpu" / rel).read_text()


@pytest.mark.parametrize("name", ["split_backends", "apply_rules_host",
                                  "ALL_RULES", "_HOST_ALIASES", "_TPU_ALIASES"])
def test_hybrid_routing_is_a_copy(name):
    got, want = getattr(hybrid, name), getattr(ref_hybrid, name)
    if callable(got):
        assert inspect.getsource(got) == inspect.getsource(want)
    else:
        assert got == want


def test_multiply_and_strip_match_reference():
    from distel_tpu.frontend.ontology_tools import strip_non_el as ref_strip
    from distel_tpu.owl import loader as ref_loader

    path = str(ROOT / "tests" / "corpora" / "galen_module_jia.owl")
    onto, ref_onto = loader.load_file(path), ref_loader.load_file(path)
    for crossed in (False, True):
        got = tools.multiply_ontology(onto, 3, crossed=crossed)
        want = ref_tools.multiply_ontology(ref_onto, 3, crossed=crossed)
        assert got.iri == want.iri
        assert [repr(a) for a in got.axioms] == [repr(a) for a in want.axioms]
    got, want = tools.strip_non_el(onto), ref_strip(ref_onto)
    assert [repr(a) for a in got.axioms] == [repr(a) for a in want.axioms]
    assert len(got.axioms) == len(onto.axioms) - 12


@pytest.mark.parametrize("tile_m,tile_l,bounds", [(512, 256, None), (8, 4, 16)])
def test_cr6_schedule_matches_reference(tile_m, tile_l, bounds):
    _r, idx = _both(tools.snomed_shaped_ontology(900, seed=1))
    cp = idx.chain_pairs
    n_roles = idx.role_closure.shape[0]
    nl = ((idx.n_links + 31) // 32) * 32
    link_roles = np.full(nl, n_roles, np.int64)
    link_roles[: idx.n_links] = idx.links[:, 0]
    h2 = np.zeros((n_roles + 1, n_roles), np.int8)
    h2[:n_roles] = idx.role_closure
    m6 = np.ascontiguousarray(h2[:, cp[:, 0]].T)
    gb = [0, len(cp)] if bounds is None else list(range(0, len(cp), bounds)) + [len(cp)]
    kw = dict(lc=64, n_lchunks=-(-nl // 64), tile_m=tile_m, tile_l=tile_l,
              group_bounds=gb, dead_link=nl - 1, pad_target=0)
    got = build_cr6_tile_schedule(cp[:, 0], cp[:, 1], cp[:, 2], link_roles,
                                  idx.role_closure, **kw)
    want = ref_schedule(cp[:, 0], cp[:, 1], cp[:, 2], m6, link_roles,
                        idx.role_closure, **kw)
    for name in ("rows", "fdx", "tids", "tval"):
        assert (getattr(got, name) == getattr(want, name)).all(), name
    # the port keeps row ids into the mask table (pad: an all-zero row)
    # where the reference keeps the padded copy of its rows
    m6_pad = np.concatenate([m6, np.zeros((1, m6.shape[1]), np.int8)])
    assert (m6_pad[got.mrow_ids] == want.mrows).all()
    assert (got.n_rt, got.nt) == (want.n_rt, want.nt)
    assert got.stats == want.stats
    assert len(got.groups) == len(want.groups)
    for g, w in zip(got.groups, want.groups):
        assert g[:2] == w[:2]
        assert (g[3] == w[3]).all() and (g[4] == w[4]).all()
