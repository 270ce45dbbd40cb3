"""The port's per-rule backend routing and its config keys.

``distel_tpu_torch``'s ``HybridSaturator`` (the row-packed engine on
``device="cpu"`` for the device rules, numpy on the host for the routed
ones) against the reference's on every routing of
``tests/test_hybrid.py``: S, R, derivations and iterations must be
equal.  ``backend.CRn`` reaches it through the config and
``make_engine``; invalid routings, and routings on another engine than
the row-packed one, are refused as the reference refuses them; the
reference's mesh keys are refused, never dropped.
"""

import numpy as np
import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.core.hybrid import HybridSaturator as RefHybrid
from distel_tpu.core.indexing import index_ontology
from distel_tpu.frontend.normalizer import normalize
from distel_tpu.frontend.ontology_tools import (
    snomed_shaped_ontology,
    synthetic_ontology,
)
from distel_tpu.owl import parser
from distel_tpu.runtime.classifier import ELClassifier as RefClassifier
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core.hybrid import HybridSaturator, split_backends
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.runtime.classifier import ELClassifier, make_engine
from test_packed_engine import BOTTOM_ONTO
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)

ALL_HOST = {f"CR{i}": "host" for i in range(1, 7)}
DEEP_CHAIN = "\n".join(f"SubClassOf(C{i} C{i + 1})" for i in range(300))
CORPORA = {
    "bottom": lambda: BOTTOM_ONTO,
    "synthetic": lambda: synthetic_ontology(
        n_classes=200, n_anatomy=40, n_locations=25, n_definitions=15
    ),
    "snomed": lambda: snomed_shaped_ontology(400, seed=42),
    "deep-chain": lambda: DEEP_CHAIN,
}
#: every routing of tests/test_hybrid.py, and the smoke's two
CASES = [
    ("bottom", {"CR4": "host"}),
    ("bottom", {"CR1": "cpu"}),
    ("bottom", {"CR5": "oracle", "CR6": "redis"}),
    ("synthetic", ALL_HOST),
    ("deep-chain", {"CR1": "host"}),
    ("snomed", {"CR5": "host"}),
    ("snomed", {"CR1": "host", "CR6": "host"}),
    ("snomed", {"CR4": "tpu", "CR2": "device"}),
]


def _index(text):
    return index_ontology(normalize(parser.parse(text)))


@pytest.mark.parametrize(
    "corpus,routed", CASES,
    ids=[f"{c}-{'+'.join(sorted(r))}" for c, r in CASES],
)
def test_hybrid_matches_reference(corpus, routed):
    idx = _index(CORPORA[corpus]())
    want = RefHybrid(idx, routed).saturate()
    got = HybridSaturator(idx, routed, device="cpu").saturate()
    n, nl = idx.n_concepts, idx.n_links
    assert np.array_equal(got.s[:n, :n], np.asarray(want.s)[:n, :n])
    assert np.array_equal(got.r[:n, :nl], np.asarray(want.r)[:n, :nl])
    assert (got.iterations, got.derivations, got.converged) == (
        want.iterations, want.derivations, want.converged)
    full = RowPackedSaturationEngine(idx, device="cpu").saturate()
    assert np.array_equal(got.s[:n, :n], full.s[:n, :n])
    assert got.derivations == full.derivations


def test_split_backends_validates():
    assert split_backends({}) == (
        frozenset(f"CR{i}" for i in range(1, 7)), frozenset()
    )
    with pytest.raises(ValueError, match="unknown rule"):
        split_backends({"CR9": "tpu"})
    with pytest.raises(ValueError, match="unknown backend"):
        split_backends({"CR1": "gpu"})
    with pytest.raises(ValueError, match="unknown rule"):
        ClassifierConfig(rule_backends={"CR7": "host"})
    with pytest.raises(ValueError, match="unknown backend"):
        ClassifierConfig(rule_backends={"CR2": "gpu"})


def test_classifier_routes_rules_to_the_host():
    routed = {"CR4": "host"}
    got = ELClassifier(ClassifierConfig(rule_backends=routed, use_native_loader=False),
                       device="cpu").classify_text(BOTTOM_ONTO)
    want = RefClassifier(RefConfig(rule_backends=routed, shape_buckets=False,
                                   use_native_loader=False)).classify_text(BOTTOM_ONTO)
    assert isinstance(got.engine, HybridSaturator)
    assert got.engine.host_rules == {"CR4"}
    assert "CatDog" in got.taxonomy.unsatisfiable
    assert got.taxonomy.parents == want.taxonomy.parents
    assert (got.result.iterations, got.result.derivations) == (
        want.result.iterations, want.result.derivations)


def test_device_only_routing_keeps_the_plain_engine():
    idx = _index(BOTTOM_ONTO)
    cfg = ClassifierConfig(rule_backends={"CR1": "tpu"})
    assert type(make_engine(cfg, idx, "cpu")) is RowPackedSaturationEngine


@pytest.mark.parametrize("engine", ["packed", "dense"])
def test_hybrid_requires_the_rowpacked_engine(engine):
    cfg = ClassifierConfig(engine=engine, rule_backends={"CR4": "host"})
    with pytest.raises(ValueError, match="requires the"):
        ELClassifier(cfg, device="cpu").classify_text("SubClassOf(A B)")


def test_backend_keys_are_parsed(tmp_path):
    props = tmp_path / "c.properties"
    props.write_text("backend.CR4 = host\nbackend.CR1 = tpu\nengine = rowpacked\n")
    cfg = ClassifierConfig.from_properties(str(props))
    assert cfg.rule_backends == {"CR4": "host", "CR1": "tpu"}
    assert cfg.rule_backends == RefConfig.from_properties(str(props)).rule_backends
    props.write_text("backend.CR4 = gpu\n")
    with pytest.raises(ValueError, match="unknown backend"):
        ClassifierConfig.from_properties(str(props))
    props.write_text("backend.CR8 = host\n")
    with pytest.raises(ValueError, match="unknown rule"):
        ClassifierConfig.from_properties(str(props))


@pytest.mark.parametrize(
    "line,key",
    [("mesh.devices = 4", "mesh.devices"),
     ("NODES_LIST = node1,node2", "NODES_LIST"),
     ("mesh.devices = 1", "mesh.devices"),
     ("NODES_LIST = node1", "NODES_LIST")],
)
def test_mesh_keys_are_refused(tmp_path, line, key):
    """The mesh plane is ported (``parallel/mesh.py``): each line the
    port once refused now builds the reference's mesh size — in process
    a mesh of one, and a larger one only with the ranks to hold it (so
    a single process refuses it, naming the launchers); a key naming no
    device builds none, in both packages."""
    from distel_tpu.config import ClassifierConfig as RefConfig
    from distel_tpu.parallel.mesh import setup as ref_setup
    from distel_tpu_torch.parallel.mesh import setup

    props = tmp_path / "c.properties"
    props.write_text(line + "\n")
    want = RefConfig.from_properties(str(props)).mesh_devices
    cfg = ClassifierConfig.from_properties(str(props))
    assert cfg.mesh_devices == want
    if want == 1:
        assert setup(cfg, device="cpu").size == 1
    else:
        with pytest.raises(ValueError, match="launch_local"):
            setup(cfg, device="cpu")
    props.write_text("mesh.devices = 0\nNODES_LIST = \n")
    assert ref_setup(RefConfig.from_properties(str(props))) is None
    assert setup(ClassifierConfig.from_properties(str(props))) is None
