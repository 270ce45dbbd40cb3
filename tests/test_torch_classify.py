"""The port's one-shot classify against the reference classifier.

``distel_tpu_torch``'s ``ELClassifier(ClassifierConfig(
use_native_loader=False), device="cpu").classify_text`` and the
reference ``ELClassifier(ClassifierConfig(shape_buckets=False,
use_native_loader=False))`` (both on the Python load plane, whose ids
the tests compare) must give the same taxonomy and the same summary
counts; the golden fixtures pass the golden checker through the
port; and snapshots resume across the two packages in both directions.
Equality is exact everywhere.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.frontend.ontology_tools import (
    chain_tailed_ontology,
    snomed_shaped_ontology,
)
from distel_tpu.runtime import checkpoint as ref_checkpoint
from distel_tpu.runtime.classifier import ELClassifier as RefClassifier
from distel_tpu_torch import cli
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.ops import bitmatmul
from distel_tpu_torch.runtime import checkpoint
from distel_tpu_torch.runtime.classifier import ELClassifier
from distel_tpu_torch.runtime.taxonomy import extract_taxonomy
from test_golden import _load_expected, _named_closure

GOLDEN = sorted((Path(__file__).parent / "golden").glob("*.ofn"))

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)
COUNTS = ("concepts", "roles", "links", "normalized_axioms",
          "removed_axioms", "derivations", "unsatisfiable")


def _ref_classifier():
    return RefClassifier(RefConfig(shape_buckets=False, use_native_loader=False))


def _port_classifier():
    # the Python load plane, as the reference classifier's: the tests
    # compare ids and wire state, which differ between the planes
    return ELClassifier(ClassifierConfig(use_native_loader=False), device="cpu")


def _tax_key(tax):
    return (tax.parents, tax.equivalents, sorted(tax.unsatisfiable))


def _wire(result):
    return (np.asarray(result.packed_s).astype(np.uint32),
            np.asarray(result.packed_r).astype(np.uint32))


@pytest.fixture(scope="module")
def snomed_text():
    return snomed_shaped_ontology(n_classes=500, seed=11)


@pytest.mark.parametrize(
    "corpus",
    [
        pytest.param(lambda: snomed_shaped_ontology(n_classes=500, seed=11),
                     id="snomed"),
        pytest.param(lambda: chain_tailed_ontology(300, 8), id="chain-tailed"),
        pytest.param(lambda: (Path(__file__).parent / "golden"
                              / "19-bottom-chain.ofn").read_text(),
                     id="bottom-chain"),
    ],
)
def test_classify_matches_reference(corpus):
    text = corpus()
    ref = _ref_classifier().classify_text(text)
    got = _port_classifier().classify_text(text)
    assert _tax_key(got.taxonomy) == _tax_key(ref.taxonomy)
    assert got.taxonomy.subsumers == ref.taxonomy.subsumers
    want, have = ref.summary(), got.summary()
    assert {k: have[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    s, r = got.result.wire()
    ws, wr = _wire(ref.result)
    assert np.array_equal(s, ws) and np.array_equal(r, wr)


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_through_the_port(path):
    """The golden checker of tests/test_golden.py, and the smoke
    script's copy of it, both pass on the port's result."""
    res = _port_classifier().classify_file(str(path))
    expected = _load_expected(path.with_suffix(".expected"))
    closure = _named_closure(res.result)
    assert chip_smoke.golden_closure(res.result) == closure
    assert chip_smoke.load_expected(path.with_suffix(".expected")) == expected
    assert chip_smoke.golden_errors(closure, expected) == []


def test_smoke_checker_catches_a_wrong_closure():
    expected = {"A": {"B"}, "U": {"owl:Nothing", "B"}}
    assert chip_smoke.golden_errors({"A": {"B"}, "U": {"owl:Nothing", "B", "C"}},
                                    expected) == []
    assert chip_smoke.golden_errors({"A": {"B", "C"}, "U": {"owl:Nothing", "B"}},
                                    expected)
    assert chip_smoke.golden_errors({"A": {"B"}, "U": {"B"}}, expected)
    assert chip_smoke.golden_errors({"U": {"owl:Nothing", "B"}}, expected)


@pytest.mark.parametrize("block", [64, 4096])
def test_blocked_device_taxonomy_equals_host(snomed_text, block):
    """The blocked program (on a card: the dense packed-columns kernel)
    gives the host path's taxonomy, with small blocks too."""
    res = _port_classifier().classify_text(snomed_text)
    host = extract_taxonomy(res.result, method="host")
    dev = extract_taxonomy(res.result, method="device", block=block)
    assert _tax_key(dev) == _tax_key(host)
    assert dev.subsumers == host.subsumers


@pytest.mark.parametrize("route", ["sparse", "dense"])
def test_device_taxonomy_routing_equals_host(snomed_text, route, monkeypatch):
    """The taxonomy's product is not pinned to a route: the plan's auto
    rule picks it (every block sparse with the threshold at 0, dense with
    it past the product's work), and either gives the host taxonomy."""
    monkeypatch.setattr(bitmatmul, "SKIP_TILES_MIN_WORK",
                        0 if route == "sparse" else 1 << 62)
    seen = []
    orig = bitmatmul.PackedColsMatmulPlan.__call__

    def spy(plan, a, b, out=None):
        seen.append(plan.skip_zero_tiles)
        return orig(plan, a, b, out)

    monkeypatch.setattr(bitmatmul.PackedColsMatmulPlan, "__call__", spy)
    res = _port_classifier().classify_text(snomed_text)
    host = extract_taxonomy(res.result, method="host")
    seen.clear()
    dev = extract_taxonomy(res.result, method="device", block=128)
    assert len(seen) > 1 and set(seen) == {route == "sparse"}
    assert _tax_key(dev) == _tax_key(host)


def test_blocked_device_taxonomy_with_unsatisfiable_classes():
    text = (Path(__file__).parent / "golden" / "21-range-bottom.ofn").read_text()
    res = _port_classifier().classify_text(text)
    host = extract_taxonomy(res.result, method="host")
    dev = extract_taxonomy(res.result, method="device", block=2)
    assert host.unsatisfiable
    assert _tax_key(dev) == _tax_key(host)


def wide_parents_text(n_parents):
    """One class under ``n_parents`` incomparable direct parents."""
    return "\n".join(f"SubClassOf(X P{i})" for i in range(n_parents))


def test_blocked_device_taxonomy_keeps_every_direct_parent():
    """A class with thousands of direct parents leaves the blocked
    program whole: no cap on the parents a class may have."""
    res = _port_classifier().classify_text(wide_parents_text(5000))
    dev = extract_taxonomy(res.result, method="device", block=1024)
    assert len(dev.parents["X"]) == 5000
    assert _tax_key(dev) == _tax_key(extract_taxonomy(res.result, method="host"))


def _split(text):
    """A corpus and a strict subset of it (the first two thirds of its
    axiom lines)."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    return "\n".join(lines[: 2 * len(lines) // 3]), text


def test_resume_from_reference_snapshot(tmp_path, snomed_text):
    """The JAX package saves a partial run; the port resumes it to the
    reference's full closure."""
    from distel_tpu.core.rowpacked_engine import RowPackedSaturationEngine

    ref = _ref_classifier()
    full = ref.classify_text(snomed_text)
    engine = RowPackedSaturationEngine(full.idx, bucket=False, unroll=1)
    part = engine.saturate(2, allow_incomplete=True)
    assert not part.converged
    snap = str(tmp_path / "ref.npz")
    ref_checkpoint.save_snapshot(snap, part)
    got = _port_classifier().classify_text(snomed_text, resume_from=snap)
    assert np.array_equal(got.result.wire()[0], _wire(full.result)[0])
    assert np.array_equal(got.result.wire()[1], _wire(full.result)[1])
    assert _tax_key(got.taxonomy) == _tax_key(full.taxonomy)
    assert got.result.iterations < full.result.iterations


def test_resume_grown_corpus_from_reference_snapshot(tmp_path, snomed_text):
    """A snapshot of a SUBSET corpus realigns by name onto the grown one."""
    small, big = _split(snomed_text)
    ref = _ref_classifier()
    snap = str(tmp_path / "small.npz")
    ref_checkpoint.save_snapshot(snap, ref.classify_text(small).result)
    want = ref.classify_text(big)
    got = _port_classifier().classify_text(big, resume_from=snap)
    assert np.array_equal(got.result.wire()[0], _wire(want.result)[0])
    assert np.array_equal(got.result.wire()[1], _wire(want.result)[1])
    assert _tax_key(got.taxonomy) == _tax_key(want.taxonomy)


def test_reference_resumes_from_port_snapshot(tmp_path, snomed_text):
    """The reverse direction: the port saves a partial run, the JAX
    package resumes it to its own full closure."""
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

    port = _port_classifier().classify_text(snomed_text)
    engine = RowPackedSaturationEngine(port.idx, device="cpu")
    part = engine.saturate(2, allow_incomplete=True)
    snap = str(tmp_path / "port.npz")
    checkpoint.save_snapshot(snap, part)
    ref = _ref_classifier()
    want = ref.classify_text(snomed_text)
    got = ref.classify_text(snomed_text, resume_from=snap)
    assert np.array_equal(_wire(got.result)[0], _wire(want.result)[0])
    assert np.array_equal(_wire(got.result)[1], _wire(want.result)[1])
    assert _tax_key(got.taxonomy) == _tax_key(want.taxonomy)
    # and the reference reads the port's snapshot as it reads its own
    state, info = ref_checkpoint.load_snapshot_state(snap, idx=want.idx)
    assert info["iterations"] == 2 and not info["meta"]["converged"]
    assert np.array_equal(state[0], part.wire()[0])


def test_cli_classify_writes_taxonomy_and_snapshot(tmp_path, capsys):
    src = tmp_path / "onto.ofn"
    src.write_text((Path(__file__).parent / "golden" / "05-existential.ofn").read_text())
    out, snap = tmp_path / "tax.ofn", tmp_path / "snap.npz"
    rc = cli.main(["classify", str(src), "--device", "cpu", "-o", str(out),
                   "--snapshot", str(snap)])
    assert rc == 0
    assert "SubClassOf(" in out.read_text()
    again = _port_classifier().classify_file(str(src), resume_from=str(snap))
    assert again.result.iterations == 1      # nothing left to derive
    assert '"derivations"' in capsys.readouterr().out


def test_config_from_properties(tmp_path):
    props = tmp_path / "c.properties"
    props.write_text(
        "# reference keys\nmax.iterations = 77\ncr6.tiles.enable = false\n"
        "engine = rowpacked\nshape.buckets = false\n"
    )
    cfg = ClassifierConfig.from_properties(str(props))
    assert cfg.max_iterations == 77 and cfg.cr6_tiles_config() is None
    props.write_text("shape.buckets = true\n")
    with pytest.raises(ValueError, match="shape_buckets"):
        ClassifierConfig.from_properties(str(props))
    props.write_text("engine = dense\nnative.loader = false\n"
                     "normalize.cache.path = /x/cache.json\n")
    cfg = ClassifierConfig.from_properties(str(props))
    assert cfg.engine == "dense" and not cfg.use_native_loader
    assert cfg.normalize_cache_path == "/x/cache.json"
    with pytest.raises(ValueError, match="rowpacked"):
        ClassifierConfig(engine="sparse")


# ------------------------------------------------------- the packed engine

PACKED = dict(engine="packed")


def _ref_packed_classifier():
    return RefClassifier(RefConfig(engine="packed", shape_buckets=False,
                                   use_native_loader=False))


def _port_packed_classifier():
    return ELClassifier(
        ClassifierConfig(**PACKED, use_native_loader=False), device="cpu"
    )


@pytest.mark.parametrize(
    "corpus",
    [
        pytest.param(lambda: snomed_shaped_ontology(n_classes=500, seed=11),
                     id="snomed"),
        pytest.param(lambda: (Path(__file__).parent / "golden"
                              / "19-bottom-chain.ofn").read_text(),
                     id="bottom-chain"),
    ],
)
def test_packed_classify_matches_reference(corpus):
    """``engine="packed"`` through both packages: the same x-major
    closure, iterations, summary counts and taxonomy — and the port's
    row-packed engine's taxonomy."""
    text = corpus()
    ref = _ref_packed_classifier().classify_text(text)
    got = _port_packed_classifier().classify_text(text)
    assert type(got.engine).__name__ == "PackedSaturationEngine"
    assert _tax_key(got.taxonomy) == _tax_key(ref.taxonomy)
    want, have = ref.summary(), got.summary()
    assert {k: have[k] for k in COUNTS + ("iterations",)} == {
        k: want[k] for k in COUNTS + ("iterations",)
    }
    s, r = got.result.wire()
    ws, wr = _wire(ref.result)
    assert np.array_equal(s, ws) and np.array_equal(r, wr)
    row = _port_classifier().classify_text(text)
    assert _tax_key(row.taxonomy) == _tax_key(got.taxonomy)
    assert row.result.derivations == got.result.derivations


@pytest.mark.parametrize("block", [64, 4096])
def test_x_major_taxonomy_host_equals_device(snomed_text, block):
    """An x-major result through the host path and the blocked device
    program (on the CPU: the plain packed-columns version) equals the
    row-packed result's taxonomy."""
    got = _port_packed_classifier().classify_text(snomed_text)
    assert not got.result.transposed
    host = extract_taxonomy(got.result, method="host")
    dev = extract_taxonomy(got.result, method="device", block=block)
    assert _tax_key(dev) == _tax_key(host)
    assert dev.subsumers == host.subsumers
    row = _port_classifier().classify_text(snomed_text)
    assert _tax_key(extract_taxonomy(row.result, method="device", block=block)) \
        == _tax_key(dev)


def test_x_major_device_taxonomy_with_unsatisfiable_classes():
    text = (Path(__file__).parent / "golden" / "21-range-bottom.ofn").read_text()
    res = _port_packed_classifier().classify_text(text)
    host = extract_taxonomy(res.result, method="host")
    dev = extract_taxonomy(res.result, method="device", block=2)
    assert host.unsatisfiable
    assert _tax_key(dev) == _tax_key(host)


def test_port_packed_resumes_reference_v1_snapshot(tmp_path, snomed_text):
    """The reference packed engine saves a partial run (a v1 snapshot);
    the port's packed engine resumes it to the reference's closure."""
    from distel_tpu.core.packed_engine import PackedSaturationEngine as RefPacked

    full = _ref_packed_classifier().classify_text(snomed_text)
    part = RefPacked(full.idx, use_pallas=False).saturate(4, allow_incomplete=True)
    assert not part.converged
    snap = str(tmp_path / "ref_v1.npz")
    ref_checkpoint.save_snapshot(snap, part)
    assert "s_packed" in np.load(snap, allow_pickle=True)
    got = _port_packed_classifier().classify_text(snomed_text, resume_from=snap)
    s, r = got.result.wire()
    assert np.array_equal(s, _wire(full.result)[0])
    assert np.array_equal(r, _wire(full.result)[1])
    assert _tax_key(got.taxonomy) == _tax_key(full.taxonomy)
    assert got.result.iterations < full.result.iterations
    # the row-packed engine resumes the same v1 snapshot (bool form)
    row = _port_classifier().classify_text(snomed_text, resume_from=snap)
    assert _tax_key(row.taxonomy) == _tax_key(full.taxonomy)


def test_reference_packed_resumes_port_v1_snapshot(tmp_path, snomed_text):
    """The reverse direction: the port's packed engine saves a partial
    run as v1; the JAX package reads it as its own and resumes it."""
    from distel_tpu_torch.core.packed_engine import PackedSaturationEngine

    port = _port_packed_classifier().classify_text(snomed_text)
    part = PackedSaturationEngine(port.idx, device="cpu").saturate(
        4, allow_incomplete=True
    )
    snap = str(tmp_path / "port_v1.npz")
    checkpoint.save_snapshot(snap, part)
    ref = _ref_packed_classifier()
    want = ref.classify_text(snomed_text)
    got = ref.classify_text(snomed_text, resume_from=snap)
    assert np.array_equal(_wire(got.result)[0], _wire(want.result)[0])
    assert np.array_equal(_wire(got.result)[1], _wire(want.result)[1])
    assert _tax_key(got.taxonomy) == _tax_key(want.taxonomy)
    rs, rr, rinfo = ref_checkpoint.load_snapshot(snap)
    ps, pr, pinfo = checkpoint.load_snapshot(snap)
    assert np.array_equal(rs, ps) and np.array_equal(rr, pr)
    assert rinfo["iterations"] == pinfo["iterations"] == 4
    n = port.idx.n_concepts
    assert np.array_equal(ps, part.s[:n, :n])


def test_packed_engine_resumes_v2_rowpacked_snapshot(tmp_path, snomed_text):
    """A v2 (row-packed wire) snapshot reaches the packed engine
    unpacked (``unpack=True``), realigned by name, and resumes to the
    full closure; the wire form itself is refused by that engine."""
    from distel_tpu_torch.core.packed_engine import PackedSaturationEngine
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

    full = _port_packed_classifier().classify_text(snomed_text)
    part = RowPackedSaturationEngine(full.idx, device="cpu").saturate(
        2, allow_incomplete=True
    )
    snap = str(tmp_path / "row_v2.npz")
    checkpoint.save_snapshot(snap, part)
    got = _port_packed_classifier().classify_text(snomed_text, resume_from=snap)
    assert np.array_equal(got.result.wire()[0], full.result.wire()[0])
    assert np.array_equal(got.result.wire()[1], full.result.wire()[1])
    assert _tax_key(got.taxonomy) == _tax_key(full.taxonomy)
    state, _info = checkpoint.load_snapshot_state(snap, unpack=True, idx=full.idx)
    ref_state, _ = ref_checkpoint.load_snapshot_state(snap, unpack=True, idx=full.idx)
    assert all(np.array_equal(a, b) for a, b in zip(state, ref_state))
    wire, _info = checkpoint.load_snapshot_state(snap, idx=full.idx)
    with pytest.raises(TypeError, match="unpack=True"):
        PackedSaturationEngine(full.idx, device="cpu").saturate(initial=wire)


def test_cli_classify_with_the_packed_engine(tmp_path, capsys):
    src = tmp_path / "onto.ofn"
    src.write_text((Path(__file__).parent / "golden" / "05-existential.ofn").read_text())
    props = tmp_path / "packed.properties"
    props.write_text("engine = packed\nmatmul.dtype = bf16\n")
    assert ClassifierConfig.from_properties(str(props)).engine == "packed"
    snap, out = tmp_path / "snap.npz", tmp_path / "tax.ofn"
    rc = cli.main(["classify", str(src), "--device", "cpu", "--config", str(props),
                   "-o", str(out), "--snapshot", str(snap)])
    assert rc == 0 and "SubClassOf(" in out.read_text()
    assert "s_packed" in np.load(snap, allow_pickle=True)   # v1 from x-major
    rc = cli.main(["classify", str(src), "--device", "cpu", "--config", str(props),
                   "--resume", str(snap)])
    assert rc == 0 and '"derivations": 0' in capsys.readouterr().out


def test_dense_engine_is_refused():
    """``engine="dense"`` builds the dense engine (it is ported now),
    and an engine name the reference does not know is refused.  The
    name dates from when the port refused the dense engine; it is kept
    so the test's history reads as one test."""
    from distel_tpu_torch.core.engine import SaturationEngine
    from distel_tpu_torch.runtime.classifier import make_engine

    text = (Path(__file__).parent / "golden" / "05-existential.ofn").read_text()
    idx = _port_classifier().classify_text(text).idx
    engine = make_engine(ClassifierConfig(engine="dense"), idx, "cpu")
    assert isinstance(engine, SaturationEngine)
    with pytest.raises(ValueError, match="unknown engine"):
        ClassifierConfig(engine="Packed")
