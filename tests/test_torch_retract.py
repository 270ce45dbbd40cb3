"""The port's retraction (DRed delete-and-rederive) against the
reference's.

The reference's scenarios (``tests/test_retract.py``) run through
``distel_tpu``'s ``IncrementalClassifier(ClassifierConfig(
shape_buckets=False))`` and ``distel_tpu_torch``'s
``IncrementalClassifier(device="cpu")``: after every add and every
retraction the history record, S and R by name and the taxonomy must be
equal, and after every retraction the taxonomy must also equal a
from-scratch classify of the surviving texts — tolerance 0.  Refusals
must raise the reference's error class and leave the classifier
untouched; a restore through an op log with retraction markers must
give the same closure.  ``core/retract.py`` itself is a pinned copy
(``tests/test_torch_frontend.py``).
"""

import json
import random

import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu.core import retract as ref_retract
from distel_tpu.core.incremental import IncrementalClassifier as RefInc
from distel_tpu.runtime.taxonomy import extract_taxonomy as ref_taxonomy
from distel_tpu_torch.core import retract
from distel_tpu_torch.core.incremental import IncrementalClassifier
from distel_tpu_torch.runtime.taxonomy import extract_taxonomy
from test_torch_incremental import _assert_same_closure
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

torch.set_num_threads(2)

RETRACT_KEYS = ("path", "iterations", "new_derivations", "retracted_rows",
                "affected_concepts")


def _tax_key(tax) -> str:
    return json.dumps(
        {"parents": tax.parents, "equivalents": tax.equivalents,
         "unsatisfiable": tax.unsatisfiable},
        sort_keys=True,
    )


def _oracle_key(texts) -> str:
    """A from-scratch classify of ``texts`` through the port."""
    inc = IncrementalClassifier(device="cpu")
    for t in texts:
        inc.add_text(t)
    return _tax_key(extract_taxonomy(inc.last_result))


class Both:
    """Both packages' classifiers, stepped together and held equal."""

    def __init__(self, texts=()):
        self.ref = RefInc(RefConfig(shape_buckets=False))
        # exact shapes, as the reference's (snapshots cross packages)
        self.port = IncrementalClassifier(ClassifierConfig(shape_buckets=False),
                                          device="cpu")
        for t in texts:
            self.add(t)

    def _same(self, rr, pr, keys):
        for key in keys:
            if key in self.ref.history[-1]:
                assert self.port.history[-1][key] == self.ref.history[-1][key], key
        _assert_same_closure(rr, pr)
        assert _tax_key(extract_taxonomy(pr)) == _tax_key(ref_taxonomy(rr))

    def add(self, text):
        self._same(self.ref.add_text(text), self.port.add_text(text),
                   ("path", "iterations", "new_derivations", "batch_axioms"))

    def retract(self, text):
        self._same(self.ref.retract(text), self.port.retract(text), RETRACT_KEYS)
        assert self.port.history[-1]["path"] == "retract"

    def key(self) -> str:
        return _tax_key(extract_taxonomy(self.port.last_result))


def test_retract_parity_cr5_bottom():
    base = (
        "SubClassOf(A B)\n"
        "SubClassOf(B ObjectSomeValuesFrom(r C))\n"
        "DisjointClasses(D E)\n"
    )
    doomed = "SubClassOf(C D)\nSubClassOf(C E)\n"
    both = Both([base, doomed])
    assert "C" in extract_taxonomy(both.port.last_result).unsatisfiable
    both.retract(doomed)
    assert both.key() == _oracle_key([base])
    assert extract_taxonomy(both.port.last_result).unsatisfiable == []


def test_retract_parity_cr6_role_chain():
    base = (
        "SubObjectPropertyOf(ObjectPropertyChain(r s) r)\n"
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n"
        "SubClassOf(ObjectSomeValuesFrom(r C) Hit)\n"
    )
    doomed = "SubClassOf(B ObjectSomeValuesFrom(s C))\n"
    both = Both([base, doomed])
    assert "Hit" in extract_taxonomy(both.port.last_result).subsumers["A"]
    both.retract(doomed)
    assert both.key() == _oracle_key([base])
    assert "Hit" not in extract_taxonomy(both.port.last_result).subsumers["A"]


POOL = [
    "SubClassOf(P0 P1)\nSubClassOf(P1 P2)\n",
    "SubClassOf(P3 ObjectSomeValuesFrom(u P0))\n",
    "SubClassOf(ObjectSomeValuesFrom(u P2) P4)\n",
    "SubObjectPropertyOf(ObjectPropertyChain(u v) u)\n"
    "SubClassOf(P0 ObjectSomeValuesFrom(v P3))\n",
    "EquivalentClasses(P5 ObjectIntersectionOf(P1 P4))\n",
    "DisjointClasses(P2 P6)\n",
    "SubClassOf(P7 P6)\nSubClassOf(P7 ObjectSomeValuesFrom(v P1))\n",
]


def test_retract_seeded_random_sequence():
    """The reference's randomized add/retract interleaving (seed 0):
    both packages step together, and every retraction equals a
    from-scratch classify of the survivors."""
    base = "SubClassOf(Seed0 Seed1)\n"
    rng = random.Random(0)
    both = Both([base])
    live = [base]
    checked = 0
    for _ in range(12):
        addable = [t for t in POOL if t not in live]
        retractable = live[1:]
        if addable and (not retractable or rng.random() < 0.55):
            t = rng.choice(addable)
            both.add(t)
            live.append(t)
        else:
            t = rng.choice(retractable)
            try:
                both.port.retract(t)
            except retract.EntangledRetraction:
                with pytest.raises(ref_retract.EntangledRetraction):
                    both.ref.retract(t)
                continue
            both._same(both.ref.retract(t), both.port.last_result, RETRACT_KEYS)
            live.remove(t)
            assert both.key() == _oracle_key(live), t
            checked += 1
    assert checked >= 2


def _state(inc):
    return (
        [dict(rec, spans=dict(rec["spans"]) if rec["spans"] else None)
         for rec in inc._ingests],
        inc.increment, len(inc.history), inc.last_result,
        {f: len(getattr(inc.accumulated, f)) for f in retract.NF_FAMILIES},
    )


REFUSALS = {
    "unknown": (["SubClassOf(A B)"], "SubClassOf(Never Added)", "UnknownRetraction"),
    "entangled_gensym": (
        ["SubClassOf(A ObjectSomeValuesFrom(r ObjectIntersectionOf(D E)))",
         "SubClassOf(B ObjectSomeValuesFrom(r ObjectIntersectionOf(D E)))"],
        "SubClassOf(B ObjectSomeValuesFrom(r ObjectIntersectionOf(D E)))",
        "EntangledRetraction",
    ),
    "range_machinery": (
        ["ObjectPropertyRange(r B)\nSubClassOf(A ObjectSomeValuesFrom(r C))\n",
         "SubClassOf(D A)"],
        "SubClassOf(D A)", "EntangledRetraction",
    ),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_leave_the_classifier_untouched(case):
    texts, doomed, err = REFUSALS[case]
    both = Both(texts)
    before = _state(both.port)
    key = both.key()
    with pytest.raises(getattr(retract, err)):
        both.port.retract(doomed)
    with pytest.raises(getattr(ref_retract, err)):
        both.ref.retract(doomed)
    assert _state(both.port) == before
    assert both.key() == key
    if case == "unknown":   # retracting the same text twice
        both.add("SubClassOf(C A)")
        both.retract("SubClassOf(C A)")
        with pytest.raises(retract.UnknownRetraction):
            both.port.retract("SubClassOf(C A)")


def test_restore_replays_retract_markers(tmp_path):
    """Snapshot after a retraction, then restore through the op log
    (texts and a retraction marker): one quiet pass, the same closure —
    into the port from either package's snapshot."""
    base = "SubClassOf(A B)\nSubClassOf(B ObjectSomeValuesFrom(r C))\n"
    doomed = "SubClassOf(C D)\nSubClassOf(ObjectSomeValuesFrom(r D) Hit)\n"
    later = "SubClassOf(E A)\n"
    both = Both([base, doomed, later])
    both.retract(doomed)
    log = [base, doomed, later, {"op": "retract", "text": doomed}]
    for who in ("port", "ref"):
        path = str(tmp_path / f"{who}.npz")
        getattr(both, who).snapshot(path)
        back = IncrementalClassifier.restore(log, path, device="cpu")
        assert back.history[-1]["path"] == "restore"
        assert back.history[-1]["new_derivations"] == 0
        assert back.increment == both.port.increment
        _assert_same_closure(both.ref.last_result, back.last_result)
    ref_back = RefInc.restore(log, str(tmp_path / "port.npz"),
                              RefConfig(shape_buckets=False))
    _assert_same_closure(ref_back.last_result, both.port.last_result)
    assert both.key() == _oracle_key([base, later])
