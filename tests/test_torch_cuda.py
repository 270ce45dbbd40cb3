"""The port on a CUDA card: the hand-written kernels and the paths that
launch them, each against the plain PyTorch version on the CPU.

Every test here is marked ``cuda`` and skips without a card (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.frontend.ontology_tools import (
    chain_tailed_ontology,
    snomed_shaped_ontology,
)
from distel_tpu_torch.ops import bitmatmul
from distel_tpu_torch.ops.bitmatmul import (
    LAUNCHES,
    PackedColsMatmulPlan,
    live_tiles,
    plain_packed_cols,
)
from distel_tpu_torch.runtime.classifier import ELClassifier
from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

GOLDEN = Path(__file__).parent / "golden"
KERNELS = (("packed_cols_dense", False), ("packed_cols_sparse", True))

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(gen, m, l, w, density, dead_tiles=False):
    a = (torch.rand((m, l), generator=gen, device="cuda") < density).to(torch.int8)
    if dead_tiles:
        keep = torch.rand((-(-m // 64), -(-l // 32)), generator=gen, device="cuda") < 0.1
        keep = keep.repeat_interleave(64, 0)[:m].repeat_interleave(32, 1)[:, :l]
        a = a * keep.to(torch.int8)
    b = torch.randint(-2**31, 2**31, (l, w), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.int32)
    return a.contiguous(), b.contiguous()


@pytest.mark.parametrize("name,skip", KERNELS, ids=[k for k, _ in KERNELS])
@pytest.mark.parametrize(
    "m,l,w,density,dead",
    [(37, 70, 5, 0.2, False), (513, 257, 129, 0.01, False),
     (300, 1000, 200, 0.05, True), (1, 1, 1, 1.0, False), (64, 32, 128, 0.0, False)],
)
def test_kernel_matches_plain(card, name, skip, m, l, w, density, dead):
    """Bit for bit, on unaligned, tile-sparse and all-zero operands;
    each call adds exactly one launch to its own counter."""
    gen = torch.Generator(device="cuda").manual_seed(m * 7 + l)
    a, b = _operands(gen, m, l, w, density, dead)
    want = plain_packed_cols(a, b)
    before = dict(LAUNCHES)
    got = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=skip)(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    other = [k for k in LAUNCHES if k != name][0]
    assert LAUNCHES[name] == before[name] + 1
    assert LAUNCHES[other] == before[other]


def test_bool_operand_and_wrapper_checks(card):
    gen = torch.Generator(device="cuda").manual_seed(1)
    a, b = _operands(gen, 40, 50, 9, 0.1)
    plan = PackedColsMatmulPlan(40, 50, 9, skip_zero_tiles=False)
    assert torch.equal(plan(a.bool(), b), plain_packed_cols(a, b))
    with pytest.raises(ValueError, match="contiguous"):
        PackedColsMatmulPlan(40, 25, 9)(a[:, ::2], b[:25])
    with pytest.raises(ValueError, match="on"):
        plan(a, b.cpu())


def test_live_tiles_on_the_card_match_the_cpu(card):
    gen = torch.Generator(device="cuda").manual_seed(2)
    a, _b = _operands(gen, 300, 1000, 1, 0.05, dead_tiles=True)
    for got, want in zip(live_tiles(a), live_tiles(a.cpu())):
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize(
    "text,config",
    [
        pytest.param(lambda: snomed_shaped_ontology(n_classes=600), {}, id="snomed"),
        pytest.param(lambda: snomed_shaped_ontology(n_classes=600),
                     {"cr6_tiles_density_threshold": 100.0}, id="snomed-tiles"),
        pytest.param(lambda: chain_tailed_ontology(400, 12), {}, id="chain-tailed"),
        pytest.param(lambda: (GOLDEN / "19-bottom-chain.ofn").read_text(), {},
                     id="bottom-chain"),
    ],
)
def test_classify_on_the_card_equals_the_cpu(card, text, config):
    """The whole slice: closure, derivations, iterations and taxonomy
    on the card equal the CPU run's."""
    text = text()
    cfg = ClassifierConfig(**config)
    bitmatmul.reset_launches()
    gpu = ELClassifier(cfg, device="cuda").classify_text(text)
    launched = sum(LAUNCHES.values())
    cpu = ELClassifier(cfg, device="cpu").classify_text(text)
    for g, c in zip(gpu.result.wire(), cpu.result.wire()):
        assert np.array_equal(g, c)
    assert gpu.result.derivations == cpu.result.derivations
    assert gpu.result.iterations == cpu.result.iterations
    assert gpu.taxonomy.parents == cpu.taxonomy.parents
    assert gpu.taxonomy.equivalents == cpu.taxonomy.equivalents
    assert gpu.taxonomy.unsatisfiable == cpu.taxonomy.unsatisfiable
    if gpu.idx.n_links:
        assert launched > 0


def test_device_taxonomy_launches_the_dense_kernel(card):
    res = ELClassifier(device="cuda").classify_text(
        snomed_shaped_ontology(n_classes=600)
    )
    bitmatmul.reset_launches()
    dev = extract_taxonomy(res.result, method="device", block=128)
    assert LAUNCHES["packed_cols_dense"] > 0
    host = extract_taxonomy(res.result, method="host")
    assert dev.parents == host.parents and dev.equivalents == host.equivalents


def test_wide_taxonomy_stays_on_the_card(card, monkeypatch):
    """A result on the card takes the device path however many direct
    parents a class has; the host path is never reached."""
    from distel_tpu_torch.runtime import taxonomy

    text = "\n".join(f"SubClassOf(X P{i})" for i in range(5000))
    res = ELClassifier(device="cuda").classify_text(text)
    want = extract_taxonomy(
        ELClassifier(device="cpu").classify_text(text).result, method="host"
    )

    def no_host(*_args):
        raise AssertionError("a result on the card reached the host path")

    monkeypatch.setattr(taxonomy, "_extract_host", no_host)
    got = extract_taxonomy(res.result)
    assert len(got.parents["X"]) == 5000
    assert got.parents == want.parents and got.equivalents == want.equivalents
