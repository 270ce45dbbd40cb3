"""The port's corpus tools on the command line against the reference's.

``normalize``, ``stats``, ``check`` and ``multiply`` of
``distel_tpu_torch.cli`` and of ``distel_tpu.cli`` on the OpenGALEN
module of ``tests/corpora/`` (RDF/XML, with out-of-profile axioms): the
same standard output and error, the same files written and the same
exit code.  A multiplied corpus written as OFN classifies through the
port's ``classify`` to the reference's taxonomy.
"""

import json
from pathlib import Path

import pytest
import torch

from distel_tpu import cli as ref_cli
from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.runtime.classifier import ELClassifier as RefClassifier
from distel_tpu_torch import cli
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)

GALEN = str(Path(__file__).parent / "corpora" / "galen_module_jia.owl")


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize(
    "argv,rc",
    [(["normalize", GALEN], 0), (["stats", GALEN], 0), (["check", GALEN], 1)],
    ids=["normalize", "stats", "check"],
)
def test_subcommand_output_matches_reference(argv, rc, capsys):
    got = _run(cli.main, argv, capsys)
    want = _run(ref_cli.main, argv, capsys)
    assert got == want
    assert got[0] == rc and got[1]
    if argv[0] == "check":
        assert json.loads(got[1])["removed"] == {"FunctionalObjectProperty": 12}


def test_normalize_to_a_file_matches_reference(tmp_path, capsys):
    out, ref_out = tmp_path / "port.nf", tmp_path / "ref.nf"
    got = _run(cli.main, ["normalize", GALEN, "-o", str(out)], capsys)
    want = _run(ref_cli.main, ["normalize", GALEN, "-o", str(ref_out)], capsys)
    assert got == want and "# normalized:" in got[2]
    assert out.read_text() == ref_out.read_text() != ""


@pytest.mark.parametrize("crossed", [False, True], ids=["plain", "crossed"])
def test_multiply_matches_reference_and_classifies(crossed, tmp_path, capsys):
    flag = ["--crossed"] if crossed else []
    out, ref_out = tmp_path / "port.ofn", tmp_path / "ref.ofn"
    got = _run(cli.main, ["multiply", GALEN, "3", "-o", str(out)] + flag, capsys)
    want = _run(ref_cli.main, ["multiply", GALEN, "3", "-o", str(ref_out)] + flag,
                capsys)
    assert got[0] == want[0] == 0
    assert got[1].replace(str(out), "X") == want[1].replace(str(ref_out), "X")
    assert out.read_text() == ref_out.read_text()
    tax = tmp_path / "tax.ofn"
    rc, stdout, _ = _run(cli.main, ["classify", str(out), "--device", "cpu",
                                    "-o", str(tax)], capsys)
    assert rc == 0
    summary = json.loads(stdout[: stdout.rindex("}") + 1])
    ref = RefClassifier(RefConfig(shape_buckets=False)).classify_file(str(out))
    assert summary["concepts"] == ref.idx.n_concepts
    assert summary["derivations"] == ref.result.derivations
    assert summary["iterations"] == ref.result.iterations
    ref_tax = tmp_path / "ref_tax.ofn"
    ref.taxonomy.write(str(ref_tax))
    assert tax.read_text() == ref_tax.read_text()
