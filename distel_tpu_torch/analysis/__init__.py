"""distel-lint for the port: project-specific static analysis (stdlib
``ast`` only; no torch import).

The port of ``distel_tpu/analysis/``.  The port keeps its own copies
of the reference's hand-rolled locking (``serve/``, ``obs/``,
``parallel/``, the runtime aggregates), so it keeps its own gate over
them: five rules, each encoding a contract the port carries.

* :mod:`~distel_tpu_torch.analysis.lockorder` — lock-acquisition graph
  from ``with <lock>:`` nesting + intra-package call edges; cycles and
  cross-module acquire-while-holding.  Runtime counterpart:
  :mod:`distel_tpu_torch.testing.lockdep`.
* :mod:`~distel_tpu_torch.analysis.purity` — captured purity, the
  port's form of the reference's traced-purity rule: functions run
  under ``torch.cuda.graph(...)`` (and what they call) must not close
  over an engine's card tables, host-sync a tensor
  (``.item()``/``bool()``/``.cpu()``/``np.asarray``), or Python-branch
  on a tensor ("a captured step program is a function of its tables
  only": a graph keeps its capture's addresses and values).
* :mod:`~distel_tpu_torch.analysis.sharedstate` — attributes mutated
  both inside and outside a ``with <lock>:`` block on the same class.
* :mod:`~distel_tpu_torch.analysis.knobs` — config-knob drift between
  ``config.py`` fields, ``from_properties`` keys, actual reads, and
  README documentation.
* :mod:`~distel_tpu_torch.analysis.metricnames` — metric-family
  discipline: counters end ``_total``, gauges/histograms never do, and
  every minted family is covered by the README family table.

``findings``, ``project``, ``lockorder``, ``sharedstate``, ``knobs``,
``metricnames`` and ``runner`` are the reference's text apart from
their import lines and their targets (the scopes and includes of
``runner``, the baseline's name, ``knobs``' config path).  Run it:
``python -m distel_tpu_torch.cli lint`` (committed baseline:
``.distel-torch-lint-baseline.json``).
"""

from distel_tpu_torch.analysis.findings import Baseline, Finding
from distel_tpu_torch.analysis.project import Project
from distel_tpu_torch.analysis.runner import ALL_RULES, run_rules

__all__ = [
    "ALL_RULES",
    "Baseline",
    "Finding",
    "Project",
    "run_rules",
]
