"""distel-lint for the port (``distel_tpu_torch/analysis/``): the
reference's ``tests/test_analysis.py``, case for case, on the port's
copies — per-rule must-fire / must-not-fire fixtures, baseline
round-trip, the port's self-lint under its committed baseline, ``cli
lint`` failing on a fresh finding, the port's runtime lockdep — plus
the retargeted purity rule firing on each of its three checks inside a
``torch.cuda.graph`` body, and the pin of the copied modules to the
reference's text.

The purity fixtures are the reference's, written for the port's
contract: a captured step program is a function of its tables only
(the roots are the functions a ``with torch.cuda.graph(...)`` body
calls; a tensor its class rebinds, a host read of a tensor and a
Python branch on one are the three findings).
"""

import json
import threading

import pytest

from distel_tpu_torch.analysis import knobs, lockorder, metricnames, purity, sharedstate
from distel_tpu_torch.analysis.findings import Baseline, Finding
from distel_tpu_torch.analysis.project import Project
from distel_tpu_torch.analysis.runner import (
    DEFAULT_INCLUDE,
    repo_root,
    run_rules,
)
from distel_tpu_torch.testing import lockdep


def project(files):
    return Project("/synthetic", files=files)


def rules_of(findings):
    return sorted({f.rule for f in findings})


# --------------------------------------------------------------------
# rule 1: lock order
# --------------------------------------------------------------------

_LOCK_CYCLE = '''
import threading

class A:
    def __init__(self):
        self._lock = threading.Lock()
        self.peer = None

    def hot(self):
        with self._lock:
            self.peer.poke()

class B:
    def __init__(self):
        self._lock = threading.Lock()
        self.owner = None

    def poke(self):
        with self._lock:
            pass

    def back(self):
        with self._lock:
            self.owner.hot()
'''

_LOCK_CLEAN = '''
import threading

class A:
    def __init__(self):
        self._lock = threading.Lock()

    def seq(self):
        with self._lock:
            x = 1
        with self._lock:
            return x

    def try_acquire(self, other):
        # non-blocking acquire cannot deadlock: no ordering edge
        if other.lock.acquire(blocking=False):
            try:
                pass
            finally:
                other.lock.release()

class Entry:
    def __init__(self):
        self.lock = threading.Lock()
'''


def test_lockorder_cycle_fires():
    fs = lockorder.check(project({"pkg/a.py": _LOCK_CYCLE}))
    assert any(f.rule == lockorder.RULE_CYCLE for f in fs), fs
    cyc = [f for f in fs if f.rule == lockorder.RULE_CYCLE][0]
    assert "A._lock" in cyc.symbol and "B._lock" in cyc.symbol


def test_lockorder_clean_is_silent():
    fs = lockorder.check(project({"pkg/a.py": _LOCK_CLEAN}))
    assert [f for f in fs if f.rule == lockorder.RULE_CYCLE] == []
    assert [f for f in fs if f.rule == lockorder.RULE_CROSS] == []


def test_lockorder_cross_module_edge():
    held = '''
import threading
from pkg.leaf import Leaf

class Holder:
    def __init__(self):
        self._lock = threading.Lock()
        self.leaf = Leaf()

    def work(self):
        with self._lock:
            self.leaf.bump()
'''
    leaf = '''
import threading

class Leaf:
    def __init__(self):
        self._lock = threading.Lock()

    def bump(self):
        with self._lock:
            pass
'''
    fs = lockorder.check(
        project({"pkg/holder.py": held, "pkg/leaf.py": leaf})
    )
    cross = [f for f in fs if f.rule == lockorder.RULE_CROSS]
    assert len(cross) == 1
    assert cross[0].symbol == "Holder._lock -> Leaf._lock"


def test_lockorder_caller_holds_docstring():
    src = '''
import threading

class R:
    def __init__(self):
        self._lock = threading.Lock()
        self.other = None

    def helper(self):
        """Caller holds ``self._lock``."""
        with self.other.wrap_lock:
            pass
'''
    other = '''
import threading

class W:
    def __init__(self):
        self.wrap_lock = threading.Lock()
'''
    fs = lockorder.check(
        project({"pkg/r.py": src, "pkg/w.py": other})
    )
    # helper's body nests W.wrap_lock under the documented R._lock —
    # a cross-module acquire-while-holding the docstring made visible
    assert any(
        f.rule == lockorder.RULE_CROSS
        and f.symbol == "R._lock -> W.wrap_lock"
        for f in fs
    ), fs


# --------------------------------------------------------------------
# rule 2: traced purity
# --------------------------------------------------------------------

_PURE_BAD = '''
import numpy as np
import torch

class Engine:
    def __init__(self, idx):
        self._table = torch.as_tensor(idx.table)
        self.graph = None

    def rebind(self, idx):
        self._table = torch.as_tensor(idx.table)   # rebound after capture

    def capture(self, s):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._step(s)

    def _step(self, s):
        t = self._table              # a rebound tensor read in the body
        total = float(torch.sum(s))  # host sync inside the capture
        if total > 0:                # python branch on a tensor
            s = s + t
        host = np.asarray(s)         # device->host inside the capture
        return s
'''

_PURE_OK = '''
import torch

class Program:
    def __init__(self, n, bucket):
        self._bucket = bucket
        self.table = torch.zeros(n)     # owned for the program's life
        self.flags = torch.zeros(1)
        self._fallback = torch.zeros(n)
        self.graph = None

    def rebind(self, n):
        self._fallback = torch.zeros(n)

    def capture(self, s, masks):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._step(s, masks)

    def _step(self, s, masks=None):
        # the documented non-bucketed fallback: guarded self-read
        mk = self._fallback if masks is None else masks["table"]
        n = s.shape[0]          # static metadata, launders taint
        if n > 4:               # branch on static shape: fine
            s = s + mk
        plan = self._plan(s.size(0))
        if "extra" in masks:    # dict-key membership: fine
            s = s + masks["extra"]
        self.flags.copy_((s > 0).any().reshape(1))
        return torch.where(s > 0, s, 0) + self.table

    def _plan(self, n):
        # host helper called with host ints only
        if n > 128:
            return "big"
        return "small"

    def controller(self, s):
        # NOT reached from a capture root: host-side folds are legitimate
        return float(torch.sum(s))
'''


def test_purity_fires_on_all_three():
    fs = purity.check(project({"pkg/eng.py": _PURE_BAD}))
    got = rules_of(fs)
    assert purity.RULE_CAPTURE in got, fs
    assert purity.RULE_SYNC in got, fs
    assert purity.RULE_BRANCH in got, fs


def test_purity_guarded_fallback_and_controller_are_silent():
    fs = purity.check(project({"pkg/eng.py": _PURE_OK}))
    assert fs == [], [f.render() for f in fs]


def test_purity_root_called_by_root_keeps_static_argnums():
    """A capture root reached first as another root's callee keeps
    what its own call sites pass: a host int handed to it stays
    untainted, so a Python branch on it is silent (the reference's
    static-argnums case: the port's roots have no static arguments,
    only host values)."""
    src = '''
import torch

class E:
    def capture(self, x):
        with torch.cuda.graph(self.g):
            self._outer(x)
            self._kern(x, x, 4)

    def _outer(self, x):
        return self._kern(x, x, 4)

    def _kern(self, x, y, n):
        if n > 2:          # a host int: must stay silent
            x = x + y
        return x
'''
    fs = purity.check(project({"pkg/e.py": src}))
    assert not any(f.rule == purity.RULE_BRANCH and "n > 2" in f.message
                   for f in fs), [f.render() for f in fs]


def test_lockorder_bare_acquire_in_with_body_scopes_correctly():
    """A bare .acquire() inside a with-body outlives the with; the
    with-exit must pop ITS lock, not the acquired one — a positional
    pop would leave the with-lock spuriously held and fabricate an
    edge to the next acquisition."""
    src = '''
import threading

class A:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self._c = threading.Lock()

    def work(self):
        with self._a:
            self._b.acquire()
        with self._c:
            pass
        self._b.release()
'''
    fs = lockorder.check(project({"pkg/a.py": src}))
    facts = lockorder._collect_facts(
        Project("/x", files={"pkg/a.py": src}), ["pkg/a.py"]
    )
    edges = {(e.held, e.acquired) for e in facts["A.work"].edges}
    assert ("A._a", "A._b") in edges          # real nesting
    assert ("A._b", "A._c") in edges          # _b held past the with
    assert ("A._a", "A._c") not in edges      # _a was released


@pytest.mark.no_lockdep
def test_lockdep_cross_test_edge_accumulation():
    """check() consumes violations but KEEPS edges: an A->B from one
    armed test plus a B->A from a later one is still an inversion."""
    lockdep.enable()
    try:
        lockdep.reset()
        a = threading.Lock()
        b = threading.Lock()

        def ab():
            with a:
                with b:
                    pass

        t = threading.Thread(target=ab)
        t.start(); t.join()
        lockdep.check()          # test 1 passes, edge a->b kept
        assert lockdep.edges()   # edges survived the check

        def ba():
            with b:
                with a:
                    pass

        t = threading.Thread(target=ba)
        t.start(); t.join()
        with pytest.raises(lockdep.LockOrderViolation):
            lockdep.check()      # test 2 closes the cycle
        lockdep.check()          # violations were consumed by the raise
    finally:
        lockdep.disable()
        lockdep.reset()


def test_purity_partial_jit_decorator_is_a_root():
    """A capture opened among other context managers (``with LOCK,
    torch.cuda.graph(g):``) still makes its body's calls roots (the
    reference's ``partial(jax.jit)`` decorator case: a root the
    collector must see through its wrapping)."""
    src = '''
import threading
import torch

LOCK = threading.Lock()

def kernel(x, n):
    if n > 2:              # a host int: fine
        x = x * 2
    s = x.sum().item()     # host sync on a tensor
    return x

def capture(g, x):
    with LOCK, torch.cuda.graph(g, capture_error_mode="thread_local"):
        kernel(x, 4)
'''
    fs = purity.check(project({"pkg/k.py": src}))
    assert any(f.rule == purity.RULE_SYNC for f in fs), fs
    assert not any(f.rule == purity.RULE_BRANCH for f in fs), fs


# the retargeted rule, one check at a time, each inside a graph body

_GRAPH_HEAD = '''
import numpy as np
import torch

class Step:
    def __init__(self, n):
        self.T = torch.zeros(n)
        self.out = torch.zeros(n)

    def load(self, tab):
        self.T = torch.as_tensor(tab)

    def capture(self, g, sp):
        with torch.cuda.graph(g):
            self.body(sp)
'''


def test_purity_capture_of_a_rebound_tensor_fires():
    src = _GRAPH_HEAD + '''
    def body(self, sp):
        self.out.copy_(sp & self.T)
'''
    fs = purity.check(project({"pkg/g.py": src}))
    assert [(f.rule, f.symbol) for f in fs] == [
        (purity.RULE_CAPTURE, "Step.body:self.T")], [f.render() for f in fs]


@pytest.mark.parametrize("read", ["sp.any().item()", "bool(sp.any())",
                                  "sp.cpu()", "np.asarray(sp)", "sp.tolist()"])
def test_purity_host_read_in_a_graph_body_fires(read):
    src = _GRAPH_HEAD + f'''
    def body(self, sp):
        x = {read}
        self.out.copy_(sp)
'''
    fs = purity.check(project({"pkg/g.py": src}))
    assert [f.rule for f in fs] == [purity.RULE_SYNC], [f.render() for f in fs]


def test_purity_python_branch_on_a_tensor_fires():
    src = _GRAPH_HEAD + '''
    def body(self, sp):
        changed = (sp != self.out).any()
        while changed:
            self.out.copy_(sp)
'''
    fs = purity.check(project({"pkg/g.py": src}))
    assert [f.rule for f in fs] == [purity.RULE_BRANCH], [f.render() for f in fs]


# --------------------------------------------------------------------
# rule 3: shared state
# --------------------------------------------------------------------

_SHARED_BAD = '''
import threading

class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = {}

    def put(self, k, v):
        with self._lock:
            self._items[k] = v

    def sneak(self, k):
        self._items.pop(k, None)   # mutation outside the lock
'''

_SHARED_OK = '''
import threading

class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = {}

    def put(self, k, v):
        with self._lock:
            self._items[k] = v

    def _drop(self, k):
        """Caller holds ``self._lock``."""
        self._items.pop(k, None)
'''


def test_sharedstate_fires():
    fs = sharedstate.check(project({"pkg/s.py": _SHARED_BAD}))
    assert any(
        f.rule == sharedstate.RULE and f.symbol == "Store._items"
        for f in fs
    ), fs


def test_sharedstate_docstring_convention_is_silent():
    fs = sharedstate.check(project({"pkg/s.py": _SHARED_OK}))
    assert fs == [], [f.render() for f in fs]


def test_holds_docstring_survives_line_wrap():
    """The load-bearing "Caller holds ..." sentence wraps across
    docstring lines in real code (registry._spill) — the shared parser
    must normalize whitespace, and must NOT leak tokens from later
    sentences into the holds set."""
    import ast as _ast

    from distel_tpu_torch.analysis.project import caller_holds_tokens

    src = '''
def helper(entry):
    """Snapshot the entry's closure and drop the classifier.  Caller
    holds ``entry.lock``.  Unrelated tail prose mentioning
    other.lock must not count."""
'''
    fn = _ast.parse(src).body[0]
    assert caller_holds_tokens(fn) == ["entry.lock"]


# --------------------------------------------------------------------
# rule 4: config knobs
# --------------------------------------------------------------------

_KNOB_CONFIG = '''
from dataclasses import dataclass

@dataclass
class ClassifierConfig:
    used_knob: int = 1
    dead_knob: int = 2
    undocumented_knob: int = 3

    @classmethod
    def from_properties(cls, path):
        raw = {}
        cfg = cls()
        if "used.knob" in raw:
            cfg.used_knob = int(raw["used.knob"])
        if "undocumented.knob" in raw:
            cfg.undocumented_knob = int(raw["undocumented.knob"])
        if "ghost.knob" in raw:
            cfg.gohst_knob = int(raw["ghost.knob"])
        return cfg
'''

_KNOB_USER = '''
def use(cfg):
    return cfg.used_knob + cfg.undocumented_knob
'''

_KNOB_README = "options: `used.knob` does things.\n"


def _knob_findings():
    p = Project(
        "/synthetic",
        files={
            "distel_tpu_torch/config.py": _KNOB_CONFIG,
            "distel_tpu_torch/user.py": _KNOB_USER,
        },
    )
    return knobs.check(p, _KNOB_README)


def test_knob_dead():
    fs = _knob_findings()
    assert any(
        f.rule == knobs.RULE_DEAD and f.symbol == "dead_knob" for f in fs
    ), fs
    # read knobs are not dead
    assert not any(
        f.rule == knobs.RULE_DEAD and f.symbol == "used_knob" for f in fs
    )


def test_knob_undocumented():
    fs = _knob_findings()
    assert any(
        f.rule == knobs.RULE_UNDOC and f.symbol == "undocumented.knob"
        for f in fs
    ), fs
    assert not any(
        f.rule == knobs.RULE_UNDOC and f.symbol == "used.knob" for f in fs
    )


def test_knob_misspelled():
    fs = _knob_findings()
    # `cfg.gohst_knob` typo: the key parses, nothing real is set
    assert any(
        f.rule == knobs.RULE_MISSPELLED and "ghost.knob" in f.symbol
        for f in fs
    ), fs


# --------------------------------------------------------------------
# rule 5: metric names
# --------------------------------------------------------------------

_METRIC_SRC = '''
class App:
    def __init__(self, metrics):
        metrics.counter_inc("distel_good_events_total")
        metrics.counter_inc("distel_bad_events")          # counter sans _total
        metrics.gauge_set("distel_depth")
        metrics.gauge_set("distel_bad_depth_total")       # gauge with _total
        metrics.observe("distel_wait_seconds", 1.0)
'''

_METRIC_README = (
    "| `distel_good_events_total` | good |\n"
    "| `distel_depth` | depth |\n"
    "| `distel_wait_seconds` | wait |\n"
    "| `distel_bad_events` | bad |\n"
    "| `distel_bad_depth_total` | bad |\n"
    "| `distel_ghost_family_total` | documented but never minted |\n"
)


def test_metric_naming_discipline():
    p = Project(
        "/synthetic", files={"distel_tpu_torch/app.py": _METRIC_SRC}
    )
    fs = metricnames.check(p, _METRIC_README)
    by_sym = {f.symbol: f for f in fs if f.rule == metricnames.RULE_NAME}
    assert "distel_bad_events" in by_sym, fs
    assert "distel_bad_depth_total" in by_sym, fs
    assert "distel_good_events_total" not in by_sym
    assert "distel_wait_seconds" not in by_sym


def test_metric_readme_both_directions():
    p = Project(
        "/synthetic", files={"distel_tpu_torch/app.py": _METRIC_SRC}
    )
    fs = metricnames.check(p, _METRIC_README)
    stale = [
        f for f in fs
        if f.rule == metricnames.RULE_README
        and f.symbol == "distel_ghost_family_total"
    ]
    assert stale, fs
    # a family missing from README fires the other direction
    fs2 = metricnames.check(p, "| `distel_good_events_total` | g |\n")
    assert any(
        f.rule == metricnames.RULE_README and f.symbol == "distel_depth"
        for f in fs2
    ), fs2


def test_metric_brace_and_wildcard_coverage():
    src = '''
class App:
    def __init__(self, m):
        m.gauge_set("distel_frontier_dense_rounds")
        m.gauge_set("distel_frontier_sparse_rounds")
        m.counter_inc("distel_registry_evictions_total")
'''
    readme = (
        "`distel_frontier_{dense,sparse}_rounds` and "
        "`distel_registry_*` cover everything\n"
    )
    p = Project("/synthetic", files={"distel_tpu_torch/app.py": src})
    fs = metricnames.check(p, readme)
    assert [f for f in fs if f.rule == metricnames.RULE_README] == [], fs


# --------------------------------------------------------------------
# baseline round-trip
# --------------------------------------------------------------------

def test_baseline_round_trip(tmp_path):
    f1 = Finding("shared-state", "pkg/s.py", 12, "Store._items", "msg")
    f2 = Finding("knob-dead", "config.py", 3, "dead_knob", "msg2")

    # add: both findings suppressed once baselined with justification
    bl = Baseline.from_findings([f1, f2], justification="pre-existing")
    path = tmp_path / "baseline.json"
    bl.save(str(path))
    loaded = Baseline.load(str(path))
    fresh, suppressed, stale = loaded.filter([f1, f2])
    assert fresh == [] and len(suppressed) == 2 and stale == []

    # suppress: fixing one finding leaves its entry stale
    fresh, suppressed, stale = loaded.filter([f1])
    assert fresh == [] and len(stale) == 1

    # regression: a NEW finding re-fires even with the baseline loaded
    f3 = Finding("shared-state", "pkg/s.py", 40, "Store._other", "msg")
    fresh, _, _ = loaded.filter([f1, f3])
    assert [f.symbol for f in fresh] == ["Store._other"]

    # line drift does NOT re-fire (fingerprint excludes the line)
    drifted = Finding("shared-state", "pkg/s.py", 99, "Store._items", "msg")
    fresh, suppressed, _ = loaded.filter([drifted])
    assert fresh == [] and len(suppressed) == 1

    # unjustified entries are flagged
    bl2 = Baseline.from_findings([f1])
    assert bl2.unjustified() == [f1.fingerprint()]


# --------------------------------------------------------------------
# repo self-lint: the CI contract
# --------------------------------------------------------------------

def test_repo_lint_is_clean_under_committed_baseline():
    root = repo_root()
    p = Project(root, include=DEFAULT_INCLUDE)
    with open(root + "/README.md", encoding="utf-8") as f:
        readme = f.read()
    findings = run_rules(p, readme)
    bl = Baseline.load(root + "/.distel-torch-lint-baseline.json")
    fresh, _suppressed, stale = bl.filter(findings)
    assert fresh == [], "\n".join(f.render() for f in fresh)
    assert stale == [], f"stale baseline entries: {stale}"
    assert bl.unjustified() == []


def test_cli_lint_fails_on_fresh_finding(tmp_path, capsys):
    """The CI gate's contract end-to-end: a tree with a non-baselined
    finding exits 1 and reports it; baselining it (justified) exits 0;
    an unjustified baseline exits 1."""
    from distel_tpu_torch.cli import main

    root = tmp_path / "repo"
    # under serve/ so the lock rules' scope covers it
    (root / "distel_tpu_torch" / "serve").mkdir(parents=True)
    (root / "distel_tpu_torch" / "serve" / "bad.py").write_text(_SHARED_BAD)
    (root / "README.md").write_text("")

    json_out = tmp_path / "findings.json"
    rc = main([
        "lint", "--root", str(root), "--json", str(json_out),
    ])
    assert rc == 1
    doc = json.loads(json_out.read_text())
    assert any(
        f["rule"] == "shared-state" for f in doc["fresh"]
    ), doc

    # write + justify a baseline → clean exit
    bl_path = tmp_path / "bl.json"
    rc = main([
        "lint", "--root", str(root),
        "--write-baseline", str(bl_path),
    ])
    assert rc == 0
    bl_doc = json.loads(bl_path.read_text())
    for rec in bl_doc["findings"].values():
        rec["justification"] = "fixture debt"
    bl_path.write_text(json.dumps(bl_doc))
    rc = main([
        "lint", "--root", str(root), "--baseline", str(bl_path),
    ])
    assert rc == 0

    # unjustified baseline entries fail the run
    for rec in bl_doc["findings"].values():
        rec["justification"] = ""
    bl_path.write_text(json.dumps(bl_doc))
    rc = main([
        "lint", "--root", str(root), "--baseline", str(bl_path),
    ])
    assert rc == 1
    capsys.readouterr()


# --------------------------------------------------------------------
# runtime lockdep
# --------------------------------------------------------------------

@pytest.mark.no_lockdep
def test_lockdep_detects_inversion_without_deadlock():
    """The seeded ABBA repro: two threads take two locks in opposite
    orders but NEVER overlap (joined sequentially) — no deadlock
    happens, the inversion is still reported."""
    lockdep.enable()
    try:
        lockdep.reset()
        a = threading.Lock()
        b = threading.Lock()

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        for fn in (ab, ba):
            t = threading.Thread(target=fn)
            t.start()
            t.join()
        with pytest.raises(lockdep.LockOrderViolation) as exc:
            lockdep.check()
        assert "inversion" in str(exc.value)
    finally:
        lockdep.disable()
        lockdep.reset()


@pytest.mark.no_lockdep
def test_lockdep_clean_patterns_pass():
    lockdep.enable()
    try:
        lockdep.reset()
        a = threading.Lock()
        b = threading.Lock()
        # consistent order on both threads
        def ordered():
            with a:
                with b:
                    pass
        for _ in range(2):
            t = threading.Thread(target=ordered)
            t.start()
            t.join()
        # RLock reentrancy is not same-class nesting
        r = threading.RLock()
        with r:
            with r:
                pass
        # try-acquire records no ordering edge
        l2 = threading.Lock()
        with b:
            assert l2.acquire(blocking=False)
            l2.release()
        lockdep.check()
        assert all(e != ("b", "a") for e in lockdep.edges())
    finally:
        lockdep.disable()
        lockdep.reset()


@pytest.mark.no_lockdep
def test_lockdep_condition_wait_releases_bookkeeping():
    """Condition.wait drops the lock: the waiter must not appear to
    hold it while the notifier runs its own nested acquisitions."""
    lockdep.enable()
    try:
        lockdep.reset()
        cv = threading.Condition()
        inner = threading.Lock()
        woke = []

        def waiter():
            with cv:
                cv.wait(timeout=5)
                woke.append(1)

        t = threading.Thread(target=waiter)
        t.start()
        import time

        time.sleep(0.2)
        with inner:          # inner -> cv on the notifier
            with cv:
                cv.notify_all()
        t.join()
        assert woke
        # the waiter re-acquired cv AFTER wait without holding inner:
        # no cv -> inner edge exists, so no inversion
        lockdep.check()
    finally:
        lockdep.disable()
        lockdep.reset()


def test_lockdep_fixture_is_armed_for_concurrency_suites():
    """Assert the port's fleet suite arms the port's lockdep module-wide
    (an autouse fixture that enables it and checks after each test), so
    a rename doesn't silently disarm the guard."""
    import ast as _ast
    import pathlib

    src = (pathlib.Path(__file__).parent / "test_torch_fleet.py").read_text()
    armed = [
        fn for fn in _ast.parse(src).body
        if isinstance(fn, _ast.FunctionDef) and fn.name == "_lockdep_armed"
    ]
    assert armed, "test_torch_fleet.py lost its lockdep fixture"
    text = _ast.unparse(armed[0])
    assert "autouse=True" in text and "lockdep.enable()" in text
    # and this module itself runs un-armed (the seeded-inversion tests
    # above would otherwise trip the fixture's check())
    assert lockdep.enabled() is False


# --------------------------------------------------------------------
# the copies: the reference's text apart from imports and targets
# --------------------------------------------------------------------

#: per copied module, the reference's lines that name what the port
#: lints (its tree, its scopes, its baseline, its config) — the only
#: lines besides the import lines that may differ
TARGETS = {
    "findings.py": (),
    "project.py": (),
    "lockorder.py": (),
    "sharedstate.py": (),
    "metricnames.py": (),
    "knobs.py": ('    config_path: str = "distel_tpu/config.py",',),
    "runner.py": (
        '    "distel_tpu/serve/",', '    "distel_tpu/obs/",',
        '    "distel_tpu/runtime/instrumentation.py",',
        '    "distel_tpu/core/program_cache.py",', '    "distel_tpu/parallel/",',
        '    "distel_tpu/core/",', '    "distel_tpu/ops/",',
        '    "distel_tpu",', '    "bench.py",', '    "bench_serve.py",',
        '    "scripts",', '    "__graft_entry__.py",',
        '             if p.startswith("distel_tpu/")],',
        '        distel_tpu.__file__',
        '        default = os.path.join(root, ".distel-lint-baseline.json")',
    ),
}


def _is_import(line):
    return line.lstrip().startswith(("from distel_tpu", "import distel_tpu"))


@pytest.mark.parametrize("rel", sorted(TARGETS))
def test_module_is_a_copy_apart_from_imports_and_targets(rel):
    import difflib
    import pathlib

    root = pathlib.Path(repo_root())
    port = (root / "distel_tpu_torch" / "analysis" / rel).read_text().splitlines()
    ref = (root / "distel_tpu" / "analysis" / rel).read_text().splitlines()
    sm = difflib.SequenceMatcher(a=ref, b=port, autojunk=False)
    for op, i1, i2, j1, j2 in sm.get_opcodes():
        if op == "equal":
            continue
        for ln in ref[i1:i2]:
            assert _is_import(ln) or ln in TARGETS[rel], f"{rel}: reference line {ln!r}"
        for ln in port[j1:j2]:
            assert _is_import(ln) or not ln.strip() or any(
                t in ln for t in ("distel_tpu_torch", "distel-torch-lint", '"chip_')
            ), f"{rel}: port line {ln!r}"
    imports = [ln.strip() for ln in port if _is_import(ln)]
    assert all(ln.startswith(("from distel_tpu_torch.", "import distel_tpu_torch"))
               for ln in imports)
