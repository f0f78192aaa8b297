"""The port's race analyzers: ``analysis.race`` (static lockset rules R9
/ R10) and ``analysis.racecheck`` (vector-clock confirmation over real
threads).

R9 / R10 fire on their fixtures and not on the clean twins, under
virtual paths of the port; the same fixtures give the JAX package's
analyzer's diagnostics (the analysis does not depend on the framework).
The port's tree is clean against ``race_baseline.txt``.  Each racecheck
scenario runs the port's real code clean at two seeds, and racy with
its lock dropped: a checker that sees nothing fails.
"""
import os
import subprocess
import sys
import threading

import pytest

from mxnet_tpu.analysis import race as ref_race
from mxnet_tpu_torch.analysis import race
from mxnet_tpu_torch.analysis import racecheck as rc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "mxnet_tpu_torch", "analysis",
                        "race_baseline.txt")
P = "mxnet_tpu_torch/fx.py"


def _ids(src, relpath=P, rules=None):
    return [d.rule_id
            for d in race.race_source(src, relpath, rules=rules)]


# ----------------------------------------------------------------------
# R9: unguarded cross-thread access
# ----------------------------------------------------------------------
R9_BAD = """
import threading

_counts = {}

def _worker():
    _counts["n"] = _counts.get("n", 0) + 1

def start():
    threading.Thread(target=_worker).start()
    _counts["n"] = _counts.get("n", 0) + 1
"""

R9_CLEAN = """
import threading

_lock = threading.Lock()
_counts = {}

def _worker():
    with _lock:
        _counts["n"] = _counts.get("n", 0) + 1

def start():
    threading.Thread(target=_worker).start()
    with _lock:
        _counts["n"] = _counts.get("n", 0) + 1
"""

R9_READONLY = """
import threading

_config = {"poll": 0.1}

def _worker():
    return _config["poll"]

def start():
    threading.Thread(target=_worker).start()
    return _config["poll"]
"""

R9_SAFE_TYPE = """
import threading

_stop = threading.Event()

def _worker():
    _stop.set()

def start():
    threading.Thread(target=_worker).start()
    return _stop.is_set()
"""

R9_ATTR_BAD = """
import threading

class Engine:
    def __init__(self):
        self.steps = 0
        self._thread = None

    def _loop(self):
        self.steps = self.steps + 1

    def start(self):
        self._thread = threading.Thread(target=self._loop)
        self._thread.start()

    def stats(self):
        return self.steps
"""

R9_ATTR_CLEAN = """
import threading

class Engine:
    def __init__(self):
        self.steps = 0
        self._lock = threading.RLock()
        self._thread = None

    def _loop(self):
        with self._lock:
            self.steps = self.steps + 1

    def start(self):
        self._thread = threading.Thread(target=self._loop)
        self._thread.start()

    def stats(self):
        with self._lock:
            return self.steps
"""

R9_MULTI = """
import threading

_total = {}

def _waiter(i):
    _total[i] = _total.get(i, 0) + 1

def dispatch_all():
    for i in range(4):
        threading.Thread(target=_waiter, args=(i,)).start()
"""

R9_TRYLOCK = """
import threading

_lock = threading.Lock()
_state = {}

def _worker():
    with _lock:
        _state["n"] = 1

def fire():
    if not _lock.acquire(blocking=False):
        return None
    try:
        _state["n"] = 2
    finally:
        _lock.release()

def start():
    threading.Thread(target=_worker).start()
    fire()
"""

R9_RELEASE_IN_FINALLY = """
import threading

_l = threading.Lock()
_shared = {}

def _worker():
    with _l:
        _shared["n"] = 1

def start():
    threading.Thread(target=_worker).start()
    _l.acquire()
    try:
        _shared["n"] = 2
    finally:
        _l.release()
    _shared["n"] = 3
"""

R9_SUPPRESSED = """
import threading

_flag = {}

def _worker():
    # mxlint: disable=R9 -- a torn test flag the reader tolerates
    _flag["x"] = 1

def start():
    threading.Thread(target=_worker).start()
    return _flag.get("x")
"""

R9_BARE_SUPPRESS = """
import threading

_flag = {}

def _worker():
    # mxlint: disable=R9
    _flag["x"] = 1

def start():
    threading.Thread(target=_worker).start()
    return _flag.get("x")
"""

R10_BAD = """
import threading

_a = threading.Lock()
_b = threading.Lock()

def worker():
    with _a:
        with _b:
            pass

def main_path():
    with _b:
        with _a:
            pass

def boot():
    threading.Thread(target=worker).start()
    main_path()
"""

R10_CLEAN = """
import threading

_a = threading.Lock()
_b = threading.Lock()

def worker():
    with _a:
        with _b:
            pass

def main_path():
    with _a:
        with _b:
            pass

def boot():
    threading.Thread(target=worker).start()
    main_path()
"""

R10_SINGLE_THREAD = """
import threading

_a = threading.Lock()
_b = threading.Lock()

def a_then_b():
    with _a:
        with _b:
            pass

def b_then_a():
    with _b:
        with _a:
            pass
"""

#: fixture -> the rule ids it gives on a port path
FIXTURES = {
    "R9_BAD": (R9_BAD, ["R9"]),
    "R9_CLEAN": (R9_CLEAN, []),
    "R9_READONLY": (R9_READONLY, []),
    "R9_SAFE_TYPE": (R9_SAFE_TYPE, []),
    "R9_ATTR_BAD": (R9_ATTR_BAD, ["R9"]),
    "R9_ATTR_CLEAN": (R9_ATTR_CLEAN, []),
    "R9_MULTI": (R9_MULTI, ["R9"]),
    "R9_TRYLOCK": (R9_TRYLOCK, []),
    "R9_RELEASE_IN_FINALLY": (R9_RELEASE_IN_FINALLY, ["R9"]),
    "R9_SUPPRESSED": (R9_SUPPRESSED, []),
    "R9_BARE_SUPPRESS": (R9_BARE_SUPPRESS, ["MX901"]),
    "R10_BAD": (R10_BAD, ["R10"]),
    "R10_CLEAN": (R10_CLEAN, []),
    "R10_SINGLE_THREAD": (R10_SINGLE_THREAD, []),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_fires_or_stays_clean_as_the_jax_analyzer(name):
    src, want = FIXTURES[name]
    got = race.race_source(src, "mxnet_tpu_torch/serve_fx.py")
    assert [d.rule_id for d in got] == want
    ref = ref_race.race_source(src, "mxnet_tpu/serve_fx.py")
    assert [(d.rule_id, d.line) for d in got] == \
        [(d.rule_id, d.line) for d in ref]


def test_rules_scoped_to_the_port_control_plane():
    assert _ids(R9_BAD, "chip_smoke.py") == ["R9"]
    assert _ids(R9_BAD, "tests/test_torch_fx.py") == []
    assert _ids(R9_BAD, "mxnet_tpu_torch/analysis/fx.py") == []
    assert _ids(R9_BAD, "mxnet_tpu/fx.py") == []


def test_multi_instance_root_races_itself():
    diags = race.race_source(R9_MULTI, P)
    assert "multi-instance" in diags[0].message


def test_r9_sees_across_modules():
    prog = race.Program()
    race._add_module(
        prog, "mxnet_tpu_torch/store.py",
        "import threading\n_db = {}\n\n"
        "def put(k, v):\n    _db[k] = v\n")
    race._add_module(
        prog, "mxnet_tpu_torch/spawner.py",
        "import threading\nfrom . import store as _store\n\n"
        "def _worker():\n    _store.put('a', 1)\n\n"
        "def start():\n"
        "    threading.Thread(target=_worker).start()\n"
        "    _store.put('b', 2)\n")
    race._finalize_program(prog)
    diags = race.scan_program(prog)
    assert [d.rule_id for d in diags] == ["R9"]
    assert "mxnet_tpu_torch.store._db" in diags[0].message


def test_r10_message_names_the_inversion():
    assert "opposite order" in race.race_source(R10_BAD, P)[0].message


# ----------------------------------------------------------------------
# the gate: the port's tree, and the static liveness proof
# ----------------------------------------------------------------------
def test_self_scan_port_clean_modulo_baseline():
    diags = race.scan_paths(ROOT)
    baseline = race.load_baseline(BASELINE)
    un, kept, stale = race.apply_baseline(diags, baseline)
    assert not un, "\n".join(d.format() for d in un)
    assert not stale, stale
    assert kept and all(why for _, why in baseline.values())
    assert all(d.path.startswith("mxnet_tpu_torch/") for d in diags)


def test_strip_lock_static_liveness():
    rel = "mxnet_tpu_torch/profiler.py"
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        stripped = race.strip_locks_source(f.read(), ("_rec_lock",))
    assert "with _rec_lock:" not in stripped
    diags = race.scan_paths(
        ROOT, targets=(rel, "mxnet_tpu_torch/fault.py",
                       "mxnet_tpu_torch/fault_dist.py"),
        rules={"R9"}, override={rel: stripped})
    assert [d for d in diags if d.path == rel and "_state" in d.message]
    with pytest.raises(ValueError):
        race.strip_locks_source("x = 1\n", ("_rec_lock",))


def test_every_rule_is_live():
    assert set(race.RULES) == {"R9", "R10"}
    assert race.DEFAULT_TARGETS == ("mxnet_tpu_torch", "chip_smoke.py")
    assert race.EXCLUDE_PREFIXES == ("mxnet_tpu_torch/analysis/",)


# ----------------------------------------------------------------------
# dynamic confirmation over the port's real code
# ----------------------------------------------------------------------
LIVENESS = {"counter_bump": "drop_counter_lock",
            "lease_flag": "drop_lease_lock",
            "serve_sched": "drop_sched_lock",
            "telemetry_view": "drop_telemetry_lock",
            "flightrec_ring": "drop_flightrec_lock"}


def test_scenarios_and_mutations_are_the_ports():
    assert set(rc.SCENARIOS) == set(LIVENESS)
    assert set(rc.KNOWN_MUTATIONS) == set(LIVENESS.values())
    assert "relay" not in rc.SCENARIOS


@pytest.mark.parametrize("scenario", sorted(LIVENESS))
def test_scenario_clean_with_its_lock(scenario):
    rep = rc.confirm(scenario, seeds=(0, 1))
    assert not rep.racy, rep.summary()
    assert rep.seeds == (0, 1)


@pytest.mark.parametrize("scenario", sorted(LIVENESS))
def test_dropped_lock_is_confirmed_racy(scenario):
    with rc.mutations(LIVENESS[scenario]):
        rep = rc.confirm(scenario, seeds=(0, 1))
    assert rep.racy, "racecheck went blind on %s" % scenario
    assert "mxnet_tpu_torch/" in rep.witnesses[0].var
    assert "RACE CONFIRMED" in rep.summary()


def test_counter_bump_loses_no_update_with_its_lock():
    rep = rc.confirm("counter_bump", seeds=(0,))
    assert rep.info["final"] == rep.info["expected"]


def test_unknown_mutation_rejected_and_nothing_left_armed():
    with pytest.raises(KeyError):
        with rc.mutations("drop_counter_lock", "drop_no_such_lock"):
            pass  # pragma: no cover
    assert not rc._ARMED


def test_vector_clock_orders_lock_handoffs():
    det = rc.RaceDetector()
    lock = rc.InstrumentedLock(det, "l")
    done = threading.Event()

    def a():
        with lock:
            det.on_access("v", True)
        done.set()

    def b():
        done.wait(5.0)
        with lock:
            det.on_access("v", True)

    ta = threading.Thread(target=det.spawned(a))
    tb = threading.Thread(target=det.spawned(b))
    ta.start(), tb.start()
    ta.join(5.0), tb.join(5.0)
    assert det.races() == []
    det2 = rc.RaceDetector()
    ts = [threading.Thread(target=det2.spawned(
        lambda: det2.on_access("v", True))) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(5.0)
    assert det2.races()


@pytest.mark.integration
def test_race_and_racecheck_cli(tmp_path):
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.analysis"]
    r = subprocess.run(cmd + ["race", "--smoke"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "liveness ok" in r.stderr
    r = subprocess.run(cmd + ["racecheck", "flightrec_ring", "--mutate",
                              "drop_flightrec_lock"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1 and "RACE CONFIRMED" in r.stdout
    r = subprocess.run(cmd + ["racecheck", "--smoke"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
