"""mxverify of the port (``mxnet_tpu_torch.analysis.modelcheck``): sound
on the port's real protocols and provably alive.

Every scenario (consensus, the step lease, resize, grow, the serving
scheduler with and without a shared prefix, the router) is clean on
the port's unmutated code at a small budget; each of the seven known
mutations is found with a minimized counterexample that ``replay``
reproduces with the mutation armed and that comes back clean without
it.  The scenarios, variants, oracles and mutations are the JAX
package's.  And in production every seam the checker drives is inert:
the mutation sets are empty, ``_sim`` / ``_sched`` are None and no comm
carries a scheduler.
"""
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from mxnet_tpu.analysis import modelcheck as ref_mc
from mxnet_tpu_torch import fault_dist, fault_elastic, serve, serve_router
from mxnet_tpu_torch.analysis import modelcheck as mc
from mxnet_tpu_torch.models import TransformerLM, tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the smallest schedule budgets that still find every mutation; the
#: wall limits only guard a hang (a scenario takes about a second), so a
#: loaded machine does not end a run before its schedules are explored
CLEAN = dict(schedules=100, seconds=30, seed=0)
HUNT = dict(schedules=400, seconds=30, seed=0)

MUTATIONS = {"solo_reissue": ("consensus", ("no_solo_reissue",)),
             "skip_lease_revoke": ("consensus_amortized",
                                   ("no_lease_false_success",)),
             "skip_commit_funnel": ("resize", ("no_fork",)),
             "skip_join_barrier": ("resize_grow",
                                   ("no_fork", "equal_generations",
                                    "joiner_adopts_committed_gen")),
             "serve_stale_commit": ("serve_sched",
                                    ("serve_no_cross_delivery",)),
             "skip_cow_copy": ("serve_sched",
                               ("serve_shared_no_cross_delivery",)),
             "skip_failover_dedupe": ("serve_router",
                                      ("exactly_once_delivery",))}


def test_scenarios_variants_oracles_and_mutations_are_the_references():
    assert set(mc.SCENARIOS) == set(ref_mc.SCENARIOS)
    for name in mc.SCENARIOS:
        mine = [(v.name, v.world, v.oracles, v.mutating)
                for v in mc.SCENARIOS[name]()]
        ref = [(v.name, v.world, v.oracles, v.mutating)
               for v in ref_mc.SCENARIOS[name]()]
        assert mine == ref, name
    assert set(mc.KNOWN_MUTATIONS) == set(ref_mc.KNOWN_MUTATIONS) == \
        set(MUTATIONS)
    assert {n: m.__name__.split(".")[-1]
            for n, m in mc.KNOWN_MUTATIONS.items()} == \
        {n: m.__name__.split(".")[-1]
         for n, m in ref_mc.KNOWN_MUTATIONS.items()}
    assert all(m.__name__.startswith("mxnet_tpu_torch.")
               for m in mc.KNOWN_MUTATIONS.values())


@pytest.mark.parametrize("scenario", sorted(mc.SCENARIOS))
def test_port_protocol_is_clean(scenario):
    rep = mc.verify_scenario(scenario, budget=mc.Budget(**CLEAN))
    assert rep.ok, rep.counterexample.format()
    assert rep.schedules >= 90
    assert rep.dfs > 0


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_mutation_is_caught_and_replays(mutation):
    scenario, oracles = MUTATIONS[mutation]
    with mc.mutations(mutation):
        rep = mc.verify_scenario(scenario, budget=mc.Budget(**HUNT))
    assert not rep.ok, "checker went blind: %s not found" % mutation
    cex = rep.counterexample
    assert cex.oracle in oracles
    assert cex.events, "a counterexample carries its replayed trace"
    data = json.loads(json.dumps(cex.to_json()))
    with mc.mutations(mutation):
        violation, _ = mc.replay(data)
    assert violation is not None and violation.oracle == cex.oracle
    violation, _ = mc.replay(data)
    assert violation is None, "the unmutated protocol must be clean"
    text = cex.format()
    assert "minimized schedule" in text and "replayed events" in text


def test_unknown_mutation_rejected_and_nothing_left_armed():
    with pytest.raises(KeyError):
        with mc.mutations("solo_reissue", "skip_commit_funel"):
            pass  # pragma: no cover
    for mod in (fault_dist, fault_elastic, serve, serve_router):
        assert mod._TEST_MUTATIONS == set()


def test_budget_env_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_VERIFY_SCHEDULES", "77")
    monkeypatch.setenv("MXNET_VERIFY_PREEMPTIONS", "5")
    monkeypatch.setenv("MXNET_VERIFY_SECONDS", "3.5")
    b = mc.Budget()
    assert (b.schedules, b.preemptions, b.seconds) == (77, 5, 3.5)
    assert (b.faults, b.steps, b.seed) == (1, 4000, 0)
    assert mc.Budget(schedules=3).schedules == 3   # args beat the env
    subs = mc.Budget(schedules=90, seconds=9).split(3)
    assert [s.schedules for s in subs] == [30, 30, 30]
    assert [s.seconds for s in subs] == [3.0, 3.0, 3.0]


def test_virtual_clock_is_per_thread():
    """The checker's clock reaches ``fault_dist._now`` and
    ``fault_elastic._now`` on its own threads only."""
    assert fault_elastic._SIM_CLOCK is fault_dist._SIM_CLOCK
    seen = {}

    def sim_thread():
        fault_dist._SIM_CLOCK.fn = lambda: 1234.5
        seen["sim"] = (fault_dist._now(), fault_elastic._now())
        fault_dist._SIM_CLOCK.fn = None
    t = threading.Thread(target=sim_thread)
    t.start()
    t.join()
    assert seen["sim"] == (1234.5, 1234.5)
    assert fault_dist._now() != 1234.5
    assert getattr(fault_dist._SIM_CLOCK, "fn", None) is None


def test_seams_are_inert_in_production():
    """After one coordinated_call over real threads and one request
    served on the CPU, every seam the checker drives is unset."""
    comms = fault_dist.InProcessComm.create(2)
    gens = [fault_dist.Generation() for _ in comms]
    out = {}

    def rank(r):
        out[r] = fault_dist.coordinated_call(lambda: r * 10,
                                             comm=comms[r], op="probe",
                                             gen=gens[r])
    ts = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert out == {0: 0, 1: 10}
    assert "sched" not in comms[0]._shared
    assert fault_dist.StepLease()._sim is None
    assert fault_elastic.InProcessBoard()._sched is None

    net = TransformerLM(tiny_config(), device="cpu").initialize(
        torch.Generator().manual_seed(0), std=0.1)
    srv = serve.Server(net, serve.ServeConfig(slots=2, page_size=8,
                                              pages=16, ladder=(16,),
                                              max_new=3))
    group = serve_router.ReplicaGroup([srv], threaded=False)
    with srv:
        rid = srv.submit([1, 2, 3], max_new=3)
        assert len(srv.result(rid, timeout=120)["tokens"]) == 3
    assert srv.sched._sim is None and group._sim is None
    for mod in (fault_dist, fault_elastic, serve, serve_router):
        assert mod._TEST_MUTATIONS == set()


@pytest.mark.integration
def test_verify_cli(tmp_path):
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.analysis", "verify"]
    r = subprocess.run(cmd + ["--list"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0
    assert "serve_router" in r.stdout and "skip_cow_copy" in r.stdout
    trace = tmp_path / "trace.json"
    r = subprocess.run(cmd + ["--scenario", "resize", "--mutate",
                              "skip_commit_funnel", "--schedules", "400",
                              "--seconds", "10", "--trace-out",
                              str(trace)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "counterexample" in r.stdout and trace.exists()
    r = subprocess.run(cmd + ["--replay", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "no longer reproduces" in r.stdout
    r = subprocess.run(cmd + ["--replay", str(trace), "--mutate",
                              "skip_commit_funnel"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "VIOLATES no_fork" in r.stdout
    r = subprocess.run(cmd + ["--scenario", "nope"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2
