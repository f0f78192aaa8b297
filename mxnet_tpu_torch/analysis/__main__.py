"""The port's analysis CLI::

    python -m mxnet_tpu_torch.analysis lint [--smoke] [paths]
    python -m mxnet_tpu_torch.analysis race [--smoke] [paths]
    python -m mxnet_tpu_torch.analysis verify [--smoke] [--scenario S]
    python -m mxnet_tpu_torch.analysis racecheck [--smoke] [SCENARIO]

``lint`` runs the AST rules R1-R8 and ``race`` the lockset rules R9 /
R10 over the port's tree (paths relative to the repo root), each
against its checked-in baseline beside this file
(``lint_baseline.txt``, ``race_baseline.txt``: ``rule path count --
reason`` lines).  A finding beyond the baseline fails, and so does a
baseline entry whose count the scan no longer reaches: lower it (the
ratchet).  ``race --smoke`` also strips ``profiler._rec_lock`` from the
real source and requires R9 to see it.

``verify`` explores the protocol scenarios of :mod:`.modelcheck`;
``--smoke`` runs every scenario at a small budget and requires each of
the seven known mutations to be found.  ``racecheck`` runs the
vector-clock scenarios of :mod:`.racecheck`; ``--smoke`` requires every
scenario clean at two seeds and racy with its lock dropped.

Exit code 0 = clean, 1 = findings (or a counterexample, or a checker
that went blind), 2 = usage error.
"""
import argparse
import contextlib
import json
import os
import sys
import time

from . import lint, race

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.dirname(os.path.abspath(__file__))
LINT_BASELINE = os.path.join(HERE, "lint_baseline.txt")
RACE_BASELINE = os.path.join(HERE, "race_baseline.txt")

#: (scenario, mutation) pairs the verify smoke must catch
VERIFY_LIVENESS = (("consensus", "solo_reissue"),
                   ("consensus_amortized", "skip_lease_revoke"),
                   ("resize", "skip_commit_funnel"),
                   ("resize_grow", "skip_join_barrier"),
                   ("serve_sched", "serve_stale_commit"),
                   ("serve_sched", "skip_cow_copy"),
                   ("serve_router", "skip_failover_dedupe"))
#: scenario -> the drop-lock mutation the racecheck smoke must flag
RACECHECK_LIVENESS = {"counter_bump": "drop_counter_lock",
                      "lease_flag": "drop_lease_lock",
                      "serve_sched": "drop_sched_lock",
                      "telemetry_view": "drop_telemetry_lock",
                      "flightrec_ring": "drop_flightrec_lock"}


def _log(msg):
    print(msg, file=sys.stderr)


def _split_csv(text):
    return [t.strip() for t in text.split(",") if t.strip()]


def _gate(prog, diags, bpath, no_baseline, rules, fmt):
    """Print the findings beyond the baseline and the stale entries;
    True when the gate fails."""
    baseline = {}
    if not no_baseline and os.path.exists(bpath):
        baseline = lint.load_baseline(bpath)
        if rules:
            baseline = {k: v for k, v in baseline.items()
                        if k[0] in rules}
    unbaselined, baselined, stale = lint.apply_baseline(diags, baseline)
    for d in unbaselined:
        if fmt == "github":
            print("::error file=%s,line=%d,title=%s %s::%s"
                  % (d.path, d.line, prog, d.rule_id, d.message))
        else:
            print(d.format())
    for (rule_id, path), allowed, found in stale:
        why = baseline.get((rule_id, path), (0, ""))[1]
        print("%s: stale baseline entry '%s %s %d -- %s': the scan finds "
              "only %d; lower the count to %d"
              % (prog, rule_id, path, allowed, why, found, found))
    _log("%s: %d diagnostic(s) (%d baselined, %d stale baseline entr%s)"
         % (prog, len(unbaselined), len(baselined), len(stale),
            "y" if len(stale) == 1 else "ies"))
    return bool(unbaselined) or bool(stale)


def _rules(ap, args, known):
    rules = set(_split_csv(args.rules)) if args.rules else None
    if rules and rules - set(known):
        ap.error("unknown rule id(s) %s; known: %s"
                 % (",".join(sorted(rules - set(known))),
                    ",".join(sorted(known))))
    return rules


def _list_rules(rules):
    for r in sorted(rules.values(), key=lambda r: int(r.rule_id[1:])):
        print("%s %-30s %s" % (r.rule_id, r.name, r.invariant))
        print("    scope: %s" % ", ".join(r.scope))


def cmd_lint(ap, args):
    if args.list_rules:
        _list_rules(lint.RULES)
        return 0
    rules = _rules(ap, args, lint.RULES)
    t0 = time.monotonic()
    diags = lint.lint_paths(ROOT, args.paths or None, rules=rules)
    failed = _gate("lint", diags, args.baseline or LINT_BASELINE,
                   args.no_baseline, rules, args.format)
    _log("lint: %s in %.1fs" % ("FAILED" if failed else "clean",
                                time.monotonic() - t0))
    return 1 if failed else 0


def cmd_race(ap, args):
    if args.list_rules:
        _list_rules(race.RULES)
        return 0
    rules = _rules(ap, args, race.RULES)
    t0 = time.monotonic()
    diags = race.scan_paths(ROOT, args.paths or None, rules=rules)
    failed = _gate("race", diags, args.baseline or RACE_BASELINE,
                   args.no_baseline, rules, args.format)
    _log("race: self-scan %s (%.1fs)" % ("FAILED" if failed else "clean",
                                         time.monotonic() - t0))
    if args.smoke:
        failed = _race_liveness() or failed
    return 1 if failed else 0


def _race_liveness():
    """Strip profiler's ``_rec_lock`` from the real source: R9 must see
    ``_state`` again.  True on failure."""
    t0 = time.monotonic()
    rel = "mxnet_tpu_torch/profiler.py"
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        stripped = race.strip_locks_source(f.read(), ("_rec_lock",))
    diags = race.scan_paths(
        ROOT, targets=(rel, "mxnet_tpu_torch/fault.py",
                       "mxnet_tpu_torch/fault_dist.py"),
        rules={"R9"}, override={rel: stripped})
    hit = [d for d in diags if d.path == rel and "_state" in d.message]
    if not hit:
        print("race: LIVENESS FAILURE: _rec_lock stripped from "
              "profiler.py yet R9 stayed silent")
        return True
    _log("race: liveness ok: stripping _rec_lock re-exposes %d R9 "
         "finding(s) on profiler._state (%.1fs)"
         % (len(hit), time.monotonic() - t0))
    return False


def _verify_report(rep, trace_out):
    print(rep.summary())
    if rep.counterexample is None:
        return True
    print(rep.counterexample.format())
    if trace_out:
        from ..utils import serialization
        payload = json.dumps(rep.counterexample.to_json(),
                             indent=1).encode("utf-8")
        with serialization.atomic_write(trace_out) as f:
            f.write(payload)
        _log("verify: counterexample written to %s (replay with "
             "--replay)" % trace_out)
    return False


def cmd_verify(ap, args):
    from . import modelcheck as mc
    if args.list:
        for name in sorted(mc.SCENARIOS):
            variants = mc.SCENARIOS[name]()
            oracles = []
            for v in variants:
                oracles += [o for o in v.oracles if o not in oracles]
            print("%s (world=%d)" % (name, variants[0].world))
            print("  variants: %s" % ", ".join(v.name for v in variants))
            print("  oracles:  %s" % ", ".join(oracles))
        print("mutations: %s" % ", ".join(sorted(mc.KNOWN_MUTATIONS)))
        return 0
    if args.mutate and args.mutate not in mc.KNOWN_MUTATIONS:
        ap.error("unknown mutation %r; known: %s"
                 % (args.mutate, ", ".join(sorted(mc.KNOWN_MUTATIONS))))
    armed = mc.mutations(args.mutate) if args.mutate \
        else contextlib.nullcontext()
    if args.replay:
        with open(args.replay, encoding="utf-8") as f:
            data = json.load(f)
        with armed:
            violation, events = mc.replay(data)
        cex = mc.Counterexample(
            data["scenario"], data["variant"],
            violation.oracle if violation else data.get("oracle", "?"),
            violation.message if violation else
            "replay no longer violates (fixed?)",
            data["schedule"], events)
        print(cex.format())
        print("verify: replay %s" % (
            "VIOLATES %s" % violation.oracle if violation
            else "clean: the recorded violation no longer reproduces"))
        return 1 if violation else 0
    log = _log if args.verbose else None
    if args.smoke:
        return 0 if _verify_smoke(mc, log) else 1
    if args.scenario == "all":
        names = sorted(mc.SCENARIOS)
    elif args.scenario in mc.SCENARIOS:
        names = [args.scenario]
    else:
        ap.error("unknown scenario %r; known: %s, all"
                 % (args.scenario, ", ".join(sorted(mc.SCENARIOS))))
    budget = mc.Budget(schedules=args.schedules, seconds=args.seconds,
                       seed=args.seed)
    ok = True
    with armed:
        for name in names:
            rep = mc.verify_scenario(name, budget=budget, log=log)
            ok = _verify_report(rep, args.trace_out) and ok
            if not ok and not args.keep_going:
                break
    return 0 if ok else 1


def _verify_smoke(mc, log=None):
    """Every scenario at the smoke budget, then every known mutation
    found (a checker that finds none of them has gone blind)."""
    ok = True
    for name in sorted(mc.SCENARIOS):
        rep = mc.verify_scenario(
            name, budget=mc.Budget(schedules=300, seconds=8), log=log)
        ok = _verify_report(rep, None) and ok
    for scen, mut in VERIFY_LIVENESS:
        t0 = time.monotonic()
        with mc.mutations(mut):
            rep = mc.verify_scenario(
                scen, budget=mc.Budget(schedules=400, seconds=10))
        if rep.counterexample is None:
            print("verify: LIVENESS FAILURE: mutation %r in scenario %s "
                  "produced no counterexample (%d schedules)"
                  % (mut, scen, rep.schedules))
            ok = False
        else:
            _log("verify: liveness ok: mutation %r caught by %s in %d "
                 "schedules (%.1fs)" % (mut, rep.counterexample.oracle,
                                        rep.schedules,
                                        time.monotonic() - t0))
    return ok


def cmd_racecheck(ap, args):
    from . import racecheck as rc
    if args.list:
        for name in sorted(rc.SCENARIOS):
            s = rc.SCENARIOS[name]
            print("%s: %s" % (name, s.doc))
            print("    confirms: %s" % s.confirms)
        print("mutations: %s" % ", ".join(sorted(rc.KNOWN_MUTATIONS)))
        return 0
    try:
        seeds = tuple(int(s) for s in _split_csv(args.seeds)) or (0,)
    except ValueError:
        ap.error("--seeds wants integers, got %r" % args.seeds)
    if args.smoke:
        failed = False
        for scen, mut in sorted(RACECHECK_LIVENESS.items()):
            t0 = time.monotonic()
            clean = rc.confirm(scen, seeds=seeds[:2] or (0, 1))
            with rc.mutations(mut):
                racy = rc.confirm(scen, seeds=seeds[:2] or (0, 1))
            if clean.racy:
                print("racecheck: %s races WITH its lock:\n%s"
                      % (scen, clean.summary()))
                failed = True
            if not racy.racy:
                print("racecheck: LIVENESS FAILURE: %s dropped yet no "
                      "race confirmed in %s" % (mut, scen))
                failed = True
            _log("racecheck: %s clean, %s confirmed racy (%d "
                 "witness(es)) in %.1fs"
                 % (scen, mut, len(racy.witnesses),
                    time.monotonic() - t0))
        return 1 if failed else 0
    if not args.scenario:
        ap.error("racecheck wants a SCENARIO, --smoke or --list")
    if args.scenario not in rc.SCENARIOS:
        ap.error("unknown scenario %r; known: %s"
                 % (args.scenario, ", ".join(sorted(rc.SCENARIOS))))
    if args.mutate and args.mutate not in rc.KNOWN_MUTATIONS:
        ap.error("unknown mutation %r; known: %s"
                 % (args.mutate, ", ".join(sorted(rc.KNOWN_MUTATIONS))))
    armed = rc.mutations(args.mutate) if args.mutate \
        else contextlib.nullcontext()
    with armed:
        rep = rc.confirm(args.scenario, seeds=seeds)
    print(rep.summary())
    return 1 if rep.racy else 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, doc in (("lint", "AST rules R1-R8"),
                      ("race", "lockset rules R9 / R10")):
        p = sub.add_parser(name, help=doc)
        p.add_argument("paths", nargs="*",
                       help="repo-relative files / directories")
        p.add_argument("--smoke", action="store_true",
                       help="the gate: baseline-clean (race: and the "
                       "strip-lock liveness proof)")
        p.add_argument("--baseline", default=None,
                       help="baseline file (default: beside this module)")
        p.add_argument("--no-baseline", action="store_true")
        p.add_argument("--rules", default=None,
                       help="comma-separated rule ids")
        p.add_argument("--format", choices=("text", "github"),
                       default="text")
        p.add_argument("--list-rules", action="store_true")
    p = sub.add_parser("verify", help="exhaustive-interleaving checker")
    p.add_argument("--scenario", default="all")
    p.add_argument("--list", action="store_true")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--mutate", default=None, metavar="NAME")
    p.add_argument("--replay", default=None, metavar="TRACE.json")
    p.add_argument("--trace-out", default=None, metavar="FILE")
    p.add_argument("--schedules", type=int, default=None)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--keep-going", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p = sub.add_parser("racecheck", help="vector-clock race confirmation")
    p.add_argument("scenario", nargs="?", default=None)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--list", action="store_true")
    p.add_argument("--mutate", default=None, metavar="NAME")
    p.add_argument("--seeds", default="0,1")
    args = ap.parse_args(argv)
    return {"lint": cmd_lint, "race": cmd_race, "verify": cmd_verify,
            "racecheck": cmd_racecheck}[args.cmd](ap, args)


if __name__ == "__main__":
    sys.exit(main())
