"""``mx.analysis``: the port's static analyzers and protocol checkers.

The conventions the port's fault runtime and serving rest on are
checkable artifacts, not prose:

- :mod:`.lint`: AST rules R1-R8 over the port's own source, no project
  imports executed.
- :mod:`.race`: the lockset race analyzer of the host threads (thread
  roots, interprocedural locksets, R9 / R10), whole-program over the
  scanned tree, stdlib-only like lint.
- :mod:`.modelcheck`: mxverify, the exhaustive-interleaving protocol
  checker.  It runs the REAL coordination code (``coordinated_call``,
  ``StepLease``, ``vote_resize`` / ``vote_join``, ``SlotScheduler``,
  ``ReplicaGroup``) under a deterministic cooperative scheduler, so it
  imports the port: lazy here.
- :mod:`.racecheck`: vector-clock happens-before confirmation of race
  findings over real threads, with drop-lock mutations proving the
  checker alive; lazy like modelcheck.

``hlo`` is not ported: it reads XLA HLO, which a CUDA program does not
have (ROADMAP section 1); the name raises ``NotImplementedError``.

``python -m mxnet_tpu_torch.analysis {lint,race,verify,racecheck}`` is
the CLI.  lint and race load by file path without torch.
"""
from . import lint, race  # noqa: F401
from .lint import (  # noqa: F401
    Diagnostic, Rule, RULES, apply_baseline, lint_paths, lint_source,
    load_baseline, rule,
)

HLO_NOT_PORTED = ("mxnet_tpu_torch.analysis.hlo is not ported by design: "
                  "it reads XLA HLO, which a PyTorch / CUDA program does "
                  "not have (ROADMAP section 1)")


def __getattr__(name):
    if name in ("modelcheck", "racecheck"):
        import importlib
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    if name == "hlo":
        raise NotImplementedError(HLO_NOT_PORTED)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
