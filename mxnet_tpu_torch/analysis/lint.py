"""mxlint level 1 for the PyTorch port: AST rules that make the fault
runtime's conventions machine-checked.

The port's ops layer rests on invariants that otherwise live only in
prose: mutating collectives retry at the entry seam only, no rank
re-issues a collective solo, artifacts are committed via
``serialization.atomic_write``'s ``os.replace`` point, broad ``except``
blocks do not swallow coordination exceptions, code captured into a CUDA
graph hides no host sync, and the tests are deterministic.  This module
turns each of those into a named rule over the port's own source: pure
``ast``, no project imports executed, so it runs anywhere python runs
(no card, no torch).

Vocabulary:

- **Diagnostic**: ``path:line rule-id message``.
- **Inline suppression**: ``# mxlint: disable=R2 -- one-line reason``
  on the flagged line or the line above.  The justification after
  ``--`` is mandatory; a bare ``disable=`` is itself a diagnostic
  (MX901), so suppressions cannot rot into unexplained noise.
- **Baseline**: a checked-in file of ``rule path count -- reason``
  lines (:func:`load_baseline`); the gate fails only on diagnostics
  beyond it, and on entries whose count the scan no longer reaches, so
  it ratchets down.  ``lint_baseline.txt`` beside this file is the
  port's.

Rules are pluggable: :func:`rule` registers a checker against a path
scope.  ``python -m mxnet_tpu_torch.analysis lint`` is the CLI.
"""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize

__all__ = [
    "Diagnostic", "Rule", "RULES", "rule", "lint_source", "lint_paths",
    "load_baseline", "apply_baseline", "DEFAULT_TARGETS",
]


class Diagnostic:
    """One finding: ``path:line rule-id message``."""

    __slots__ = ("rule_id", "path", "line", "message")

    def __init__(self, rule_id, path, line, message):
        self.rule_id = rule_id
        self.path = path
        self.line = int(line)
        self.message = message

    def format(self):
        return "%s:%d %s %s" % (self.path, self.line, self.rule_id,
                                self.message)

    def __repr__(self):
        return "Diagnostic(%s)" % self.format()


class Rule:
    def __init__(self, rule_id, name, invariant, scope, checker,
                 exclude=()):
        self.rule_id = rule_id
        self.name = name
        self.invariant = invariant
        self.scope = tuple(scope)
        self.exclude = tuple(exclude)
        self.checker = checker

    def applies(self, relpath):
        if any(relpath.startswith(e) for e in self.exclude):
            return False
        return any(relpath.startswith(s) or relpath == s.rstrip("/")
                   for s in self.scope)


#: Registry, keyed by rule id — plug new rules in with :func:`rule`.
RULES = {}


def rule(rule_id, name, invariant, scope, exclude=()):
    def deco(checker):
        RULES[rule_id] = Rule(rule_id, name, invariant, scope, checker,
                              exclude)
        return checker
    return deco


# ----------------------------------------------------------------------
# file context + shared AST utilities
# ----------------------------------------------------------------------
class FileContext:
    """Parsed source + the indexes every rule needs (built once)."""

    def __init__(self, text, relpath):
        self.text = text
        self.relpath = relpath
        self.lines = text.splitlines()
        self.tree = ast.parse(text)
        # one walk: every node, its parent, and the calls / defs lists
        # the rules read (``ctx.calls`` is ``ctx.calls``)
        self.nodes = list(ast.walk(self.tree))
        self.parents = {}
        for node in self.nodes:
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.calls = [n for n in self.nodes if isinstance(n, ast.Call)]
        self.functions = [n for n in self.nodes
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))]
        # module aliases: {"numpy": {"onp", "_onp", ...}, "time": {...}}
        # and from-imports: {bound name: (top module, original name)} so
        # `from time import time` is as visible as `import time`
        self.aliases = {}
        self.from_imports = {}
        # relative from-imports: {bound name: (module, original name)}
        self.rel_imports = {}
        for node in self.nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    top = a.name.split(".")[0]
                    self.aliases.setdefault(top, set()).add(
                        a.asname or top)
            elif isinstance(node, ast.ImportFrom) and node.level > 0:
                for a in node.names:
                    self.rel_imports[a.asname or a.name] = (
                        node.module or "", a.name)
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    self.from_imports[a.asname or a.name] = (node.module,
                                                             a.name)
                    # `from numpy import random` binds a submodule —
                    # treat the bound name as a module alias too
                    sub = "%s.%s" % (node.module, a.name)
                    self.aliases.setdefault(sub, set()).add(
                        a.asname or a.name)

    def enclosing_functions(self, node):
        """Function defs containing ``node``, innermost first."""
        out = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def is_descendant(self, node, ancestor):
        cur = node
        while cur is not None:
            if cur is ancestor:
                return True
            cur = self.parents.get(cur)
        return False


def _dotted(expr):
    """Dotted name of an expression (``lax.psum``, ``fdist.coordinated_call``,
    ``open``), or '' when it is not a plain name chain."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return ""


def _call_tail(call):
    d = _dotted(call.func)
    return d.rsplit(".", 1)[-1] if d else ""


def _calls(tree):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)]


def _kwarg(call, name):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _str_const(expr):
    """The literal string of an expression, looking through ``"a%s" % x``
    and ``"a" + x`` to the literal prefix; None when there is none."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.BinOp):
        return _str_const(expr.left)
    return None


def _contains_raise(nodes):
    for stmt in nodes:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Raise):
                return True
    return False


def _referenced_names(node):
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _module_funcs(ctx):
    """Top-level (module or class body) function defs by name."""
    out = {}
    for f in ctx.functions:
        encl = ctx.enclosing_functions(f)
        if not encl:
            out[f.name] = f
    return out


# ----------------------------------------------------------------------
# R1 — raw collectives must launch through a coordinated/retry seam
# ----------------------------------------------------------------------
#: torch.distributed's collectives and point-to-point calls
_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                "reduce_scatter", "reduce_scatter_tensor", "broadcast",
                "all_to_all", "all_to_all_single", "send", "recv",
                "isend", "irecv", "batch_isend_irecv", "barrier",
                "all_gather_object", "broadcast_object_list"}
#: the port's own comm wrappers (``parallel/_compat.py``): collectives
#: too, to their callers
_COMPAT_WRAPPERS = {"ppermute", "ppermute_start", "psum", "psum_grad",
                    "psum_partial", "psum_scatter", "all_gather",
                    "gather", "split", "broadcast", "exchange", "barrier",
                    "all_to_all"}
_SEAMS = {"coordinated_call", "retry_call"}


def _dist_aliases(ctx):
    """Names bound to ``torch.distributed`` in this file."""
    out = set()
    for node in ctx.nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    out.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module == "torch":
            for a in node.names:
                if a.name == "distributed":
                    out.add(a.asname or a.name)
    return out


def _collective_sites(ctx, node):
    """Calls under ``node`` that launch a collective: a
    ``torch.distributed`` one (``dist.all_reduce``), or one of the
    port's ``_compat`` wrappers (``_compat.psum``, or the bare name
    imported from ``_compat``)."""
    dist = _dist_aliases(ctx)
    out = []
    for c in _calls(node):
        d = _dotted(c.func)
        if not d:
            continue
        head, _, tail = d.rpartition(".")
        if head:
            if (head in dist or head == "torch.distributed") \
                    and tail in _COLLECTIVES:
                out.append(c)
            elif head.rsplit(".", 1)[-1] == "_compat" \
                    and tail in _COMPAT_WRAPPERS:
                out.append(c)
        else:
            mod, orig = ctx.rel_imports.get(d, ("", ""))
            if mod.rsplit(".", 1)[-1] == "_compat" \
                    and orig in _COMPAT_WRAPPERS:
                out.append(c)
    return out


def _seam_guarded_names(ctx):
    """Names structurally inside a seam: functions passed by name to
    ``coordinated_call``/``retry_call``, plus decorator factories whose
    own body contains a seam call (the ``kvstore._retrying`` pattern —
    anything they decorate launches through the seam they wrap)."""
    guarded, seam_factories = set(), set()
    for c in ctx.calls:
        if _call_tail(c) in _SEAMS:
            for a in c.args:
                if isinstance(a, ast.Name):
                    guarded.add(a.id)
    for name, f in _module_funcs(ctx).items():
        if any(_call_tail(c) in _SEAMS for c in _calls(f)):
            seam_factories.add(name)
    return guarded, seam_factories


def _guarded_funcs(ctx):
    """Function defs whose body runs inside a seam: passed by name to a
    seam call, decorated by a seam factory, defined inside one of those,
    or reached (same file, by name or ``self.<method>``) from one."""
    guarded_names, seam_factories = _seam_guarded_names(ctx)
    by_name = {}
    for f in ctx.functions:
        by_name.setdefault(f.name, []).append(f)
    roots = []
    for f in ctx.functions:
        if f.name in guarded_names or any(
                _dotted(d.func if isinstance(d, ast.Call) else d)
                .rsplit(".", 1)[-1] in seam_factories
                for d in f.decorator_list):
            roots.append(f)
    return _reach_defs(ctx, roots, by_name)


def _reach_defs(ctx, roots, by_name):
    """``roots`` plus every def nested in them or referenced from them
    by a bare name or a ``self.<name>`` attribute, and every method of a
    class referenced by name (``_Ring.apply`` runs its ``forward``),
    all in the same file."""
    classes = {n.name: n for n in ctx.nodes
               if isinstance(n, ast.ClassDef)}
    out, seen, frontier = [], set(), list(roots)
    while frontier:
        f = frontier.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        out.append(f)
        names = _referenced_names(f) | {
            n.attr for n in ast.walk(f)
            if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "self"}
        for n in ast.walk(f):
            if n is not f and isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                frontier.append(n)
        for name in names:
            for g in by_name.get(name, ()):
                if id(g) not in seen:
                    frontier.append(g)
            if name in classes:
                frontier.extend(
                    n for n in classes[name].body
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)))
    return out


@rule("R1", "coordinated-collective-launch",
      "every torch.distributed collective (or _compat wrapper) launched "
      "from parallel/ or kvstore/ goes through coordinated_call / "
      "retry_call (a solo re-issue against parked peers deadlocks the "
      "mesh)",
      scope=("mxnet_tpu_torch/parallel/", "mxnet_tpu_torch/kvstore/"),
      exclude=("mxnet_tpu_torch/parallel/_compat.py",))
def _check_r1(ctx):
    guarded = {id(f) for f in _guarded_funcs(ctx)}
    seam_calls = [c for c in ctx.calls if _call_tail(c) in _SEAMS]
    for site in _collective_sites(ctx, ctx.tree):
        encl = ctx.enclosing_functions(site)
        if not encl:
            continue  # module scope: nothing launches at import
        if any(id(f) in guarded for f in encl):
            continue
        if any(ctx.is_descendant(site, sc) for sc in seam_calls):
            continue
        yield (site.lineno,
               "collective %s launched with no coordinated_call/"
               "retry_call seam on its path — a transient failure here "
               "re-issues solo (or not at all) while peers stay parked"
               % _dotted(site.func))


# ----------------------------------------------------------------------
# R2 — artifact writes need an os.replace commit point
# ----------------------------------------------------------------------
_WRITE_MODES = re.compile(r"[wax+]")


def _is_os_commit_call(ctx, call):
    """True only for a REAL ``os.replace``/``os.link`` (module-qualified
    through an ``os`` import alias, or from-imported from ``os``) — a
    same-named helper (``photos.link(...)``, a local ``link()``) must
    not exempt an unrelated raw write from R2."""
    d = _dotted(call.func)
    if "." in d:
        head, _, tail = d.rpartition(".")
        return tail in ("replace", "link") and \
            head.rsplit(".", 1)[-1] in ctx.aliases.get("os", ())
    return d in ("replace", "link") and \
        ctx.from_imports.get(d, ("", ""))[0] == "os"


@rule("R2", "atomic-artifact-write",
      "files are written via serialization.atomic_write (or an explicit "
      "os.replace commit point) so a crash never leaves a torn artifact",
      scope=("mxnet_tpu_torch/", "chip_smoke.py"),
      exclude=("mxnet_tpu_torch/utils/serialization.py",
               "mxnet_tpu_torch/analysis/"))
def _check_r2(ctx):
    for c in ctx.calls:
        tail = _call_tail(c)
        if tail == "open" and _dotted(c.func) in ("open", "io.open"):
            mode = c.args[1] if len(c.args) > 1 else _kwarg(c, "mode")
            if mode is None:
                continue  # default 'r'
            lit = _str_const(mode)
            if lit is None or not _WRITE_MODES.search(lit):
                continue
        elif tail in ("write_text", "write_bytes"):
            pass
        else:
            continue
        encl = ctx.enclosing_functions(c)
        if any(f.name == "atomic_write" for f in encl):
            continue
        if encl and any(_is_os_commit_call(ctx, c2)
                        for c2 in _calls(encl[-1])):
            # manual tmp+os.replace (or first-writer-wins tmp+os.link)
            # pattern: the rename/link IS the commit point
            continue
        yield (c.lineno,
               "file opened for writing with no os.replace commit point "
               "— route through serialization.atomic_write (a crash "
               "mid-write leaves a torn artifact)")


# ----------------------------------------------------------------------
# R3 — mutating ops retry at the entry seam only
# ----------------------------------------------------------------------
_MUTATING_OP_WORDS = re.compile(
    r"push|pushpull|update|commit|save|optimizer|checkpoint")


def _mutating_context(ctx, call):
    """True when the retry wrapper sits where a mutating op can flow
    through it: an enclosing function takes/derives a ``mutating`` flag,
    or the ``op=`` literal names a mutating operation."""
    op = _kwarg(call, "op")
    lit = _str_const(op) if op is not None else None
    if lit and _MUTATING_OP_WORDS.search(lit):
        return True
    for f in ctx.enclosing_functions(call):
        argnames = {a.arg for a in (f.args.args + f.args.kwonlyargs)}
        if argnames & {"mutating", "is_mutating"}:
            return True
        for n in ast.walk(f):
            if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name)
                    and t.id in ("mutating", "is_mutating")
                    for t in n.targets):
                return True
    return False


@rule("R3", "entry-seam-retry",
      "retry wrappers reachable by mutating ops pass entry_only_policy() "
      "(a mid-op retry double-applies the mutation) and never a "
      "per-attempt timeout (an abandoned attempt thread races its retry)",
      scope=("mxnet_tpu_torch/", "chip_smoke.py"),
      exclude=("mxnet_tpu_torch/fault.py",))
def _check_r3(ctx):
    for c in ctx.calls:
        if _call_tail(c) != "retry_call":
            continue
        policy = _kwarg(c, "policy")
        if isinstance(policy, ast.Call) and \
                _call_tail(policy) == "entry_only_policy":
            continue
        # a per-attempt timeout on a retried op is flagged regardless of
        # policy provenance — RetryPolicy(timeout=<truthy>) inline
        if isinstance(policy, ast.Call) and \
                _call_tail(policy) == "RetryPolicy":
            t = _kwarg(policy, "timeout")
            timed = not (t is None or (isinstance(t, ast.Constant)
                                       and not t.value))
        else:
            timed = False
        if not (timed or _mutating_context(ctx, c)):
            continue
        yield (c.lineno,
               "retry wrapper reachable by a mutating op without a "
               "syntactic entry_only_policy() — a mid-op transient here "
               "re-runs the mutation (or an abandoned timed-out attempt "
               "races it); prove the entry-seam rule or suppress with "
               "the proof")


# ----------------------------------------------------------------------
# R4 — broad excepts must not swallow coordination exceptions
# ----------------------------------------------------------------------
_BROAD = {"Exception", "BaseException"}


def _is_broad(handler):
    t = handler.type
    if t is None:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    return any(_dotted(n).rsplit(".", 1)[-1] in _BROAD for n in names)


@rule("R4", "no-swallowed-abort",
      "a broad except on the fault paths re-raises (or never catches) "
      "CoordinatedAbortError/PeerLostError/VotedOutError — a swallowed "
      "abort leaves this rank running while its peers stopped, forking "
      "the job",
      scope=("mxnet_tpu_torch/fault.py", "mxnet_tpu_torch/fault_dist.py",
             "mxnet_tpu_torch/fault_elastic.py", "mxnet_tpu_torch/kvstore/",
             "mxnet_tpu_torch/parallel/"))
def _check_r4(ctx):
    for node in ctx.nodes:
        if not isinstance(node, ast.ExceptHandler) or not _is_broad(node):
            continue
        if _contains_raise(node.body):
            continue
        yield (node.lineno,
               "broad except without a re-raise can swallow "
               "CoordinatedAbortError/PeerLostError/VotedOutError — "
               "narrow it, re-raise the coordination exceptions, or "
               "suppress with the reason they cannot reach here")


# ----------------------------------------------------------------------
# R5 — no host syncs inside CUDA-graph-captured code
# ----------------------------------------------------------------------
_CAPTURERS = {"capture_graph"}
_SYNC_TAILS = {"item", "tolist", "cpu", "numpy"}


def _capture_entries(ctx):
    """Call tails that capture a function they are handed:
    ``capture_graph`` and, one level up, any function or class of this
    file that passes one of its own parameters to it (``_Program(fn)``
    captures ``fn``)."""
    entries = set(_CAPTURERS)
    for c in ctx.calls:
        if _call_tail(c) not in _CAPTURERS:
            continue
        for f in ctx.enclosing_functions(c):
            params = {a.arg for a in f.args.args + f.args.kwonlyargs}
            if any(isinstance(a, ast.Name) and a.id in params
                   for a in c.args):
                owner = f.name
                if owner == "__init__":
                    cls = next((p for p in [ctx.parents.get(f)]
                                if isinstance(p, ast.ClassDef)), None)
                    if cls is None:
                        continue
                    owner = cls.name
                entries.add(owner)
    return entries


def _handed(expr):
    """The function names an argument hands over: ``f``,
    ``self.method``, ``functools.partial(f, ...)`` or a lambda's calls."""
    if isinstance(expr, ast.Name):
        return [expr.id]
    if isinstance(expr, ast.Attribute):
        return [expr.attr]
    if isinstance(expr, ast.Call) and _call_tail(expr) == "partial" \
            and expr.args:
        return _handed(expr.args[0])
    if isinstance(expr, ast.Lambda):
        return [n for c in _calls(expr.body) for n in _handed(c.func)]
    return []


def _captured_roots(ctx):
    """Function defs handed to a capture (:func:`_capture_entries`) and
    the bodies of ``with torch.cuda.graph(...)`` blocks."""
    by_name = {}
    for f in ctx.functions:
        by_name.setdefault(f.name, []).append(f)
    entries = _capture_entries(ctx)
    roots, blocks = [], []
    for c in ctx.calls:
        if _call_tail(c) not in entries:
            continue
        for a in list(c.args[:1]) + [k.value for k in c.keywords
                                     if k.arg == "fn"]:
            for name in _handed(a):
                roots.extend(by_name.get(name, ()))
    for node in ctx.nodes:
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(i.context_expr, ast.Call)
                and _dotted(i.context_expr.func).endswith("cuda.graph")
                for i in node.items):
            blocks.append(node)
            for c in _calls(node):
                for name in _handed(c.func):
                    roots.extend(by_name.get(name, ()))
    return _reach_defs(ctx, roots, by_name), blocks


@rule("R5", "pure-captured-step",
      "code captured into a CUDA graph (handed to cuda_ops.capture_graph "
      "or run under torch.cuda.graph, and what it reaches in the same "
      "file) contains no host sync (.item()/.tolist()/.cpu()/.numpy()/"
      "torch.cuda.synchronize/print/time/host random) — each makes the "
      "capture fail or bakes one host value into every replay",
      scope=("mxnet_tpu_torch/",),
      exclude=("mxnet_tpu_torch/analysis/",))
def _check_r5(ctx):
    onp = ctx.aliases.get("numpy", set())
    time_mods = ctx.aliases.get("time", set())
    rand_mods = ctx.aliases.get("random", set())

    def _from(mod_pred, name):
        mod, _ = ctx.from_imports.get(name, ("", ""))
        return mod_pred(mod)
    reported = set()
    funcs, blocks = _captured_roots(ctx)
    for f in funcs + blocks:
        for n in ast.walk(f):
            if not isinstance(n, ast.Call):
                continue
            key = None
            d = _dotted(n.func)
            tail = d.rsplit(".", 1)[-1]
            head = d.split(".", 1)[0]
            # .item()/.cpu() sync on ANY expression, not just plain
            # name chains (buf[0].item() counts too)
            attr = n.func.attr if isinstance(n.func, ast.Attribute) \
                else tail
            if attr in _SYNC_TAILS and not (head in onp and "." in d):
                key = (n.lineno, "host sync .%s() inside captured code "
                       "— the capture fails, or the value is read once "
                       "and replayed forever" % attr)
            elif d.endswith("cuda.synchronize"):
                key = (n.lineno, "torch.cuda.synchronize() inside "
                       "captured code — illegal during a capture")
            elif (head in time_mods and "." in d) or \
                    ("." not in d and _from(lambda m: m == "time", d)):
                key = (n.lineno, "%r inside captured code — runs at "
                       "capture time only, not per replay" % d)
            elif (head in rand_mods and "." in d) or \
                    (head in onp and ".random." in d + ".") or \
                    ("." not in d and _from(
                        lambda m: m in ("random", "numpy.random"), d)):
                key = (n.lineno, "host random draw %r inside captured "
                       "code — drawn once at capture, replayed forever"
                       % d)
            elif d == "print":
                key = (n.lineno, "print() inside captured code — fires "
                       "at capture time only")
            if key and key not in reported:
                reported.add(key)
                yield key


# ----------------------------------------------------------------------
# R6 — tier-1 tests are deterministic
# ----------------------------------------------------------------------
_RNG_NONDRAWS = {"seed", "RandomState", "Random", "default_rng",
                 "getstate", "setstate", "PRNGKey", "key"}


def _seed_lines(func):
    return [n.lineno for n in ast.walk(func)
            if isinstance(n, ast.Call) and _call_tail(n) == "seed"]


@rule("R6", "deterministic-tests",
      "tier-1 tests draw no unseeded randomness and no wall-clock "
      "entropy: module-scope draws run before the seeding fixture, and "
      "time.time() makes assertions flaky (conftest helpers run outside "
      "the fixture too)",
      scope=("tests/test_torch_", "tests/conftest.py"))
def _check_r6(ctx):
    is_conftest = os.path.basename(ctx.relpath) == "conftest.py"
    time_mods = ctx.aliases.get("time", set())
    for c in ctx.calls:
        d = _dotted(c.func)
        tail = d.rsplit(".", 1)[-1]
        head = d.split(".", 1)[0]
        fmod, forig = ctx.from_imports.get(d, ("", "")) if "." not in d \
            else ("", "")
        if (head in time_mods and tail in ("time", "time_ns")) or \
                (fmod == "time" and forig in ("time", "time_ns")):
            yield (c.lineno, "time.%s() in a tier-1 test — wall-clock "
                   "entropy makes it flaky; use time.monotonic() for "
                   "durations or a fixed stamp" % (forig or tail))
            continue
        if tail in _RNG_NONDRAWS:
            # unseeded RNG constructors are still nondeterministic
            if tail in ("RandomState", "Random", "default_rng") and \
                    not c.args and not c.keywords:
                yield (c.lineno, "unseeded %s() — every run draws a "
                       "different stream; pass a literal seed" % tail)
            continue
        is_global_rng = (".random." in d + "." and "." in d) or \
            head in ctx.aliases.get("random", set()) or \
            head in ctx.aliases.get("numpy.random", set()) or \
            (fmod == "random" or fmod.endswith(".random")) and \
            forig not in _RNG_NONDRAWS and bool(fmod)
        if not is_global_rng:
            continue
        encl = ctx.enclosing_functions(c)
        if not encl:
            yield (c.lineno, "module-scope draw from a global RNG runs "
                   "at collection time, before the seeding fixture — "
                   "use a seeded RandomState")
        elif is_conftest and not any(ln < c.lineno
                                     for ln in _seed_lines(encl[0])):
            # conftest helpers/fixtures run OUTSIDE the autouse seeding
            # fixture; test-file function bodies are exempt because
            # seed_and_fence seeds all RNGs before every test
            yield (c.lineno, "conftest draw from a global RNG with no "
                   "earlier seed() in this function — conftest code "
                   "runs outside the autouse seeding fixture")


# ----------------------------------------------------------------------
# R7 — no rank-divergent control flow guarding a collective launch
# ----------------------------------------------------------------------
#: names whose value differs per rank — branching on one of these with a
#: collective in only one arm is the classic SPMD deadlock
_RANK_NAMES = {"rank", "process_index", "process_id", "worker_id",
               "local_rank", "old_rank", "new_rank"}
#: call tails that launch (or are themselves) a cross-rank rendezvous
_R7_RENDEZVOUS = (_COLLECTIVES | _COMPAT_WRAPPERS
                  | {"coordinated_call", "allgather", "wait_at_barrier"})


def _rank_divergent_test(test):
    """True when an ``if`` test reads a per-rank value (``rank``,
    ``comm.rank``, ``jax.process_index()``, ...)."""
    for n in ast.walk(test):
        if isinstance(n, ast.Name) and n.id in _RANK_NAMES:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _RANK_NAMES:
            return True
        if isinstance(n, ast.Call) and \
                _call_tail(n) in ("process_index", "get_rank"):
            return True
    return False


def _rendezvous_calls(stmts):
    out = []
    for stmt in stmts:
        for c in _calls(stmt):
            if _call_tail(c) in _R7_RENDEZVOUS:
                out.append(c)
    return out


@rule("R7", "rank-divergent-collective",
      "no branch on a per-rank value (rank/process_index/...) may launch "
      "a collective in one arm and not the other — the arm that skips "
      "the launch parks its peers forever (the classic SPMD deadlock)",
      scope=("mxnet_tpu_torch/parallel/", "mxnet_tpu_torch/kvstore/",
             "mxnet_tpu_torch/fault_dist.py",
             "mxnet_tpu_torch/fault_elastic.py"))
def _check_r7(ctx):
    for node in ctx.nodes:
        if not isinstance(node, ast.If) or \
                not _rank_divergent_test(node.test):
            continue
        body_rv = _rendezvous_calls(node.body)
        else_rv = _rendezvous_calls(node.orelse)
        if bool(body_rv) == bool(else_rv):
            continue  # both arms launch, or neither — symmetric
        launch = (body_rv or else_rv)[0]
        yield (node.lineno,
               "branch on a per-rank value launches %r in only one arm "
               "— ranks taking the other arm never enter the "
               "rendezvous and the launching ranks park forever; hoist "
               "the collective out of the branch (or prove both arms "
               "rendezvous and suppress)" % _dotted(launch.func))


# ----------------------------------------------------------------------
# R8 — comm/board namespace discipline
# ----------------------------------------------------------------------
#: control-plane transports whose instances share a root/service
_COMM_CLASSES = {"FileComm", "CoordServiceComm", "FileBoard"}


def _r8_root_key(call, tail):
    if tail == "CoordServiceComm":
        return "<coordination service>"
    root = call.args[0] if call.args else _kwarg(call, "root")
    return ast.dump(root) if root is not None else "<unknown root>"


@rule("R8", "comm-namespace-discipline",
      "two comms/boards constructed over one root or coordination "
      "service carry distinct namespaces — implicit construction-order "
      "namespaces cross-consume rounds when any rank orders its "
      "constructions differently (a heartbeat comm and a kvstore comm "
      "once consumed each other's rounds so)",
      scope=("mxnet_tpu_torch/", "chip_smoke.py"),
      exclude=("mxnet_tpu_torch/analysis/",))
def _check_r8(ctx):
    groups = {}
    for c in ctx.calls:
        tail = _call_tail(c)
        if tail not in _COMM_CLASSES:
            continue
        groups.setdefault((tail, _r8_root_key(c, tail)), []).append(c)
    for (tail, root), sites in sorted(groups.items(),
                                      key=lambda kv: kv[0]):
        if len(sites) < 2:
            continue
        if tail == "FileBoard":
            # boards have no namespace parameter: a second board on the
            # same root IS the collision — point at every extra site
            for c in sites[1:]:
                yield (c.lineno,
                       "second FileBoard over the same root %s — two "
                       "logical boards on one directory cross-consume "
                       "each other's records; use distinct roots" % root)
            continue
        naked = [c for c in sites if _kwarg(c, "namespace") is None]
        for c in naked[1:]:
            yield (c.lineno,
                   "second %s over %s without an explicit namespace= — "
                   "the implicit per-process construction sequence only "
                   "lines up when EVERY rank constructs its comms in "
                   "the same order; one divergent rank cross-consumes "
                   "the other comm's vote rounds" % (tail, root))
        lits = {}
        for c in sites:
            ns = _kwarg(c, "namespace")
            if isinstance(ns, ast.Constant) and \
                    isinstance(ns.value, str):
                if ns.value in lits:
                    yield (c.lineno,
                           "duplicate literal namespace %r for %s over "
                           "%s (also line %d) — the two comms consume "
                           "each other's rounds"
                           % (ns.value, tail, root, lits[ns.value]))
                else:
                    lits[ns.value] = c.lineno


# ----------------------------------------------------------------------
# engine: suppressions, baseline, entry points
# ----------------------------------------------------------------------
_SUPPRESS_RE = re.compile(
    r"#\s*mxlint:\s*disable=([A-Za-z0-9_, ]+?)\s*(?:--\s*(\S.*))?$")


def _suppressions(text):
    """{line: (rule-id set, justified)} from REAL comment tokens — a
    ``# mxlint: disable=`` lookalike inside a string literal (e.g. a
    lint fixture) is not a suppression."""
    out = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, IndentationError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if m:
            ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
            out[tok.start[0]] = (ids, bool(m.group(2)))
    return out


def lint_source(text, relpath, rules=None):
    """All diagnostics for one file (after inline suppression, before
    any baseline).  ``relpath`` drives rule scoping, so fixture tests
    can place a snippet anywhere in the virtual tree."""
    relpath = relpath.replace(os.sep, "/")
    try:
        ctx = FileContext(text, relpath)
    except SyntaxError as e:
        return [Diagnostic("MX900", relpath, e.lineno or 1,
                           "syntax error: %s" % e.msg)]
    diags = []
    for r in RULES.values():
        if rules is not None and r.rule_id not in rules:
            continue
        if not r.applies(relpath):
            continue
        for line, msg in r.checker(ctx):
            diags.append(Diagnostic(r.rule_id, relpath, line, msg))
    sup = _suppressions(text)
    kept = []
    for d in diags:
        # a suppression covers its own line, or — walking upward through
        # a contiguous comment block — the statement right below it
        candidates = [d.line]
        ln = d.line - 1
        while 1 <= ln <= len(ctx.lines) and \
                ctx.lines[ln - 1].strip().startswith("#"):
            candidates.append(ln)
            ln -= 1
        if not any(d.rule_id in sup.get(c, ((), False))[0]
                   for c in candidates):
            kept.append(d)
    for ln, (ids, justified) in sorted(sup.items()):
        if not justified:
            kept.append(Diagnostic(
                "MX901", relpath, ln,
                "suppression without a justification — append "
                "'-- <one-line reason>'"))
    return sorted(kept, key=lambda d: (d.line, d.rule_id))


#: What a bare ``lint`` run scans, relative to the repo root; under
#: ``tests`` only the port's own test files (:data:`TEST_PREFIX`).
DEFAULT_TARGETS = ("mxnet_tpu_torch", "chip_smoke.py", "tests")
TEST_PREFIX = "test_torch_"
_SKIP_DIRS = {"__pycache__", "_native", ".git", "csrc"}


def _scanned(rel):
    """Under ``tests/`` only the port's test files are scanned."""
    if rel.startswith("tests/"):
        return os.path.basename(rel).startswith(TEST_PREFIX)
    return True


def lint_paths(root, targets=None, rules=None):
    """Lint every ``.py`` file under ``targets`` (repo-relative);
    returns diagnostics sorted by path/line."""
    diags = []
    for target in targets or DEFAULT_TARGETS:
        top = os.path.join(root, target)
        if os.path.isfile(top):
            files = [top]
        elif os.path.isdir(top):
            files = []
            for dirpath, dirnames, filenames in os.walk(top):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in _SKIP_DIRS)
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames)
                             if f.endswith(".py"))
        else:
            continue
        for path in files:
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            if not _scanned(rel):
                continue
            with open(path, encoding="utf-8") as f:
                diags.extend(lint_source(f.read(), rel, rules=rules))
    return sorted(diags, key=lambda d: (d.path, d.line, d.rule_id))


def load_baseline(path):
    """Parse ``rule path count -- justification`` lines into
    ``{(rule, path): (count, justification)}``.  Blank lines and ``#``
    comments are ignored; a malformed line raises (the baseline is an
    executable artifact, not prose)."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            head, sep, why = line.partition("--")
            parts = head.split()
            if len(parts) != 3 or not sep or not why.strip():
                raise ValueError(
                    "%s:%d malformed baseline line (want 'RULE path "
                    "count -- justification'): %r" % (path, i, line))
            out[(parts[0], parts[1])] = (int(parts[2]), why.strip())
    return out


def apply_baseline(diags, baseline):
    """Split diagnostics into (unbaselined, baselined, stale) where
    ``stale`` lists baseline entries whose count exceeds what the scan
    found — the ratchet: tighten them when the code improves."""
    by_key = {}
    for d in diags:
        by_key.setdefault((d.rule_id, d.path), []).append(d)
    unbaselined, baselined = [], []
    for key, group in sorted(by_key.items()):
        allowed = baseline.get(key, (0, ""))[0]
        baselined.extend(group[:allowed])
        unbaselined.extend(group[allowed:])
    stale = [(k, v[0], len(by_key.get(k, ())))
             for k, v in sorted(baseline.items())
             if len(by_key.get(k, ())) < v[0]]
    return unbaselined, baselined, stale
