"""mxrace level 1 for the PyTorch port: RacerD-style static lockset
analysis of the host control plane.

The port's host side runs threads of its own: the preemption poller
and the attempt threads of ``fault.py``, the step heartbeat of
``fault_dist.py``, the serving engine of ``serve.py`` and the router's
waiters in ``serve_router.py``, with counters, rings and sessions they
share under locks.  This module checks that discipline, whole-program
over the scanned tree (a race needs to see the thread spawned in
``fault_dist.py`` touch the counter dict living in ``profiler.py``):

1. **Thread roots**: functions reaching ``threading.Thread(target=…)``
   / ``threading.Timer``, ``signal.signal`` handlers and pool
   ``.submit`` sites, plus the **main root** (every function with no
   in-repo caller: the public entry points the main thread runs).  A
   root spawned in a loop/comprehension (or from two sites) is
   *multi-instance*: it races itself.
2. **Shared state**: module globals (data bindings, not defs/imports)
   and ``self.<attr>`` fields, resolved across modules through import
   aliases (absolute and relative).  Objects of known thread-safe types
   (``threading.Event``/``local``, queues, deques, loggers) and the
   locks themselves are exempt; ``__init__`` writes are
   pre-publication and exempt.
3. **Locksets**: the set of locks *definitely held* at each access:
   ``with lock:`` regions (``Condition`` counts: it embeds a lock),
   ``acquire()``/``release()`` pairs, the
   ``if not lock.acquire(blocking=False): return`` trylock idiom, all
   propagated interprocedurally along the same-repo call graph.

Rules (the Diagnostic/suppression/baseline vocabulary of :mod:`.lint`;
``python -m mxnet_tpu_torch.analysis race`` is the CLI and
``race_baseline.txt`` beside this file the ratchet):

- **R9 unguarded-cross-thread-access**: a field written from one root
  and touched from another with disjoint locksets.
- **R10 lock-order-inversion**: two locks acquired in opposite orders
  from different roots (the textbook ABBA deadlock).

Known limitations (deliberate): closure variables shared with a nested
thread target, class attributes mutated via ``Cls.attr``, and accesses
through unresolvable receivers (``obj.method()`` where ``obj`` is a
parameter) are not tracked; the dynamic half (:mod:`.racecheck`)
confirms findings and covers the object-granular cases.

``mxnet_tpu_torch/analysis/`` itself is excluded from the scan: the
model checker's scheduler deliberately runs many threads one at a time,
which is exactly the shape a lockset analysis must not reason about.

Like :mod:`.lint` this is stdlib-only and loadable by file path; the
sibling ``lint.py`` is loaded the same way when the package is not
importable.
"""
from __future__ import annotations

import ast
import os

# Diagnostic / suppression / baseline machinery comes from the sibling
# lint.py: package-relative normally, by file path when this module was
# itself loaded standalone (without importing the package or torch).
try:
    from . import lint as _lint
except ImportError:  # standalone file-path load
    import importlib.util as _ilu
    _spec = _ilu.spec_from_file_location(
        "mxrace_lint_core",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "lint.py"))
    _lint = _ilu.module_from_spec(_spec)
    _spec.loader.exec_module(_lint)

Diagnostic = _lint.Diagnostic
load_baseline = _lint.load_baseline
apply_baseline = _lint.apply_baseline

__all__ = [
    "Diagnostic", "RULES", "DEFAULT_TARGETS", "build_program",
    "scan_program", "scan_paths", "race_source", "strip_locks_source",
    "load_baseline", "apply_baseline",
]

#: What a bare ``race`` run scans.  tests/ spawn threads freely under
#: their own harnesses; the control plane lives here.
DEFAULT_TARGETS = ("mxnet_tpu_torch", "chip_smoke.py")
_SKIP_DIRS = {"__pycache__", "_native", ".git", "csrc"}
#: The model checker's one-thread-at-a-time scheduler is not a
#: concurrency bug surface — see the module docstring.
EXCLUDE_PREFIXES = ("mxnet_tpu_torch/analysis/",)

RULES = {
    "R9": _lint.Rule(
        "R9", "unguarded-cross-thread-access",
        "shared host state (module globals, self attributes) written "
        "from one thread root and touched from another carries a "
        "non-empty common lockset — a torn read-modify-write here is "
        "the torn-relay bug class",
        scope=("mxnet_tpu_torch/", "chip_smoke.py"), checker=None,
        exclude=EXCLUDE_PREFIXES),
    "R10": _lint.Rule(
        "R10", "lock-order-inversion",
        "no two locks are acquired in opposite orders from different "
        "thread roots — an ABBA interleaving deadlocks both threads "
        "with no timeout to save them",
        scope=("mxnet_tpu_torch/", "chip_smoke.py"), checker=None,
        exclude=EXCLUDE_PREFIXES),
}

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
_SAFE_FACTORIES = {"Event", "Semaphore", "BoundedSemaphore", "Barrier",
                   "local", "Queue", "SimpleQueue", "LifoQueue",
                   "PriorityQueue", "deque", "getLogger"}
#: method names that mutate their receiver in place
_MUTATORS = {"append", "extend", "insert", "remove", "pop", "popitem",
             "clear", "update", "setdefault", "add", "discard", "sort",
             "reverse", "appendleft", "popleft", "put", "set"}


def _modname(relpath):
    rp = relpath[:-3] if relpath.endswith(".py") else relpath
    name = rp.replace("/", ".")
    return name[:-9] if name.endswith(".__init__") else name


# ----------------------------------------------------------------------
# per-function summary
# ----------------------------------------------------------------------
class FuncInfo:
    __slots__ = ("node", "mod", "cls", "qual", "is_init", "nested",
                 "parent", "locals", "global_decls", "accesses",
                 "raw_calls", "acquires", "edges", "top_level")

    def __init__(self, node, mod, cls, qual, parent, top_level):
        self.node = node
        self.mod = mod
        self.cls = cls
        self.qual = qual
        self.parent = parent
        self.top_level = top_level
        self.is_init = cls is not None and node.name in ("__init__",
                                                         "__new__")
        self.nested = {}          # name -> FuncInfo (direct children)
        self.locals = set()       # params + assigned names (scope chain)
        self.global_decls = set()
        self.accesses = []        # (var, write, heldset, line)
        self.raw_calls = []       # (func-expr, heldset, line)
        self.acquires = []        # (lock_id, heldset-before, line)
        self.edges = []           # (FuncInfo, heldset, line)

    def lookup_nested(self, name):
        cur = self
        while cur is not None:
            if name in cur.nested:
                return cur.nested[name]
            cur = cur.parent
        return None

    def in_scope(self, name):
        cur = self
        while cur is not None:
            if name in cur.locals and name not in cur.global_decls:
                return True
            cur = cur.parent
        return False


class ModuleInfo:
    __slots__ = ("relpath", "name", "text", "tree", "parents", "funcs",
                 "top", "methods", "data_globals", "import_mods",
                 "from_names", "global_locks", "attr_locks",
                 "safe_globals", "safe_attrs", "module_calls",
                 "func_by_node")

    def __init__(self, relpath, name, text, tree):
        self.relpath = relpath
        self.name = name
        self.text = text
        self.tree = tree
        self.parents = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.funcs = {}       # qual -> FuncInfo
        self.top = {}         # module-level def name -> FuncInfo
        self.methods = {}     # (cls, name) -> FuncInfo
        self.data_globals = set()
        self.import_mods = {}   # bound name -> dotted module
        self.from_names = {}    # bound name -> (base module, orig name)
        self.global_locks = {}  # name -> lock id
        self.attr_locks = {}    # (cls, attr) -> lock id
        self.safe_globals = set()
        self.safe_attrs = set()
        self.module_calls = []   # module-level Call nodes
        self.func_by_node = {}   # id(def node) -> FuncInfo

    def ancestors(self, node):
        out = []
        cur = self.parents.get(node)
        while cur is not None:
            out.append(cur)
            cur = self.parents.get(cur)
        return out


def _scan_imports(mi):
    for node in ast.walk(mi.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    mi.import_mods[a.asname] = a.name
                else:
                    top = a.name.split(".")[0]
                    mi.import_mods[top] = top
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                parts = mi.name.split(".")
                parts = parts[:len(parts) - node.level] \
                    if node.level <= len(parts) else []
                base = ".".join(parts)
                if node.module:
                    base = base + "." + node.module if base \
                        else node.module
            for a in node.names:
                bound = a.asname or a.name
                mi.from_names[bound] = (base, a.name)
                # a from-import may bind a submodule — register it as a
                # module alias too; resolution against the program (or
                # threading/signal) decides which reading wins
                mi.import_mods.setdefault(
                    bound, (base + "." + a.name) if base else a.name)


def _is_threadlib(mi, head, libs=("threading",)):
    """Does dotted head name one of ``libs`` (via import alias)?"""
    return mi.import_mods.get(head) in libs


def _factory_tail(mi, call):
    d = _lint._dotted(call.func)
    if not d:
        return None
    if "." in d:
        head, _, tail = d.rpartition(".")
        if _is_threadlib(mi, head.split(".")[0],
                         ("threading", "queue", "collections",
                          "logging")):
            return tail
        return None
    base, orig = mi.from_names.get(d, ("", ""))
    if base in ("threading", "queue", "collections", "logging"):
        return orig
    return None


def _scan_module_bindings(mi):
    """Module-level data globals, lock/safe tables, self-attr locks."""
    for stmt in mi.tree.body:
        targets = []
        value = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        elif isinstance(stmt, ast.AugAssign):
            targets, value = [stmt.target], stmt.value
        for t in targets:
            names = [t] if isinstance(t, ast.Name) else \
                [e for e in getattr(t, "elts", [])
                 if isinstance(e, ast.Name)]
            for n in names:
                mi.data_globals.add(n.id)
                if isinstance(value, ast.Call):
                    tail = _factory_tail(mi, value)
                    if tail in _LOCK_FACTORIES:
                        mi.global_locks[n.id] = "%s.%s" % (mi.name, n.id)
                    elif tail in _SAFE_FACTORIES:
                        mi.safe_globals.add(n.id)
    # `global X` declarations make X module data even without a
    # module-level binding
    for node in ast.walk(mi.tree):
        if isinstance(node, ast.Global):
            mi.data_globals.update(node.names)
    # self.<attr> = threading.Lock()/Event()/... anywhere in a class
    for node in ast.walk(mi.tree):
        if not isinstance(node, ast.Assign) or \
                not isinstance(node.value, ast.Call):
            continue
        tail = _factory_tail(mi, node.value)
        if tail is None:
            continue
        for t in node.targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and \
                    t.value.id == "self":
                cls = next((a.name for a in mi.ancestors(node)
                            if isinstance(a, ast.ClassDef)), None)
                if cls is None:
                    continue
                if tail in _LOCK_FACTORIES:
                    mi.attr_locks[(cls, t.attr)] = \
                        "%s.%s.%s" % (mi.name, cls, t.attr)
                elif tail in _SAFE_FACTORIES:
                    mi.safe_attrs.add((cls, t.attr))


def _collect_funcs(mi):
    def visit(stmts, cls, prefix, parent, top_level):
        for stmt in stmts:
            if isinstance(stmt, ast.ClassDef):
                visit(stmt.body, stmt.name, stmt.name, None, top_level)
            elif isinstance(stmt, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                qual = "%s.%s" % (prefix, stmt.name) if prefix \
                    else stmt.name
                fi = FuncInfo(stmt, mi, cls, qual, parent, top_level)
                mi.func_by_node[id(stmt)] = fi
                args = stmt.args
                for a in (args.args + args.kwonlyargs + args.posonlyargs
                          + ([args.vararg] if args.vararg else [])
                          + ([args.kwarg] if args.kwarg else [])):
                    fi.locals.add(a.arg)
                mi.funcs[qual] = fi
                if top_level and cls is None:
                    mi.top[stmt.name] = fi
                if top_level and cls is not None:
                    mi.methods[(cls, stmt.name)] = fi
                if parent is not None:
                    parent.nested[stmt.name] = fi
                _scan_locals(fi)
                visit(stmt.body, cls, qual, fi, False)
            elif isinstance(stmt, (ast.If, ast.Try, ast.With,
                                   ast.AsyncWith, ast.For, ast.AsyncFor,
                                   ast.While)):
                for field in ("body", "orelse", "finalbody"):
                    visit(getattr(stmt, field, []) or [], cls, prefix,
                          parent, top_level)
                for h in getattr(stmt, "handlers", []):
                    visit(h.body, cls, prefix, parent, top_level)
    visit(mi.tree.body, None, "", None, True)


def _scan_locals(fi):
    """Names assigned in this function's own body (nested defs have
    their own scope and are skipped)."""
    def visit(stmts):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                fi.locals.add(stmt.name)
                continue
            for n in ast.walk(stmt):
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                    continue
                if isinstance(n, ast.Name) and \
                        isinstance(n.ctx, (ast.Store, ast.Del)):
                    fi.locals.add(n.id)
                elif isinstance(n, ast.Global):
                    fi.global_decls.update(n.names)
                elif isinstance(n, (ast.Import, ast.ImportFrom)):
                    for a in n.names:
                        fi.locals.add(a.asname
                                      or a.name.split(".")[0])
    visit(fi.node.body)


# ----------------------------------------------------------------------
# lockset-aware summary walk
# ----------------------------------------------------------------------
def _resolve_lock(expr, fi, mi, program):
    if isinstance(expr, ast.Name):
        if fi is not None and fi.in_scope(expr.id):
            return None
        return mi.global_locks.get(expr.id)
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name):
        if expr.value.id == "self" and fi is not None and \
                fi.cls is not None:
            return mi.attr_locks.get((fi.cls, expr.attr))
        m2 = program.modules_by_name.get(
            mi.import_mods.get(expr.value.id))
        if m2 is not None:
            return m2.global_locks.get(expr.attr)
    return None


def _trylock(stmt, fi, mi, program):
    """``if not X.acquire(...):`` with a terminating body — the trylock
    idiom: the fall-through path holds X."""
    if not isinstance(stmt, ast.If) or \
            not isinstance(stmt.test, ast.UnaryOp) or \
            not isinstance(stmt.test.op, ast.Not) or \
            not isinstance(stmt.test.operand, ast.Call):
        return None
    call = stmt.test.operand
    if not isinstance(call.func, ast.Attribute) or \
            call.func.attr != "acquire":
        return None
    if not stmt.body or not isinstance(stmt.body[-1],
                                       (ast.Return, ast.Raise,
                                        ast.Continue, ast.Break)):
        return None
    return _resolve_lock(call.func.value, fi, mi, program)


def _chain_root(expr):
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    return expr


class _Summarizer:
    def __init__(self, fi, mi, program):
        self.fi = fi
        self.mi = mi
        self.program = program

    def _lock_call(self, stmt, tail):
        """The lock id when ``stmt`` is a bare ``<lock>.<tail>()``
        expression statement, else None."""
        if isinstance(stmt, ast.Expr) and \
                isinstance(stmt.value, ast.Call) and \
                isinstance(stmt.value.func, ast.Attribute) and \
                stmt.value.func.attr == tail:
            return _resolve_lock(stmt.value.func.value, self.fi,
                                 self.mi, self.program)
        return None

    def run(self):
        self.walk(self.fi.node.body, frozenset())

    # -- variable classification --------------------------------------
    def _var_of(self, expr):
        """Shared-state identity of an l/r-value root, or None."""
        fi, mi = self.fi, self.mi
        if isinstance(expr, ast.Name):
            name = expr.id
            if fi.in_scope(name) and name not in fi.global_decls:
                return None
            if name not in mi.data_globals:
                return None
            if name in mi.global_locks or name in mi.safe_globals:
                return None
            return ("%s.%s" % (mi.name, name), mi.relpath)
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            base = expr.value.id
            if base == "self" and fi.cls is not None:
                if fi.is_init:
                    return None  # pre-publication construction
                key = (fi.cls, expr.attr)
                if key in mi.attr_locks or key in mi.safe_attrs:
                    return None
                return ("%s.%s.%s" % (mi.name, fi.cls, expr.attr),
                        mi.relpath)
            m2 = self.program.modules_by_name.get(
                mi.import_mods.get(base))
            if m2 is not None and expr.attr in m2.data_globals:
                if expr.attr in m2.global_locks or \
                        expr.attr in m2.safe_globals:
                    return None
                return ("%s.%s" % (m2.name, expr.attr), m2.relpath)
        return None

    def _access(self, var, write, held, line):
        self.fi.accesses.append((var[0], var[1], write, held, line))

    def visit_expr(self, node, held):
        for n in ast.walk(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # own scope, summarized separately
            if isinstance(n, ast.Call):
                self.fi.raw_calls.append((n, held, n.lineno))
                if isinstance(n.func, ast.Attribute) and \
                        n.func.attr in _MUTATORS:
                    var = self._var_of(_chain_root(n.func.value))
                    if var is not None:
                        self._access(var, True, held, n.lineno)
            elif isinstance(n, ast.Name):
                var = self._var_of(n)
                if var is not None:
                    self._access(var,
                                 isinstance(n.ctx, (ast.Store, ast.Del)),
                                 held, n.lineno)
            elif isinstance(n, ast.Attribute):
                var = self._var_of(n)
                if var is not None:
                    self._access(var,
                                 isinstance(n.ctx, (ast.Store, ast.Del)),
                                 held, n.lineno)
            elif isinstance(n, ast.Subscript) and \
                    isinstance(n.ctx, (ast.Store, ast.Del)):
                var = self._var_of(_chain_root(n.value))
                if var is not None:
                    self._access(var, True, held, n.lineno)

    # -- statements ----------------------------------------------------
    def walk(self, stmts, held):
        fi, mi, program = self.fi, self.mi, self.program
        pending = {}  # lock id -> line, from bare .acquire()
        for stmt in stmts:
            cur = held | frozenset(pending)
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                for d in stmt.decorator_list:
                    self.visit_expr(d, cur)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                added = []
                for item in stmt.items:
                    self.visit_expr(item.context_expr, cur)
                    lk = _resolve_lock(item.context_expr, fi, mi,
                                       program)
                    if lk is not None:
                        fi.acquires.append(
                            (lk, cur | frozenset(added), stmt.lineno))
                        added.append(lk)
                self.walk(stmt.body, cur | frozenset(added))
                continue
            if isinstance(stmt, ast.If):
                self.visit_expr(stmt.test, cur)
                lk = _trylock(stmt, fi, mi, program)
                self.walk(stmt.body, cur)
                self.walk(stmt.orelse, cur)
                if lk is not None:
                    fi.acquires.append((lk, cur, stmt.lineno))
                    pending[lk] = stmt.lineno
                continue
            if isinstance(stmt, ast.Try):
                self.walk(stmt.body, cur)
                for h in stmt.handlers:
                    if h.type is not None:
                        self.visit_expr(h.type, cur)
                    self.walk(h.body, cur)
                self.walk(stmt.orelse, cur)
                self.walk(stmt.finalbody, cur)
                # the canonical acquire();try:...finally:release() shape:
                # a release anywhere in this Try (almost always the
                # finally) ends the OUTER pending region — the nested
                # walks above used their own pending dict, so without
                # this the lock would be "held" for the rest of the
                # function and R9 would go silent on unguarded tails
                for sub in stmt.finalbody + stmt.body:
                    lk = self._lock_call(sub, "release")
                    if lk is not None:
                        pending.pop(lk, None)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self.visit_expr(stmt.target, cur)
                self.visit_expr(stmt.iter, cur)
                self.walk(stmt.body, cur)
                self.walk(stmt.orelse, cur)
                continue
            if isinstance(stmt, ast.While):
                self.visit_expr(stmt.test, cur)
                self.walk(stmt.body, cur)
                self.walk(stmt.orelse, cur)
                continue
            lk = self._lock_call(stmt, "acquire")
            if lk is not None:
                fi.acquires.append((lk, cur, stmt.lineno))
                pending[lk] = stmt.lineno
                continue
            lk = self._lock_call(stmt, "release")
            if lk is not None:
                pending.pop(lk, None)
                continue
            self.visit_expr(stmt, cur)


# ----------------------------------------------------------------------
# program model, call resolution, roots
# ----------------------------------------------------------------------
class Root:
    __slots__ = ("kind", "key", "entries", "sites", "multi")

    def __init__(self, kind, key, entries, sites=(), multi=False):
        self.kind = kind      # "main" | "thread" | "signal" | "pool"
        self.key = key
        self.entries = list(entries)
        self.sites = list(sites)
        self.multi = multi

    def label(self):
        if self.kind == "main":
            return "the main thread (public entry points)"
        site = "%s:%d" % self.sites[0] if self.sites else "?"
        extra = " (multi-instance)" if self.multi else ""
        return "the %s root %s spawned at %s%s" % (
            self.kind, self.key, site, extra)


class Program:
    def __init__(self):
        self.modules = {}          # relpath -> ModuleInfo
        self.modules_by_name = {}  # dotted name -> ModuleInfo
        self.errors = []           # Diagnostic MX900
        self.roots = []
        self.main_root = None

    def func(self, modname, qual):
        mi = self.modules_by_name.get(modname)
        return mi.funcs.get(qual) if mi is not None else None


def _resolve_callable(expr, fi, mi, program):
    """FuncInfo a call/target expression lands in, or None."""
    if isinstance(expr, ast.Name):
        name = expr.id
        if fi is not None:
            nested = fi.lookup_nested(name)
            if nested is not None:
                return nested
            if fi.cls is not None and (fi.cls, name) in mi.methods \
                    and not fi.in_scope(name) and name not in mi.top:
                pass  # methods are not visible bare — fall through
        if name in mi.top:
            return mi.top[name]
        base, orig = mi.from_names.get(name, ("", ""))
        m2 = program.modules_by_name.get(base)
        if m2 is not None:
            got = m2.top.get(orig)
            if got is not None:
                return got
            init = m2.methods.get((orig, "__init__"))
            if init is not None:
                return init
        # same-module class constructor
        init = mi.methods.get((name, "__init__"))
        if init is not None and (fi is None or not fi.in_scope(name)):
            return init
        return None
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name):
        base, attr = expr.value.id, expr.attr
        if base == "self" and fi is not None and fi.cls is not None:
            got = mi.methods.get((fi.cls, attr))
            if got is not None:
                return got
            return None
        m2 = program.modules_by_name.get(mi.import_mods.get(base))
        if m2 is not None:
            got = m2.top.get(attr)
            if got is not None:
                return got
            return m2.methods.get((attr, "__init__"))
    return None


def _spawn_target(call, mi):
    """(kind, target-expr) when ``call`` starts a new execution root."""
    d = _lint._dotted(call.func)
    tail = d.rsplit(".", 1)[-1] if d else ""
    head = d.split(".", 1)[0] if "." in d else ""
    if tail == "Thread" and (
            _is_threadlib(mi, head) or
            mi.from_names.get(d, ("",))[0] == "threading"):
        return "thread", _lint._kwarg(call, "target")
    if tail == "Timer" and (
            _is_threadlib(mi, head) or
            mi.from_names.get(d, ("",))[0] == "threading"):
        tgt = call.args[1] if len(call.args) > 1 \
            else _lint._kwarg(call, "function")
        return "thread", tgt
    if tail == "signal" and _is_threadlib(mi, head, ("signal",)):
        return "signal", call.args[1] if len(call.args) > 1 else None
    if tail == "submit" and isinstance(call.func, ast.Attribute):
        return "pool", call.args[0] if call.args else None
    return None, None


def _enclosing_func(mi, node):
    for a in mi.ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return mi.func_by_node.get(id(a))
    return None


def _in_loop(mi, node, fi):
    stop = fi.node if fi is not None else None
    for a in mi.ancestors(node):
        if a is stop:
            return False
        if isinstance(a, (ast.For, ast.AsyncFor, ast.While,
                          ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            return True
    return False


def build_program(root, targets=None, override=None):
    """Parse the scan set into a :class:`Program` with per-function
    lockset summaries, resolved call edges, and execution roots.
    ``override`` maps relpath -> replacement source (virtual files are
    allowed) — the seeded-mutation liveness proof rescans the repo with
    one file's locks stripped."""
    program = Program()
    override = dict(override or {})
    files = {}
    for target in targets or DEFAULT_TARGETS:
        top = os.path.join(root, target)
        if os.path.isfile(top):
            found = [top]
        elif os.path.isdir(top):
            found = []
            for dirpath, dirnames, filenames in os.walk(top):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in _SKIP_DIRS)
                found.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames)
                             if f.endswith(".py"))
        else:
            continue
        for path in found:
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            if any(rel.startswith(p) for p in EXCLUDE_PREFIXES):
                continue
            files[rel] = path
    texts = {}
    for rel, path in sorted(files.items()):
        if rel in override:
            texts[rel] = override.pop(rel)
        else:
            with open(path, encoding="utf-8") as f:
                texts[rel] = f.read()
    for rel, text in sorted(override.items()):  # purely virtual files
        if not any(rel.startswith(p) for p in EXCLUDE_PREFIXES):
            texts[rel] = text
    for rel, text in sorted(texts.items()):
        _add_module(program, rel, text)
    _finalize_program(program)
    return program


def _add_module(program, rel, text):
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        program.errors.append(Diagnostic(
            "MX900", rel, e.lineno or 1, "syntax error: %s" % e.msg))
        return None
    mi = ModuleInfo(rel, _modname(rel), text, tree)
    _scan_imports(mi)
    _scan_module_bindings(mi)
    _collect_funcs(mi)
    program.modules[rel] = mi
    program.modules_by_name[mi.name] = mi
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                _enclosing_func(mi, node) is None:
            mi.module_calls.append(node)
    return mi


def _finalize_program(program):
    """Summaries, then edges/roots (needs every module's tables)."""
    for mi in program.modules.values():
        for fi in mi.funcs.values():
            _Summarizer(fi, mi, program).run()
    has_in_edge = set()
    spawn_targets = set()
    spawns = {}
    for mi in program.modules.values():
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call):
                continue
            kind, tgt = _spawn_target(node, mi)
            if kind is None or tgt is None:
                continue
            fi = _enclosing_func(mi, node)
            callee = _resolve_callable(tgt, fi, mi, program)
            if callee is None:
                continue
            spawn_targets.add(id(callee))
            key = (kind, "%s:%s" % (callee.mod.name, callee.qual))
            site = (mi.relpath, node.lineno)
            multi = _in_loop(mi, node, fi)
            if key in spawns:
                spawns[key].sites.append(site)
                spawns[key].multi = True
            else:
                spawns[key] = Root(kind, key[1], [callee], [site], multi)
        for fi in mi.funcs.values():
            for call, held, line in fi.raw_calls:
                callee = _resolve_callable(call.func, fi, mi, program)
                if callee is not None:
                    fi.edges.append((callee, held, line))
                    has_in_edge.add(id(callee))
        for call in mi.module_calls:
            callee = _resolve_callable(call.func, None, mi, program)
            if callee is not None:
                has_in_edge.add(id(callee))
    program.roots = [spawns[k] for k in sorted(spawns)]
    main_entries = []
    for mi in program.modules.values():
        for fi in mi.funcs.values():
            if not fi.top_level:
                continue
            if id(fi) in has_in_edge or id(fi) in spawn_targets:
                continue
            main_entries.append(fi)
    program.main_root = Root("main", "main", main_entries)
    return program


# ----------------------------------------------------------------------
# the analysis proper
# ----------------------------------------------------------------------
def _collect_root(root):
    """(observations, acquire-pairs) for one root: DFS over call edges
    propagating the held lockset into callees."""
    obs = []    # (var, write, lockset, relpath, line)
    pairs = []  # (held-lock, acquired-lock, relpath, line)
    seen = set()
    stack = [(e, frozenset()) for e in root.entries]
    while stack:
        fi, ctx = stack.pop()
        key = (id(fi), ctx)
        if key in seen:
            continue
        seen.add(key)
        for var, relpath, write, held, line in fi.accesses:
            obs.append((var, write, ctx | held, relpath, line))
        for lock, held, line in fi.acquires:
            for h in sorted(ctx | held):
                if h != lock:
                    pairs.append((h, lock, fi.mod.relpath, line))
        for callee, held, line in fi.edges:
            stack.append((callee, ctx | held))
    return obs, pairs


def _fmt_locks(locks):
    return "{%s}" % ", ".join(sorted(locks)) if locks else "no lock"


def _check_r9(per_root):
    """per_root: {root: (obs, pairs)} -> diagnostics."""
    by_var = {}
    for root, (obs, _) in per_root.items():
        for var, write, locks, relpath, line in obs:
            by_var.setdefault(var, []).append(
                (root, write, locks, relpath, line))
    diags = []
    for var in sorted(by_var):
        lst = by_var[var]
        hit = None
        for w in lst:
            if not w[1]:
                continue
            for o in lst:
                # two observations from ONE root only conflict when the
                # root is multi-instance (several live threads run it)
                if o[0] is w[0] and not w[0].multi:
                    continue
                if w[2] & o[2]:
                    continue
                cand = (w, o)
                if hit is None or (cand[0][3], cand[0][4]) < \
                        (hit[0][3], hit[0][4]):
                    hit = cand
        if hit is None:
            continue
        w, o = hit
        what = "writes" if o[1] else "reads"
        if o[0] is w[0]:
            across = "another instance of the same root %s" \
                % o[0].label()
        else:
            across = o[0].label()
        diags.append(Diagnostic(
            "R9", w[3], w[4],
            "shared state %s written by %s at %s:%d holding %s while "
            "%s %s it at %s:%d holding %s — no common lock orders the "
            "accesses; guard both sides with one lock (or prove the "
            "race benign and suppress with the proof)"
            % (var, w[0].label(), w[3], w[4], _fmt_locks(w[2]),
               across, what, o[3], o[4], _fmt_locks(o[2]))))
    return diags


def _check_r10(per_root):
    pair_map = {}
    for root, (_, pairs) in per_root.items():
        for a, b, relpath, line in pairs:
            pair_map.setdefault((a, b), []).append((root, relpath, line))
    diags = []
    for (a, b) in sorted(pair_map):
        if (b, a) not in pair_map or a >= b:
            continue
        fwd, rev = pair_map[(a, b)], pair_map[(b, a)]
        root_keys = {r.key for r, _, _ in fwd} | \
            {r.key for r, _, _ in rev}
        multi = any(r.multi for r, _, _ in fwd + rev)
        if len(root_keys) < 2 and not multi:
            continue  # one single-instance thread cannot self-deadlock
        froot, fpath, fline = min(fwd, key=lambda t: (t[1], t[2]))
        rroot, rpath, rline = min(rev, key=lambda t: (t[1], t[2]))
        diags.append(Diagnostic(
            "R10", fpath, fline,
            "lock order inversion: %s is taken before %s here (by %s) "
            "but %s:%d (by %s) takes them in the opposite order — an "
            "ABBA interleaving deadlocks both with no timeout; pick "
            "one global order"
            % (a, b, froot.label(), rpath, rline, rroot.label())))
    return diags


def scan_program(program, rules=None):
    per_root = {}
    for root in program.roots + [program.main_root]:
        per_root[root] = _collect_root(root)
    diags = list(program.errors)
    if rules is None or "R9" in rules:
        diags.extend(_check_r9(per_root))
    if rules is None or "R10" in rules:
        diags.extend(_check_r10(per_root))
    kept = []
    for d in diags:
        r = RULES.get(d.rule_id)
        if r is not None and not r.applies(d.path):
            continue
        kept.append(d)
    # inline suppressions + MX901 for unjustified race-rule disables
    out = []
    sups = {rel: _lint._suppressions(mi.text)
            for rel, mi in program.modules.items()}
    lines = {rel: mi.text.splitlines()
             for rel, mi in program.modules.items()}
    for d in kept:
        sup = sups.get(d.path, {})
        src = lines.get(d.path, [])
        candidates = [d.line]
        ln = d.line - 1
        while 1 <= ln <= len(src) and \
                src[ln - 1].strip().startswith("#"):
            candidates.append(ln)
            ln -= 1
        if not any(d.rule_id in sup.get(c, ((), False))[0]
                   for c in candidates):
            out.append(d)
    for rel, sup in sorted(sups.items()):
        for ln, (ids, justified) in sorted(sup.items()):
            if not justified and ids & set(RULES):
                out.append(Diagnostic(
                    "MX901", rel, ln,
                    "race-rule suppression without a justification — "
                    "append '-- <one-line reason>'"))
    return sorted(out, key=lambda d: (d.path, d.line, d.rule_id))


def scan_paths(root, targets=None, rules=None, override=None):
    """The whole pipeline: parse, summarize, analyze; diagnostics
    sorted by path/line (inline suppressions applied; the baseline is
    the CLI's business, via :func:`apply_baseline`)."""
    return scan_program(build_program(root, targets=targets,
                                      override=override), rules=rules)


def race_source(text, relpath, rules=None):
    """Single-file scan for fixture tests, mirroring
    ``lint.lint_source``: the virtual ``relpath`` drives rule scoping."""
    relpath = relpath.replace(os.sep, "/")
    program = Program()
    if _add_module(program, relpath, text) is None:
        return list(program.errors)
    _finalize_program(program)
    return scan_program(program, rules=rules)


# ----------------------------------------------------------------------
# seeded-mutation support: strip lock regions from real source
# ----------------------------------------------------------------------
class _LockStripper(ast.NodeTransformer):
    def __init__(self, names):
        self.names = set(names)
        self.changed = False

    def _hits(self, expr):
        d = _lint._dotted(expr)
        return bool(d) and d.rsplit(".", 1)[-1] in self.names

    def visit_With(self, node):
        self.generic_visit(node)
        keep = [i for i in node.items if not self._hits(i.context_expr)]
        if len(keep) == len(node.items):
            return node
        self.changed = True
        if keep:
            node.items = keep
            return node
        return node.body

    visit_AsyncWith = visit_With

    def visit_Expr(self, node):
        v = node.value
        if isinstance(v, ast.Call) and \
                isinstance(v.func, ast.Attribute) and \
                v.func.attr in ("acquire", "release") and \
                self._hits(v.func.value):
            self.changed = True
            return None
        return node


def strip_locks_source(text, lock_names):
    """Source with every ``with <lock>:`` region (and bare
    acquire/release pair) on the named locks removed — the deliberately
    reintroduced bug the liveness proof rescans for.  Raises when
    nothing matched: a proof that stripped nothing is vacuous."""
    tree = ast.parse(text)
    stripper = _LockStripper(lock_names)
    new = stripper.visit(tree)
    if not stripper.changed:
        raise ValueError(
            "strip_locks_source: no lock region named %s found — the "
            "liveness proof would be vacuous" % sorted(lock_names))
    ast.fix_missing_locations(new)
    return ast.unparse(new)
