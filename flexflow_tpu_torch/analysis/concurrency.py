"""Whole-program lock-discipline analysis (FF150-FF154), the port of
``flexflow_tpu/analysis/concurrency.py``.

The serving stack is hand-threaded (the fleet dispatcher, tenant
loaders, decode loops, the metrics HTTP server, the flight taps), so the
locks get what the strategies get: a static analysis that predicts what
the runtime does, held against the runtime in the tests.

* **guard inference**: each class's field-to-guard mapping is inferred
  from majority use (a field written outside ``__init__`` whose accesses
  overwhelmingly hold one lock is treated as guarded by it), then
  checked against the ``# guarded_by:`` annotations;
* **lock-order graph**: every ``with lock:`` scope, chased through a
  best-effort call graph (self-calls, attribute types from ``self.x =
  Class(...)`` assignments and parameter/return annotations, a name
  fallback for calls the types cannot pin), yields nested-acquisition
  edges; a cycle is a potential ABBA deadlock;
* **dynamic twin**: :mod:`flexflow_tpu_torch.obs.lockwatch` records the
  same graph at runtime (``FF_LOCKWATCH=1``); the tests hold the runtime
  edges to a subset of the static ones.

Diagnostics (the JAX package's codes):

=======  ======  ====================================================
FF150    ERROR   shared field accessed outside inferred/declared guard
FF151    ERROR   lock-order inversion (cycle in the static graph)
FF152    WARN    blocking call while holding a lock
FF153    WARN    cv.wait without predicate loop / without its lock
FF154    ERROR   annotation drift (annotation vs inferred guard)
=======  ======  ====================================================

Waivers (same-line comments, or the comment block just above the site):
``# unguarded-ok: <why>`` waives FF150/FF154 at an access or
declaration site; ``# lock-ok: <why>`` waives FF152/FF153 at a call
site.  Every waiver states its safety argument.

Contracts: ``# may-acquire: <lock-id>`` anywhere inside a function
declares a lock it can take through a path the walk cannot resolve
(stored callbacks such as fflogger taps), so call sites holding locks
still get the static edge the runtime will observe.

The blocking calls of FF152 are the JAX package's, with its device
fetch and sync (``device_get``, ``block_until_ready``) in the port's
idiom: ``synchronize`` (``torch.cuda.synchronize``,
``Stream.synchronize``, ``Event.synchronize``) and ``cpu``, the
device-to-host copy the engines fetch a step's results with (on a CUDA
tensor ``.cpu()`` waits for the stream).  ``.item()`` and ``.tolist()``
also wait for the device, but the engines call them on host tensors by
the hundred, so they stay out: a name-based rule cannot tell the two
apart.

Scope notes (documented over-approximations):

* self-edges (a lock re-acquired under itself) are excluded from FF151:
  name-fallback call resolution over-approximates, and a genuine
  self-deadlock on a non-reentrant lock is a different bug class the
  dynamic twin catches at once;
* the name fallback resolves ``x.meth()`` with unknown ``x`` to every
  lock-acquiring method named ``meth``, keeping the static graph a
  superset of anything the runtime can observe (the direction the
  subset check needs) at the cost of spurious edges;
* closures and lambdas are analyzed with an empty held set (they run
  later, on an unknown thread) and their acquisitions still feed the
  graph through the call-site fallback.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .diagnostics import DiagnosticReport, make

_GUARDED_RE = re.compile(r"#\s*guarded_by:\s*([\w.]+)")
_UNGUARDED_RE = re.compile(r"#\s*unguarded-ok\b")
_LOCK_OK_RE = re.compile(r"#\s*lock-ok\b")
# declares a lock a function may take through a path the analyzer
# cannot resolve (stored callbacks: fflogger taps, tracer sinks) —
# folded into the function's acquired set so callers holding locks at
# the call site get the static edge the runtime will observe
_MAY_ACQUIRE_RE = re.compile(r"#\s*may-acquire:\s*([\w.]+)")

# constructor call leaf names that create a lock-like object (raw
# threading or the lockwatch factory — adoption must not blind the pass)
_LOCK_CTORS = {"Lock": "Lock", "RLock": "RLock", "Condition": "Condition",
               "lock": "Lock", "rlock": "RLock", "condition": "Condition"}

# attribute leaf names whose call blocks the calling thread (FF152).
# ``wait`` on a held condition is the CV protocol, judged by FF153.
_BLOCKING_LEAVES = {
    "join": "thread/process join",
    "result": "Future.result",
    "sleep": "sleep",
    "_sleep": "injected sleep",
    "wait": "wait",
    "synchronize": "device sync",
    "cpu": "device fetch",
}

# inference thresholds: a field qualifies for guard inference when it is
# written outside __init__, has at least _MIN_ACCESSES sites, and one
# lock covers at least _MAJORITY of them
_MIN_ACCESSES = 4
_MAJORITY = 0.75


def _leaf(func: ast.expr) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


class _FuncInfo:
    """Per-function summary: direct acquisitions, calls with the locks
    held at the call site, field accesses, blocking calls, cv.waits."""

    def __init__(self, node: ast.AST, cls: Optional[str], module: str,
                 name: str):
        self.node = node
        self.cls = cls
        self.module = module            # module relpath
        self.name = name
        self.qual = f"{cls}.{name}" if cls else name
        self.decl_entry: Set[str] = set()   # def-line guarded_by (ids)
        self.decl_raw: Set[str] = set()     # raw annotation text
        self.acquired: Set[str] = set()     # locks taken via `with`
        # (tuple(targets), frozenset(held), line)
        self.calls: List[Tuple] = []
        # (def_cls|None, field, frozenset(held), line, is_write, waived)
        self.accesses: List[Tuple] = []
        # (desc, frozenset(held), line, waived)
        self.blocking: List[Tuple] = []
        # (cond_lockid, frozenset(held), in_loop, line, waived)
        self.cv_waits: List[Tuple] = []
        self.return_type: Optional[str] = None
        self.is_property = False
        self.escapes = False  # referenced as a value (callback/target)
        self.entry: Set[str] = set()  # inferred caller-holds locks
        self.trans_acquired: Set[str] = set()
        # `# may-acquire: <lock-id>` contracts anywhere in the body
        # (callback fan-outs the walk cannot resolve); pass-1 data,
        # survives reset()
        self.may_acquire: Set[str] = set()

    def reset(self) -> None:
        self.acquired = set()
        self.calls = []
        self.accesses = []
        self.blocking = []
        self.cv_waits = []
        self.trans_acquired = set()


class _ClassInfo:
    def __init__(self, name: str, module: str, bases: List[str]):
        self.name = name
        self.module = module
        self.bases = bases
        self.methods: Dict[str, _FuncInfo] = {}
        self.properties: Set[str] = set()
        self.fields: Set[str] = set()
        self.lock_attrs: Dict[str, str] = {}   # attr -> kind
        self.lock_ctor_attrs: Set[str] = set()  # ctor-assigned here
        # field -> (raw guard text, decl line, waived)
        self.field_guard_decl: Dict[str, Tuple[str, int, bool]] = {}
        self.attr_types: Dict[str, str] = {}   # attr -> class name


class _ModuleInfo:
    def __init__(self, relpath: str, lines: List[str]):
        self.relpath = relpath
        self.base = os.path.splitext(os.path.basename(relpath))[0]
        self.lines = lines
        self.classes: Dict[str, _ClassInfo] = {}
        self.functions: Dict[str, _FuncInfo] = {}
        self.locks: Dict[str, str] = {}        # global name -> kind
        # global name -> (raw guard text, line)
        self.global_guards: Dict[str, Tuple[str, int]] = {}
        self.imports: Set[str] = set()         # `from X import name`s


class Analysis:
    """The program model + findings.  ``edges`` is the static
    lock-order graph the lockwatch subset pin compares against."""

    def __init__(self) -> None:
        self.modules: Dict[str, _ModuleInfo] = {}
        self.classes: Dict[str, _ClassInfo] = {}
        self.report = DiagnosticReport()
        self.edges: Set[Tuple[str, str]] = set()
        self.locks: Dict[str, str] = {}        # lock id -> kind
        self.closures: List[_FuncInfo] = []
        self.method_fallback: Dict[str, List[_FuncInfo]] = {}
        self.property_fallback: Dict[str, List[_FuncInfo]] = {}

    # ---- identity ------------------------------------------------------
    def _mro(self, cls: str) -> Iterator[_ClassInfo]:
        seen: Set[str] = set()
        stack = [cls]
        while stack:
            c = stack.pop(0)
            if c in seen or c not in self.classes:
                continue
            seen.add(c)
            ci = self.classes[c]
            yield ci
            stack.extend(ci.bases)

    def defining_class(self, cls: str, attr: str) -> Optional[str]:
        """The class in ``cls``'s (name-based) MRO that defines field or
        lock ``attr`` — lock/field ids name the DEFINING class, so a
        subclass (GenerationMetrics) shares its base's identity."""
        for ci in self._mro(cls):
            if attr in ci.lock_attrs or attr in ci.fields:
                return ci.name
        return None

    def lock_id_for_attr(self, cls: str, attr: str) -> Optional[str]:
        for ci in self._mro(cls):
            if attr in ci.lock_attrs:
                return f"{ci.name}.{attr}"
        return None

    def resolve_method(self, cls: str, name: str) -> Optional[_FuncInfo]:
        for ci in self._mro(cls):
            if name in ci.methods:
                return ci.methods[name]
        return None

    def attr_type(self, cls: str, attr: str) -> Optional[str]:
        for ci in self._mro(cls):
            if attr in ci.attr_types:
                return ci.attr_types[attr]
        return None

    def all_funcs(self) -> Iterator[_FuncInfo]:
        for mi in self.modules.values():
            for ci in mi.classes.values():
                yield from ci.methods.values()
            yield from mi.functions.values()
        yield from self.closures


# ---------------------------------------------------------------------------
# pass 1: collection (classes, fields, locks, annotations, types)
# ---------------------------------------------------------------------------

def _line_has(lines: List[str], node: ast.AST, pat: re.Pattern) -> bool:
    cand = {getattr(node, "lineno", 0),
            getattr(node, "end_lineno", 0) or 0}
    # a waiver may also sit in the contiguous comment block directly
    # above the site (long call lines leave no room inline)
    above = getattr(node, "lineno", 0) - 1
    while 0 < above <= len(lines) \
            and lines[above - 1].lstrip().startswith("#"):
        cand.add(above)
        above -= 1
    for ln in cand:
        if 0 < ln <= len(lines) and pat.search(lines[ln - 1]):
            return True
    return False


def _span_may_acquire(lines: List[str], node: ast.AST) -> Set[str]:
    """Every ``# may-acquire: <lock-id>`` contract inside the
    function's line span."""
    out: Set[str] = set()
    lo = getattr(node, "lineno", 0)
    hi = getattr(node, "end_lineno", 0) or lo
    for ln in range(lo, min(hi, len(lines)) + 1):
        m = _MAY_ACQUIRE_RE.search(lines[ln - 1])
        if m:
            out.add(m.group(1))
    return out


def _guard_text(lines: List[str], node: ast.AST) -> Optional[str]:
    for ln in {getattr(node, "lineno", 0),
               getattr(node, "end_lineno", 0) or 0}:
        if 0 < ln <= len(lines):
            m = _GUARDED_RE.search(lines[ln - 1])
            if m:
                return m.group(1)
    return None


def _def_guard_text(lines: List[str], node: ast.AST) -> Optional[str]:
    """Caller-holds contract on a def SIGNATURE (``def f():  #
    guarded_by: self._cv``) — scans only the signature lines, never the
    body (whose last line is the node's end_lineno)."""
    body = getattr(node, "body", None)
    stop = body[0].lineno - 1 if body else node.lineno
    for ln in range(node.lineno, max(node.lineno, stop) + 1):
        if 0 < ln <= len(lines):
            m = _GUARDED_RE.search(lines[ln - 1])
            if m:
                return m.group(1)
    return None


def _ret_annotation(node: ast.AST) -> Optional[str]:
    ret = getattr(node, "returns", None)
    if isinstance(ret, ast.Name):
        return ret.id
    if isinstance(ret, ast.Constant) and isinstance(ret.value, str):
        return ret.value.strip('"\'')
    return None


def _param_annotation(fn: ast.AST, param: str) -> Optional[str]:
    args = getattr(fn, "args", None)
    if args is None:
        return None
    for a in list(args.args) + list(args.kwonlyargs):
        if a.arg == param and a.annotation is not None:
            ann = a.annotation
            if isinstance(ann, ast.Name):
                return ann.id
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                return ann.value.strip('"\'')
    return None


def _collect_module(mi: _ModuleInfo, tree: ast.AST) -> None:
    # imports at ANY depth, not just module scope: lazy function-local
    # imports (obs/flight.py's `from .trace import get_tracer` under
    # _flight_lock) must resolve calls the same way, or the walk goes
    # blind exactly where import cycles forced laziness — which is
    # where locks nest across modules
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                mi.imports.add(alias.asname or alias.name)
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            pass  # handled above
        elif isinstance(node, ast.ClassDef):
            _collect_class(mi, node)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fi = _FuncInfo(node, None, mi.relpath, node.name)
            fi.return_type = _ret_annotation(node)
            g = _def_guard_text(mi.lines, node)
            if g:
                fi.decl_raw.add(g)
            fi.may_acquire = _span_may_acquire(mi.lines, node)
            mi.functions[node.name] = fi
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            val = node.value
            kind = (_LOCK_CTORS.get(_leaf(val.func))
                    if isinstance(val, ast.Call) else None)
            g = _guard_text(mi.lines, node)
            for t in targets:
                if isinstance(t, ast.Name):
                    if kind:
                        mi.locks[t.id] = kind
                    elif g:
                        mi.global_guards[t.id] = (g, node.lineno)


def _collect_class(mi: _ModuleInfo, node: ast.ClassDef) -> None:
    ci = _ClassInfo(node.name, mi.relpath,
                    [b.id for b in node.bases if isinstance(b, ast.Name)])
    mi.classes[node.name] = ci
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fi = _FuncInfo(item, ci.name, mi.relpath, item.name)
            fi.return_type = _ret_annotation(item)
            for dec in item.decorator_list:
                if _leaf(dec) == "property":
                    fi.is_property = True
                    ci.properties.add(item.name)
            g = _def_guard_text(mi.lines, item)
            if g:
                fi.decl_raw.add(g)
            fi.may_acquire = _span_may_acquire(mi.lines, item)
            ci.methods[item.name] = fi
        elif isinstance(item, (ast.Assign, ast.AnnAssign)):
            targets = (item.targets if isinstance(item, ast.Assign)
                       else [item.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    ci.fields.add(t.id)
                    g = _guard_text(mi.lines, item)
                    if g:
                        ci.field_guard_decl.setdefault(t.id, (
                            g, item.lineno,
                            _line_has(mi.lines, item, _UNGUARDED_RE)))
    for fi in ci.methods.values():
        _scan_method_decls(mi, ci, fi)


def _scan_method_decls(mi: _ModuleInfo, ci: _ClassInfo,
                       fi: _FuncInfo) -> None:
    """Field set, lock attrs, guard annotations, attribute types from
    one method body (order-independent; assignments win over `with`)."""
    for sub in ast.walk(fi.node):
        if isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (sub.targets if isinstance(sub, ast.Assign)
                       else [sub.target])
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                ci.fields.add(t.attr)
                val = getattr(sub, "value", None)
                if isinstance(val, ast.Call):
                    kind = _LOCK_CTORS.get(_leaf(val.func))
                    if kind:
                        ci.lock_attrs[t.attr] = kind
                        ci.lock_ctor_attrs.add(t.attr)
                    elif isinstance(val.func, ast.Name):
                        ci.attr_types.setdefault(t.attr, val.func.id)
                    else:
                        # `self.x = threading.Thread(...)`: class-like
                        # ctor leaf types the attr as EXTERNAL, which
                        # blocks the name fallback for calls on it
                        leaf = _leaf(val.func)
                        if leaf[:1].isupper():
                            ci.attr_types.setdefault(t.attr, leaf)
                elif isinstance(val, ast.Name):
                    ann = _param_annotation(fi.node, val.id)
                    if ann:
                        ci.attr_types.setdefault(t.attr, ann)
                g = _guard_text(mi.lines, sub)
                if g and t.attr not in ci.field_guard_decl:
                    ci.field_guard_decl[t.attr] = (
                        g, sub.lineno,
                        _line_has(mi.lines, sub, _UNGUARDED_RE))
        elif isinstance(sub, ast.With):
            for item in sub.items:
                e = item.context_expr
                if (isinstance(e, ast.Attribute)
                        and isinstance(e.value, ast.Name)
                        and e.value.id == "self"):
                    ci.lock_attrs.setdefault(e.attr, "Lock")


# ---------------------------------------------------------------------------
# pass 2: body walk with a lexically held lock set
# ---------------------------------------------------------------------------

class _BodyWalker:
    def __init__(self, an: Analysis, mi: _ModuleInfo,
                 ci: Optional[_ClassInfo], fi: _FuncInfo):
        self.an = an
        self.mi = mi
        self.ci = ci
        self.fi = fi
        self.local_types: Dict[str, str] = {}
        self._sync_lambdas: Set[int] = set()
        args = getattr(fi.node, "args", None)
        if args is not None:
            for a in list(args.args) + list(args.kwonlyargs):
                ann = _param_annotation(fi.node, a.arg)
                if ann:
                    self.local_types[a.arg] = ann

    # ---- resolution ----------------------------------------------------
    def _expr_type(self, e: ast.expr) -> Optional[str]:
        if isinstance(e, ast.Name):
            if e.id == "self" and self.ci is not None:
                return self.ci.name
            return self.local_types.get(e.id)
        if isinstance(e, ast.Attribute):
            base = self._expr_type(e.value)
            if base and base in self.an.classes:
                return self.an.attr_type(base, e.attr)
            return None
        if isinstance(e, ast.Call):
            leaf = _leaf(e.func)
            if leaf in self.an.classes:
                return leaf
            for t in self._call_targets(e.func):
                if t.return_type:
                    return t.return_type
        return None

    def _lock_id(self, e: ast.expr) -> Optional[str]:
        if isinstance(e, ast.Attribute):
            if isinstance(e.value, ast.Name):
                if e.value.id == "self" and self.ci is not None:
                    return self.an.lock_id_for_attr(self.ci.name, e.attr)
                t = self.local_types.get(e.value.id)
                if t:
                    return self.an.lock_id_for_attr(t, e.attr)
                for mi in self.an.modules.values():
                    if mi.base == e.value.id and e.attr in mi.locks:
                        return f"{mi.base}.{e.attr}"
                return None
            t = self._expr_type(e.value)
            if t:
                return self.an.lock_id_for_attr(t, e.attr)
            return None
        if isinstance(e, ast.Name):
            if e.id in self.mi.locks:
                return f"{self.mi.base}.{e.id}"
            if e.id in self.mi.imports:
                for mi in self.an.modules.values():
                    if e.id in mi.locks:
                        return f"{mi.base}.{e.id}"
        return None

    def _call_targets(self, func: ast.expr) -> List[_FuncInfo]:
        if isinstance(func, ast.Name):
            name = func.id
            if name in self.mi.functions:
                return [self.mi.functions[name]]
            if name in self.mi.classes:
                m = self.an.resolve_method(name, "__init__")
                return [m] if m else []
            if name in self.mi.imports:
                out = []
                for mi in self.an.modules.values():
                    if name in mi.functions:
                        out.append(mi.functions[name])
                if not out and name in self.an.classes:
                    m = self.an.resolve_method(name, "__init__")
                    if m:
                        out.append(m)
                return out
            return []
        if isinstance(func, ast.Attribute):
            if (isinstance(func.value, ast.Call)
                    and _leaf(func.value.func) == "super"
                    and self.ci is not None):
                for b in self.ci.bases:
                    m = self.an.resolve_method(b, func.attr)
                    if m:
                        return [m]
                return []
            base_t = self._expr_type(func.value)
            if base_t:
                if base_t in self.an.classes:
                    m = self.an.resolve_method(base_t, func.attr)
                    return [m] if m else []
                return []  # typed external (Thread, Event, ndarray...)
            if isinstance(func.value, ast.Name):
                for mi in self.an.modules.values():
                    if mi.base == func.value.id \
                            and func.attr in mi.functions:
                        return [mi.functions[func.attr]]
            return self.an.method_fallback.get(func.attr, [])
        return []

    # ---- the walk ------------------------------------------------------
    def walk(self) -> None:
        held = tuple(sorted(self.fi.decl_entry))
        self._stmts(getattr(self.fi.node, "body", []), held, 0)

    def _stmts(self, stmts, held, loops) -> None:
        for s in stmts:
            self._stmt(s, held, loops)

    def _stmt(self, s: ast.stmt, held: Tuple[str, ...],
              loops: int) -> None:
        if isinstance(s, ast.With):
            inner = held
            for item in s.items:
                lid = self._lock_id(item.context_expr)
                if lid is not None:
                    self.fi.acquired.add(lid)
                    for h in inner:
                        if h != lid:
                            self.an.edges.add((h, lid))
                    if lid not in inner:
                        inner = inner + (lid,)
                else:
                    self._scan(item.context_expr, inner, loops, s)
            self._stmts(s.body, inner, loops)
            return
        if isinstance(s, (ast.While, ast.For, ast.AsyncFor)):
            for c in ast.iter_child_nodes(s):
                if isinstance(c, ast.expr):
                    self._scan(c, held, loops, s)
            self._stmts(s.body, held, loops + 1)
            self._stmts(getattr(s, "orelse", []), held, loops + 1)
            return
        if isinstance(s, ast.If):
            self._scan(s.test, held, loops, s)
            self._stmts(s.body, held, loops)
            self._stmts(s.orelse, held, loops)
            return
        if isinstance(s, ast.Try):
            self._stmts(s.body, held, loops)
            for h in s.handlers:
                self._stmts(h.body, held, loops)
            self._stmts(s.orelse, held, loops)
            self._stmts(s.finalbody, held, loops)
            return
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._closure(s)
            return
        for c in ast.iter_child_nodes(s):
            if isinstance(c, ast.expr):
                self._scan(c, held, loops, s)

    def _closure(self, node: ast.AST) -> None:
        """A nested def/lambda runs later on an unknown thread: analyze
        with an empty held set; its acquisitions feed the fallback."""
        nested = _FuncInfo(node, self.ci.name if self.ci else None,
                           self.mi.relpath,
                           getattr(node, "name", "<lambda>"))
        nested.escapes = True
        w = _BodyWalker(self.an, self.mi, self.ci, nested)
        w.local_types.update(self.local_types)
        if isinstance(node, ast.Lambda):
            w._scan(node.body, (), 0, node)
        else:
            w._stmts(node.body, (), 0)
        self.an.closures.append(nested)

    def _scan(self, e: ast.expr, held, loops, stmt) -> None:
        """Recursive expression scan that does NOT descend into
        closure/lambda bodies with the current held set."""
        if isinstance(e, ast.Lambda):
            if id(e) in self._sync_lambdas:
                self._scan(e.body, held, loops, stmt)
            else:
                self._closure(e)
            return
        if isinstance(e, ast.Call):
            self._call(e, held, loops, stmt)
        elif isinstance(e, ast.Attribute):
            self._attribute(e, held)
        elif isinstance(e, ast.Name):
            self._global_access(e, held, stmt)
        for c in ast.iter_child_nodes(e):
            if isinstance(c, ast.expr):
                self._scan(c, held, loops, stmt)
            elif isinstance(c, (ast.comprehension, ast.keyword,
                                ast.FormattedValue)):
                for cc in ast.iter_child_nodes(c):
                    if isinstance(cc, ast.expr):
                        self._scan(cc, held, loops, stmt)

    _SYNC_HOFS = {"sort", "sorted", "min", "max", "map", "filter",
                  "any", "all", "sum", "key"}

    def _call(self, c: ast.Call, held, loops, stmt) -> None:
        leaf = _leaf(c.func)
        if leaf in self._SYNC_HOFS:
            # a lambda handed to a synchronous HOF runs inline, under
            # the current held set — not as an escaping closure
            for sub in list(c.args) + [k.value for k in c.keywords]:
                if isinstance(sub, ast.Lambda):
                    self._sync_lambdas.add(id(sub))
        waived = _line_has(self.mi.lines, c, _LOCK_OK_RE)
        recv_lock = None
        if isinstance(c.func, ast.Attribute):
            recv_lock = self._lock_id(c.func.value)
        if leaf == "wait" and recv_lock is not None \
                and self.an.locks.get(recv_lock) == "Condition":
            self.fi.cv_waits.append((recv_lock, frozenset(held),
                                     loops > 0, c.lineno, waived))
        elif leaf in _BLOCKING_LEAVES and held:
            self.fi.blocking.append((_BLOCKING_LEAVES[leaf],
                                     frozenset(held), c.lineno, waived))
        targets = self._call_targets(c.func)
        if targets:
            self.fi.calls.append((tuple(targets), frozenset(held),
                                  c.lineno))
        if isinstance(stmt, ast.Assign) and stmt.value is c:
            t = self._expr_type(c)
            if t:
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        self.local_types[tgt.id] = t

    def _attribute(self, a: ast.Attribute, held) -> None:
        if isinstance(a.value, ast.Name) and a.value.id == "self" \
                and self.ci is not None:
            if isinstance(a.ctx, ast.Load):
                m = self.an.resolve_method(self.ci.name, a.attr)
                if m is not None and m.is_property:
                    self.fi.calls.append(((m,), frozenset(held),
                                          a.lineno))
                    return
            dc = self.an.defining_class(self.ci.name, a.attr)
            if dc is not None \
                    and a.attr not in self.an.classes[dc].lock_attrs:
                eff_held = frozenset(held)
                self.fi.accesses.append((
                    dc, a.attr, eff_held, a.lineno,
                    isinstance(a.ctx, (ast.Store, ast.Del)),
                    _line_has(self.mi.lines, a, _UNGUARDED_RE)))
            return
        if isinstance(a.ctx, ast.Load):
            t = self._expr_type(a.value)
            if t and t in self.an.classes:
                m = self.an.resolve_method(t, a.attr)
                if m is not None and m.is_property:
                    self.fi.calls.append(((m,), frozenset(held),
                                          a.lineno))
                return
            fb = self.an.property_fallback.get(a.attr)
            if fb:
                self.fi.calls.append((tuple(fb), frozenset(held),
                                      a.lineno))

    def _global_access(self, n: ast.Name, held, stmt) -> None:
        if n.id in self.mi.global_guards and n.id not in self.mi.locks:
            self.fi.accesses.append((
                None, f"{self.mi.base}.{n.id}", frozenset(held),
                n.lineno, isinstance(n.ctx, ast.Store),
                _line_has(self.mi.lines, n, _UNGUARDED_RE)
                or _line_has(self.mi.lines, stmt, _UNGUARDED_RE)))


# ---------------------------------------------------------------------------
# the analysis driver
# ---------------------------------------------------------------------------

def _iter_py(root: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            if f.endswith(".py"):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _resolve_guard_text(an: Analysis, ci: Optional[_ClassInfo],
                        text: str) -> str:
    """'self._cv' / '_capture_lock' / 'metrics._ENG_LOCK' -> lock id."""
    text = text.strip()
    if text.startswith("self.") and ci is not None:
        attr = text[len("self."):]
        return an.lock_id_for_attr(ci.name, attr) or f"{ci.name}.{attr}"
    if "." in text:
        base, _, attr = text.partition(".")
        for mi in an.modules.values():
            if mi.base == base and attr in mi.locks:
                return f"{base}.{attr}"
        return text
    for mi in an.modules.values():
        if text in mi.locks:
            return f"{mi.base}.{text}"
    return text


def build(root: Optional[str] = None) -> Analysis:
    """Parse every .py under ``root`` (default: the flexflow_tpu_torch
    package) and build the whole-program model + diagnostics."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prefix = os.path.dirname(os.path.abspath(root))
    an = Analysis()
    parsed: List[Tuple[_ModuleInfo, ast.AST]] = []
    for path in _iter_py(root):
        try:
            with open(path) as f:
                src = f.read()
            tree = ast.parse(src)
        except (OSError, SyntaxError):
            continue
        rel = os.path.relpath(path, prefix)
        mi = _ModuleInfo(rel, src.splitlines())
        an.modules[rel] = mi
        _collect_module(mi, tree)
        parsed.append((mi, tree))
    for mi in an.modules.values():
        for cname, ci in mi.classes.items():
            an.classes.setdefault(cname, ci)
        for lname, kind in mi.locks.items():
            an.locks[f"{mi.base}.{lname}"] = kind
    # a `with self._lock:` in a subclass must not mint a second
    # identity for a lock the base class constructs (GenerationMetrics
    # shares ServingMetrics._lock)
    for ci in an.classes.values():
        for attr in list(ci.lock_attrs):
            if attr in ci.lock_ctor_attrs:
                continue
            for base_ci in an._mro(ci.name):
                if base_ci.name != ci.name \
                        and attr in base_ci.lock_attrs:
                    del ci.lock_attrs[attr]
                    break
    for ci in an.classes.values():
        for attr, kind in ci.lock_attrs.items():
            lid = f"{ci.name}.{attr}"
            if kind != "Lock" or lid not in an.locks:
                an.locks[lid] = kind
    # resolve def-line caller-holds contracts to lock ids
    for mi in an.modules.values():
        for ci in mi.classes.values():
            for fi in ci.methods.values():
                fi.decl_entry = {_resolve_guard_text(an, ci, g)
                                 for g in fi.decl_raw}
        for fi in mi.functions.values():
            fi.decl_entry = {_resolve_guard_text(an, None, g)
                             for g in fi.decl_raw}
    # two walk rounds: round 0 discovers each function's acquisitions,
    # round 1 re-walks with the name-fallback maps available so calls
    # the types cannot pin still reach every candidate implementation
    for round_no in range(2):
        an.edges.clear()
        an.closures = []
        for mi in an.modules.values():
            for ci in mi.classes.values():
                for fi in ci.methods.values():
                    fi.reset()
                    _BodyWalker(an, mi, ci, fi).walk()
            for fi in mi.functions.values():
                fi.reset()
                _BodyWalker(an, mi, None, fi).walk()
        # fold `# may-acquire:` contracts (known lock ids only) into
        # the acquired sets before the transitive fixpoint, so callers
        # holding locks at the call site get the edge
        for fi in an.all_funcs():
            fi.acquired |= {m for m in getattr(fi, "may_acquire", ())
                            if m in an.locks}
        _compute_transitive(an)
        if round_no == 0:
            _build_fallbacks(an)
    # call-graph edges: locks held at a call site order before
    # everything the callee may transitively acquire
    for fi in an.all_funcs():
        for targets, held, _line in fi.calls:
            for t in targets:
                for lid in t.trans_acquired:
                    for h in held:
                        if h != lid:
                            an.edges.add((h, lid))
    _mark_escapes(an)
    _infer_entries(an)
    _emit_ff150_ff154(an)
    _emit_ff151(an)
    _emit_ff152_ff153(an)
    return an


def _compute_transitive(an: Analysis) -> None:
    funcs = list(an.all_funcs())
    for fi in funcs:
        fi.trans_acquired = set(fi.acquired)
    for _ in range(16):
        changed = False
        for fi in funcs:
            for targets, _held, _line in fi.calls:
                for t in targets:
                    new = t.trans_acquired - fi.trans_acquired
                    if new:
                        fi.trans_acquired |= new
                        changed = True
        if not changed:
            break


def _build_fallbacks(an: Analysis) -> None:
    meth: Dict[str, List[_FuncInfo]] = {}
    prop: Dict[str, List[_FuncInfo]] = {}
    for ci in an.classes.values():
        for name, fi in ci.methods.items():
            if fi.trans_acquired:
                (prop if fi.is_property else meth).setdefault(
                    name, []).append(fi)
    an.method_fallback = meth
    an.property_fallback = prop


def _mark_escapes(an: Analysis) -> None:
    """A method referenced as a value (thread target, callback) can be
    entered from anywhere: no caller-holds inference for it."""
    for mi in an.modules.values():
        for ci in mi.classes.values():
            for fi in ci.methods.values():
                call_funcs = {id(sub.func) for sub in ast.walk(fi.node)
                              if isinstance(sub, ast.Call)}
                for sub in ast.walk(fi.node):
                    if (isinstance(sub, ast.Attribute)
                            and isinstance(sub.ctx, ast.Load)
                            and isinstance(sub.value, ast.Name)
                            and sub.value.id == "self"
                            and id(sub) not in call_funcs):
                        m = an.resolve_method(ci.name, sub.attr)
                        if m is not None:
                            m.escapes = True


def _infer_entries(an: Analysis) -> None:
    """Caller-holds inference: a private, never-escaping method whose
    every known call site holds lock L effectively runs under L."""
    for _round in range(3):
        sites: Dict[int, List[Set[str]]] = {}
        for fi in an.all_funcs():
            for targets, held, _line in fi.calls:
                eff = set(held) | fi.entry | fi.decl_entry
                for t in targets:
                    sites.setdefault(id(t), []).append(eff)
        changed = False
        for fi in an.all_funcs():
            if fi.decl_entry or fi.escapes or fi.is_property \
                    or not fi.name.startswith("_") \
                    or fi.name.startswith("__"):
                continue
            held_sets = sites.get(id(fi))
            if held_sets:
                inter = set.intersection(*held_sets)
                if inter != fi.entry:
                    fi.entry = inter
                    changed = True
        if not changed:
            break


def _site(fi: _FuncInfo, line: int) -> str:
    return f"{fi.module}:{line}"


def _emit_ff150_ff154(an: Analysis) -> None:
    fields: Dict[Tuple[Optional[str], str], List[Tuple]] = {}
    for fi in an.all_funcs():
        for dc, field, held, line, is_write, waived in fi.accesses:
            eff = frozenset(set(held) | fi.entry | fi.decl_entry)
            fields.setdefault((dc, field), []).append(
                (fi, eff, line, is_write, waived))
    for (dc, field), accs in sorted(
            fields.items(), key=lambda kv: (kv[0][0] or "", kv[0][1])):
        decl_mod = None            # declaration site (module relpath)
        if dc is not None:
            ci: Optional[_ClassInfo] = an.classes[dc]
            decl = None
            for mci in an._mro(dc):
                if field in mci.field_guard_decl:
                    decl = mci.field_guard_decl[field]
                    decl_mod = mci.module
                    break
            label = f"{dc}.{field}"
        else:
            ci = None
            label = field          # already "module.name"
            decl = None
            base, _, gname = field.partition(".")
            for mi in an.modules.values():
                if mi.base == base and gname in mi.global_guards:
                    g, ln = mi.global_guards[gname]
                    decl = (g, ln, False)
                    decl_mod = mi.relpath
                    break
        body = [a for a in accs if a[0].name != "__init__"]
        if not body:
            continue
        decl_guard = None
        decl_waived = False
        if decl is not None:
            g, _ln, decl_waived = decl
            decl_guard = _resolve_guard_text(an, ci, g)
        written = any(a[3] for a in body)
        counted = [a for a in body if not a[4]]
        inferred = None
        if written and len(counted) >= _MIN_ACCESSES:
            tally: Dict[str, int] = {}
            for _fi, eff, _line, _w, _waived in counted:
                for lid in eff:
                    tally[lid] = tally.get(lid, 0) + 1
            if tally:
                best = max(tally, key=lambda k: (tally[k], k))
                if tally[best] >= _MAJORITY * len(counted):
                    inferred = best
        guard = decl_guard or inferred
        if guard is None:
            continue
        basis = "declared" if decl_guard else "inferred"
        if not (decl_waived and basis == "declared"):
            for fi, eff, line, _w, waived in body:
                if guard in eff or waived:
                    continue
                an.report.add(make(
                    "FF150", _site(fi, line),
                    f"{label} accessed outside its {basis} guard "
                    f"{guard} (held: "
                    f"{', '.join(sorted(eff)) or 'nothing'}) in "
                    f"{fi.qual}",
                    hint="take the guard, or waive with "
                         "`# unguarded-ok: <why>` stating the safety "
                         "argument"))
        if decl_guard and inferred and decl_guard != inferred \
                and not decl_waived:
            # anchor at the DECLARATION site: the annotation is what
            # drifted, and the payload stays stable across refactors
            # of the accessing methods
            site = (f"{decl_mod}:{decl[1]}" if decl_mod is not None
                    else label)
            an.report.add(make(
                "FF154", site,
                f"annotation drift: {label} declares guard "
                f"{decl_guard} but majority use holds {inferred} "
                f"({len(counted)} sites)",
                hint="fix the # guarded_by: annotation or the code; "
                     "they must agree"))


def _emit_ff151(an: Analysis) -> None:
    graph: Dict[str, Set[str]] = {}
    for a, b in an.edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(root: str) -> None:
        work = [(root, iter(sorted(graph[root])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on.add(root)
        while work:
            node, it = work[-1]
            pushed = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    pushed = True
                    break
                if w in on:
                    low[node] = min(low[node], index[w])
            if pushed:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    for scc in sccs:
        an.report.add(make(
            "FF151", scc[0],
            f"lock-order inversion: {{{', '.join(scc)}}} form a cycle "
            f"in the static acquisition graph (potential ABBA "
            f"deadlock)",
            hint="impose one global acquisition order and release "
                 "the outer lock before taking the inner one on one "
                 "side"))


def _emit_ff152_ff153(an: Analysis) -> None:
    for fi in an.all_funcs():
        held_extra = fi.entry | fi.decl_entry
        for desc, held, line, waived in fi.blocking:
            if waived:
                continue
            eff = set(held) | held_extra
            if not eff:
                continue
            an.report.add(make(
                "FF152", _site(fi, line),
                f"blocking call ({desc}) in {fi.qual} while holding "
                f"{', '.join(sorted(eff))}",
                hint="move the blocking call outside the lock, or "
                     "waive with `# lock-ok: <why>` stating why no "
                     "other thread can need the held lock to make "
                     "progress"))
        for cv, held, in_loop, line, waived in fi.cv_waits:
            if waived:
                continue
            eff = set(held) | held_extra
            if cv not in eff:
                an.report.add(make(
                    "FF153", _site(fi, line),
                    f"{fi.qual} waits on condition {cv} without "
                    f"holding its lock (held: "
                    f"{', '.join(sorted(eff)) or 'nothing'})",
                    hint="wait() must run inside `with cv:`"))
            elif not in_loop:
                an.report.add(make(
                    "FF153", _site(fi, line),
                    f"{fi.qual} calls {cv}.wait() outside a predicate "
                    f"loop — spurious wakeups break the invariant",
                    hint="wrap the wait in `while not predicate: "
                         "cv.wait()`"))
            others = eff - {cv}
            if others:
                an.report.add(make(
                    "FF152", _site(fi, line),
                    f"{fi.qual} blocks in {cv}.wait() while ALSO "
                    f"holding {', '.join(sorted(others))} (wait "
                    f"releases only its own lock)",
                    hint="release the other locks before waiting"))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def analyze_tree(root: Optional[str] = None) -> DiagnosticReport:
    """Run the full pass; the report renders through the standard
    analysis.diagnostics text/JSON renderers."""
    return build(root).report


def static_lock_edges(root: Optional[str] = None
                      ) -> Set[Tuple[str, str]]:
    """The static lock-order graph: the superset that the edges an
    ``FF_LOCKWATCH=1`` run observes must fall inside."""
    return set(build(root).edges)


def concurrency_main(as_json: bool = False,
                     root: Optional[str] = None) -> int:
    """``flexflow-tpu-torch lint --concurrency [--json]``: exit 0 clean
    (INFO/WARN only), 1 on any ERROR diagnostic."""
    an = build(root)
    rep = an.report
    if as_json:
        print(rep.render_json())
    else:
        print(rep.render_text())
        print(f"lock-order graph: {len(an.locks)} locks, "
              f"{len(an.edges)} nested-acquisition edges")
    return 0 if not rep.errors else 1
