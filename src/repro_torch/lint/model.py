"""AST ingestion: parse a package tree into the analyzer's symbol model.

One pass per module builds:

  * :class:`ModuleInfo` — path, module name, imports, the
    ``# lint: deterministic`` marker, and per-line suppressions
    (``# lint: ignore[rule-a,rule-b]``; on a ``def`` line the suppression
    covers the whole function).
  * :class:`ClassInfo` — base-class names (for the hierarchy the call-graph
    resolver walks), lock-typed attributes (assigned ``threading.Lock()`` /
    ``RLock()``), and attribute type annotations from ``__init__``.
  * :class:`FunctionInfo` — every call site (with the held-lock set and the
    enclosing ``except BlockingIOError`` state), every ``self.X`` attribute
    access (read/write/aug, held locks, in-``__init__`` flag), unordered-
    producer taint events, and the thread-context *boundary seeds* the
    call-graph engine roots contexts at: ``._post(fn)`` (loop), tuples
    ``._offload(fn)`` / ``threading.Thread(target=fn)`` (worker), and
    ``table.register(name, fn, heavy=...)`` handler registrations.

Everything here is syntactic and intentionally conservative; the resolver
(:mod:`repro_torch.lint.callgraph`) and the rules (:mod:`repro_torch.lint.rules`)
decide what a call reference means.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(r"#\s*lint:\s*ignore(?:\[([a-zA-Z0-9_,\- ]+)\])?")
DETERMINISTIC_RE = re.compile(r"#\s*lint:\s*deterministic\b")
ALL_RULES = "*"

# Receiver-less method names too generic to link by name alone: they collide
# with builtin container / file / thread / socket methods, so an unresolved
# ``obj.<name>()`` is matched against the blocking-primitive tables instead
# of the internal index (typed receivers still resolve precisely).
AMBIGUOUS_METHOD_NAMES = frozenset(
    "add append clear close copy count discard extend flush get index insert "
    "items join keys pop popleft put read readline recv register release "
    "remove result send sendall setdefault sort start stop update values "
    "wait write acquire".split()
)

# Container methods that mutate their receiver: ``self.X.append(...)`` is a
# *write* to X for lockset purposes, not just a read of the reference.
MUTATOR_METHODS = frozenset(
    "add append appendleft clear discard extend insert pop popleft push "
    "remove setdefault sort update".split()
)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # POSIX path relative to the scan root
    line: int
    symbol: str  # enclosing function qualname, or "<module>"
    message: str

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: stable across line churn within a function."""
        return (self.rule, self.path, self.symbol)


@dataclasses.dataclass(frozen=True)
class CallRef:
    """One call site, classified by how its callee was written.

    ``kind`` ∈ ``self`` (``self.m()``), ``name`` (bare ``f()`` /
    ``Class()``), ``dotted`` (``mod.attr...()`` rooted at an imported
    module), ``attr`` (``obj.m()``, receiver unknown or locally typed —
    ``recv_type`` carries the inferred class name when known).
    """

    kind: str
    parts: Tuple[str, ...]  # ('m',) / ('f',) / ('time','sleep') / ('m',)
    line: int
    recv_type: Optional[str] = None  # inferred receiver class (attr calls)
    recv_name: Optional[str] = None  # receiver identifier (attr calls)
    n_args: int = 0
    kwargs: Tuple[Tuple[str, object], ...] = ()  # constant-valued kwargs only
    in_blockingio_try: bool = False  # inside try: ... except BlockingIOError
    locks: Tuple[str, ...] = ()  # lock attrs held at the call site


@dataclasses.dataclass(frozen=True)
class Access:
    """One ``self.X`` attribute access inside a method body."""

    attr: str
    line: int
    kind: str  # 'read' | 'write' | 'aug'
    locks: Tuple[str, ...]
    in_init: bool


@dataclasses.dataclass(frozen=True)
class Seed:
    """A thread-context root the call-graph engine starts propagation at."""

    kind: str  # 'post' | 'offload' | 'thread' | 'handler'
    target: CallRef  # the callable reference (resolved like a call)
    line: int
    heavy: bool = False  # handler registrations only
    reg_name: str = ""  # handler registrations only


@dataclasses.dataclass
class FunctionInfo:
    module: "ModuleInfo"
    cls: Optional[str]
    name: str
    lineno: int
    calls: List[CallRef] = dataclasses.field(default_factory=list)
    accesses: List[Access] = dataclasses.field(default_factory=list)
    seeds: List[Seed] = dataclasses.field(default_factory=list)
    # Lines where an unordered-producer value is consumed order-sensitively
    # (iterated / listed / joined) without sorting: (line, description).
    unordered_uses: List[Tuple[int, str]] = dataclasses.field(default_factory=list)

    @property
    def qualname(self) -> str:
        inner = f"{self.cls}.{self.name}" if self.cls else self.name
        return f"{self.module.modname}.{inner}"

    @property
    def local_name(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name


@dataclasses.dataclass
class ClassInfo:
    module: "ModuleInfo"
    name: str
    bases: List[str]
    methods: Dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModuleInfo:
    path: str  # scan-root-relative POSIX path
    modname: str
    deterministic: bool = False
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    # name -> dotted module for `import x.y as z`; `from m import f` -> 'm.f'
    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    suppressions: Dict[int, Set[str]] = dataclasses.field(default_factory=dict)
    func_suppressions: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)

    def suppressed(self, rule: str, line: int, symbol: str = "") -> bool:
        rules = self.suppressions.get(line)
        if rules is not None and (ALL_RULES in rules or rule in rules):
            return True
        rules = self.func_suppressions.get(symbol)
        return rules is not None and (ALL_RULES in rules or rule in rules)


@dataclasses.dataclass
class Project:
    root: str
    modules: Dict[str, ModuleInfo] = dataclasses.field(default_factory=dict)

    def all_functions(self) -> List[FunctionInfo]:
        out: List[FunctionInfo] = []
        for mod in self.modules.values():
            out.extend(mod.functions.values())
            for cls in mod.classes.values():
                out.extend(cls.methods.values())
        return out


# ------------------------------------------------------------------ helpers
def _dotted_parts(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` attribute chain rooted at a Name, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _const_kwargs(call: ast.Call) -> Tuple[Tuple[str, object], ...]:
    out = []
    for kw in call.keywords:
        if kw.arg is not None and isinstance(kw.value, ast.Constant):
            out.append((kw.arg, kw.value.value))
    return tuple(out)


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    parts = _dotted_parts(node.func)
    return parts is not None and parts[-1] in ("Lock", "RLock")


def _ann_class_name(ann: ast.AST) -> Optional[str]:
    """``X`` / ``Optional[X]`` / ``"X"`` annotation -> class simple name."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        name = ann.value.split("[")[-1].rstrip("]").split(".")[-1]
        return name or None
    if isinstance(ann, ast.Subscript):
        parts = _dotted_parts(ann.value)
        if parts and parts[-1] in ("Optional", "Final", "ClassVar"):
            return _ann_class_name(ann.slice)
        return None
    parts = _dotted_parts(ann)
    return parts[-1] if parts else None


_UNORDERED_PRODUCER_CALLS = {
    ("set",): "set()",
    ("frozenset",): "frozenset()",
    ("os", "listdir"): "os.listdir()",
    ("os", "scandir"): "os.scandir()",
    ("glob", "glob"): "glob.glob()",
    ("glob", "iglob"): "glob.iglob()",
}
_SET_METHODS = frozenset(
    ("difference", "union", "intersection", "symmetric_difference")
)
_ORDER_SINKS = frozenset(("list", "tuple", "enumerate"))


class _ModuleVisitor(ast.NodeVisitor):
    """One pass over a module: builds the ModuleInfo symbol model."""

    def __init__(self, mod: ModuleInfo, source: str):
        self.mod = mod
        self._cls_stack: List[ClassInfo] = []
        self._fn_stack: List[FunctionInfo] = []
        self._locks: List[str] = []  # lock attrs held (with-statement stack)
        self._bio_try = 0  # depth of try blocks catching BlockingIOError
        self._parse_comments(source)

    # ------------------------------------------------------------- comments
    def _parse_comments(self, source: str) -> None:
        for i, text in enumerate(source.splitlines(), start=1):
            if DETERMINISTIC_RE.search(text):
                self.mod.deterministic = True
            m = SUPPRESS_RE.search(text)
            if m:
                rules = (
                    {r.strip() for r in m.group(1).split(",") if r.strip()}
                    if m.group(1)
                    else {ALL_RULES}
                )
                self.mod.suppressions.setdefault(i, set()).update(rules)

    # -------------------------------------------------------------- imports
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.mod.imports[alias.asname or alias.name.split(".")[0]] = alias.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        base = node.module or ""
        for alias in node.names:
            self.mod.imports[alias.asname or alias.name] = (
                f"{base}.{alias.name}" if base else alias.name
            )

    # ------------------------------------------------------- class/function
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        bases = []
        for b in node.bases:
            parts = _dotted_parts(b)
            if parts:
                bases.append(parts[-1])
        cls = ClassInfo(self.mod, node.name, bases)
        self.mod.classes[node.name] = cls
        self._cls_stack.append(cls)
        for stmt in node.body:
            self.visit(stmt)
        self._cls_stack.pop()

    def _enter_function(self, node) -> None:
        cls = self._cls_stack[-1] if self._cls_stack else None
        fn = FunctionInfo(
            self.mod, cls.name if cls else None, node.name, node.lineno
        )
        # A suppression comment on (or decorators above) the def line covers
        # the whole function body.
        rules = self.mod.suppressions.get(node.lineno)
        if rules:
            self.mod.func_suppressions.setdefault(fn.local_name, set()).update(rules)
        if cls is not None and not self._fn_stack:
            cls.methods[node.name] = fn
        elif not self._fn_stack:
            self.mod.functions[node.name] = fn
        else:  # nested def: indexed by a qualified local name
            outer = self._fn_stack[-1]
            fn.name = f"{outer.name}.{node.name}"
            fn.cls = outer.cls
            if cls is not None:
                cls.methods[fn.name] = fn
            else:
                self.mod.functions[fn.name] = fn
        self._fn_stack.append(fn)
        outer_locks, self._locks = self._locks, []
        outer_bio, self._bio_try = self._bio_try, 0
        outer_types, self._local_types = self._local_types, {}
        outer_unordered, self._local_unordered = self._local_unordered, {}
        for stmt in node.body:
            self.visit(stmt)
        self._locks, self._bio_try = outer_locks, outer_bio
        self._local_types, self._local_unordered = outer_types, outer_unordered
        self._fn_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter_function(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._enter_function(node)

    # --------------------------------------------------------------- blocks
    @property
    def _fn(self) -> Optional[FunctionInfo]:
        return self._fn_stack[-1] if self._fn_stack else None

    @property
    def _in_init(self) -> bool:
        fn = self._fn
        return fn is not None and fn.name == "__init__"

    def visit_With(self, node: ast.With) -> None:
        held = []
        for item in node.items:
            parts = _dotted_parts(item.context_expr)
            if (
                parts
                and len(parts) == 2
                and parts[0] == "self"
                and self._is_lock_attr(parts[1])
            ):
                held.append(parts[1])
                self._record_access(parts[1], item.context_expr.lineno, "read")
        self._locks.extend(held)
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in held:
            self._locks.pop()

    def _is_lock_attr(self, attr: str) -> bool:
        cls = self._cls_stack[-1] if self._cls_stack else None
        if cls is not None and attr in cls.lock_attrs:
            return True
        return "lock" in attr.lower()

    def visit_Try(self, node: ast.Try) -> None:
        catches_bio = False
        for handler in node.handlers:
            t = handler.type
            names = []
            if isinstance(t, ast.Tuple):
                names = [p[-1] for e in t.elts if (p := _dotted_parts(e))]
            elif t is not None:
                p = _dotted_parts(t)
                names = [p[-1]] if p else []
            if any(n in ("BlockingIOError", "InterruptedError") for n in names):
                catches_bio = True
        if catches_bio:
            self._bio_try += 1
        for stmt in node.body:
            self.visit(stmt)
        if catches_bio:
            self._bio_try -= 1
        for handler in node.handlers:
            self.visit(handler)
        for stmt in node.orelse + node.finalbody:
            self.visit(stmt)

    # ------------------------------------------------------------- accesses
    def _record_access(self, attr: str, line: int, kind: str) -> None:
        fn = self._fn
        if fn is None:
            return
        fn.accesses.append(
            Access(attr, line, kind, tuple(self._locks), self._in_init)
        )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            kind = "write" if isinstance(node.ctx, (ast.Store, ast.Del)) else "read"
            self._record_access(node.attr, node.lineno, kind)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # ``self.X[i] = v`` / ``del self.X[i]`` mutate X: count as a write.
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            parts = _dotted_parts(node.value)
            if parts and len(parts) == 2 and parts[0] == "self":
                self._record_access(parts[1], node.lineno, "write")
                self.visit(node.slice)
                return
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if isinstance(node.target, ast.Attribute):
            parts = _dotted_parts(node.target)
            if parts and len(parts) == 2 and parts[0] == "self":
                self._record_access(parts[1], node.lineno, "aug")
                self.visit(node.value)
                return
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        cls = self._cls_stack[-1] if self._cls_stack else None
        for tgt in node.targets:
            parts = _dotted_parts(tgt)
            if parts and len(parts) == 2 and parts[0] == "self" and cls is not None:
                if _is_lock_ctor(node.value):
                    cls.lock_attrs.add(parts[1])
                tname = self._value_type(node.value)
                if tname is not None and self._in_init:
                    cls.attr_types.setdefault(parts[1], tname)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        cls = self._cls_stack[-1] if self._cls_stack else None
        parts = _dotted_parts(node.target)
        tname = _ann_class_name(node.annotation)
        if parts and tname:
            if len(parts) == 2 and parts[0] == "self" and cls is not None:
                cls.attr_types.setdefault(parts[1], tname)
                if tname in ("Lock", "RLock"):
                    cls.lock_attrs.add(parts[1])
            elif len(parts) == 1 and self._fn is not None:
                self._local_types[parts[0]] = tname
        self.generic_visit(node)

    def _value_type(self, value: ast.AST) -> Optional[str]:
        """``ClassName(...)`` constructor -> class simple name."""
        if isinstance(value, ast.Call):
            parts = _dotted_parts(value.func)
            if parts and parts[-1][:1].isupper():
                return parts[-1]
        return None

    # ----------------------------------------------------------------- calls
    _local_types: Dict[str, str] = {}

    def _callref(self, node: ast.Call) -> Optional[CallRef]:
        common = dict(
            line=node.lineno,
            n_args=len(node.args),
            kwargs=_const_kwargs(node),
            in_blockingio_try=self._bio_try > 0,
            locks=tuple(self._locks),
        )
        func = node.func
        if isinstance(func, ast.Name):
            return CallRef("name", (func.id,), **common)
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Call)
            and isinstance(func.value.func, ast.Name)
            and func.value.func.id == "super"
        ):
            # super().m() dispatches up the caller's own hierarchy only.
            return CallRef("super", (func.attr,), **common)
        parts = _dotted_parts(func)
        if parts is None:
            if isinstance(func, ast.Attribute):  # call on a call result etc.
                return CallRef("attr", (func.attr,), **common)
            return None
        if parts[0] == "self" and len(parts) == 2:
            return CallRef("self", (parts[1],), **common)
        if parts[0] == "self" and len(parts) == 3:
            # self.attr.m() — typed receiver via __init__ annotations
            cls = self._cls_stack[-1] if self._cls_stack else None
            recv = cls.attr_types.get(parts[1]) if cls else None
            return CallRef(
                "attr", (parts[2],), recv_type=recv, recv_name=parts[1], **common
            )
        if parts[0] in self.mod.imports:
            dotted = tuple(self.mod.imports[parts[0]].split(".")) + parts[1:]
            return CallRef("dotted", dotted, **common)
        if len(parts) >= 2:
            recv = self._local_types.get(parts[0]) if len(parts) == 2 else None
            if recv is None and parts[0] in self.mod.classes:
                recv = parts[0]  # ClassName.method(...)
            return CallRef(
                "attr", (parts[-1],), recv_type=recv, recv_name=parts[-2], **common
            )
        return None

    def _target_ref(self, node: ast.AST) -> Optional[CallRef]:
        """The callable passed to a boundary (_post/_offload/Thread/register)."""
        if isinstance(node, ast.Lambda):
            # Seed every call inside the lambda body as the boundary target.
            return None  # handled by caller via _lambda_calls
        if isinstance(node, (ast.Name, ast.Attribute)):
            fake = ast.Call(func=node, args=[], keywords=[])
            ast.copy_location(fake, node)
            return self._callref(fake)
        return None

    def _lambda_calls(self, lam: ast.Lambda) -> List[CallRef]:
        refs = []
        for sub in ast.walk(lam.body):
            if isinstance(sub, ast.Call):
                ref = self._callref(sub)
                if ref is not None:
                    refs.append(ref)
        return refs

    def _seed_targets(self, arg: ast.AST, kind: str, line: int,
                      heavy: bool = False, reg_name: str = "") -> None:
        fn = self._fn
        if fn is None:
            return
        if isinstance(arg, ast.Lambda):
            for ref in self._lambda_calls(arg):
                fn.seeds.append(Seed(kind, ref, line, heavy, reg_name))
        else:
            ref = self._target_ref(arg)
            if ref is not None:
                fn.seeds.append(Seed(kind, ref, line, heavy, reg_name))

    def visit_Call(self, node: ast.Call) -> None:
        fn = self._fn
        func = node.func
        attr = func.attr if isinstance(func, ast.Attribute) else None

        # -------- thread-context boundaries (no direct call edge recorded)
        if attr in ("_post", "_offload") and node.args:
            kind = "post" if attr == "_post" else "offload"
            self._seed_targets(node.args[0], kind, node.lineno)
            for arg in node.args[1:]:
                self.visit(arg)
            return
        if attr == "register" and len(node.args) >= 2 and isinstance(
            node.args[0], ast.Constant
        ) and isinstance(node.args[0].value, str):
            heavy = False
            for k, v in _const_kwargs(node):
                if k == "heavy":
                    heavy = bool(v)
            if len(node.args) >= 3 and isinstance(node.args[2], ast.Constant):
                heavy = bool(node.args[2].value)
            self._seed_targets(
                node.args[1], "handler", node.lineno,
                heavy=heavy, reg_name=str(node.args[0].value),
            )
            return
        parts = _dotted_parts(func)
        if parts is not None and parts[-1] in ("Thread", "Timer"):
            for kw in node.keywords:
                if kw.arg == "target":
                    self._seed_targets(kw.value, "thread", node.lineno)
            # fall through: also record the ctor call itself

        # ------------------------------------------ ordinary call recording
        if fn is not None:
            ref = self._callref(node)
            if ref is not None:
                fn.calls.append(ref)
            if (
                parts is not None
                and len(parts) == 3
                and parts[0] == "self"
                and parts[2] in MUTATOR_METHODS
            ):
                self._record_access(parts[1], node.lineno, "write")
            self._check_order_sink(node)
        self.generic_visit(node)

    # -------------------------------------------- unordered-producer tracking
    def _is_unordered_expr(self, node: ast.AST) -> Optional[str]:
        """Does this expression produce an unordered iterable?"""
        if isinstance(node, (ast.Set, ast.SetComp)):
            return "set literal"
        if isinstance(node, ast.Call):
            parts = _dotted_parts(node.func)
            if parts is not None:
                if parts[0] in self.mod.imports:
                    parts = tuple(self.mod.imports[parts[0]].split(".")) + parts[1:]
                desc = _UNORDERED_PRODUCER_CALLS.get(parts)
                if desc is None and len(parts) == 1:
                    desc = _UNORDERED_PRODUCER_CALLS.get((parts[0],))
                if desc is not None:
                    return desc
                if parts[-1] in _SET_METHODS:
                    return f"set.{parts[-1]}()"
                if parts[-1] == "iterdir":
                    return "Path.iterdir()"
        if isinstance(node, ast.Name):
            t = self._local_unordered.get(node.id)
            if t:
                return t
        parts = _dotted_parts(node)
        if parts and len(parts) == 2 and parts[0] == "self":
            cls = self._cls_stack[-1] if self._cls_stack else None
            if cls is not None and cls.attr_types.get(parts[1]) in (
                "set", "Set", "frozenset", "FrozenSet",
            ):
                return f"set-typed attribute self.{parts[1]}"
        return None

    _local_unordered: Dict[str, str] = {}

    def _record_unordered(self, node: ast.AST, line: int) -> None:
        desc = self._is_unordered_expr(node)
        if desc is not None and self._fn is not None:
            self._fn.unordered_uses.append((line, desc))

    def _check_order_sink(self, call: ast.Call) -> None:
        parts = _dotted_parts(call.func)
        if parts is None:
            return
        if (len(parts) == 1 and parts[0] in _ORDER_SINKS) or parts[-1] == "join":
            for arg in call.args:
                self._record_unordered(arg, call.lineno)

    def visit_For(self, node: ast.For) -> None:
        self._record_unordered(node.iter, node.iter.lineno)
        self.generic_visit(node)

    def visit_comprehension_iters(self, node) -> None:
        for gen in node.generators:
            self._record_unordered(gen.iter, getattr(gen.iter, "lineno", node.lineno))
        self.generic_visit(node)

    visit_ListComp = visit_comprehension_iters
    visit_GeneratorExp = visit_comprehension_iters
    visit_DictComp = visit_comprehension_iters

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # A lambda that reaches this visitor was NOT handed to a thread
        # boundary (those are consumed by the _post/_offload/register/
        # Thread branches above and seeded on the far side).  Its body runs
        # whenever some unknown caller invokes it — attributing its calls
        # to the *enclosing* function would paint deferred work with the
        # definer's thread context (e.g. a loop-side method building a
        # worker thunk).  Treat it as opaque.
        pass

    def visit_SetComp(self, node: ast.SetComp) -> None:
        # A set comprehension's own iteration order doesn't matter (the
        # result is a set); only check its source generators for sinks.
        self.generic_visit(node)

    # Track locals assigned from unordered producers / typed constructors.
    def _track_local(self, name: str, value: ast.AST) -> None:
        desc = self._is_unordered_expr(value)
        if desc is not None:
            self._local_unordered[name] = desc
        else:
            self._local_unordered.pop(name, None)
        t = self._value_type(value)
        if t is not None:
            self._local_types[name] = t

    def generic_visit(self, node: ast.AST) -> None:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            self._track_local(node.targets[0].id, node.value)
        super().generic_visit(node)


def parse_module(path: Path, root: Path) -> Optional[ModuleInfo]:
    rel = path.relative_to(root).as_posix()
    modname = rel[:-3].replace("/", ".")
    if modname.endswith(".__init__"):
        modname = modname[: -len(".__init__")]
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    mod = ModuleInfo(rel, modname)
    visitor = _ModuleVisitor(mod, source)
    # Fresh per-module mutable state (class attrs shared otherwise).
    visitor._local_types = {}
    visitor._local_unordered = {}
    visitor.visit(tree)
    return mod


def load_project(target: str, files: Optional[Sequence[str]] = None) -> Project:
    """Parse ``target`` (package dir or single file) into a Project.

    Paths in findings are relative to the *scan root*: ``target`` itself
    when it is a directory, its parent for a single file — so results are
    independent of the invoking process's cwd.
    """
    t = Path(target)
    if t.is_file():
        root = t.parent
        paths = [t]
    else:
        root = t
        paths = sorted(p for p in t.rglob("*.py"))
    if files is not None:
        paths = [Path(f) for f in files]
    project = Project(str(root))
    for path in paths:
        mod = parse_module(path, root)
        if mod is not None:
            project.modules[mod.modname] = mod
    return project
