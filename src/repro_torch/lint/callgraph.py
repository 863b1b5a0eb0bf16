"""Call-graph construction and thread-context propagation.

The rules need to know, for every function in the tree, *which thread can
execute it*. Three contexts:

  * ``LOOP``   — the selector thread of an :class:`EventLoopServer`
    subclass: its ``_loop`` method, everything it calls synchronously,
    every callable handed to ``_post``, and every ``MethodTable.register``
    handler registered without ``heavy=True`` (light handlers run inline
    in ``_service`` on the loop thread).
  * ``WORKER`` — the offload pool / spawned threads: ``_offload`` targets,
    ``heavy=True`` handlers, ``threading.Thread(target=...)`` targets.
  * ``CLIENT`` — everything else (library code, tests, the blocking
    client). Blocking there is fine.

Propagation is a fixed-point closure over resolved call edges starting
from the root sets. Boundary calls (``_post`` / ``_offload`` / ``register``
/ ``Thread(target=)``) deliberately do **not** create synchronous call
edges — the handed-over callable runs on the *other* side of the boundary,
so it seeds that side's root set instead. A function can end up in several
contexts (e.g. a helper called from both sides); rules fire on the most
restrictive one.

Call resolution is class-hierarchy-analysis by name, deliberately
over-approximate, with one guard: a method call whose receiver type is
unknown links by bare name only when the name is not in
``AMBIGUOUS_METHOD_NAMES`` (``add``/``write``/``close``/... collide with
builtin container, file, and socket methods and would wire unrelated
classes together).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .model import (
    AMBIGUOUS_METHOD_NAMES,
    CallRef,
    ClassInfo,
    FunctionInfo,
    Project,
)

LOOP = "loop"
WORKER = "worker"
CLIENT = "client"

# Class names whose subclasses own a selector loop thread. ``_loop`` on
# these (and any transitive subclass) is the canonical LOOP root.
LOOP_SERVER_BASES = frozenset({"EventLoopServer"})


@dataclasses.dataclass
class Graph:
    project: Project
    # qualname -> FunctionInfo
    functions: Dict[str, FunctionInfo]
    # qualname -> set of callee qualnames (synchronous edges only)
    edges: Dict[str, Set[str]]
    # qualname -> contexts it can run in
    contexts: Dict[str, Set[str]]
    # (reg_name, handler_qualname, heavy, module_path, line) for every
    # MethodTable.register call — the loop-heavy-handler rule reads this.
    handlers: List[Tuple[str, str, bool, str, int]]
    resolver: "_Resolver"

    def in_context(self, fn: FunctionInfo, ctx: str) -> bool:
        return ctx in self.contexts.get(fn.qualname, ())


class _Resolver:
    """Name-based call resolution over the project's symbol model."""

    def __init__(self, project: Project):
        self.project = project
        # simple class name -> [ClassInfo] (collisions kept: resolve to all)
        self.classes: Dict[str, List[ClassInfo]] = {}
        # method name -> [FunctionInfo] across every class
        self.methods: Dict[str, List[FunctionInfo]] = {}
        # function simple name -> [FunctionInfo] (module-level)
        self.module_funcs: Dict[str, List[FunctionInfo]] = {}
        for mod in project.modules.values():
            for fn in mod.functions.values():
                self.module_funcs.setdefault(fn.name.split(".")[-1], []).append(fn)
            for cls in mod.classes.values():
                self.classes.setdefault(cls.name, []).append(cls)
                for m in cls.methods.values():
                    self.methods.setdefault(m.name.split(".")[-1], []).append(m)
        self._subclasses: Dict[str, Set[str]] = {}
        for mod in project.modules.values():
            for cls in mod.classes.values():
                for b in cls.bases:
                    self._subclasses.setdefault(b, set()).add(cls.name)

    def class_closure(self, name: str, down: bool = True, up: bool = True) -> Set[str]:
        """Transitive subclass (and ancestor) closure of a class name."""
        seen = {name}
        frontier = [name]
        while frontier:
            cur = frontier.pop()
            nxt: Set[str] = set()
            if down:
                nxt |= self._subclasses.get(cur, set())
            if up:
                for ci in self.classes.get(cur, ()):
                    nxt |= set(ci.bases)
            for n in nxt:
                if n not in seen:
                    seen.add(n)
                    frontier.append(n)
        return seen

    def _methods_in(self, class_names: Set[str], meth: str) -> List[FunctionInfo]:
        out = []
        for cname in class_names:
            for ci in self.classes.get(cname, ()):
                m = ci.methods.get(meth)
                if m is not None:
                    out.append(m)
        return out

    def resolve(self, ref: CallRef, caller: FunctionInfo) -> List[FunctionInfo]:
        """Internal callees a call site may dispatch to (possibly empty)."""
        name = ref.parts[-1]
        if ref.kind == "self" and caller.cls is not None:
            targets = self._methods_in(self.class_closure(caller.cls), name)
            if targets:
                return targets
            return []
        if ref.kind == "name":
            # ClassName(...) -> __init__ of that class hierarchy
            if name in self.classes:
                return self._methods_in(self.class_closure(name, up=False), "__init__")
            mod = caller.module
            if name in mod.functions:
                return [mod.functions[name]]
            return list(self.module_funcs.get(name, ()))
        if ref.kind == "super":
            if caller.cls is None:
                return []
            ancestors = self.class_closure(caller.cls, down=False) - {caller.cls}
            return self._methods_in(ancestors, name)
        if ref.kind == "attr":
            if ref.recv_type is not None and ref.recv_type in self.classes:
                return self._methods_in(self.class_closure(ref.recv_type), name)
            if name in AMBIGUOUS_METHOD_NAMES:
                return []  # too generic to link by name alone
            return list(self.methods.get(name, ()))
        return []  # dotted external calls never resolve internally


def _loop_server_classes(resolver: _Resolver) -> Set[str]:
    names: Set[str] = set()
    for base in LOOP_SERVER_BASES:
        names |= resolver.class_closure(base, up=False)
    return names


def build_graph(project: Project) -> Graph:
    resolver = _Resolver(project)
    functions = {fn.qualname: fn for fn in project.all_functions()}

    edges: Dict[str, Set[str]] = {q: set() for q in functions}
    loop_roots: Set[str] = set()
    worker_roots: Set[str] = set()
    handlers: List[Tuple[str, str, bool, str, int]] = []

    loop_classes = _loop_server_classes(resolver)
    for fn in functions.values():
        if fn.cls in loop_classes and fn.name == "_loop":
            loop_roots.add(fn.qualname)
        for ref in fn.calls:
            for callee in resolver.resolve(ref, fn):
                edges[fn.qualname].add(callee.qualname)
        for seed in fn.seeds:
            targets = resolver.resolve(seed.target, fn)
            if seed.kind == "handler":
                for t in targets:
                    handlers.append(
                        (seed.reg_name, t.qualname, seed.heavy,
                         fn.module.path, seed.line)
                    )
            for t in targets:
                if seed.kind == "post":
                    loop_roots.add(t.qualname)
                elif seed.kind in ("offload", "thread"):
                    worker_roots.add(t.qualname)
                elif seed.kind == "handler":
                    (worker_roots if seed.heavy else loop_roots).add(t.qualname)

    contexts: Dict[str, Set[str]] = {q: set() for q in functions}

    def closure(roots: Set[str], ctx: str) -> None:
        frontier = [q for q in roots if q in contexts]
        for q in frontier:
            contexts[q].add(ctx)
        while frontier:
            cur = frontier.pop()
            for callee in edges.get(cur, ()):
                if ctx not in contexts[callee]:
                    contexts[callee].add(ctx)
                    frontier.append(callee)

    closure(loop_roots, LOOP)
    closure(worker_roots, WORKER)
    # Everything reachable outside L∪W runs on arbitrary caller threads.
    client_roots = {q for q, c in contexts.items() if not c}
    closure(client_roots, CLIENT)

    return Graph(project, functions, edges, contexts, handlers, resolver)
