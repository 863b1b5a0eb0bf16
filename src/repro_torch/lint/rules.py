"""The rule families: loop-hazard, lockset, determinism.

Each rule walks the parsed model plus the context-classified call graph
and yields :class:`~repro_torch.lint.model.Finding` objects. ``analyze`` is the
single entry point: parse → build graph → run rules → drop suppressed →
sort. See ``docs/lint.md`` for the catalog with examples and the exact
semantics of every heuristic below.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .callgraph import CLIENT, LOOP, WORKER, Graph, build_graph
from .model import Access, CallRef, Finding, FunctionInfo, Project, load_project

# ----------------------------------------------------------- primitive tables
# Dotted-call prefixes that block, keyed to the rule that owns them.
_SLEEP_CALLS = {("time", "sleep")}
_SUBPROCESS_ROOTS = ("subprocess",)
_SUBPROCESS_CALLS = {("os", "system"), ("os", "popen")}
_SOCKET_DOTTED = {("socket", "create_connection")}
_IO_DOTTED = {
    ("os", "fsync"),
    ("os", "replace"),
    ("os", "remove"),
    ("os", "unlink"),
    ("os", "makedirs"),
    ("os", "rename"),
    ("shutil",),
}
_WALLCLOCK_DOTTED = {
    ("time", "time"),
    ("time", "time_ns"),
    ("datetime", "datetime", "now"),
    ("datetime", "datetime", "utcnow"),
    ("datetime", "date", "today"),
}
_RANDOM_ROOTS = ("random",)
_RANDOM_DOTTED = {("uuid", "uuid1"), ("uuid", "uuid4")}

# Socket methods that block unless the socket is non-blocking *and* the call
# sits in a try that catches BlockingIOError (the event loop's own idiom).
_SOCKET_GUARDABLE = frozenset(("recv", "recv_into", "send", "accept"))
_SOCKET_ALWAYS = frozenset(("sendall", "connect", "makefile"))

# File-object methods + the receiver shapes that mark a file handle.
_FILE_METHODS = frozenset(
    ("write", "flush", "read", "readline", "readlines", "seek", "truncate")
)
_FILE_RECV_RE = re.compile(r"(?:^|_)(?:fh|file|fp|stream|log)$", re.IGNORECASE)
_FILE_RECV_TYPES = frozenset(
    (
        "TextIOBase",
        "IOBase",
        "RawIOBase",
        "BufferedIOBase",
        "TextIOWrapper",
        "BufferedWriter",
        "BufferedReader",
        "TextIO",
        "BinaryIO",
    )
)
_FILE_METHODS_ALWAYS = frozenset(
    ("read_text", "write_text", "read_bytes", "write_bytes")
)

# Method names that signal a bulk read when reachable from a light handler.
_BULK_RE = re.compile(
    r"(?:^|_)(?:peek|dump|query|snapshot|export|take_resumed|read_all)"
)


def _match_dotted(parts: Tuple[str, ...], table: Iterable[Tuple[str, ...]]) -> bool:
    return any(parts[: len(p)] == p for p in table)


def _fmt(parts: Tuple[str, ...]) -> str:
    return ".".join(parts)


class _RuleContext:
    def __init__(self, graph: Graph):
        self.graph = graph
        self.findings: List[Finding] = []
        self._resolved: Dict[int, bool] = {}

    def emit(self, rule: str, fn: FunctionInfo, line: int, message: str) -> None:
        self.findings.append(
            Finding(rule, fn.module.path, line, fn.local_name, message)
        )

    def resolves_internally(self, ref: CallRef, fn: FunctionInfo) -> bool:
        """True when the call dispatches to code we analyzed (then the
        callee's own body is where any hazard gets reported)."""
        key = id(ref)
        hit = self._resolved.get(key)
        if hit is None:
            hit = bool(self.graph.resolver.resolve(ref, fn))
            self._resolved[key] = hit
        return hit


# ------------------------------------------------------------ loop-hazard
def _loop_rules(ctx: _RuleContext) -> None:
    g = ctx.graph
    for fn in g.functions.values():
        if not g.in_context(fn, LOOP):
            continue
        for ref in fn.calls:
            name = ref.parts[-1]
            if ref.kind == "dotted":
                if ref.parts in _SLEEP_CALLS:
                    ctx.emit(
                        "loop-blocking-sleep", fn, ref.line,
                        f"time.sleep() reachable from the event-loop thread "
                        f"(contexts: {_ctxs(g, fn)})",
                    )
                elif (
                    ref.parts[0] in _SUBPROCESS_ROOTS
                    or _match_dotted(ref.parts, _SUBPROCESS_CALLS)
                ):
                    ctx.emit(
                        "loop-subprocess", fn, ref.line,
                        f"subprocess call {_fmt(ref.parts)}() on the "
                        f"event-loop thread",
                    )
                elif _match_dotted(ref.parts, _SOCKET_DOTTED):
                    ctx.emit(
                        "loop-blocking-socket", fn, ref.line,
                        f"{_fmt(ref.parts)}() blocks; connect off-loop or "
                        f"use a non-blocking socket",
                    )
                elif _match_dotted(ref.parts, _IO_DOTTED):
                    ctx.emit(
                        "loop-blocking-io", fn, ref.line,
                        f"file-system call {_fmt(ref.parts)}() on the "
                        f"event-loop thread",
                    )
                continue
            if ref.kind == "name" and name == "open":
                if not ctx.resolves_internally(ref, fn):
                    ctx.emit(
                        "loop-blocking-io", fn, ref.line,
                        "open() on the event-loop thread",
                    )
                continue
            if ref.kind not in ("attr", "self"):
                continue
            if ctx.resolves_internally(ref, fn):
                continue  # hazards reported inside the resolved callee
            if name in _SOCKET_ALWAYS:
                ctx.emit(
                    "loop-blocking-socket", fn, ref.line,
                    f".{name}() blocks even on non-blocking sockets "
                    f"(loop thread)",
                )
            elif name in _SOCKET_GUARDABLE and not ref.in_blockingio_try:
                ctx.emit(
                    "loop-blocking-socket", fn, ref.line,
                    f".{name}() on the loop thread without a "
                    f"BlockingIOError guard",
                )
            elif name == "result":
                ctx.emit(
                    "loop-blocking-sync", fn, ref.line,
                    "Future.result() parks the event-loop thread",
                )
            elif name == "wait":
                ctx.emit(
                    "loop-blocking-sync", fn, ref.line,
                    ".wait() parks the event-loop thread",
                )
            elif name == "acquire" and ref.n_args == 0 and not any(
                k in ("blocking", "timeout") for k, _ in ref.kwargs
            ):
                ctx.emit(
                    "loop-blocking-sync", fn, ref.line,
                    "bare Lock.acquire() can park the event-loop thread; "
                    "use acquire(blocking=False) or restructure",
                )
            elif name in _FILE_METHODS_ALWAYS:
                ctx.emit(
                    "loop-blocking-io", fn, ref.line,
                    f"Path.{name}() on the event-loop thread",
                )
            elif name in _FILE_METHODS and _is_file_recv(ref):
                ctx.emit(
                    "loop-blocking-io", fn, ref.line,
                    f"file .{name}() on the event-loop thread "
                    f"(receiver {ref.recv_name!r})",
                )


def _is_file_recv(ref: CallRef) -> bool:
    if ref.recv_type is not None and ref.recv_type in _FILE_RECV_TYPES:
        return True
    return ref.recv_name is not None and bool(_FILE_RECV_RE.search(ref.recv_name))


def _ctxs(g: Graph, fn: FunctionInfo) -> str:
    return ",".join(sorted(g.contexts.get(fn.qualname, ())))


def _heavy_handler_rule(ctx: _RuleContext) -> None:
    """Light (inline-on-loop) handlers must not reach bulk-read methods."""
    g = ctx.graph
    for reg_name, handler_q, heavy, mod_path, line in g.handlers:
        if heavy:
            continue
        reach = _reachable(g, handler_q)
        bulky = sorted(
            q for q in reach
            if _BULK_RE.search(q.rsplit(".", 1)[-1])
        )
        # Unresolved bulk-named method calls inside the closure count too.
        for q in reach:
            fn = g.functions.get(q)
            if fn is None:
                continue
            for ref in fn.calls:
                if (
                    ref.kind in ("attr", "self")
                    and _BULK_RE.search(ref.parts[-1])
                    and not ctx.resolves_internally(ref, fn)
                ):
                    bulky.append(f"{q}->.{ref.parts[-1]}()")
        if bulky:
            handler = g.functions.get(handler_q)
            symbol = handler.local_name if handler else handler_q
            ctx.findings.append(
                Finding(
                    "loop-heavy-handler", mod_path, line, symbol,
                    f"handler {reg_name!r} runs inline on the loop thread "
                    f"but reaches bulk read(s): {', '.join(sorted(set(bulky))[:3])}"
                    f" — register with heavy=True",
                )
            )


def _reachable(g: Graph, root: str) -> Set[str]:
    seen = {root}
    frontier = [root]
    while frontier:
        for callee in g.edges.get(frontier.pop(), ()):
            if callee not in seen:
                seen.add(callee)
                frontier.append(callee)
    return seen


# ---------------------------------------------------------------- lockset
def _lockset_rules(ctx: _RuleContext) -> None:
    g = ctx.graph
    for mod in g.project.modules.values():
        for cls in mod.classes.values():
            if cls.lock_attrs:
                _lockset_mixed_for_class(ctx, cls)
            _lockset_counter_for_class(ctx, cls)


def _lockset_mixed_for_class(ctx, cls) -> None:
    """Classic lockset discipline, per attribute:

    * a bare *read* races iff the attribute is *written* under a lock in
      some other context-capable method;
    * a bare *write* races as soon as any *locked access* (read or write)
      exists — whoever takes the lock to look is being undermined.
    """
    g = ctx.graph
    locked_writes: Dict[str, List[FunctionInfo]] = {}
    locked_any: Dict[str, List[FunctionInfo]] = {}
    bare: Dict[str, List[Tuple[FunctionInfo, Access]]] = {}
    for m in cls.methods.values():
        for acc in m.accesses:
            if acc.attr in cls.lock_attrs or acc.in_init:
                continue
            if acc.locks:
                locked_any.setdefault(acc.attr, []).append(m)
                if acc.kind in ("write", "aug"):
                    locked_writes.setdefault(acc.attr, []).append(m)
            else:
                bare.setdefault(acc.attr, []).append((m, acc))
    for attr, accesses in bare.items():
        seen_methods: Set[str] = set()
        for m, acc in accesses:
            counterpart = (
                locked_any if acc.kind in ("write", "aug") else locked_writes
            ).get(attr)
            if not counterpart:
                continue
            if m.qualname in seen_methods:
                continue  # one finding per (attr, method)
            # Same-thread pairs are fine: if both sides only ever run on
            # the loop thread there is no second thread to race with.
            mc = g.contexts.get(m.qualname, set())
            locked_methods = {lm.qualname for lm in counterpart}
            if all(
                mc == {LOOP} and g.contexts.get(lm, set()) == {LOOP}
                for lm in locked_methods
            ):
                continue
            seen_methods.add(m.qualname)
            lm_names = sorted(lm.rsplit(".", 1)[-1] for lm in locked_methods)
            ctx.emit(
                "lockset-mixed", m, acc.line,
                f"self.{attr} accessed without the lock ({acc.kind}), but "
                f"lock-guarded in {', '.join(lm_names[:3])}() — "
                f"contexts here: {_ctxs(g, m)}",
            )


def _lockset_counter_for_class(ctx, cls) -> None:
    g = ctx.graph
    for m in cls.methods.values():
        mc = g.contexts.get(m.qualname, set())
        if not (LOOP in mc or WORKER in mc):
            continue
        for acc in m.accesses:
            if (
                acc.kind == "aug"
                and not acc.locks
                and not acc.in_init
                and not acc.attr.startswith("_")
            ):
                ctx.emit(
                    "lockset-counter", m, acc.line,
                    f"unlocked increment of public counter self.{acc.attr} "
                    f"on a {'/'.join(sorted(mc))} thread — readers on other "
                    f"threads can observe torn updates",
                )


# ----------------------------------------------------------- determinism
def _det_rules(ctx: _RuleContext) -> None:
    g = ctx.graph
    for mod in g.project.modules.values():
        if not mod.deterministic:
            continue
        fns = list(mod.functions.values())
        for cls in mod.classes.values():
            fns.extend(cls.methods.values())
        for fn in fns:
            for line, desc in fn.unordered_uses:
                ctx.emit(
                    "det-unordered-iter", fn, line,
                    f"iteration over {desc} feeds output in a "
                    f"byte-deterministic module — wrap in sorted()",
                )
            for ref in fn.calls:
                if ref.kind != "dotted":
                    continue
                if _match_dotted(ref.parts, _WALLCLOCK_DOTTED):
                    ctx.emit(
                        "det-wallclock", fn, ref.line,
                        f"{_fmt(ref.parts)}() in a byte-deterministic "
                        f"module — stamp outputs from frame metadata instead",
                    )
                elif ref.parts[0] in _RANDOM_ROOTS or _match_dotted(
                    ref.parts, _RANDOM_DOTTED
                ) or ref.parts[:2] == ("numpy", "random"):
                    ctx.emit(
                        "det-random", fn, ref.line,
                        f"{_fmt(ref.parts)}() in a byte-deterministic module",
                    )


# ------------------------------------------------------------------ driver
def analyze(
    target: str,
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Run every rule over ``target``; return unsuppressed findings sorted
    by (path, line, rule). ``rules`` optionally restricts to a subset of
    rule ids."""
    project = load_project(target)
    return analyze_project(project, rules=rules)


def analyze_project(
    project: Project, rules: Optional[Sequence[str]] = None
) -> List[Finding]:
    graph = build_graph(project)
    ctx = _RuleContext(graph)
    _loop_rules(ctx)
    _heavy_handler_rule(ctx)
    _lockset_rules(ctx)
    _det_rules(ctx)

    out = []
    by_path = {m.path: m for m in project.modules.values()}
    for f in ctx.findings:
        if rules is not None and f.rule not in rules:
            continue
        mod = by_path.get(f.path)
        if mod is not None and mod.suppressed(f.rule, f.line, f.symbol):
            continue
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol))
    # Dedupe identical findings (e.g. a call both matched and re-walked).
    deduped = []
    for f in out:
        if not deduped or deduped[-1] != f:
            deduped.append(f)
    return deduped
