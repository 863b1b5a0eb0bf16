"""repro_torch.lint — concurrency & determinism static analysis for this repo.

The event-loop stack (``net/server.py``, ``viz/gateway.py``) and the
byte-determinism promises (golden traces, topology bit-equality) rest on
invariants Python neither types nor checks: no blocking call may run on the
selector loop thread, state shared across the loop/worker/client thread
contexts must be lock-disciplined, and modules on the byte-deterministic
export path must not iterate unordered containers or read wall clocks.
This package encodes those invariants as an AST-based analysis with a
call-graph context classifier and three rule families:

  * **loop-hazard** — blocking primitives (sleep, blocking socket ops, file
    IO, ``Future.result``, bare ``Lock.acquire``, subprocess) reachable from
    loop context; ``MethodTable.register`` handlers doing bulk reads
    without ``heavy=True``.
  * **lockset** — instance attributes written under ``with self._lock`` in
    one method but accessed bare from a different thread context; bare
    counter increments on loop/worker threads.
  * **determinism** — unordered iteration (sets, ``os.listdir``/``glob``),
    wall-clock reads, and ``random`` use inside modules marked
    ``# lint: deterministic``.

Run it as ``python -m repro_torch.lint src/ [--format=text|json]``; see
``docs/lint.md`` for the rule catalog, the ``# lint: ignore[rule]``
suppression syntax, and the baseline workflow (``tools/lint_baseline.json``).

The heavyweight analysis lives behind lazy imports so the runtime
companion (:mod:`repro_torch.lint.runtime`, the thread-ownership sanitizer wired
into the servers' hot paths) costs nothing in production processes.
"""
from __future__ import annotations

__all__ = ["run_analysis", "RULE_IDS"]

# Rule ids, stable across releases — the catalog docs/lint.md documents.
RULE_IDS = (
    "loop-blocking-sleep",
    "loop-blocking-io",
    "loop-blocking-sync",
    "loop-blocking-socket",
    "loop-subprocess",
    "loop-heavy-handler",
    "lockset-mixed",
    "lockset-counter",
    "det-unordered-iter",
    "det-wallclock",
    "det-random",
)


def run_analysis(target, rules=None):
    """Analyze ``target`` (a file or package directory); return Findings.

    Lazy wrapper around :func:`repro_torch.lint.rules.analyze` so importing
    :mod:`repro_torch.lint` (e.g. for :mod:`repro_torch.lint.runtime`) stays cheap.
    """
    from .rules import analyze

    return analyze(target, rules=rules)
