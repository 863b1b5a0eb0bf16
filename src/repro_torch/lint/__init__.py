"""repro_torch.lint -- the runtime half of ``repro.lint``.

Only :mod:`repro_torch.lint.runtime`, the thread-ownership sanitizer that
the event-loop server (``net/server.py``) asserts on its hot paths, is
copied here.  The static analysis (``rules``, ``callgraph``, the CLI)
waits for ROADMAP.md queue 1, item 2d.
"""
