"""The drivers, one a kind of call that a window drives: ``run(ctx)`` of
each returns the run's :class:`benchmark.harness.Outcome`. A cell names
its driver in its file; the harness imports ``benchmark.drivers.<name>``."""
