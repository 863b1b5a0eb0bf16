"""monitor_ms_per_wave: host milliseconds in the monitor's record_step_times
and ingest calls, per wave, over the window (the benchmark's own clock
around those calls)."""


def read(run):
    return 1e3 * sum(w.monitor_s for w in run.waves) / len(run.waves)
