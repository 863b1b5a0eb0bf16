"""The PyTorch port's twin of examples/serve_monitored.py: batched
prefill+decode with online trace analysis, through ``repro_torch.launch.serve``.

Runs the continuous-batching serving loop on a reduced qwen2-vl decoder
(M-RoPE), streams per-phase trace frames to Chimbuko, and prints
throughput plus the monitor's view of the run (per-phase call statistics,
anomalies).  Runs on cuda:0, where prefill attention runs the flash
kernel; ``--device cpu`` runs the plain versions on the CPU.

    PYTHONPATH=src python examples/serve_monitored_torch.py [--device cpu]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.trace.monitor import ChimbukoMonitor  # noqa: E402

# The JAX example's monitor settings and traffic.
MONITOR = dict(num_funcs=16, min_samples=8, straggler_min_steps=8)
TRAFFIC = dict(arch="qwen2-vl-2b",  # M-RoPE decoder, reduced config
               smoke=True, n_requests=12, batch=4, prompt_len=16, max_new=12)


def profile(monitor: ChimbukoMonitor):
    """The per-phase profile from the PS (the paper's 'profile
    statistics'): one line per function that was called."""
    snap = monitor.ps.snapshot()
    return [f"  {name:22s} n={snap.counts()[fid]:5.0f} "
            f"mean={snap.means()[fid]:9.0f} std={snap.stds()[fid]:8.0f}"
            for fid, name in monitor.registry.names.items() if snap.counts()[fid] > 0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda:0")
    args = ap.parse_args()
    monitor = ChimbukoMonitor(**MONITOR)
    out = serve(monitor=monitor, device=args.device, **TRAFFIC)
    print("=== serving summary ===")
    print(f"requests={out['requests']} tokens={out['tokens']} "
          f"throughput={out['tok_per_s']:.1f} tok/s")
    print("sample continuations:", out["samples"])
    print("\nmonitor:", json.dumps(out["monitor"], indent=2))
    print("\nper-phase profile (us):")
    for line in profile(monitor):
        print(line)
    monitor.close()


if __name__ == "__main__":
    main()
