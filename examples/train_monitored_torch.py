"""The PyTorch port's twin of examples/train_monitored.py: train a ~100M-param
model with full Chimbuko monitoring, fault injection, checkpoint-restart and
straggler detection, through ``repro_torch.launch.train``.

The model is a scaled gemma-style decoder (~100M params) trained for a few
hundred steps on the deterministic synthetic stream.  Mid-run we inject a
node failure (the driver restarts from the latest atomic checkpoint and the
loss curve continues exactly) and a straggler (detected online by the
step-time detector).  Runs on cuda:0; ``--device cpu`` runs on the CPU.

    PYTHONPATH=src python examples/train_monitored_torch.py [--steps 200] [--device cpu]
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.launch.steps import StepOptions  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402


def model_100m():
    """~100M-param gemma-style decoder."""
    base = configs.get_config("gemma-2b")
    return dataclasses.replace(
        base, name="gemma-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=1, head_dim=64, d_ff=2048, vocab=32768,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    args = ap.parse_args()

    cfg = model_100m()
    print(f"model: {cfg.name}  params={cfg.n_params()/1e6:.1f}M")
    # register so train() can look it up
    orig_get = configs.get_config
    configs.get_config = lambda n: cfg if n == cfg.name else orig_get(n)

    wd = args.workdir or tempfile.mkdtemp(prefix="train_monitored_torch_")
    ckpt = os.path.join(wd, "ckpt")
    mon = os.path.join(wd, "monitor")
    os.makedirs(mon, exist_ok=True)
    kw = dict(
        arch=cfg.name, smoke=False, steps=args.steps,
        global_batch=args.global_batch, seq=args.seq,
        ckpt_dir=ckpt, monitor_dir=mon, ckpt_interval=25,
        inject_straggler_at=min(args.steps - 10, 150), log_every=20,
        opts=StepOptions(ce_chunk=args.seq,
                         opt=OptConfig(peak_lr=3e-4, warmup_steps=50,
                                       decay_steps=args.steps)),
        device=args.device,
    )

    print("\n--- phase 1: run with injected failure at 40% ---")
    try:
        train(fail_at=int(args.steps * 0.4), **kw)
    except RuntimeError as e:
        print(f"[driver] caught: {e} — restarting from checkpoint")

    print("\n--- phase 2: auto-restart to completion ---")
    out = train(**kw)

    print("\n=== run summary ===")
    print(json.dumps(out["monitor"], indent=2))
    first, last = out["history"][0], out["history"][-1]
    print(f"loss: {first['loss']:.3f} (step {first['step']}) -> "
          f"{last['loss']:.3f} (step {last['step']})")
    print(f"artifacts: {wd}")
    assert last["loss"] < first["loss"], "loss must improve"


if __name__ == "__main__":
    main()
