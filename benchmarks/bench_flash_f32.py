"""Float32 flash attention on one CUDA card: builds of its source, side by side.

    python benchmarks/bench_flash_f32.py [--source A.cu --source B.cu ...] [--rounds 2]

Each ``--source`` (default: the package's own
``src/repro_torch/kernels/csrc/flash_attention.cu``) is compiled with the
package's nvcc flags (``kernels/_build.py``; one nvcc per source, all
started together) and loaded as a library of its own; a source must export
the package's C entry ``flash_attention_launch``.  For each source:

* ptxas's line (registers, spills) of every float32 instance and its wgmma
  notes (C75xx);
* the float32 comparisons of chip_smoke.py's flash phase (the test shapes,
  kv_len, the ragged shapes, a seeded sweep of float32 shapes and the model
  waves), each within 2e-5 of the plain version (``kernels/ref.py``), and
  two launches at each model wave bitwise equal;
* at each model wave (gemma-2b hd 256, granite-moe hd 64, qwen2-vl-2b hd
  128, float32, causal) the device time of one call (the split prologue
  and the attention kernel, torch.profiler) and its CUDA-event time, taken
  in turns (sources in order, then reversed, ``--rounds`` times), beside
  the bound (chip_smoke.py:flash_bound).

Prints the card's name and power limit, then one JSON object as its last
line, also written to ``chiprun_out/bench_flash_f32.json``.

``flash_f32_hd256_two_consumers.patch`` beside this script is the
two-consumer layout at hd 256 that the source note of the float32 instance
weighs against its one consumer; to measure the two side by side:

    mkdir -p build/ab && cp src/repro_torch/kernels/csrc/flash_attention.cu build/ab/one.cu
    cp build/ab/one.cu build/ab/two.cu
    patch build/ab/two.cu benchmarks/flash_f32_hd256_two_consumers.patch
    python benchmarks/bench_flash_f32.py --source build/ab/one.cu --source build/ab/two.cu
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402  (the flash phase's shapes, inputs, bound and timers)

SWEEP = 40  # seeded float32 shapes per source
OUT = ROOT / "chiprun_out" / "bench_flash_f32.json"


def build(sources):
    """{source: (library path, nvcc output)}, compiled in parallel."""
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "bench_flash_f32"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sources:
        digest = hashlib.sha256(Path(src).read_bytes()
                                + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = out_dir / f"{Path(src).stem}-{digest}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        jobs[src] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    built = {}
    for src, (lib, proc) in jobs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{text}")
        built[src] = (lib, text)
    return built


def float32_ptxas(text: str) -> dict:
    """{hd: ptxas's registers-and-spills line} of each float32 instance, and
    "notes": ptxas's wgmma notes."""
    facts, current = {}, None
    for line in text.splitlines():
        m = re.search(r"flash_fwd_wgmma_f32ILi(\d+)E", line)
        if "Compiling entry function" in line:
            current = int(m.group(1)) if m else None
        elif current is not None and ("registers" in line or "spill" in line):
            facts.setdefault(current, []).append(line.replace("ptxas info    :", "").strip())
    out = {hd: "; ".join(lines) for hd, lines in sorted(facts.items())}
    out["notes"] = sorted({line.strip() for line in text.splitlines()
                           if re.search(r"\(C75\d\d\)", line)})
    return out


def launcher(lib: Path):
    fn = ctypes.CDLL(str(lib)).flash_attention_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, i, p, p]
    fn.restype = i
    return fn


def use(fa, fn) -> None:
    """Route kernels/flash_attention.py's wrapper to the library ``fn``."""
    fa._launcher = lambda: fn


def check(dev, fa) -> dict:
    """The float32 comparisons; raises beyond 2e-5.  Returns the largest
    error at each model wave."""
    import torch

    from repro_torch.kernels.ref import flash_attention_ref

    def compare(what, case, seed, kv_len=None):
        q, k, v = cs._flash_inputs(dev, case, seed)
        kw = dict(causal=case[6], window=case[7], cap=case[8], kv_len=kv_len)
        got = fa.flash_attention(q, k, v, **kw) if case[5] in fa.HEAD_DIMS else None
        if got is None:  # a head dim the kernel pads to (as ops.flash_attention does)
            from repro_torch.kernels import ops
            got = ops.flash_attention(q, k, v, **kw)
        agree = cs.OutputAgreement()
        agree.check(what, got, flash_attention_ref(q, k, v, **kw), cs.FLASH_TOL["float32"])
        return q, k, v, got, agree.max_abs

    f32 = lambda cases: [c for c in cases if c[9] == "float32"]  # noqa: E731
    for i, case in enumerate(f32(cs.FLASH_CASES)):
        compare(f"case {i} {case}", case, case[5] + case[1] + case[3])
    compare("kv_len=77", (1, 64, 128, 2, 2, 64, False, 0, 0.0, "float32"), 1, kv_len=77)
    compare("kv_len=0", (1, 64, 128, 2, 2, 256, False, 0, 0.0, "float32"), 1, kv_len=0)
    for case in f32(cs.FLASH_RAGGED):
        compare(f"ragged {case}", case, sum(case[1:3]))
    rng = np.random.default_rng(cs.SEED)
    for i in range(SWEEP):
        KV, G = int(rng.choice([1, 2, 4])), int(rng.choice([1, 2, 4, 8]))
        case = (int(rng.integers(1, 4)), int(rng.integers(1, 300)), int(rng.integers(1, 300)),
                KV * G, KV, int(rng.choice([64, 128, 200, 256])), bool(rng.integers(0, 2)),
                int(rng.choice([0, 0, 1, 7, 64, 150])), float(rng.choice([0.0, 0.0, 5.0, 30.0])),
                "float32")
        kv_len = None if rng.random() < 0.6 else int(rng.integers(0, case[2] + 5))
        compare(f"sweep {i} {case} kv_len={kv_len}", case, i, kv_len=kv_len)
    errs = {}
    for arch, case in cs.FLASH_F32.items():
        q, k, v, out, errs[arch] = compare(f"{arch} {case}", case, cs.SEED)
        again = fa.flash_attention(q, k, v, causal=True)
        if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"{arch}: two launches on the same input differ")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=None,
                    help="a flash_attention.cu to build and measure (repeatable)")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of turns per shape")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_flash_f32: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.device import parity_mode
    from repro_torch.kernels import flash_attention as fa

    parity_mode()  # float32 products in full float32 in the plain version
    sources = args.source or [str(ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu")]
    dev = torch.device("cuda", 0)
    built = build(sources)
    fns = {src: launcher(lib) for src, (lib, _) in built.items()}
    result = {"sources": {}, "shapes": {}}
    for src, fn in fns.items():
        use(fa, fn)
        result["sources"][src] = {"ptxas": float32_ptxas(built[src][1]),
                                  "max_abs_err": check(dev, fa)}
        print(f"{src}: {json.dumps(result['sources'][src])}", flush=True)
    order = sources + sources[::-1]
    for arch, case in cs.FLASH_F32.items():
        q, k, v = cs._flash_inputs(dev, case, cs.SEED)
        call = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
        outs, device, event = {}, {s: [] for s in sources}, {s: [] for s in sources}
        for _ in range(args.rounds):
            for src in order:
                use(fa, fns[src])
                outs[src] = call()
                event[src].append(cs.cuda_ms(call, iters=20))
                device[src].append(cs.flash_call_device_ms(cs.device_ms_by_kernel(call, 5)))
        base = outs[sources[0]].view(torch.int32)
        result["shapes"][arch] = {
            "case": case, "bound_ms": cs.flash_bound(case)["bound_ms"],
            "cuda_core_ms": cs.flash_bound(case)["cuda_core_ms"],
            **{src: {"device_ms": device[src], "event_ms": event[src],
                     "bitwise_equal_to_first": bool(torch.equal(outs[src].view(torch.int32),
                                                                base))}
               for src in sources}}
        print(f"{arch} {case[:6]}: " + "; ".join(
            f"{Path(s).name} device " + ", ".join(f"{m * 1e3:.1f}" for m in device[s])
            + " us, event " + ", ".join(f"{m * 1e3:.1f}" for m in event[s]) + " us"
            for s in sources) + f"; bound {result['shapes'][arch]['bound_ms'] * 1e3:.2f} us",
            flush=True)
        del q, k, v, outs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    result["card"] = smi
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
