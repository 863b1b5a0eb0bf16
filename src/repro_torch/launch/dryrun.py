"""Dry run on the meta device: every (arch × shape) cell's costs and memory
without allocating it (port of ``repro.launch.dryrun``).

Per cell this script:
  1. builds the cell's step function and its arguments as meta tensors
     (``launch.steps.make_cell``: the step the launchers run, on shape
     stand-ins);
  2. runs it under the counting context (``compat.CostCounter``): FLOPs,
     bytes accessed, transcendentals, the collectives it issues, and the
     peak of live tensor bytes (arguments, activations, autograd's saved
     tensors);
  3. writes a JSON record with JAX's keys: ``memory``, ``cost``,
     ``collectives``, ``model_flops_global``, ``n_params``,
     ``n_active_params`` and ``roofline`` (on the H100's numbers,
     ``launch.roofline.HW``), and ``fits_80gb_hbm`` where JAX has
     ``fits_16gb_hbm``.

Eager counting counts every layer and every microbatch, where XLA counts a
loop body once.  A cell is counted at its full depth; a train cell of
many microbatches at 2 of them (a later microbatch holds what the second
does), its costs then extended by the cost of one more microbatch times
the rest, that cost taken at 1 and 2 periods and extrapolated to the full
depth, ``C(1) + (n − 1)(C(2) − C(1))`` (``evaluate``): 128 microbatches
of a 64-layer Mamba model would take hours of host time op by op.  The
extrapolation equals the direct count (tests/test_torch_dryrun.py), and
the count checks it on every cell.  The peak memory is never
extrapolated: the peak is the largest of several phases' (the forward,
the cross-entropy chunks, the backward, the optimizer's largest leaf),
each growing with the depth at its own rate.

The meta device cannot run a kernel, so prefill's attention and scan take
their plain versions (``ShardCtx(plain=True)``); ``bytes accessed`` is op
by op, unfused, an upper bound.  One device: ``--mesh none``, ``devices``
1, ``tp`` 1.

``--mesh single|multi|both``: JAX's 256- and 512-chip production meshes
(``launch.mesh.make_production_mesh``), counted on rank 0.  No XLA
partitions the step: the port's meshed step is one rank's eager SPMD
program (every rank passes the global batch, or its placed rows, and
computes its blocks), so rank 0's step under the counter is what a
device runs, as JAX's ``cost_analysis`` is per device; its collectives
run on a ``"fake"`` process group (no data moves) and are recorded.  The
process owns that group: without one the dry run starts a fake group of
512 ranks (the 256-rank mesh takes its first 256, as JAX takes
``devices[:n]``), and a real group in place makes it raise.  Rank 0 is
not every rank: it computes no halo in the sequence-parallel Mamba mixer
(``seq_shard``), and holds the first block of every split leaf.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh none|single|multi|both]
      [--skip-existing] [--probes]
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import json
import logging
import os
import sys
import time
import traceback
from typing import Dict, Tuple

from .. import configs
from ..compat import CostCounter, cost_analysis, storage_bytes
from . import roofline as R
from .mesh import batch_shards, make_production_mesh, tp_size
from .steps import StepOptions, auto_microbatch, make_cell

FAKE_WORLD = 512  # the fake process group the dry run starts: the larger mesh's ranks
MESHES = {"none": ("none",), "single": ("single",), "multi": ("multi",),
          "both": ("single", "multi")}


def production_mesh(name: str):
    """JAX's production mesh ``name`` ("single": (16, 16), "multi": (2, 16,
    16)) as rank 0 of a fake process group sees it, on the CPU device type
    (meta tensors move nowhere).  Starts a fake group of :data:`FAKE_WORLD`
    ranks when none is initialised; raises when a real one is, since the
    dry run never runs a collective that moves data."""
    import torch.distributed as dist

    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=FAKE_WORLD)
    elif dist.get_backend() != "fake":
        raise RuntimeError(f"the dry run on a mesh counts rank 0 of a fake process group; "
                           f"a {dist.get_backend()} group is in place")
    if dist.get_rank() != 0:
        raise RuntimeError(f"the dry run counts rank 0, this process is rank {dist.get_rank()}")
    return make_production_mesh(multi_pod=name == "multi", device_type="cpu")


def _devices_dp_tp(mesh) -> Tuple[int, int, int]:
    """(devices, data-parallel size, model-axis size): (1, 1, 1) on one device."""
    if mesh is None:
        return 1, 1, 1
    return mesh.size(), batch_shards(mesh), tp_size(mesh)


def count(cell) -> dict:
    """Run ``cell`` once under a :class:`CostCounter`."""
    counter = CostCounter()
    with counter:
        counter.hold(cell.args)
        out = cell.run()
    ca = cost_analysis(counter)
    coll = R.collective_bytes(counter.collectives)
    args, outs = storage_bytes(cell.args), storage_bytes(out)
    return {
        "flops": ca["flops"],
        "bytes_accessed": ca["bytes accessed"],
        "transcendentals": ca["transcendentals"],
        "aten_ops": counter.ops,
        "wire_bytes": sum(v["wire_bytes"] for v in coll.values()),
        "collectives": coll,
        "peak_bytes": counter.peak_bytes,
        "argument_size_in_bytes": sum(args.values()),
        "output_size_in_bytes": sum(outs.values()),
        "alias_size_in_bytes": sum(n for k, n in outs.items() if k in args),
    }


def _lerp(c1: float, c2: float, n: int) -> float:
    """C(n) from C(1) and C(2) on a line."""
    return c1 + (n - 1) * (c2 - c1)


_COSTS = ("flops", "bytes_accessed", "transcendentals", "wire_bytes", "aten_ops")
_MEMORY = ("peak_bytes", "argument_size_in_bytes", "output_size_in_bytes",
           "alias_size_in_bytes")


def evaluate(cfg, shape: str, opts: StepOptions, mesh=None,
             extrapolate_depth: bool = False) -> Tuple[dict, Dict[str, dict]]:
    """The cell's counts at full depth and full batch (on ``mesh``: rank 0's).

    With ``extrapolate_depth`` a prefill or decode cell of more than 2
    periods is counted at 1 and 2 periods and every count, the peak
    included, extrapolated to the full depth, C(1) + (n − 1)(C(2) − C(1)):
    each period runs the same ops and leaves the same cache blocks behind
    (tests/test_torch_mesh_dryrun.py holds it equal to the direct count at
    3 periods).  A 32k-token prefill counts ~150,000 aten ops a layer (the
    plain chunked attention), ~20 s of host time each.

    A cell of at most 2 microbatches is counted as it is.  A train cell of
    NM > 2 microbatches is counted at full depth with 2 of them (memory
    and costs; a later microbatch holds what the second does, and the
    batch argument is then put at its full size), and its costs get
    (NM − 2) more microbatches' worth, the cost of one microbatch taken at
    1 and 2 periods (2 and 3 microbatches) and extrapolated to the full
    depth.  The 2-microbatch costs extrapolated the same way must equal the
    full-depth count, or this raises.  -> (record, the counts made, keyed
    "p<periods>m<microbatches>")."""
    cell = configs.SHAPES[shape]
    B, S = cell.global_batch, cell.seq_len
    NP = cfg.n_periods
    NM = 1
    if cell.mode == "train":
        NM = opts.microbatch or auto_microbatch(cfg, B, S, _devices_dp_tp(mesh)[1])

    def at(npd, nm):
        pcfg = cfg if npd == NP else dc.replace(cfg, n_layers=cfg.period * npd)
        return count(make_cell(pcfg, shape, mesh, dc.replace(opts, microbatch=nm),
                               batch=B // NM * nm))

    if extrapolate_depth and cell.mode != "train" and NP > 2:
        make_cell(dc.replace(cfg, n_layers=cfg.period), shape, mesh, opts).run()  # see below
        vals = {1: at(1, 1), 2: at(2, 1)}
        out = {k: _lerp(vals[1][k], vals[2][k], NP) for k in _COSTS + _MEMORY}
        out["collectives"] = {
            op: {k: _lerp(vals[1]["collectives"][op][k], vals[2]["collectives"][op][k], NP)
                 for k in ("count", "result_bytes", "wire_bytes")}
            for op in vals[1]["collectives"]}
        out["microbatch"] = 1
        return out, {f"p{p}m1": v for p, v in vals.items()}

    # what a process makes once (M-RoPE's per-device section ids) would be
    # counted by its first count only: one period runs first, uncounted, so
    # every count sees the same ops whatever ran before
    make_cell(dc.replace(cfg, n_layers=cfg.period), shape, mesh,
              dc.replace(opts, microbatch=min(NM, 2)), batch=B // NM * min(NM, 2)).run()
    full = at(NP, min(NM, 2))
    vals = {(NP, min(NM, 2)): full}
    out = {k: full[k] for k in _COSTS + _MEMORY}
    out["collectives"] = full["collectives"]
    if NM > 2:
        nps = (1, 2) if NP > 2 else (NP,)
        for npd in nps:
            for nm in (2, 3):
                vals.setdefault((npd, nm), at(npd, nm) if (npd, nm) != (NP, 2) else full)

        def along_np(get):
            if len(nps) == 1:
                return get(vals[(nps[0], 2)]), get(vals[(nps[0], 3)]) - get(vals[(nps[0], 2)])
            two = _lerp(get(vals[(1, 2)]), get(vals[(2, 2)]), NP)
            one_mb = _lerp(get(vals[(1, 3)]) - get(vals[(1, 2)]),
                           get(vals[(2, 3)]) - get(vals[(2, 2)]), NP)
            return two, one_mb

        def cost(get):
            two, one_mb = along_np(get)
            if two != get(full):
                raise AssertionError(f"the 2-microbatch count extrapolated to {NP} periods, "
                                     f"{two}, is not the full-depth count {get(full)}")
            return get(full) + (NM - 2) * one_mb

        for k in _COSTS:
            out[k] = cost(lambda v, k=k: v[k])
        out["collectives"] = {
            op: {k: cost(lambda v, op=op, k=k: v["collectives"][op][k])
                 for k in ("count", "result_bytes", "wire_bytes")}
            for op in full["collectives"]
        }
        # the batch argument at its full size
        full_args = sum(storage_bytes(make_cell(cfg, shape, mesh, opts).args).values())
        out["peak_bytes"] += full_args - out["argument_size_in_bytes"]
        out["argument_size_in_bytes"] = full_args
    out["microbatch"] = NM
    return out, {f"p{p}m{m}": v for (p, m), v in vals.items()}


def probe_costs(cfg, shape: str, mesh, opts_kw, microbatch: int) -> dict:
    """Cost accounting of the probe cells (single-block attention,
    whole-sequence Mamba chunks, ``ce_chunk = S``) at 1 and 2 periods,
    extrapolated as JAX's: total = C(1) + (n_periods − 1)·(C(2) − C(1)).
    Counted eagerly, the probe's costs are exactly affine in the periods.
    On ``mesh`` rank 0's costs, its collectives among them."""
    vals = {}
    for npd in (1, 2):
        pcfg = dc.replace(cfg, n_layers=cfg.period * npd)
        opts = StepOptions(**{**opts_kw, "probe": True, "microbatch": microbatch})
        c = count(make_cell(pcfg, shape, mesh, opts))
        vals[npd] = {k: c[k] for k in ("flops", "bytes_accessed", "transcendentals",
                                       "wire_bytes", "collectives")}
    NP = cfg.n_periods
    ex = lambda k: _lerp(vals[1][k], vals[2][k], NP)  # noqa: E731
    out = {
        "period1": vals[1],
        "period2": vals[2],
        "n_periods": NP,
        "flops": ex("flops"),
        "bytes_accessed": ex("bytes_accessed"),
        "transcendentals": ex("transcendentals"),
        "wire_bytes": ex("wire_bytes"),
    }
    out["collectives"] = {
        op: {k: _lerp(vals[1]["collectives"][op][k], vals[2]["collectives"][op][k], NP)
             for k in ("count", "result_bytes", "wire_bytes")}
        for op in vals[1]["collectives"]
    }
    return out


def run_cell(arch, shape: str, mesh: str = "none", opts_kw=None, probes: bool = False,
             extrapolate_depth: bool = False) -> dict:
    """One cell's record (``arch`` a config name or a ``ModelConfig``);
    ``mesh`` "none" (one device), "single" or "multi" (rank 0 of JAX's
    production mesh, :func:`production_mesh`); ``extrapolate_depth`` as in
    :func:`evaluate` (recorded as ``depth_extrapolated``)."""
    cfg = configs.get_config(arch) if isinstance(arch, str) else arch
    name = arch if isinstance(arch, str) else cfg.name
    ok, why = configs.cell_applicable(cfg, shape)
    rec = {"arch": name, "shape": shape, "mesh": mesh,
           "devices": {"none": 1, "single": 256, "multi": 512}[mesh],
           "status": "skipped", "reason": why}
    if not ok:
        return rec
    on = None if mesh == "none" else production_mesh(mesh)
    devices, _, tp = _devices_dp_tp(on)
    if on is not None:
        rec["rank"] = 0  # the rank whose step is counted
    opts = StepOptions(**(opts_kw or {}))
    t0 = time.time()
    cell = make_cell(cfg, shape, on, opts)
    t1 = time.time()
    ev, points = evaluate(cfg, shape, opts, on, extrapolate_depth)
    t2 = time.time()
    # lower_s: building the cell; compile_s: counting it (JAX: lower, compile)
    rec.update(status="ok", lower_s=round(t1 - t0, 2), compile_s=round(t2 - t1, 2),
               mode=cell.mode, opts=str(opts), counted=points,
               depth_extrapolated=extrapolate_depth and cell.mode != "train"
               and cfg.n_periods > 2)

    # ---- memory --------------------------------------------------------
    m = {k: int(ev[k]) for k in ("argument_size_in_bytes", "output_size_in_bytes",
                                 "alias_size_in_bytes")}
    peak = int(ev["peak_bytes"])
    # JAX's live = argument + output + temp − alias; here the peak of live bytes
    m["temp_size_in_bytes"] = (peak - m["argument_size_in_bytes"] - m["output_size_in_bytes"]
                               + m["alias_size_in_bytes"])
    m["peak_bytes"] = peak
    m["live_bytes_per_device"] = peak
    m["fits_80gb_hbm"] = bool(peak < R.HW["hbm_bytes"])
    rec["memory"] = m

    # ---- cost ----------------------------------------------------------
    rec["cost"] = {k: ev[k] for k in ("flops", "bytes_accessed", "transcendentals")}
    rec["aten_ops"] = int(ev["aten_ops"])
    rec["collectives"] = ev["collectives"]
    rec["wire_bytes_per_device"] = ev["wire_bytes"]

    # ---- roofline -------------------------------------------------------
    cellspec = configs.SHAPES[shape]
    rec["model_flops_global"] = R.model_flops(
        cfg, cell.mode, cellspec.global_batch, cellspec.seq_len
    )
    rec["n_params"] = cfg.n_params()
    rec["n_active_params"] = cfg.n_active_params()
    if rec["cost"]["flops"] > 0:
        terms = R.roofline_terms(
            rec["cost"]["flops"], rec["cost"]["bytes_accessed"], rec["wire_bytes_per_device"]
        )
        terms["model_vs_hlo_flops"] = rec["model_flops_global"] / (
            rec["cost"]["flops"] * rec["devices"]
        )
        rec["roofline"] = terms

    # ---- probe-corrected roofline ---------------------------------------
    if probes:
        mbv = ev["microbatch"]
        pr = probe_costs(cfg, shape, on, opts_kw or {}, mbv)
        rec["probe"] = pr
        terms = R.roofline_terms(pr["flops"], pr["bytes_accessed"], pr["wire_bytes"])
        terms["model_vs_hlo_flops"] = rec["model_flops_global"] / max(
            pr["flops"] * rec["devices"], 1.0
        )
        # kernel-corrected memory term: the direct attention's score tensors,
        # which the flash kernel keeps on chip
        scores = R.attn_scores_traffic(
            cfg, cell.mode, cellspec.global_batch, cellspec.seq_len, devices, tp=tp,
        )
        terms["attn_scores_bytes"] = scores
        terms["memory_kernel_s"] = max(pr["bytes_accessed"] - scores, 0.0) / R.HW["hbm_bw"]
        floor = R.analytic_memory_floor(
            cfg, cell.mode, cellspec.global_batch, cellspec.seq_len, devices, mbv, tp=tp,
        )
        terms["memory_floor_bytes"] = floor
        terms["memory_floor_s"] = floor / R.HW["hbm_bw"]
        rec["roofline_probe"] = terms
        rec["microbatch"] = mbv
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--remat", default="block")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ce-chunk", type=int, default=1024)
    ap.add_argument("--seq-shard", type=int, default=0)
    ap.add_argument("--master-in-opt", type=int, default=0)
    ap.add_argument("--mamba-tp", type=int, default=1)
    ap.add_argument("--probes", action="store_true",
                    help="add the probe cells' cost accounting")
    ap.add_argument("--extrapolate-depth", action="store_true",
                    help="count prefill and decode cells at 1 and 2 periods and extrapolate")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    # DTensor warns at every gather of a leaf split over two mesh dims
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    os.makedirs(args.out_dir, exist_ok=True)
    cells = []
    if args.all:
        for arch in configs.ARCHS:
            canon = arch.replace("_", "-") if arch.replace("_", "-") in configs.ALIASES else arch
            for shape in configs.SHAPES:
                cells.append((canon, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    opts_kw = dict(
        remat=args.remat, fsdp=bool(args.fsdp), microbatch=args.microbatch,
        ce_chunk=args.ce_chunk, seq_shard=bool(args.seq_shard),
        master_in_opt=bool(args.master_in_opt), mamba_tp=bool(args.mamba_tp),
    )
    failures = 0
    t_all = time.time()
    for arch, shape in cells:
        for mesh in MESHES[args.mesh]:
            tag = f"__{args.tag}" if args.tag else ""
            name = f"{arch}__{shape}__{mesh}{tag}.json"
            path = os.path.join(args.out_dir, name)
            if args.skip_existing and os.path.exists(path):
                print(f"[dryrun] skip (exists): {name}")
                continue
            print(f"[dryrun] {arch} × {shape} × {mesh} ...", flush=True)
            try:  # probes on one device and the single pod only, as JAX's
                rec = run_cell(arch, shape, mesh, opts_kw, probes=args.probes and mesh != "multi",
                               extrapolate_depth=args.extrapolate_depth)
            except Exception as e:  # one cell's failure is recorded, the sweep goes on
                rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                       "error": repr(e), "traceback": traceback.format_exc()}
                failures += 1
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)
            extra = ""
            if rec["status"] == "ok":
                extra = (f" lower={rec['lower_s']}s compile={rec['compile_s']}s "
                         f"live={rec['memory']['live_bytes_per_device'] / 2**30:.2f}GiB")
            print(f"[dryrun]   -> {rec['status']}{extra}", flush=True)
    print(f"[dryrun] {len(cells)} cells in {time.time() - t_all:.1f} s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
