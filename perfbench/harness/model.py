"""The model a cell serves: the program's configuration, checked against
the configuration file, and its weights made on the device from the seed.

The configuration file names the program's registered configuration
(``port.arch``) and the fields it replaces (``port.replace``); its
``model`` block states every size as run, by the program's field names,
and is what the plain reference reads.  :func:`port_config` refuses a
program configuration that disagrees with that block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from . import spec as SP

DT_MIN, DT_MAX = 1e-3, 1e-1  # the range of the initial Mamba time steps


def port_config(conf: dict):
    """The program's ``ModelConfig`` for ``conf``, held to its ``model`` block."""
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(conf["port"]["arch"]),
                              **conf["port"].get("replace", {}))
    wrong = []
    for key, want in conf["model"].items():
        got = getattr(cfg, key)
        if key == "layout":
            got = [[s.mixer, s.mlp] for s in got]
        elif key == "compute_dtype":
            got = str(got).removeprefix("torch.")
        if got != want:
            wrong.append(f"{key}: program {got!r}, file {want!r}")
    if wrong:
        raise ValueError(f"{conf['port']['arch']} as the program configures it differs from "
                         f"the configuration file: " + "; ".join(wrong))
    return cfg


def weight_leaves(conf: dict) -> List[Tuple[Tuple, Tuple[int, ...], str]]:
    return SP.reference(conf["reference"]).leaves(conf["model"])


def check_layout(cfg, leaves) -> None:
    """The leaves' shapes are those the program's parameter tree has."""
    from repro_torch.models.common import param_shapes

    shapes = param_shapes(cfg)
    want = {("embed",): shapes["embed"], ("final_ln",): shapes["final_ln"]}
    if "unembed" in shapes:
        want[("unembed",)] = shapes["unembed"]
    for i, layer in enumerate(shapes["layers"]):
        want.update({("layers", i, k): tuple(s) for k, s in layer.items()})
    got = {path: tuple(shape) for path, shape, _ in leaves}
    if got != want:
        raise ValueError(f"the reference's weights {sorted(set(got) ^ set(want))} or shapes "
                         f"differ from the program's parameter tree")


@torch.no_grad()
def make_weights(conf: dict, seed: int, device) -> Dict[str, Any]:
    """The served weights, in the program's tree and compute dtypes, from
    ``seed``, on ``device``: the normal draws of every matrix in one call
    into one bfloat16 buffer (each leaf a view, scaled by 1/sqrt(fan in);
    the embedding by 1/sqrt(d)), the time-step biases in one uniform draw,
    and the constant leaves (norms 1, conv bias 0, D 1, A_log log(1..st))."""
    family = SP.reference(conf["reference"])
    leaves = family.leaves(conf["model"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dense = [(p, s, k) for p, s, k in leaves if k in ("dense", "embed")]
    total = sum(math.prod(s) for _, s, _ in dense)
    buf = torch.empty(total, dtype=torch.bfloat16, device=device).normal_(generator=gen)
    out: Dict[Tuple, torch.Tensor] = {}
    at = 0
    for path, shape, kind in dense:
        n = math.prod(shape)
        fan_in = conf["model"]["d_model"] if kind == "embed" else shape[-2]
        out[path] = buf[at:at + n].view(shape).mul_(1.0 / math.sqrt(fan_in))
        at += n
    dt = [(p, s) for p, s, k in leaves if k == "dt_bias"]
    if dt:
        u = torch.rand(sum(math.prod(s) for _, s in dt), generator=gen, device=device)
        lo, hi = math.log(DT_MIN), math.log(DT_MAX)
        u = torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo))).to(torch.bfloat16)
        at = 0
        for path, shape in dt:
            out[path] = u[at:at + math.prod(shape)].view(shape)
            at += math.prod(shape)
    for path, shape, kind in leaves:
        f32 = family.float32_leaf(path[-1])
        dtype = torch.float32 if f32 else torch.bfloat16
        if kind == "ones":
            out[path] = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "zeros":
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "a_log":
            a = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device)
            out[path] = torch.log(a).expand(shape).contiguous().to(dtype)
    tree: Dict[str, Any] = {"layers": [{} for _ in conf["model"]["layout"]]}
    for path, shape, kind in leaves:
        if path[0] == "layers":
            tree["layers"][path[1]][path[2]] = out[path]
        else:
            tree[path[0]] = out[path]
    return tree
