"""The closed-loop serving window.

``clients`` clients each send a prompt and wait for its reply; a wave is
the batch of every client's request, served by the prefill and decode
steps that the program's ``launch.serve.serve`` builds
(``launch.steps.build_prefill_step``/``build_decode_step`` over one
device's ``ShardCtx``), on the benchmark's weights in the layout
``models.model.compute_params`` gives.  The program's tracer and monitor
are attached as ``serve`` attaches them: spans ``serve/prefill`` and
``serve/decode_step``, ``record_step_times`` after each decode step and
``ingest(tracer.drain(step))`` once per wave.

A wave: the prompts go to the device, the prefill runs and each request's
first token (greedy) is read back to the host, which is its time to first
token; then ``max_new - 1`` decode steps, each ending when its tokens are
on the host; then the monitor's ingest.  A client sends its next request
when its reply is complete, so the next wave's requests are submitted at
the previous wave's last token and wait through its ingest.

The window starts with the first request and runs whole waves: a wave
starts while less than ``seconds`` have passed, and the window closes when
the last one has ended.  Every served logit row is kept (a reference to
the tensor the step returned, no copy) for the correctness check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

MONITOR = dict(num_funcs=16, min_samples=8)  # as launch.serve.serve builds its monitor
MONITOR_ALPHA = 6.0  # ChimbukoMonitor's default: the paper's


def now() -> float:
    return time.perf_counter()


@dataclasses.dataclass
class Wave:
    prompts: np.ndarray  # (B, S) int
    submit: float  # when its requests were sent
    t_first: float = 0.0  # first tokens on the host
    t_done: float = 0.0  # last tokens on the host
    t_end: float = 0.0  # the monitor's ingest returned
    emitted: List[tuple] = dataclasses.field(default_factory=list)  # (time, tokens)
    step_s: List[float] = dataclasses.field(default_factory=list)  # decode steps, host clock
    monitor_s: float = 0.0  # in record_step_times and ingest
    prefill_ms: Optional[float] = None  # CUDA events around the prefill (traced runs)
    label_lag_s: Optional[np.ndarray] = None  # per labelled record
    tokens: Optional[np.ndarray] = None  # (B, max_new) served, greedy
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list)  # per token
    records: Optional[np.ndarray] = None  # the monitor's labelled records
    frame: object = None  # what the monitor ingested


class Traffic:
    """The general generator: a closed loop of ``clients`` clients, each
    prompt ``prompt_len`` token ids drawn uniformly from the vocabulary,
    ``max_new`` greedy tokens each.  The same seed and stream give the same
    prompts (stream 1 the window's, 3 the warm-up wave's)."""

    KEYS = {"loop", "clients", "prompt_len", "max_new", "check_tokens", "trace_waves", "why"}

    def __init__(self, params: dict, vocab: int, seed: int, stream: int = 1):
        unknown = set(params) - self.KEYS
        if unknown or params.get("loop") != "closed":
            raise ValueError(f"the generator takes a closed loop with {sorted(self.KEYS)}, "
                             f"got loop {params.get('loop')!r} and {sorted(unknown)}")
        self.clients = int(params["clients"])
        self.prompt_len = int(params["prompt_len"])
        self.max_new = int(params["max_new"])
        self.vocab = vocab
        self.rng = np.random.default_rng([seed, stream])

    def next_prompts(self) -> np.ndarray:
        return self.rng.integers(0, self.vocab, (self.clients, self.prompt_len), dtype=np.int64)


class Server:
    def __init__(self, cfg, weights, traffic: Traffic, device, timed_events: bool = False):
        from repro_torch.launch.steps import (StepOptions, build_decode_step,
                                              build_prefill_step, make_shard_ctx)
        from repro_torch.models import model as M

        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        opts = StepOptions()
        ctx = make_shard_ctx(cfg, None, traffic.clients, opts)
        self.params = M.compute_params(cfg, weights)
        self.prefill = build_prefill_step(cfg, ctx, opts,
                                          max_seq=traffic.prompt_len + traffic.max_new)
        self.decode = build_decode_step(cfg, ctx, opts)
        self.timed_events = timed_events and self.device.type == "cuda"
        self.ranges = False  # torch.profiler ranges around the host's phases
        self.new_monitor()

    def new_monitor(self) -> None:
        from repro_torch.trace.monitor import ChimbukoMonitor
        from repro_torch.trace.tracer import Tracer

        self.monitor = ChimbukoMonitor(**MONITOR)
        self.tracer = Tracer(self.monitor.registry, rank=0)
        self.step = 0

    def close(self) -> None:
        self.monitor.close()

    def _range(self, name: str):
        if not self.ranges:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def wave(self, prompts: np.ndarray, submit: float) -> Wave:
        B = prompts.shape[0]
        w = Wave(prompts=prompts, submit=submit)
        toks = []
        with self._range("bench/prefill"), self.tracer.span("serve/prefill"):
            batch = {"tokens": torch.from_numpy(prompts.astype(np.int32)).to(self.device)}
            if self.timed_events:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            logits, cache = self.prefill(self.params, batch)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            if self.timed_events:
                ev[1].record()
            toks.append(nxt.tolist())
        w.t_first = now()
        w.emitted.append((w.t_first, prompts.size + B))
        w.logits.append(logits[:, -1])
        for _ in range(self.traffic.max_new - 1):
            t0 = now()
            with self._range("bench/decode_step"), self.tracer.span("serve/decode_step"):
                logits, cache = self.decode(self.params, cache, nxt[:, None].to(torch.int32))
                nxt = torch.argmax(logits[:, 0], dim=-1)
                toks.append(nxt.tolist())
            t1 = now()
            w.step_s.append(t1 - t0)
            w.emitted.append((t1, B))
            w.logits.append(logits[:, 0])
            with self._range("bench/record_step_times"):
                self.monitor.record_step_times(self.step, {0: t1 - t0})
            w.monitor_s += now() - t1
            self.step += 1
        w.t_done = now()
        del cache
        with self._range("bench/monitor_ingest"):
            frame = self.tracer.drain(self.step)
            res = self.monitor.ingest(frame)
        ret_ns = time.perf_counter_ns()  # the clock of now() and of the tracer's stamps
        w.t_end = ret_ns / 1e9
        w.monitor_s += w.t_end - w.t_done
        w.frame, w.records = frame, res.records.copy()
        w.label_lag_s = (ret_ns // 1000 - res.records["exit"].astype(np.int64)) / 1e6
        w.tokens = np.asarray(toks, dtype=np.int64).T
        if self.timed_events:
            ev[1].synchronize()
            w.prefill_ms = ev[0].elapsed_time(ev[1])
        return w


def window(server: Server, seconds: float) -> Tuple[float, List[Wave]]:
    """Whole waves from now until ``seconds`` have passed (see the module)
    -> (the window's start, its waves)."""
    waves: List[Wave] = []
    t0 = submit = now()
    while not waves or now() - t0 < seconds:
        waves.append(server.wave(server.traffic.next_prompts(), submit))
        submit = waves[-1].t_done
    return t0, waves
