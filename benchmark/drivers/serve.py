"""A serving cell: the port's `InferenceEngine` under an open loop of
arrivals at the mix's fixed rate, timed from the clients' side.

Set-up draws the weights from the seed on the card in the form a
deployment loads (matrices and tables bf16, LayerNorm f32), builds the
engine and runs one request through both of its step shapes (prefill
and decode).  The mix is then sent for `ramp_blocks` blocks of
arrivals, so that the lanes hold about as many requests as the load
keeps busy when the window opens; the ramp is a fixed span of the
arrival clock, not set-up, and is reported apart (`load`).  The window is
the next block: the same lengths and arrival gaps for every seed, so
`--seconds` has to be the mix's `block_seconds`.  The engine's
scheduler iteration (`step()`, what its own thread runs in a loop) is
driven from this process's main thread, so that a traced run records
its host ops; the clients are threads that block on their streams.
After the window no new request is sent; the run keeps stepping until
every request due in the window has its first token (at most
`drain_seconds`), then shuts the engine down.  A traced run starts the
profiler as the window opens and stops it `trace_seconds` later; the
arrival clock stands while the profiler starts and stops (each takes
seconds and holds the scheduler), so that no arrivals fall due then,
and the window's bounds move with it.  The per-layer metrics read the
engine's counters over the traced part.

The check: a sample drawn from the seed of the requests that finished,
the longest among them, until `check_tokens` served tokens; the plain
reference runs once over each prompt with its served tokens, and the
number compared is the widest gap by which a served token's f32 logit
lies below the best f32 logit at its position.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from benchmark import harness
from benchmark import requests as traffic_gen
from benchmark import trace, weights
from benchmark.harness import BenchError
from benchmark.drivers._common import free, log, memory_peak, now, program

_POLL_S = 0.0005


@dataclass
class Record:
    """One request as its client saw it (host seconds)."""
    index: int
    prompt: np.ndarray
    max_new: int
    submitted: float = 0.0        # when it was due
    offset: float = 0.0           # ... on the arrival clock
    times: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)

    @property
    def finished(self) -> bool:
        return len(self.tokens) == self.max_new


def _counting_observer():
    """The engine's Observer: counters summed by name in `.values`."""
    from ray_tpu_torch.util.observe import Observer

    class Counting(Observer):
        def __init__(self):
            self.values: dict = {}

        def inc(self, name, n=1.0):
            self.values[name] = self.values.get(name, 0.0) + n

    return Counting()


class _Traffic:
    """The mix's sender: an open loop.  One thread sends each request
    when it is due (the gaps of the list, from `start()`, on an arrival
    clock that stands while `held()` runs), whatever the system has
    finished, and a thread a request reads its stream.  A record's
    `submitted` is when the request was due, `offset` that time on the
    arrival clock."""

    def __init__(self, engine, reqs):
        self.engine, self.reqs = engine, reqs
        self.records: List[Record] = []
        self.stop = threading.Event()
        self.lateness = 0.0          # the latest send past its due time
        self.start_s = 0.0
        self.stood = 0.0             # seconds the arrival clock has stood
        self._clock = threading.Lock()
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []

    def _spawn(self, target, *args) -> None:
        t = threading.Thread(target=target, args=args, daemon=True)
        with self._lock:
            self._threads.append(t)
        t.start()

    def start(self) -> None:
        """Start sending: the first request is due now."""
        self.start_s = now()
        self._spawn(self._sender)

    def at(self, offset: float) -> float:
        """Host time at which the arrival clock reads `offset`."""
        return self.start_s + self.stood + offset

    @contextmanager
    def held(self):
        """The arrival clock stands while the block runs."""
        with self._clock:
            t = now()
            try:
                yield
            finally:
                self.stood += now() - t

    @staticmethod
    def _read(rec: Record, handle) -> None:
        for tok in handle:
            rec.times.append(now())
            rec.tokens.append(tok)

    def _sender(self) -> None:
        offset = 0.0
        for i, req in enumerate(self.reqs):
            # Due times to the microsecond: a block's gaps sum to its
            # seconds exactly, so the window's bounds fall on arrivals.
            due_at = round(offset, 6)
            offset += req.gap_s
            while True:
                with self._clock:
                    due = self.at(due_at)
                    wait = due - now()
                    if wait <= 0 and not self.stop.is_set():
                        self.lateness = max(self.lateness, -wait)
                        rec = Record(i, req.prompt, req.max_new,
                                     submitted=due, offset=due_at)
                        with self._lock:
                            self.records.append(rec)
                        try:
                            handle = self.engine.submit(
                                req.prompt.tolist(), req.max_new)
                        except RuntimeError:  # shut down after the window
                            return
                        break
                if self.stop.wait(max(wait, 0.0)):
                    return
            self._spawn(self._read, rec, handle)
        raise RuntimeError("the mix ran out of requests")

    def join(self) -> None:
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=30)
        alive = [t.name for t in threads if t.is_alive()]
        if alive:
            raise RuntimeError(f"senders did not stop: {alive}")


def check_sample(records: List[Record], seed: int, tokens: int) -> list:
    """The requests compared: of those finished, the one with the most
    served tokens (then the longest prompt), then others in an order
    drawn from the seed, until `tokens` served tokens."""
    done = [r for r in records if r.finished]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), len(r.prompt)))
    rng = np.random.default_rng(weights.derive_seed(seed, "check"))
    rest = [r for r in done if r is not longest]
    picked, total = [longest], len(longest.tokens)
    for i in rng.permutation(len(rest)):
        if total >= tokens:
            break
        picked.append(rest[i])
        total += len(rest[i].tokens)
    return picked


def run(spec: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    from ray_tpu_torch.inference.engine import InferenceEngine

    cfg, mix = spec["config"]["run"], spec["traffic"]
    reference = harness.reference(spec)
    device = torch.device(device)
    eng = mix["engine"]
    family, conf = program(spec)
    counters = _counting_observer()
    engine = InferenceEngine(
        family, conf, reference.draw_params(cfg, seed, device,
                                            matmul_dtype=torch.bfloat16),
        max_lanes=eng["max_lanes"], block_size=eng["block_size"],
        num_blocks=eng["num_blocks"], max_seq_len=eng["max_seq_len"],
        prefill_chunk=eng["prefill_chunk"], auto_start=False,
        device=device, observer=counters)
    reqs = traffic_gen.requests(mix, seed, spec["config"]["vocab_published"],
                                mix["requests"])
    traffic = _Traffic(engine, reqs)
    tracer = trace.TraceWindow(traced)

    marks = {}                # name -> (host time, engine stats, counters)

    def mark(name):
        marks[name] = (now(), engine.stats(), dict(counters.values))

    def step():
        if not engine.step():
            time.sleep(_POLL_S)

    if seconds != mix["block_seconds"]:
        raise BenchError(f"the window is one block of the mix: --seconds "
                         f"{mix['block_seconds']:g}, not {seconds:g}")
    # The window opens `ramp_blocks` blocks after the first request was
    # due and holds the next block, on the arrival clock.
    ramp = mix["ramp_blocks"] * mix["block_seconds"]
    # Set-up ends with every step shape of the cell run once: one
    # request of two prefill chunks and a decode step.
    engine.submit(list(range(1, eng["prefill_chunk"] + 2)), 2)
    while engine.stats()["active"] or engine.stats()["waiting"]:
        step()
    setup_s = now() - t_start
    traffic.start()
    while now() < traffic.at(ramp):
        step()
    if tracer.enabled:
        with traffic.held():
            t_prof = now()
            tracer.start()
            log("profiler start", t_prof)
    t0 = traffic.at(ramp)
    mark("t0")
    tracer.open()
    mark("trace_open")
    trace_end = marks["trace_open"][0] + mix["trace_seconds"]
    while now() < traffic.at(ramp + seconds):
        step()
        if tracer.enabled and not tracer.closed and now() >= trace_end:
            with traffic.held():
                mark("trace_end")
                tracer.close()
    traffic.stop.set()
    mark("t1")
    if tracer.enabled and not tracer.closed:
        mark("trace_end")
        tracer.close()
    t1 = traffic.at(ramp + seconds)

    def in_window(records):
        return [r for r in records if ramp <= r.offset < ramp + seconds]

    drain_end = t1 + mix["drain_seconds"]
    while now() < drain_end and any(
            not r.times for r in in_window(list(traffic.records))):
        step()
    peak = memory_peak(device)
    log(f"setup {setup_s:.3f} s, ramp {t0 - t_start - setup_s:.3f} s, "
        f"waiting {marks['t0'][1]['waiting']} "
        f"-> {marks['t1'][1]['waiting']}, active "
        f"{marks['t0'][1]['active']} -> {marks['t1'][1]['active']}, "
        f"sent {len(traffic.records)}, late {traffic.lateness:.3f} s, "
        f"clock stood {traffic.stood:.3f} s; "
        "window and drain", t0)
    engine.shutdown()
    traffic.join()
    records = list(traffic.records)
    traffic_late, stood = traffic.lateness, traffic.stood
    del engine, traffic
    free(device)

    window = in_window(records)
    failed = sum(1 for r in window if not r.times)
    sample = [(r.prompt.tolist(), r.tokens)
              for r in check_sample(records, seed, mix["check_tokens"])]
    t_ref = now()
    gaps = reference.served_gaps(cfg, seed, sample, device, "f32")
    log(f"reference over {len(sample)} requests", t_ref)
    # Fewer served tokens than the mix asks to compare is no check.
    enough = len(gaps) >= mix["check_tokens"]
    checks = [("served_gap", max(gaps) if enough else float("inf"))]
    ctx = {
        "kind": "serve", "cfg": cfg, "traffic": mix, "chips": 1,
        "setup_s": setup_s, "window_s": t1 - t0, "t0": t0, "t1": t1,
        "records": records, "window_records": window, "marks": marks,
        "trace": tracer.trace,
    }
    return {"ctx": ctx, "checks": checks, "attempted": len(window),
            "failed": failed, "memory_peak_bytes": peak,
            "sample": sample, "load": {
                "ramp_s": t0 - t_start - setup_s, "late_s": traffic_late,
                "clock_stood_s": stood,
                "waiting": [marks["t0"][1]["waiting"],
                            marks["t1"][1]["waiting"]],
                "active": [marks["t0"][1]["active"],
                           marks["t1"][1]["active"]]}}


def _traced(ctx: dict):
    """The marks that bound the traced part of a traced run's window;
    None without a trace."""
    marks = ctx["marks"]
    if "trace_end" not in marks:
        return None
    return marks["trace_open"], marks["trace_end"]


def stats_delta(ctx: dict, key: str):
    """Engine stats() entry `key` over the traced part of the window
    (the profiler's start and stop, which stall the scheduler for
    seconds, fall outside it); None in a run without a trace."""
    span = _traced(ctx)
    return None if span is None else span[1][1][key] - span[0][1][key]


def counter_delta(ctx: dict, name: str):
    """The engine's Observer counter `name` over the same part."""
    span = _traced(ctx)
    if span is None:
        return None
    return span[1][2].get(name, 0.0) - span[0][2].get(name, 0.0)


def traced_span(ctx: dict):
    """(start, end) host seconds of the traced part of the window."""
    open_, end = _traced(ctx)
    return open_[0], end[0]


def readings(spec: dict, seed: int, device, seconds: float,
             control: bool) -> dict:
    """The program's `served_gap` over a run of the mix for `seconds`
    and, with `control`, the control's: at every served position of the
    same sample, the gap of the token that the reference one precision
    below the configuration's (fp8) puts first."""
    out = run(spec, seed, seconds, False, device, time.perf_counter())
    numbers = {"program": dict(out["checks"])}
    if control:
        low = harness.reference(spec).served_gaps(
            spec["config"]["run"], seed, out["sample"], device, "fp8")
        numbers["control"] = {"served_gap": max(low)}
    return numbers


def tiny(mix: dict) -> dict:
    """The mix at the CPU tests' sizes: four lanes, short prompts and
    outputs, blocks of a second."""
    return dict(mix, engine=dict(mix["engine"], max_lanes=4, num_blocks=64,
                                 max_seq_len=256),
                block_seconds=1.0, block=16, requests=256, ramp_blocks=1,
                trace_seconds=0.5, drain_seconds=120, check_tokens=32,
                prompt_len=dict(median=48, sigma=0.5, min=16, max=112),
                output_len=dict(median=8, sigma=0.7, min=2, max=32))
