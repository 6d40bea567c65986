"""Drives ``RoutedServer`` through the warm-up and the measured window,
a closed loop of jobs, recording on the host's clock when each job went
in and when each response was harvested.

The harness calls only the server's public surface: ``submit``,
``step``, ``stats``, ``bind_tracer`` and ``scheduler.has_work``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .loadgen import Spec, Traffic

GRACE_S = 60.0      # how long past the close the last job is waited for


def stretch(seconds: float):
    """(seconds into the window, length) of the stretch that a traced
    run profiles."""
    return min(5.0, seconds / 4), min(2.0, seconds / 4)


@dataclasses.dataclass
class Record:
    spec: Spec
    done: Optional[float] = None     # host clock (perf_counter seconds)
    tokens: Optional[np.ndarray] = None
    expert: Optional[str] = None
    fine: int = -1
    score: float = float("nan")


@dataclasses.dataclass
class Window:
    """The measured window: jobs go in from ``start`` until ``end`` (the
    close); the job running at the close is waited for, and ``finish`` is
    when the last response of the window's jobs was harvested (None where
    one never came). ``records`` holds every request of those jobs, and
    the engine counters are read at ``start`` and at ``finish``."""
    start: float
    end: float
    finish: Optional[float]
    records: Dict[int, Record]
    steps: List[List[float]]         # [start, end] of every step called
    stats0: Dict[str, Dict[str, Any]]
    stats1: Dict[str, Dict[str, Any]]
    jobs: int = 0
    traced: Optional[Dict[str, Any]] = None   # profiler sub-window
    tracer: Any = None
    tracer_offset: float = 0.0       # host clock - tracer ts, seconds
    captured_in_window: int = 0


def _request(s: Spec):
    from repro_torch.serve import Request
    return Request(uid=s.uid, features=s.features, prompt=s.prompt,
                   max_new_tokens=s.max_new)


def engine_stats(server) -> Dict[str, Dict[str, Any]]:
    return {n: st.as_dict() for n, st in server.stats["engines"].items()}


def _captured(server) -> int:
    return sum(st["decode_captured"] for st in engine_stats(server).values())


def _drain(server, timeout: float = 600.0) -> None:
    t = time.perf_counter() + timeout
    while server.scheduler.has_work:
        server.step()
        if time.perf_counter() > t:
            raise RuntimeError("warm-up did not drain")


def warm(fleet, traffic: Traffic) -> Dict[str, Any]:
    """Capture every engine's decode graph at every batch bucket (one
    wave of that many pre-routed rows an engine, three tokens each: a
    graph captures at its bucket's second step), then run the mix's own
    warm-up jobs, which route through the kernels and prefill the mix's
    shapes. Nothing is timed."""
    from repro_torch.serve import Request
    server = fleet.server
    vocab = fleet.arch.vocab_size
    rng = np.random.default_rng(0)
    uid = -1
    lens = sorted({int(fleet.cfg["fleet"].get("min_len_bucket", 8))})
    for bb in fleet.cfg["fleet"]["batch_buckets"]:
        reqs = []
        for e in range(len(fleet.names)):
            for _ in range(int(bb)):
                reqs.append(Request(uid=uid, features=np.zeros(784, np.float32),
                                    prompt=rng.integers(0, vocab, size=lens[0] * 2)
                                    .astype(np.int32), max_new_tokens=3,
                                    expert=e))
                uid -= 1
        server.submit(reqs)
        _drain(server)
    for j in range(traffic.warmup_jobs):
        server.submit([_request(s) for s in traffic.job(j)])
        _drain(server)
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    return {"graphs_captured": _captured(server)}


class _Profiler:
    """``torch.profiler`` over whole scheduler steps of one stretch of the
    window: started at a step boundary once ``at`` is reached, stopped
    at the first boundary ``length`` seconds later, after the device
    has finished what those steps enqueued. Stopping takes the raw
    results (``torch.autograd._disable_profiler``) and leaves building
    events from them until the window has closed: the profiler's own
    parse of a few hundred thousand kernels takes seconds. Input shapes
    are recorded, so that an idle gap names the tensors the host op that
    left the device idle was working on."""

    def __init__(self, at: float, length: float, device, server):
        self.at, self.length, self.device = at, length, device
        self.server = server
        self.prof = None
        self.t0 = self.t1 = None
        self.first_step = self.last_step = None
        self.results = None
        self.steps0 = self.steps1 = 0

    def before_step(self, now: float, k: int) -> None:
        if self.prof is None and self.t0 is None and now >= self.at:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.steps0 = _decode_steps(self.server)
            self.prof = profile(activities=acts, record_shapes=True)
            self.prof.start()
            self.t0 = time.perf_counter()
            self.first_step = k

    def after_step(self, now: float, k: int, force: bool = False) -> None:
        """Stop once ``length`` has passed (or at once with ``force``),
        ``k`` being the last step traced."""
        if self.prof is not None and (force or now >= self.t0 + self.length):
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.results = torch.autograd._disable_profiler()
            self.t1 = time.perf_counter()
            self.last_step = k
            self.steps1 = _decode_steps(self.server)
            self.prof = None

    def read(self) -> Optional[Dict[str, Any]]:
        """The trace, read once the window has closed."""
        if self.results is None:
            return None
        from .trace_read import read_profile
        out = read_profile(self.results)
        out.update(host_t0=self.t0, host_t1=self.t1,
                   first_step=self.first_step, last_step=self.last_step,
                   decode_steps=self.steps1 - self.steps0)
        self.results = None
        return out


def _decode_steps(server) -> int:
    return sum(st["decode_steps"] for st in engine_stats(server).values())


def run_window(fleet, traffic: Traffic, seconds: float, trace: bool,
               device) -> Window:
    """The measured window: jobs back to back for ``seconds``, then the
    job running at the close to its end (``GRACE_S`` at most)."""
    server = fleet.server
    tracer, offset = None, 0.0
    if trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer(enabled=True)
        t = time.perf_counter()
        tracer.event("bench.clock")
        offset = t - tracer.records()[-1]["ts"] / 1e6
        tracer.clear()
        server.bind_tracer(tracer)
    prof = None
    if trace:
        prof = _Profiler(0.0, stretch(seconds)[1], device, server)
    records: Dict[int, Record] = {}
    steps: List[List[float]] = []
    cap0 = _captured(server)
    stats0 = engine_stats(server)
    start = time.perf_counter()
    end = start + seconds
    if prof is not None:
        prof.at = start + stretch(seconds)[0]
    finish: Optional[float] = None
    j = traffic.warmup_jobs
    jobs = 0
    current: List[int] = []
    while True:
        now = time.perf_counter()
        if all(records[u].done is not None for u in current):
            if now >= end:
                finish = max(records[u].done for u in current) \
                    if current else now
                break
            specs = traffic.job(j)
            for s in specs:
                records[s.uid] = Record(s)
            n = server.submit([_request(s) for s in specs])
            if n != len(specs):
                raise RuntimeError(f"the server took {n} of {len(specs)}")
            current = [s.uid for s in specs]
            j += 1
            jobs += 1
        if now > end + GRACE_S:
            break
        k = len(steps)
        t0 = time.perf_counter()
        if prof is not None:
            prof.before_step(t0, k)
        out = server.step()
        t1 = time.perf_counter()
        steps.append([t0, t1])
        if prof is not None:
            prof.after_step(t1, k)
        for r in out:
            rec = records.get(r.uid)
            if rec is not None:
                rec.done, rec.tokens = t1, np.asarray(r.tokens)
                rec.expert, rec.fine = r.expert, int(r.fine_class)
                rec.score = float(np.asarray(r.coarse_scores)[0])
    stats1 = engine_stats(server)
    if prof is not None:     # a stretch the steps did not close
        prof.after_step(time.perf_counter(), len(steps) - 1, force=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return Window(start, end, finish, records, steps, stats0, stats1, jobs,
                  traced=prof.read() if prof is not None else None,
                  tracer=tracer, tracer_offset=offset,
                  captured_in_window=_captured(server) - cap0)
