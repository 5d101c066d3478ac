"""Tracing and profiling utilities: port of `rnnpose_tpu/utils/profiling.py`.

  * `trace(dir)`: context manager that runs `torch.profiler` over everything
    inside (host and, where a card is visible, CUDA activity) and writes a
    Chrome trace, `<dir>/trace.json` (chrome://tracing or Perfetto);
  * `device_busy(prof)`: the device's busy time in a profiled window;
  * `Tracer`: the port's own spans, counters and device stamps, which see
    inside a replayed CUDA graph, where the profiler sees kernels without
    the ops that launched them.

Tracing is off unless a `Tracer` is given to the program:
`InferenceEngine(model, tracer=Tracer(device))` or `Trainer(model, cfg,
tracer=Tracer(device))`. With it on, the program records:

  * host spans (`Tracer.span`, `span_on`): name, start and end on
    `time.perf_counter_ns`, parent span and call id, at its boundaries
    (`engine/copy_in`,
    `engine/replay`, `engine/clone_out`, `engine/encode_3d`,
    `engine/warmup`, `engine/capture`; `trainer/copy_in`,
    `trainer/replay_a`, `trainer/all_reduce`, `trainer/replay_b`,
    `trainer/clone_out`, `trainer/warmup`, `trainer/capture`). Every span
    and stamp of one `refine` or `run_step` call shares the call's id.
    Under an active `torch.profiler` a span is also a `record_function` of
    its name;
  * device stamps (`mark`): a one-thread kernel (`csrc/stamp.cu`) that
    writes the device clock (%globaltimer) and the mark's id into a ring
    in device memory. The engine and trainer make their tracer active
    around their eager work and their captures, so a graph captured with
    tracing on holds one stamp node per mark and a graph captured with it
    off holds none. The marks cut the forward into contiguous stages:
    `encode` (SuperPoint; per render iteration the crop resample, the
    RAFT encoder, the correlation pyramid and the context split),
    `render` (pose, zoom crop, raster, interpolation, shading), per inner
    step `flow` (pose-induced coords, correlation lookup, GRU) and `pose`
    (similarity weight, LM), then `tail`; a training step `forward` (the
    refiner's marks nest in it), `backward` and `update`. A mark named
    `end` closes a stage without opening one: the time until the call's
    next stamp is the device waiting on the host. On the CPU a mark
    records `perf_counter_ns` (eager CPU ops are synchronous);
  * counters: those of the objects that `attach` theirs (the engine's
    `graph_captures`, `encode_3d_calls`, `replays` and `graph_nodes`; the
    trainer's).

`Tracer.export(path)` reads the ring, calibrates the device clock against
`perf_counter_ns` (the closest of ~20 stamp-and-synchronise pairs, at the
tracer's start and at export: offset, drift and error bound), puts every
stamp on the host's timeline and returns (and with `path` writes as JSON)
the spans, stamps, calls with their stage intervals, counters, and each
stretch of device idle inside a call named by the innermost host span open
at its start. `stage_ms`, `group_ms`, `span_ms`, `idle_ms` and `report`
read an export.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import functools
import json
import os
import statistics
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple

import torch

__all__ = ["trace", "mark", "span_on", "annotation_names", "device_busy", "Tracer",
           "END", "graph_nodes", "calibrate", "clock_fit", "to_host", "stage_ms", "group_ms",
           "span_ms", "idle_ms", "self_ms", "report"]

END = "end"  # a mark that closes a stage and opens none
STAMP_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "stamp.cu"
CALIBRATION_PAIRS = 20
RING = 1 << 20  # stamps the device ring holds (12 bytes each); later ones are dropped

_local = threading.local()  # the tracer active on this thread (`Tracer.active`)
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body; yields the profiler (its `key_averages()` holds the
    per-op host and device times) and writes `<log_dir>/trace.json`. The
    card is synchronised before the profiler stops: a replayed CUDA graph
    returns before its work runs, and work that runs after the stop is not
    in the trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def mark(name: str) -> None:
    """One device stamp opening stage `name` (`END`: closing the open one)
    on the tracer active on this thread; nothing without one."""
    tracer = getattr(_local, "tracer", None)
    if tracer is not None:
        tracer.mark(name)


def span_on(tracer: Optional["Tracer"], name: str):
    """`tracer.span(name)`, or nothing without a tracer (the program's span
    sites: one `is None` branch when tracing is off)."""
    return _NULL if tracer is None else tracer.span(name)


def annotation_names(prof: torch.profiler.profile) -> Set[str]:
    """The names of the user-annotation ranges (`Tracer.span`, `record_function`)
    among a profiled window's events."""
    return {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}


def device_busy(prof: torch.profiler.profile) -> Tuple[float, int]:
    """(ms, operations): the summed own times of the device operations
    (kernels, memcpys, memsets) of a profiled window, and their number.
    The spans that user annotations put on the device are left out: a span
    covers the gaps between its kernels, as the table's "Self CUDA time
    total" leaves it out."""
    from torch.autograd import DeviceType

    ranges = annotation_names(prof)
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and e.name not in ranges]
    return sum(e.self_device_time_total for e in device) / 1e3, len(device)


# --------------------------------------------------------------------------
# The stamp kernel and the graph's node count (built and loaded on first use)


@functools.lru_cache(maxsize=None)
def _stamp_lib() -> ctypes.CDLL:
    from ..kernels.build import build_kernel

    lib = ctypes.CDLL(str(build_kernel(STAMP_SOURCE)))
    lib.rnnpose_stamp.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_uint64, ctypes.c_int,
                                                          ctypes.c_void_p]
    lib.rnnpose_stamp.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    return lib


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> int:
    """The number of nodes of a captured graph made with `keep_graph=True`
    (`cudaGraphGetNodes` on `raw_cuda_graph()`)."""
    n = ctypes.c_size_t(0)
    err = _libcuda().cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return int(n.value)


# --------------------------------------------------------------------------
# The clock


def calibrate(pairs: Sequence[Tuple[int, int, int]]) -> Dict[str, float]:
    """The device clock's offset from the host's, from (host ns before a
    stamp's launch, the stamp's device ns, host ns after the synchronise
    that follows it) triples: the triple with the shortest round trip, its
    offset taken at the round trip's middle and its error bound half the
    round trip."""
    h0, d, h1 = min(pairs, key=lambda p: p[2] - p[0])
    return {"offset_ns": d - (h0 + h1) / 2, "error_ns": (h1 - h0) / 2, "device_ns": d,
            "pairs": len(pairs)}


def clock_fit(start: Dict[str, float], end: Dict[str, float]) -> Dict[str, float]:
    """A device-to-host map from two calibrations: the start's offset, a
    linear drift (ns per device ns) to the end's, the larger error bound."""
    span_ns = end["device_ns"] - start["device_ns"]
    drift = (end["offset_ns"] - start["offset_ns"]) / span_ns if span_ns > 0 else 0.0
    return {"offset_ns": start["offset_ns"], "device_ns": start["device_ns"], "drift": drift,
            "error_ns": max(start["error_ns"], end["error_ns"]), "start": start, "end": end}


def to_host(device_ns: float, clock: Dict[str, float]) -> float:
    """A device clock reading on the host's clock, by `clock_fit`'s map."""
    return device_ns - (clock["offset_ns"] + clock["drift"] * (device_ns - clock["device_ns"]))


# --------------------------------------------------------------------------
# The tracer


class Tracer:
    """Spans, counters and device stamps of one program, kept in memory
    until `export` (see the module docstring). One thread drives a tracer
    at a time. On a CUDA device the ring holds RING stamps; a stamp past it
    is dropped and counted."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._names: Dict[str, int] = {}
        self._spans: List[list] = []      # [name, start, end, parent, call]
        self._open: List[int] = []        # indices of the open spans, innermost last
        self._call: Optional[int] = None
        self.calls = 0                    # calls opened so far (the last call's id)
        self._sources: Dict[str, Callable[[], Dict[str, Any]]] = {}
        # (mark id, call id, from a replay) of every stamp the device will
        # write, in stream order; the marks of the graph being captured.
        self._expected: List[Tuple[int, Optional[int], bool]] = []
        self._capture: Optional[List[int]] = None
        self._host: List[int] = []        # CPU: the stamps' perf_counter_ns
        if self.cuda:
            with torch.cuda.device(self.device):
                self._count = torch.zeros(1, dtype=torch.int64, device=self.device)
                self._times = torch.zeros(RING, dtype=torch.int64, device=self.device)
                self._ids = torch.zeros(RING, dtype=torch.int32, device=self.device)
                self._cal = [torch.zeros(n, dtype=dt, device=self.device) for n, dt in (
                    (1, torch.int64), (CALIBRATION_PAIRS, torch.int64),
                    (CALIBRATION_PAIRS, torch.int32))]
        self._clock_start = self._calibrate()

    # ---- host side -------------------------------------------------------

    @contextlib.contextmanager
    def active(self) -> Iterator["Tracer"]:
        """Make this the tracer that `mark` uses on this thread."""
        prev = getattr(_local, "tracer", None)
        _local.tracer = self
        try:
            yield self
        finally:
            _local.tracer = prev

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[int]:
        """A host span, child of the innermost open one, in the current call;
        yields its index. A `record_function` too under an active profiler."""
        i = len(self._spans)
        rec = [name, time.perf_counter_ns(), None, self._open[-1] if self._open else None,
               self._call]
        self._spans.append(rec)
        self._open.append(i)
        rf = (torch.profiler.record_function(name)
              if torch.autograd.profiler._is_profiler_enabled else contextlib.nullcontext())
        try:
            with rf:
                yield i
        finally:
            rec[2] = time.perf_counter_ns()
            self._open.pop()

    @contextlib.contextmanager
    def call(self, name: str) -> Iterator[int]:
        """One call into the program: a new call id shared by every span and
        stamp until it ends, a root span `name`, and this tracer active.
        A call opened inside another is a span of the outer call."""
        if self._call is not None:
            with self.span(name):
                yield self._call
            return
        self.calls += 1
        self._call = self.calls
        try:
            with self.active(), self.span(name):
                yield self._call
        finally:
            self._call = None

    def attach(self, name: str, counters: Callable[[], Dict[str, Any]]) -> None:
        """Export `counters()` under `name` (the program's own counters)."""
        self._sources[name] = counters

    # ---- device stamps ---------------------------------------------------

    def _stamp(self, mark_id: int, ring) -> None:
        count, times, ids = ring
        with torch.cuda.device(self.device):
            err = _stamp_lib().rnnpose_stamp(
                count.data_ptr(), times.data_ptr(), ids.data_ptr(), times.numel(), mark_id,
                torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"stamp kernel launch failed: cudaError {err}")

    def mark(self, name: str) -> None:
        mark_id = self._names.setdefault(name, len(self._names))
        if not self.cuda:
            self._host.append(time.perf_counter_ns())
            self._expected.append((mark_id, self._call, False))
            return
        capturing = torch.cuda.is_current_stream_capturing()
        if capturing and self._capture is None:
            raise RuntimeError("a mark inside a graph capture the tracer was not told of "
                               "(`Tracer.capture`): its stamps could not be placed")
        self._stamp(mark_id, (self._count, self._times, self._ids))
        if capturing:
            self._capture.append(mark_id)
        else:
            self._expected.append((mark_id, self._call, False))

    @contextlib.contextmanager
    def capture(self) -> Iterator[List[int]]:
        """Around a graph's capture: yields the list that collects the ids of
        the marks captured into it, which `replayed` takes."""
        self._capture = marks = []
        try:
            yield marks
        finally:
            self._capture = None

    def replayed(self, marks: Sequence[int]) -> None:
        """A replay of a graph whose capture collected `marks` was launched."""
        self._expected.extend((m, self._call, True) for m in marks)

    # ---- the clock -------------------------------------------------------

    def _calibrate(self) -> Dict[str, float]:
        """CALIBRATION_PAIRS stamp-and-synchronise pairs -> `calibrate`."""
        if not self.cuda:
            pairs = []
            for _ in range(CALIBRATION_PAIRS):
                h0 = time.perf_counter_ns()
                d = time.perf_counter_ns()
                pairs.append((h0, d, time.perf_counter_ns()))
            return calibrate(pairs)
        self._cal[0].zero_()
        torch.cuda.synchronize(self.device)
        host = []
        for _ in range(CALIBRATION_PAIRS):
            h0 = time.perf_counter_ns()
            self._stamp(0, self._cal)
            torch.cuda.synchronize(self.device)
            host.append((h0, time.perf_counter_ns()))
        dev = self._cal[1].tolist()
        return calibrate([(h0, d, h1) for (h0, h1), d in zip(host, dev)])

    # ---- export ----------------------------------------------------------

    def _written(self) -> Tuple[List[int], List[int], int]:
        """(device ns, mark ids) of the stamps written so far, in slot
        order, and how many were launched."""
        if not self.cuda:
            return list(self._host), [m for m, _, _ in self._expected], len(self._host)
        torch.cuda.synchronize(self.device)
        n = int(self._count.item())
        k = min(n, RING)
        return self._times[:k].tolist(), self._ids[:k].tolist(), n

    def export(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Everything recorded so far, on the host's clock (see the module
        docstring); written as JSON to `path` if given."""
        times, ids, launched = self._written()
        clock = clock_fit(self._clock_start, self._calibrate())
        names = sorted(self._names, key=self._names.get)
        stamps, mismatched = [], 0
        for (mark_id, call, replay), t, got in zip(self._expected, times, ids):
            mismatched += int(mark_id != got)
            stamps.append({"call": call, "name": names[got], "replay": replay,
                           "device_ns": t, "ns": to_host(t, clock)})
        spans = [{"name": n, "start_ns": s, "end_ns": e, "parent": p, "call": c}
                 for n, s, e, p, c in self._spans]
        doc = {
            "device": str(self.device),
            "clock": clock,
            "marks": names,
            "spans": spans,
            "stamps": stamps,
            "stamps_launched": launched,
            "stamps_expected": len(self._expected),
            "stamps_dropped": max(0, launched - RING),
            "stamps_mismatched": mismatched,
            "counters": {k: fn() for k, fn in self._sources.items()},
        }
        doc["calls"] = _calls(doc)
        doc["idle"] = _idle(doc)
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


# --------------------------------------------------------------------------
# Reading an export


def _calls(doc) -> List[Dict[str, Any]]:
    """Each call's root span and its intervals: between consecutive stamps
    of the call, [name, start, end] named by the stamp that opens it, or
    [None, start, end] after an `END` stamp (the device waiting on the
    host inside the call)."""
    by_call: Dict[int, List[dict]] = collections.defaultdict(list)
    for s in doc["stamps"]:
        by_call[s["call"]].append(s)
    calls = []
    for sp in doc["spans"]:
        if sp["parent"] is not None or sp["call"] is None:
            continue
        st = by_call.get(sp["call"], [])
        intervals = [[None if a["name"] == END else a["name"], a["ns"], b["ns"]]
                     for a, b in zip(st, st[1:])]
        graph = [s["ns"] for s in st if s["replay"]]
        calls.append({"id": sp["call"], "name": sp["name"], "start_ns": sp["start_ns"],
                      "end_ns": sp["end_ns"], "first_stamp_ns": st[0]["ns"] if st else None,
                      "last_stamp_ns": st[-1]["ns"] if st else None,
                      "replay_ns": graph[-1] - graph[0] if graph else None,
                      "intervals": intervals})
    return calls


def _innermost(spans, starts, t) -> str:
    """The name of the innermost host span open at host time t."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        sp = spans[i]
        if sp["end_ns"] is None or sp["end_ns"] > t:
            return sp["name"]
    return "(no span)"


def _idle(doc) -> List[Dict[str, Any]]:
    """Each stretch in which the device waited on the host inside a call:
    from the later of the call's entry and the previous call's last stamp
    to the call's first stamp (`entry`), and each interval after an `END`
    stamp (`wait`); named by the innermost host span open at its start."""
    spans = doc["spans"]
    starts = [s["start_ns"] for s in spans]
    out, prev = [], None
    for c in doc["calls"]:
        if c["first_stamp_ns"] is None:
            continue
        t0 = c["start_ns"] if prev is None else max(c["start_ns"], prev)
        if c["first_stamp_ns"] > t0:
            out.append({"call": c["id"], "kind": "entry", "start_ns": t0,
                        "ns": c["first_stamp_ns"] - t0, "span": _innermost(spans, starts, t0)})
        for name, a, b in c["intervals"]:
            if name is None:
                out.append({"call": c["id"], "kind": "wait", "start_ns": a, "ns": b - a,
                            "span": _innermost(spans, starts, a)})
        prev = c["last_stamp_ns"]
    return out


def _selected(doc, calls: Optional[Sequence[int]]):
    keep = None if calls is None else set(calls)
    return [c for c in doc["calls"] if (keep is None or c["id"] in keep) and c["intervals"]]


def stage_ms(doc, calls: Optional[Sequence[int]] = None) -> Dict[str, List[float]]:
    """Per stage name, its device ms in each selected call that has stamps
    (0 where a call lacks the stage); waits left out."""
    sel = _selected(doc, calls)
    names = {n for c in sel for n, _, _ in c["intervals"] if n is not None}
    out = {n: [0.0] * len(sel) for n in names}
    for k, c in enumerate(sel):
        for n, a, b in c["intervals"]:
            if n is not None:
                out[n][k] += (b - a) / 1e6
    return out


def group_ms(doc, heads: Sequence[str], calls: Optional[Sequence[int]] = None
             ) -> Dict[str, List[float]]:
    """Per head stage, the device ms in each selected call of the head and
    every stage that follows it up to the next head or wait: the marks
    nested in it (a training step's `forward` holds the refiner's)."""
    sel = _selected(doc, calls)
    out = {h: [0.0] * len(sel) for h in heads}
    for k, c in enumerate(sel):
        cur = None
        for n, a, b in c["intervals"]:
            cur = n if n in out else (None if n is None else cur)
            if cur is not None:
                out[cur][k] += (b - a) / 1e6
    return out


def span_ms(doc, name: str, calls: Optional[Sequence[int]] = None) -> List[float]:
    """Host ms in spans called `name`, summed per selected call (calls with
    no such span left out)."""
    keep = None if calls is None else set(calls)
    per: Dict[int, float] = collections.defaultdict(float)
    for s in doc["spans"]:
        if s["name"] == name and s["end_ns"] is not None and (keep is None or s["call"] in keep):
            per[s["call"]] += (s["end_ns"] - s["start_ns"]) / 1e6
    return [per[c] for c in sorted(per)]


def idle_ms(doc, calls: Optional[Sequence[int]] = None) -> Dict[str, float]:
    """Idle ms inside the selected calls by the host span that names it."""
    keep = None if calls is None else set(calls)
    out: Dict[str, float] = collections.defaultdict(float)
    for i in doc["idle"]:
        if keep is None or i["call"] in keep:
            out[i["span"]] += i["ns"] / 1e6
    return dict(out)


def self_ms(doc, calls: Optional[Sequence[int]] = None) -> Dict[str, float]:
    """Host self ms by span name: each span's duration less its children's."""
    keep = None if calls is None else set(calls)
    spans = doc["spans"]
    child = [0] * len(spans)
    for s in spans:
        if s["parent"] is not None and s["end_ns"] is not None:
            child[s["parent"]] += s["end_ns"] - s["start_ns"]
    out: Dict[str, float] = collections.defaultdict(float)
    for s, c in zip(spans, child):
        if s["end_ns"] is not None and (keep is None or s["call"] in keep):
            out[s["name"]] += (s["end_ns"] - s["start_ns"] - c) / 1e6
    return dict(out)


def report(doc, calls: Optional[Sequence[int]] = None) -> str:
    """Lines for a log: the median device ms of each stage per call, the
    host self ms of each span and the idle ms by span, each per call, and
    the clock's calibration."""
    sel = _selected(doc, calls)
    n = max(len(sel), 1)
    ids = [c["id"] for c in sel]
    stages = stage_ms(doc, ids)
    lines = [f"stamped calls {len(sel)}; stage median device ms per call: " + ", ".join(
        f"{k} {statistics.median(v):.4f}" for k, v in sorted(stages.items()))]
    lines.append("host self ms per call by span: " + ", ".join(
        f"{k} {v / n:.4f}" for k, v in sorted(self_ms(doc, ids).items())))
    lines.append("device idle ms per call by host span: " + ", ".join(
        f"{k} {v / n:.4f}" for k, v in sorted(idle_ms(doc, ids).items())))
    ck = doc["clock"]
    lines.append(f"clock: offset {ck['offset_ns']:.0f} ns, drift {ck['drift']:.3e}, error bound "
                 f"{ck['error_ns']:.0f} ns; stamps "
                 f"launched {doc['stamps_launched']}, expected {doc['stamps_expected']}, dropped "
                 f"{doc['stamps_dropped']}, mismatched {doc['stamps_mismatched']}")
    return "\n".join(lines)
