"""The copied trace arithmetic on a hand-written Chrome trace."""
from __future__ import annotations

import pytest

from benchmark import trace


def _trace():
    # Two requests. Host: a user annotation per request, the graph launch
    # inside the first, an eager kernel launch inside the second, and the
    # host read after each. Device: the first request's three kernels (the
    # attribute sweep among them) and a memcpy; the second's kernel and a
    # memset. Times in microseconds.
    X = "X"
    return {"traceEvents": [
        {"ph": X, "cat": "user_annotation", "name": "bench/request", "ts": 0, "dur": 100},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 10, "dur": 20},
        {"ph": X, "cat": "kernel", "name": "void culled_sweep_kernel<true>(float const*)",
         "ts": 40, "dur": 10},
        {"ph": X, "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>()",
         "ts": 50, "dur": 30},
        {"ph": X, "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "ts": 80,
         "dur": 5},
        {"ph": X, "cat": "user_annotation", "name": "bench/host_read", "ts": 100, "dur": 200},
        {"ph": X, "cat": "kernel", "name": "ampere_sgemm_64x64_nn", "ts": 200, "dur": 50},
        {"ph": X, "cat": "user_annotation", "name": "bench/request", "ts": 300, "dur": 100},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 310, "dur": 5},
        {"ph": X, "cat": "cpu_op", "name": "aten::mul", "ts": 305, "dur": 20},
        {"ph": X, "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>()",
         "ts": 330, "dur": 20},
        {"ph": X, "cat": "gpu_memset", "name": "Memset (Device)", "ts": 350, "dur": 5},
        # a span the profiler puts on the device for an annotation: not busy time
        {"ph": X, "cat": "gpu_user_annotation", "name": "bench/request", "ts": 40, "dur": 45},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0},
    ]}


def test_busy_launches_and_families():
    s = trace.summarize(_trace())
    assert s["busy_s"] == pytest.approx((10 + 30 + 5 + 50 + 20 + 5) / 1e6)
    assert s["device_events"] == 6
    assert (s["launches"], s["graph_launches"]) == (1, 1)
    fam = dict(s["families"])
    assert fam["vectorized_elementwise_kernel"] == pytest.approx(50e-6)
    assert fam["culled_sweep_kernel"] == pytest.approx(10e-6)
    assert fam["ampere_sgemm_64x64_nn"] == pytest.approx(50e-6)
    assert s["raster"]["attrs"] == {"seconds": pytest.approx(10e-6), "launches": 1}
    assert s["raster"]["z/fid"] == {"seconds": 0.0, "launches": 0}


def test_idle_gaps_by_host_activity():
    gaps = dict(trace.summarize(_trace())["idle_gaps"])
    # 85 -> 200 starts inside the first request's span (its graph launch
    # has ended); 250 -> 330 starts inside the host read.
    assert gaps == {"bench/request": pytest.approx(115e-6),
                    "bench/host_read": pytest.approx(80e-6)}


def test_idle_share_and_roofline_share():
    s = trace.summarize(_trace())
    window_s = 400e-6
    assert 1 - s["busy_s"] / window_s == pytest.approx(1 - 120 / 400)
    nbytes = trace.raster_bytes("attrs", 1, 4096, 240, 240, 6)
    assert nbytes == 4096 * (64 + 16 + 72) + 240 * 240 * (8 + 24) == 2465792
    assert trace.raster_bytes("z/fid", 8, 4096, 240, 240, 6) == 8 * (4096 * 80 + 57600 * 8)
    # 3.35e12 bytes/s: 2,465,792 bytes take 0.736 us; at 7.36 us the share is 10%
    assert trace.roofline_share(nbytes, nbytes / 3.35e12 * 10) == pytest.approx(10.0)
    assert trace.family("void culled_sweep_kernel<true>(float const*)") == "culled_sweep_kernel"
    assert trace.family("fusion.12 = add") == "fusion"


def test_idle_share_from_call_gaps():
    """The idle share is the gaps between calls over the window, both from
    the card's events in one window; it is silent where there are none."""
    from benchmark import readers

    ctx = dict(kind="serve", call_gaps=(30.0, 2.25))
    assert readers.idle_share(ctx, "serve") == pytest.approx(7.5)
    assert readers.idle_share(ctx, "train") is None
    assert readers.idle_share(dict(kind="serve", call_gaps=None), "serve") is None
