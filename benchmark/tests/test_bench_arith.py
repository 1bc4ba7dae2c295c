"""The end-to-end arithmetic and the trace reduction on made-up inputs."""
import statistics

import pytest
import torch

from benchmark import devtrace, harness, readers, roofline


class Clock:
    """perf_counter stand-in: each call to `call` advances it by the next
    duration."""

    def __init__(self, durations):
        self.t, self.durations = 0.0, list(durations)

    def now(self):
        return self.t

    def call(self):
        self.t += self.durations.pop(0)
        return 64


def run_window(monkeypatch, durations, seconds):
    clock = Clock(durations)
    monkeypatch.setattr(harness.time, "perf_counter", clock.now)
    return harness.window(clock.call, seconds)


def test_rate_over_the_whole_window(monkeypatch):
    win = run_window(monkeypatch, [0.015625] * 700, 9.99)
    # the last call starts before the 9.99 s and runs to its end
    assert len(win["call_s"]) == 640 and win["wall_s"] == pytest.approx(10.0)
    e2e = harness.end_to_end(["serve_images_per_s", "serve_p95_ms", "setup_s"], win, 30.0)
    assert e2e["serve_images_per_s"] == pytest.approx(64 * 640 / 10.0)
    assert e2e["serve_p95_ms"] == pytest.approx(15.625)
    assert e2e["setup_s"] == 30.0


def test_closed_loop_ends_on_whole_cycles(monkeypatch):
    clock = Clock([0.3, 0.2] * 40)
    monkeypatch.setattr(harness.time, "perf_counter", clock.now)
    win = harness.window(clock.call, 1.05, multiple=2)
    assert len(win["call_s"]) == 6 and win["wall_s"] == pytest.approx(1.5)


def test_one_stall_moves_the_rate_and_p95(monkeypatch):
    calm = run_window(monkeypatch, [0.02] * 600, 10.0)
    stalls = [0.02] * 600
    for i in range(0, 400, 16):  # one call in 16 stalls for 0.2 s
        stalls[i] = 0.2
    stalled = run_window(monkeypatch, stalls, 10.0)
    a = harness.end_to_end(["serve_images_per_s", "serve_p95_ms"], calm, 0.0)
    b = harness.end_to_end(["serve_images_per_s", "serve_p95_ms"], stalled, 0.0)
    assert b["serve_p95_ms"] > 5 * a["serve_p95_ms"]
    assert b["serve_images_per_s"] < 0.85 * a["serve_images_per_s"]
    # a median of windows would not move
    assert statistics.median(stalled["call_s"]) == pytest.approx(0.02)


def test_percentile_is_over_every_call():
    assert harness.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert harness.percentile([5.0], 95) == 5.0


def event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        event("user_annotation", devtrace.SLICE, 0, 1000),
        event("kernel", "cudnn_conv_fwd", 100, 300),
        event("kernel", "raster_fused_windows_kernel", 350, 100),  # overlaps the conv
        event("gpu_memcpy", "Memcpy HtoD", 600, 100),
        event("kernel", "vectorized_elementwise_kernel", 900, 200),  # runs past the span
        event("cpu_op", "aten::nonzero", 450, 200),
        event("cuda_runtime", "cudaStreamSynchronize", 480, 50),
    ]
    r = devtrace.reduce(events, calls=2)
    assert r["window_s"] == pytest.approx(1e-3)
    # busy: [100, 450) + [600, 700) + [900, 1000)
    assert r["busy_s"] == pytest.approx(550e-6)
    assert r["class_s"]["convolution"] == pytest.approx(300e-6)
    assert r["class_s"][readers.PORT_KERNELS] == pytest.approx(100e-6)
    assert r["device_ops"][0] == ["cudnn_conv_fwd", pytest.approx(300e-6)]
    gaps = dict(r["idle_gaps"])
    # [0, 100) and [700, 900) have no host op; [450, 600)'s middle lies in
    # aten::nonzero and, innermost, in the synchronize
    assert gaps["cudaStreamSynchronize"] == pytest.approx(150e-6)
    assert gaps["no host op"] == pytest.approx(300e-6)
    rec = {"slice": r, "window": {"call_s": [0.1] * 10,
                                  "wall_s": 1.0, "thread_s": 0.5},
           "flops_per_call": 6.7e11, "raster_bound_s_per_call": 25e-6}
    assert readers.idle_pct(rec) == pytest.approx(45.0)
    assert readers.class_ms(rec, "convolution") == pytest.approx(0.15)
    assert readers.raster_roofline_pct(rec) == pytest.approx(50.0)
    assert readers.mfu_pct(rec) == pytest.approx(10.0)
    assert readers.host_cpu_ms(rec) == pytest.approx(50.0)


def test_readers_find_nothing_to_read():
    rec = {"window": {"call_s": [0.1], "wall_s": 0.1, "thread_s": 0.01}}
    assert readers.idle_pct(rec) is None and readers.raster_roofline_pct(rec) is None
    assert readers.mfu_pct(rec) is None


def test_box_pairs_and_bounds():
    # one triangle over pixel centres 0..3 of an 8 px image in both axes
    S = 8
    px = torch.tensor([0.0, 3.0, 0.0])
    py = torch.tensor([0.0, 0.0, 3.0])
    fv = torch.stack([(2 * px + 1 - S) / S, (2 * py + 1 - S) / S, torch.ones(3)], -1)
    assert roofline.box_pairs(fv[None, None], S) == 16
    fwd = roofline.raster_forward(fv[None, None], S, 3)
    assert fwd["ops"] == 16 * 16 + 64 * 4 * 3
    assert fwd["bytes"] == 18 * 4 + 4 * 64 * 4
    s, by = roofline.total_bound([fwd])
    assert by == "bytes" and s == pytest.approx(fwd["bytes"] / roofline.PEAK_HBM_BYTES)
