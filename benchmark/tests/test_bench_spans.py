"""The spans' reduction (`benchmark/spans.py`) on a made-up Chrome trace:
kernels launched from two host threads, a backward-thread launch inside
the main thread's `smirk.backward`, nested spans, idle gaps, a host-to-device
and a pageable device-to-host copy, and synchronizes inside and outside the
call."""
import json
import os

import pytest

from benchmark import devtrace, harness, spans

MAIN, AUTOGRAD = 1, 2


def ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": MAIN}


def launch(name, ts, corr, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "tid": tid,
            "args": {"correlation": corr}}


def dev(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def op(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "tid": tid}


SPANS = [
    ann(devtrace.SLICE, 0, 1000),
    ann("smirk.train_step", 10, 900),
    ann("smirk.batch", 12, 6),
    ann("smirk.phase1", 20, 480),
    ann("smirk.encoder", 30, 70),
    ann("smirk.masking", 120, 60),
    ann("smirk.backward", 200, 200),
    ann("smirk.readback", 600, 100),
]
WORK = [
    # the batch to the device: a copy, no sync
    launch("cudaMemcpyAsync", 14, 6),
    dev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 15, 2, 6),
    # the encoder's kernel, launched on the main thread
    launch("cudaLaunchKernel", 40, 1),
    dev("kernel", "sm80_xmma_fprop_implicit_gemm", 50, 30, 1),
    # masking waits on the card inside one op
    op("aten::nonzero", 140, 30),
    launch("cudaStreamSynchronize", 150, 5),
    # a backward kernel launched from autograd's thread
    op("autograd::engine::evaluate_function", 240, 30, tid=AUTOGRAD),
    launch("cudaLaunchKernel", 250, 2, tid=AUTOGRAD),
    dev("kernel", "void wgrad_alg0_engine", 260, 50, 2),
    # a kernel under the phase alone
    launch("cudaLaunchKernel", 450, 3),
    dev("kernel", "void at::native::elementwise_kernel", 455, 10, 3),
    # the metrics to the host: a pageable copy and its synchronize, one op
    op("aten::_local_scalar_dense", 610, 80),
    launch("cudaMemcpyAsync", 620, 4),
    dev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 625, 5, 4),
    launch("cudaStreamSynchronize", 632, 8),
    # the caller's synchronize after the call: outside the root
    launch("cudaDeviceSynchronize", 950, 9),
]
EVENTS = SPANS + WORK


def test_spans_device_host_idle():
    r = spans.reduce(EVENTS, 1)
    got = {k: {m: pytest.approx(v[m] * 1e6) if m != "count" else v[m] for m in v}
           for k, v in r["names"].items()}
    # device: each kernel or copy to the innermost span of its launch, the
    # backward thread's launch to the main thread's smirk.backward; idle:
    # gaps (17, 50) encoder, (80, 260) masking, (310, 455) backward,
    # (465, 625) and (630, 1000) the root; (0, 15) lies before the root
    want = {
        "smirk.train_step": dict(device_s=0, host_s=900, idle_s=160 + 370, count=1),
        "smirk.batch": dict(device_s=2, host_s=6, idle_s=0, count=1),
        "smirk.phase1": dict(device_s=10, host_s=480, idle_s=0, count=1),
        "smirk.encoder": dict(device_s=30, host_s=70, idle_s=33, count=1),
        "smirk.masking": dict(device_s=0, host_s=60, idle_s=180, count=1),
        "smirk.backward": dict(device_s=50, host_s=200, idle_s=145, count=1),
        "smirk.readback": dict(device_s=5, host_s=100, idle_s=0, count=1),
    }
    assert got == want
    assert r["unattributed_busy_s"] == pytest.approx(10e-6)
    pc = spans.per_call(dict(r, calls=1))
    assert pc["attributed_share"] == pytest.approx(1 - 10 / 97)


def test_syncs_named_by_span_and_op():
    """The pageable copy and its synchronize in one op are one sync; the
    host-to-device copy and the synchronize after the call are none."""
    r = spans.reduce(EVENTS, 2)
    assert r["syncs"]["count"] == 2
    assert sorted(r["syncs"]["by"]) == [
        ["smirk.masking", "aten::nonzero", "cudaStreamSynchronize", 1],
        ["smirk.readback", "aten::_local_scalar_dense",
         "cudaMemcpyAsync+cudaStreamSynchronize", 1],
    ]
    assert spans.per_call(r)["syncs"] == 1.0


def test_long_range_found_past_many_events():
    """A range opened before tens of thousands of other host events still
    holds what it launches."""
    filler = [op("aten::add", 201 + i * 0.002, 0.001) for i in range(20000)]
    r = spans.reduce(EVENTS + filler, 1)
    assert r["names"]["smirk.backward"]["device_s"] == pytest.approx(50e-6)


def test_spans_leave_the_slice_reduction_alone():
    """The spans in a trace move none of devtrace.reduce's numbers but its
    idle labels."""
    with_spans = devtrace.reduce(EVENTS, 1)
    without = devtrace.reduce([e for e in EVENTS if not e["name"].startswith("smirk.")], 1)
    assert set(with_spans) == set(without)
    for k in set(with_spans) - {"idle_gaps"}:
        assert with_spans[k] == without[k], k
    assert "smirk.backward" in dict(with_spans["idle_gaps"])


def test_every_per_layer_metric_has_its_reader():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for m in manifest["per_layer"]:
        path = os.path.join(harness.HERE, "metrics", m["name"] + ".py")
        assert os.path.isfile(path), m["name"]
        assert callable(harness.metric_reader(m["name"]))
