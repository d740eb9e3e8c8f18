"""The trace reduction: busy time is the union of device activity over the
stretch's host-clock length, each idle gap between device ops is named by
the shortest runtime call open at its middle."""

import pytest

from portbench.core import trace


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


def test_reduce():
    events = [
        ev("ampere_bf16_s16816gemm", "kernel", 100, 40),
        ev("mla_decode_queue_mma_kernel", "kernel", 120, 30),  # overlaps the gemm
        ev("Memcpy DtoH", "gpu_memcpy", 190, 5),
        ev("elementwise_kernel", "kernel", 250, 50),
        ev("cudaStreamSynchronize", "cuda_runtime", 150, 45),
        ev("cudaGraphLaunch", "cuda_runtime", 205, 30),
        ev("cudaMemcpyAsync", "cuda_runtime", 196, 100),
    ]
    t = trace.reduce(events, steps=2, window_s=250e-6)
    assert t.steps == 2
    assert t.window_s == pytest.approx(250e-6)
    # busy: 100..150, 190..195, 250..300
    assert t.busy_s == pytest.approx(105e-6)
    assert t.kernel_s(lambda n: trace.kind_of(n) == "cublas") == pytest.approx(40e-6)
    assert sorted(t.idle) == sorted([("cudaStreamSynchronize", 40e-6), ("cudaGraphLaunch", 55e-6)])
    b = t.breakdown()
    assert b["device_ops"][0] == ["elementwise_kernel", pytest.approx(50e-6)]
    assert len(b["idle_gaps"]) == 2


def test_a_gap_with_no_runtime_call_open():
    t = trace.reduce([ev("a", "kernel", 0, 10), ev("b", "kernel", 30, 10)], 1, 50e-6)
    assert t.idle == [("host: no runtime call", pytest.approx(20e-6))]


def test_kind_of():
    assert trace.kind_of("sm90_xmma_gemm_bf16bf16") == "cublas"
    assert trace.kind_of("combine_kernel") == "attention"
    assert trace.kind_of("void at::native::reduce_kernel") == "small_ops"


def test_no_device_activity_is_an_error():
    with pytest.raises(RuntimeError):
        trace.reduce([ev("aten::mm", "cpu_op", 0, 1)], 1, 1e-3)
