"""The traced slice's reduction on a synthetic trace: busy union, idle gaps by
host span, and device time tied through correlation ids to the spans."""
import pytest

from perfbench.harness.profiling import DeviceOp, Slice, kernel_seconds, reduce, short_name
from perfbench.harness.recorder import Span

MS = 1_000_000


def test_short_name_strips_templates_and_arguments():
    assert short_name("void encoder_layer_gemm<false, 4, 2>(CUtensorMap, float*)") == \
        "encoder_layer_gemm"
    assert short_name("local_attention_kernel(Params)") == "local_attention_kernel"
    assert short_name("Memset (Device)") == "Memset"
    assert short_name("(anonymous namespace)::encoder_layer_norm<4>(float const*, int)") == \
        "encoder_layer_norm"


def test_reduce_ties_device_time_to_spans():
    spans = [Span("wavlm", 0, 10 * MS, 8), Span("denoiser", 11 * MS, 40 * MS, None)]
    ops = [
        DeviceOp("void wavlm_gemm<1>(x)", 1 * MS, 6 * MS, 1),            # replay in wavlm
        DeviceOp("local_attention_kernel(p)", 12 * MS, 13 * MS, 2),      # replay 1
        DeviceOp("void encoder_layer_gemm<2>(q)", 13 * MS, 16 * MS, 2),
        DeviceOp("void encoder_layer_norm<2>(q)", 15 * MS, 17 * MS, 2),  # starts early (PDL)
        DeviceOp("local_attention_kernel(p)", 20 * MS, 21 * MS, 3),      # replay 2
        DeviceOp("void encoder_layer_gemm<2>(q)", 21 * MS, 24 * MS, 3),
        DeviceOp("elementwise(x)", 24 * MS, 25 * MS, 4),                 # eager op
        DeviceOp("local_attention_kernel(p)", 41 * MS, 42 * MS, 5),      # launched after sync
        DeviceOp("void wavlm_gemm<1>(x)", 0, 1 * MS, 6),                 # launched before start
    ]
    launches = {1: (2 * MS, "cudaGraphLaunch"), 2: (12 * MS, "cudaGraphLaunch"),
                3: (19 * MS, "cudaGraphLaunch"), 4: (23 * MS, "cudaLaunchKernel"),
                5: (36 * MS, "cudaGraphLaunch"), 6: (-1 * MS, "cudaGraphLaunch")}
    red = reduce(Slice(ops, launches, 0, 35 * MS), spans)
    assert red.window_s == pytest.approx(0.024)                        # 1 ms .. 25 ms
    assert red.busy_s == pytest.approx((5 + 5 + 5) / 1000)
    assert red.idle_gaps[0] == ("host in wavlm", pytest.approx(0.006))
    assert red.idle_gaps[1] == ("host in denoiser", pytest.approx(0.003))
    den = red.layers["denoiser"]
    assert den["launches"] == 3 and den["graph_launches"] == 2
    assert den["graph_seconds"] == pytest.approx(0.009)
    assert kernel_seconds(den, r"^local_attention_kernel") == (2, pytest.approx(0.002))
    assert kernel_seconds(den, r"^encoder_layer_") == (3, pytest.approx(0.007))
    wav = red.layers["wavlm"]
    assert wav["graph_seconds"] == pytest.approx(0.005)
    assert sum(sp.count for sp in wav["spans"]) == 8
    assert red.device_ops[0] == ("encoder_layer_gemm", pytest.approx(0.006))


def test_nothing_launched_inside_reads_nothing():
    red = reduce(Slice([DeviceOp("k", 0, 5, 1)], {1: (-1, "cudaLaunchKernel")}, 0, 10), [])
    assert red.busy_s == 0.0 and red.layers == {}
