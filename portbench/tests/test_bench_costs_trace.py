"""The yardstick's arithmetic: work items' costs against hand counts,
the union-of-intervals idle share and the idle gaps' attribution on
synthetic traces, and the 95th percentile over all realizations."""

import math

import pytest

from portbench import peaks, run, trace
from portbench.kernels import k2, noise_gemm


def test_noise_gemm_cost_by_hand():
    c = noise_gemm.cost(m=3, k=4, n=5)
    assert c["flops"] == 2 * 3 * 4 * 5
    assert c["bytes"] == 2 * (3 * 4 + 4 * 5) + 4 * 3 * 5
    # compute-bound at the AtLAST shape: 2 m k n over the bf16 peak
    shape = {"m": 50004, "k": 3119, "n": 3000}
    assert noise_gemm.least_seconds(shape) == pytest.approx(2 * 50004 * 3119 * 3000 / peaks.BF16_FLOPS)


def test_k2_cost_by_hand():
    # the TOD and its ids read once, three Stokes weights a detector of 2, four maps written once
    c = k2.cost(values=10, n_pix=7, maps=4, weights=6)
    assert c["bytes"] == 4 * 10 + 4 * 10 + 4 * 6 + 4 * 7 * 4
    # a sum and a hit count of the AtLAST TOD
    shape = {"values": 50004 * 3000, "n_pix": 16384, "maps": 2}
    assert k2.least_seconds(shape) == (8 * 50004 * 3000 + 4 * 16384 * 2) / peaks.HBM_BYTES_PER_S


def test_kernel_attribution():
    assert noise_gemm.matches("void cutlass::Kernel2<cutlass_75_tensorop_s1688gemm_bf16_256x128_nn_align1>(...)")
    assert not noise_gemm.matches("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>(...)")
    assert k2.matches("void bin_map_kernel<1, true>(float const*, int const*)")


@pytest.mark.parametrize("intervals, length", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(0, 1), (2, 3), (0.5, 2.5)], 3.0),
    ([(5, 6), (0, 1), (0, 1)], 2.0),
])
def test_union_length(intervals, length):
    assert trace.union_length(intervals) == pytest.approx(length)


def test_idle_gaps_and_summary():
    events = [
        {"name": "portbench.window", "cat": "user_annotation", "ts": 0.0, "dur": 100.0},
        {"name": "k_a", "cat": "kernel", "ts": 10.0, "dur": 20.0},
        {"name": "k_b", "cat": "kernel", "ts": 20.0, "dur": 20.0},  # overlaps k_a: counted once
        {"name": "k_a", "cat": "kernel", "ts": 70.0, "dur": 10.0},
        {"name": "step", "cat": "cpu_op", "ts": 0.0, "dur": 100.0},
        {"name": "host_work", "cat": "cpu_op", "ts": 45.0, "dur": 20.0},
    ]
    s = trace.summarize_events(events)
    assert s["busy_s"] == pytest.approx(40e-6)  # [10, 40] and [70, 80]
    assert s["window_s"] == pytest.approx(100e-6)
    assert dict(s["device_ops"]) == pytest.approx({"k_a": 30e-6, "k_b": 20e-6})
    gaps = dict(s["idle_gaps"])  # [0, 10] and [80, 100] under "step", [40, 70] under "host_work"
    assert gaps == pytest.approx({"step": 30e-6, "host_work": 30e-6})
    assert trace.idle_gaps([(10, 40), (70, 80)], 0, 100) == [(0, 10), (40, 70), (80, 100)]


def test_short_names():
    name = "vectorized_elementwise_kernel<4>(int)"
    assert trace.short_name(f"void at::native::{name}") == name


@pytest.mark.parametrize("n", [5, 19, 20, 100, 1001])
def test_p95_over_all_realizations(n):
    values = [float(i) for i in range(1, n + 1)]
    got = run.quantile95(values)
    if n < 20:
        assert got == max(values)
    else:
        # the exclusive method: position 0.95 (n + 1), interpolated
        pos = 0.95 * (n + 1)
        lo = math.floor(pos)
        assert got == pytest.approx(values[lo - 1] + (pos - lo) * (values[min(lo, n - 1)] - values[lo - 1]))


def test_seeds_are_reproducible_and_large():
    seed = 2**31 + 12345
    assert run.realization_seed(seed, 3) == run.realization_seed(seed, 3)
    assert run.realization_seed(seed, 3) != run.realization_seed(seed, 4)
    assert 0 <= run.realization_seed(seed, -1) < 2**63
    picked = run.checked_indices(seed)
    assert picked == run.checked_indices(seed) and len(set(picked)) == run.CHECKED
    assert all(0 <= i < run.CHECK_CAP for i in picked)
