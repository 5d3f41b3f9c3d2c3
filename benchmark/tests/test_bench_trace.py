"""The trace arithmetic on synthetic intervals: busy time as a union, the
idle share over the whole window (gaps before the first operation and
after the last count), the gaps named by the host span open, and kernel
names sorted into the port's attention kernels, library products and the
rest."""

from __future__ import annotations

import pytest

from benchmark import trace
from benchmark.trace import Trace


def test_idle_share_counts_the_gaps_at_both_ends():
    # window 0..100 ns; kernels 10..30, 20..40 (overlapping), 60..90
    tr = Trace(ops=[("k1", 10, 30), ("k2", 20, 40), ("k3", 60, 90)], window=(0, 100))
    assert tr.busy_s() == pytest.approx(60e-9)
    assert tr.idle_share() == pytest.approx(40.0)
    # an operation that starts before the window counts only inside it
    tr = Trace(ops=[("k", -50, 20), ("k", 95, 130)], window=(0, 100))
    assert tr.busy_s() == pytest.approx(25e-9)
    assert tr.idle_share() == pytest.approx(75.0)


def test_no_window_reads_nothing():
    assert Trace(ops=[("k", 0, 1)]).idle_share() is None


def test_idle_gaps_are_named_by_the_innermost_open_span():
    tr = Trace(ops=[("k", 10, 20), ("k", 50, 60)], window=(0, 100),
               spans=[("bench.window", 0, 100), ("bench.segment", 5, 45), ("bench.segment", 45, 100)])
    gaps = tr.idle_gaps()
    assert gaps[0] == ["bench.segment", pytest.approx(40e-9)]  # 60..100, under the second segment
    assert ["bench.segment", pytest.approx(30e-9)] in gaps  # 20..50 begins under the first
    assert ["bench.window", pytest.approx(10e-9)] in gaps  # 0..10, before any segment


def test_top_ops_group_by_symbol():
    tr = Trace(ops=[("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16>(Params<__nv_bfloat16>)", 0, 30),
                    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16>(Params<__nv_bfloat16>)", 40, 70),
                    ("Memset (Device)", 80, 85)], window=(0, 100))
    assert tr.top_ops() == [["flash_fwd_kernel", pytest.approx(60e-9)], ["Memset", pytest.approx(5e-9)]]


@pytest.mark.parametrize("name,family,matmul", [
    ("void (anonymous namespace)::flash_fwd_kernel<__half>(Params<__half>)", "b1", False),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<__nv_bfloat16>(Params<__nv_bfloat16>)", "b2", False),
    ("void (anonymous namespace)::banded_fwd_kernel<__nv_bfloat16>(Params<__nv_bfloat16>)", "b4", False),
    ("nvjet_tst_192x208_64x4_2x1_v_bz_coopB_bias_TNT", None, True),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_cudnn", None, True),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_align4>(Params)", None, True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int, float)", None, False),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float, float>(long, float)", None, False),
])
def test_kernel_families(name, family, matmul):
    assert trace.attention_family(name) == family
    assert trace.is_matmul(name) is matmul
