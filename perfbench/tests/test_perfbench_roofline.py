"""The matmul stage's least time reproduces the K4 bounds of the port's
kernel table from shapes alone."""

import pytest

from perfbench import roofline

H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


@pytest.mark.parametrize("nq,K,d_pad,storage,want", [
    (8192, 2048, 51200, "int8", 0.5855),
    (8192, 2048, 51200, "hilo", 0.6480),
    (1024, 1024, 1001472, "int8", 1.8452),
])
def test_k4_bounds(nq, K, d_pad, storage, want):
    nnz = nq * 8   # every bound here is the bytes bound
    got = roofline.matmul_bound_ms(nq, K, d_pad, storage, nnz, H100)
    assert round(got, 4) == want
    assert roofline.matmul_bytes(nq, K, d_pad, storage) / H100[
        "hbm_bytes_s"] > roofline.matmul_ops(nnz, d_pad, storage) / H100[
        "int8_ops_s" if storage == "int8" else "bf16_flops_s"]


def test_unknown_card_reads_no_peak():
    assert roofline.peaks("some other card") is None
