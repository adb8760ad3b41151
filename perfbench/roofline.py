"""Published peaks and the least time for a stage's work.

The frequent-term matmul stage's work is counted from its own inputs
and outputs, whatever implements it (the unfused library product, or
K4): the impact matrix read once in its storage (int8 pair 2 B an
entry plus two float32 scales a document; hilo 4 B; bf16 2 B; f32 4
B), the float32 query block read once, the (nq, D_pad) float32 scores
and their 256-column block maxima written once; operations 2 per
nonzero query count and document, per product pass (two for the int8
and hilo pairs), at the storage's peak rate. The least time is the
larger of the two bounds. These are the rules of the K4 bounds in the
port's kernel table (PERF.md), so K4 and the unfused product + K1 read
the same work."""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_s=3.35e12, int8_ops_s=1979e12,
                                  bf16_flops_s=989e12, f32_flops_s=67e12),
}

_IMPACT_BYTES = {"int8": 2, "int8-coarse": 1, "hilo": 4, "bf16": 2, "f32": 4}
_PASSES = {"int8": 2, "int8-coarse": 1, "hilo": 2, "bf16": 1, "f32": 1}
_RATE = {"int8": "int8_ops_s", "int8-coarse": "int8_ops_s",
         "hilo": "bf16_flops_s", "bf16": "bf16_flops_s",
         "f32": "f32_flops_s"}
BLOCK = 256


def peaks(device_name: str) -> dict | None:
    """The card's published peaks, or None for a card not in the table
    (no roofline is then reported)."""
    return PEAKS.get(device_name)


def matmul_bytes(nq: int, K: int, d_pad: int, storage: str) -> int:
    impact = d_pad * K * _IMPACT_BYTES[storage]
    if storage.startswith("int8"):
        impact += d_pad * 4 * (2 if storage == "int8" else 1)
    queries = nq * K * 4
    scores = nq * d_pad * 4
    bmax = nq * (d_pad // BLOCK) * 4
    return impact + queries + scores + bmax


def matmul_ops(nnz: int, d_pad: int, storage: str) -> int:
    return 2 * nnz * d_pad * _PASSES[storage]


def matmul_bound_ms(nq: int, K: int, d_pad: int, storage: str, nnz: int,
                    peak: dict) -> float:
    return 1e3 * max(matmul_bytes(nq, K, d_pad, storage) / peak["hbm_bytes_s"],
                     matmul_ops(nnz, d_pad, storage) / peak[_RATE[storage]])
