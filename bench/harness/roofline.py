"""The table of peaks and the operation and byte counts of the kernels.

Peaks: NVIDIA's data sheet for one H100 SXM (dense rates, no sparsity),
which assume the full 700 W power limit; a run prints the card's limit
beside its numbers.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,     # outside the tensor cores
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(kind: str) -> dict:
    """The peaks of the card ``kind`` (``torch.cuda.get_device_name``);
    an H100 of another name (PCIe, NVL) raises: its peaks differ."""
    if kind not in PEAKS:
        raise KeyError(f"no peaks for {kind!r}; known: {sorted(PEAKS)}")
    return PEAKS[kind]


def gram_flops(m: int, n: int) -> float:
    """K1, G = AᵀA + cI of an (m, n) A: the symmetric half's
    m·n·(n+1)/2 multiply-adds, two operations each."""
    return float(m) * n * (n + 1)


def gram_bytes(m: int, n: int, itemsize: int) -> float:
    """K1 reads A once and writes the f32 (n, n) Gram once."""
    return float(m) * n * itemsize + 4.0 * n * n


def gram_bound_s(m: int, n: int, itemsize: int, kind: str) -> float:
    """The least time the card could take for one K1 call: the larger of
    its operations at the f32 rate (bf16 operands: the bf16 rate) and its
    bytes at the HBM rate."""
    p = peaks(kind)
    rate = p["bf16_flops"] if itemsize == 2 else p["f32_flops"]
    return max(gram_flops(m, n) / rate,
               gram_bytes(m, n, itemsize) / p["hbm_bytes_per_s"])
