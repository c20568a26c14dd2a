"""Operations and bytes of a kernel call from its shapes, and a roofline
share.  They are the work the shapes need, whatever kernel performs it:
each operand is read once and each output written once.  A model's FLOPs
sit in its configuration's own file (``configs/<config>.py``).
"""
from __future__ import annotations

BF16_BYTES = 2


def causal_pairs(t: int) -> int:
    """(query, key) pairs of one causal sequence of ``t`` positions."""
    return t * (t + 1) // 2


def flash_fwd(b: int, t: int, s: int, hq: int, hkv: int, dh: int) -> tuple:
    """(FLOPs, bytes) of one causal flash-attention forward call in bf16:
    4 dh per visible pair (t == s); q, k, v read and out written once."""
    flops = 4 * dh * b * hq * causal_pairs(t)
    nbytes = BF16_BYTES * b * dh * (2 * t * hq + 2 * s * hkv)
    return flops, nbytes


def flash_bwd(b: int, t: int, s: int, hq: int, hkv: int, dh: int) -> tuple:
    """(FLOPs, bytes) of one causal flash-attention backward call in bf16:
    10 dh per visible pair (Q K^T, dO V^T, dV, dQ, dK); q, out, dout, k, v
    read and dq, dk, dv written once."""
    flops = 10 * dh * b * hq * causal_pairs(t)
    nbytes = BF16_BYTES * b * dh * (4 * t * hq + 4 * s * hkv)
    return flops, nbytes


def roofline_share(flops: float, nbytes: float, seconds: float,
                   peak_ops: float, peak_bytes: float) -> float:
    """Percent of the roofline: the least time the chip could take (the
    larger of operations over the peak rate and bytes over HBM bandwidth)
    over the measured device time."""
    return 100.0 * max(flops / peak_ops, nbytes / peak_bytes) / seconds


def calls_share(trace: dict, key: str, work, kernels) -> float:
    """Roofline share of the calls the trace recorded under ``key`` (their
    shapes, each counted by ``work``) over the device time of the
    operations named in ``kernels``; None where there is nothing to read."""
    from portbench import harness, peaks
    calls = trace["calls"].get(key, [])
    seconds = harness.device_seconds(trace, kernels)
    if not calls or seconds is None:
        return None
    counts = [work(*shape) for shape in calls]
    return roofline_share(sum(f for f, _ in counts),
                          sum(b for _, b in counts), seconds,
                          peaks.BF16_FLOPS, peaks.HBM_BYTES)
