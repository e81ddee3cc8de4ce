"""The chip's peaks and the byte bound of the windowed warp gather.

The bound is chip_smoke.py's ``gather_bound_ms`` (the operands and outputs
of one launch, each moved through HBM once, at the data sheet's 3.35 TB/s),
frozen here with the shapes of csrc/warp_gather.cu's operands: a gather has
no arithmetic to bound it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth at the 700 W limit
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def gather_bytes(batch: int, target_h: int, target_w: int, out_h: int, out_w: int, active: bool) -> int:
    """Bytes one launch must move: planes (B, Ht, 8, Wt) f32, r and c (B,
    Ho, Wo) i32, active (B, Ho, Wo) bool when given; out (B, 8, Ho, Wo) f32
    and the mask (B, Ho, Wo) bool."""
    n_out = batch * out_h * out_w
    return batch * target_h * 8 * target_w * 4 + 2 * n_out * 4 + (n_out if active else 0) + n_out * 8 * 4 + n_out


def bound_seconds(nbytes: int, kind: str):
    """Least time to move ``nbytes`` on the card ``kind``, or None for a card
    whose peak the table lacks."""
    peak = HBM_BYTES_PER_S.get(kind)
    return None if peak is None else nbytes / peak
