"""Frozen copy of the plain (PyTorch) windowed warp gather of
rgbd360_torch/ops/warp_gather.py, the semantics the CUDA kernel
csrc/warp_gather.cu computes bit for bit: the benchmark's reference runs
this on the device where the program launches the kernel. Kept here so that
no change to the program moves the yardstick; imports nothing of the
program.
"""

from __future__ import annotations

import torch

# Window constants (JAX warp_gather.py:51-70, their defaults; fixed)
BR, BC = 8, 128  # source tile
PR = 14  # target window rows
K = 4  # per-output-row row window
PC = 256  # target window columns
_BIG = 1 << 24  # sentinel of the masked reductions (JAX :211)
_FLAG_BITS = 0x3F800000  # f32 1.0, the in-window flag of channel 6

# anchor sets the path uses: the exact-final re-gather and full coverage
DUAL = ("min", "max")
FULL = ("mean", "min", "max")

def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def wrap_halo(wt: int) -> int:
    """Width of the theta-wrap halo (JAX :148): for wt <= 2*PC it is
    min(PC, wt); above that it fills the BC-aligned padded width with
    wrapped columns, so no remapped window reaches zero padding."""
    halo = min(PC, wt)
    if wt > 2 * PC:
        halo = max(_round_up(wt + PC, BC), PC + BC) - wt
    return halo


def _geometry(ht: int, wt: int, wrap: bool):
    """(hp, wp_ext, w_eff, halo) of the padded target footprint, as
    _prep_operands (JAX :187-195) and window_mask_reference (:740-749)."""
    hp = max(ht, PR)
    halo = wrap_halo(wt) if wrap else 0
    wp_ext = max(_round_up(wt + halo, BC), PC + BC)
    w_eff = wt if wrap else (1 << 22)  # straddle threshold; off without wrap
    return hp, wp_ext, w_eff, halo


def _tile_view(x: torch.Tensor, hop: int, wop: int) -> torch.Tensor:
    """(B, hop, wop) -> (B, nr, nc, BR, BC)."""
    b = x.shape[0]
    return x.reshape(b, hop // BR, BR, wop // BC, BC).permute(0, 1, 3, 2, 4)


def _untile(x: torch.Tensor) -> torch.Tensor:
    b, nr, nc = x.shape[:3]
    return x.permute(0, 1, 3, 2, 4).reshape(b, nr * BR, nc * BC)


def _pad_indices(r_idx, c_idx, active, pad_active=False):
    """Edge-replicate r/c and pad active with ``pad_active`` to the (BR, BC)
    grid (_prep_operands, JAX :197-200): pad pixels take no part in the
    pipelined passes, and every part in the single-buffer one."""
    _, ho, wo = r_idx.shape
    hop, wop = _round_up(ho, BR), _round_up(wo, BC)
    if (hop, wop) != (ho, wo):
        dev = r_idx.device
        ri = torch.clamp(torch.arange(hop, device=dev), max=ho - 1)
        ci = torch.clamp(torch.arange(wop, device=dev), max=wo - 1)
        r_idx = r_idx.index_select(1, ri).index_select(2, ci)
        c_idx = c_idx.index_select(1, ri).index_select(2, ci)
        active = torch.nn.functional.pad(active, (0, wop - wo, 0, hop - ho), value=pad_active)
    return r_idx, c_idx, active, hop, wop


def _masked_min(x, m, dims):
    return torch.amin(torch.where(m, x, torch.full_like(x, _BIG)), dim=dims)


def _masked_max(x, m, dims):
    return torch.amax(torch.where(m, x, torch.full_like(x, -_BIG)), dim=dims)


def _remap_seam(c_t, a_t, w):
    """Per-tile straddle test over the active targets and the +W remap of
    the low side (JAX :299-302, :762-766). Returns the remapped columns."""
    spread = _masked_max(c_t, a_t, (3, 4)) - _masked_min(c_t, a_t, (3, 4))
    straddle = (spread > (w // 2))[..., None, None]
    return torch.where(straddle & (c_t < w // 2), c_t + w, c_t)


def _origins(r_t, c_t, a_t, hp, wp_ext, kind):
    """Window origins (B, nr, nc, 1, 1) from seam-remapped tile columns
    (JAX _tile_origins :236-250 == window_mask_reference :767-786)."""
    if kind == "max":
        r0 = torch.clamp(_masked_max(r_t, a_t, (3, 4)) - (PR - 1), 0, hp - PR)
        c0 = torch.clamp(
            _masked_max(c_t, a_t, (3, 4)) // 128 * 128 - (PC - 128), 0, wp_ext - PC
        )
    else:
        r0 = torch.clamp(_masked_min(r_t, a_t, (3, 4)), 0, hp - PR)
        c0 = torch.clamp(_masked_min(c_t, a_t, (3, 4)), 0, wp_ext - PC) // 128 * 128
    return r0[..., None, None], c0[..., None, None]


def _windows(r_idx, c_idx, active, policies, target_shape, wrap, pad_active=False):
    """Coverage of each row policy, plus the seam-remapped columns.

    r_idx/c_idx (B, Ho, Wo) i32, active (B, Ho, Wo) bool. Returns
    ([in_window (B, Ho, Wo) bool per policy], c_remapped (B, Ho, Wo))."""
    _, ho, wo = r_idx.shape
    ht, wt = target_shape
    hp, wp_ext, w, _halo = _geometry(ht, wt, wrap)
    r_p, c_p, a_p, hop, wop = _pad_indices(r_idx, c_idx, active, pad_active)
    r_t, c_t = _tile_view(r_p, hop, wop), _tile_view(c_p, hop, wop)
    a_t = _tile_view(a_p, hop, wop)
    c_t = _remap_seam(c_t, a_t, w)
    masks = []
    for policy in policies:
        r0, c0 = _origins(r_t, c_t, a_t, hp, wp_ext, "max" if policy == "max" else "min")
        lr = r_t - r0
        lc = c_t - c0
        lc_ok = (lc >= 0) & (lc < PC) & a_t
        if policy == "mean":
            row_n = torch.clamp(lc_ok.to(torch.float32).sum(dim=4), min=1.0)
            row_sum = torch.where(lc_ok, lr.to(torch.float32), torch.zeros((), device=lr.device)).sum(dim=4)
            # (mean - (K-1)/2) + 0.5 in f32, truncated: the TPU kernel's order
            lo = ((row_sum / row_n - (K - 1) / 2) + 0.5).to(torch.int32)
        elif policy == "min":
            lo = _masked_min(lr, lc_ok, 4).to(torch.int32)
        else:
            lo = (_masked_max(lr, lc_ok, 4) - (K - 1)).to(torch.int32)
        lo = torch.clamp(lo, 0, PR - K)[..., None]
        in_win = lc_ok & (lr >= lo) & (lr < lo + K)
        masks.append(_untile(in_win)[:, :ho, :wo])
    return masks, _untile(c_t)[:, :ho, :wo]


def window_mask_reference(
    r_idx: torch.Tensor,
    c_idx: torch.Tensor,
    active: torch.Tensor = None,
    row_policy: str = "mean",
    target_shape=None,
    wrap: bool = True,
) -> torch.Tensor:
    """The kernel's in-window mask in plain torch (JAX :718), batched:
    r_idx/c_idx (B, Ho, Wo) or (Ho, Wo) i32 target coordinates clipped into
    range. Returns bool of the same shape."""
    single = r_idx.dim() == 2
    if single:
        r_idx, c_idx = r_idx[None], c_idx[None]
        active = None if active is None else active[None]
    if active is None:
        active = torch.ones(r_idx.shape, dtype=torch.bool, device=r_idx.device)
    shape = target_shape if target_shape is not None else tuple(r_idx.shape[1:])
    (mask,), _ = _windows(r_idx, c_idx, active.to(torch.bool), (row_policy,), shape, wrap)
    return mask[0] if single else mask


def _read_covered(planes, r_idx, c_rm, hit, wrap):
    """The 8 target channels of each covered pixel as int32 bits, 0 where
    uncovered: (B, 8, Ho, Wo). The halo-padded read: remapped columns
    wt.. read wt+j -> j; anything past the halo, or past the last row, is
    the TPU copy's zero padding (unreachable for clipped indices, kept so
    both versions agree anyway)."""
    bsz, ht, _cdim, wt = planes.shape
    _hp, _wp, _w, halo = _geometry(ht, wt, wrap)
    readable = (r_idx >= 0) & (r_idx < ht) & (c_rm >= 0) & (c_rm < wt + halo)
    rr = torch.clamp(r_idx, 0, ht - 1).long()
    cc = torch.clamp(torch.where(c_rm >= wt, c_rm - wt, c_rm), 0, wt - 1).long()
    b_idx = torch.arange(bsz, device=planes.device).view(bsz, 1, 1)
    bits = planes.view(torch.int32)[b_idx, rr, :, cc].permute(0, 3, 1, 2)
    take = (hit & readable)[:, None]
    return torch.where(take, bits, torch.zeros((), dtype=torch.int32, device=bits.device))


def _gather_plain(planes, r_idx, c_idx, active, policies, wrap):
    """Plain version of the kernel for any anchor list: OR of the
    per-anchor coverage, then a bitwise select of the direct read."""
    _bsz, ht, _cdim, wt = planes.shape
    masks, c_rm = _windows(r_idx, c_idx, active, policies, (ht, wt), wrap)
    hit = masks[0]
    for m in masks[1:]:
        hit = hit | m
    out = _read_covered(planes, r_idx, c_rm, hit, wrap)
    out[:, 6] = torch.where(hit, _FLAG_BITS, 0).to(torch.int32)
    return out.view(torch.float32), hit


def warp_gather_batched_plain(planes, r_idx, c_idx, active=None, row_policy="mean", wrap=True):
    """Plain torch version of ``warp_gather_batched``."""
    if active is None:
        active = torch.ones(r_idx.shape, dtype=torch.bool, device=r_idx.device)
    return _gather_plain(planes, r_idx, c_idx, active, (row_policy,), wrap)


def warp_gather_batched_multi_plain(planes, r_idx, c_idx, active, wrap=True, anchors=DUAL):
    """Plain torch version of ``warp_gather_batched_multi``."""
    return _gather_plain(planes, r_idx, c_idx, active, tuple(anchors), wrap)


# the names the aligner calls: on every device, the plain version
warp_gather_batched = warp_gather_batched_plain
warp_gather_batched_multi = warp_gather_batched_multi_plain
