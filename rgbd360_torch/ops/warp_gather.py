"""Windowed warp gather — the gather of the dense aligner's sweeps on the
large pyramid levels.

Counterpart of rgbd360_tpu/ops/warp_gather.py. The JAX package runs it as
the Pallas kernels ``_kernel_pipelined`` (warp_gather.py:254) and
``_kernel_pipelined_multi`` + ``_gather_tile`` (:363, :441); here both are
one CUDA kernel, ``csrc/warp_gather.cu``, since a single-anchor pass is the
multi-anchor pass with one anchor.

Semantics (what the TPU kernel computes, kept bit for bit):
  * source pixels form (BR, BC) = (8, 128) tiles; each tile places a
    PR x PC = 14 x 256 target window at the min (or, for the "max" anchor,
    the max) of its active targets, the column origin 128-aligned
    (``tile_origins``, JAX :214-251);
  * a tile whose active targets spread over more than W/2 straddles the
    theta seam: its low side is remapped by +W into the wrap halo
    (``wrap_halo``, JAX :148-165);
  * each output row reads a K = 4-row sub-window placed by the row policy:
    the row's mean ("mean"), lowest ("min") or highest ("max") in-window
    target row (JAX :312-327);
  * a covered pixel returns the 8 target channels at (r, c), with the
    in-window flag as f32 1.0 in channel 6; an uncovered pixel returns 0.

On the GPU the window is only a coverage predicate: a covered pixel reads
its target straight from the (B, H, 8, W) planes. ``wrap_halo``'s rule is
what makes that equal to reading the TPU kernel's halo-padded copy: no
reachable window position lands on zero padding.

Data moves as int32 bits and is selected, never accumulated: the target
planes hold -0.0 (the seam mask multiplies negative gradients by 0) and
f32 denormals, and a float ``acc + val`` would turn -0.0 into +0.0.

The single-buffer pass (``warp_gather_single``; the Pallas ``_kernel``,
JAX :86) is what ``warp_gather_batched`` runs when the module constant
``PIPELINE_KERNEL`` is False, as in JAX (:644, :688-711). It is a mean
pass, but not the pipelined mean pass with ``active`` all-true:
  * it takes no ``active`` (any given is ignored, whatever the
    ``row_policy``): every pixel of the (8, 128) tile grid takes part, the
    edge-replicated pad pixels too, in the straddle test, the window origin
    and the row means — so on a level whose last column tile is half pad
    (960 and 480 wide) its windows differ from the pipelined pass's;
  * the output is accumulated in f32 (``acc + where(sel, val, 0.0)``), and
    both backends of the JAX package flush denormals in float adds (the TPU;
    XLA on the CPU runs with DAZ/FTZ set, so interpret mode does too). So a
    gathered -0.0 or denormal comes back as +0.0: ``0.0 + x`` is x for every
    other non-NaN x. Both versions compute that on the bits (exponent field
    0 -> 0), which no float unit or compiler flag can change;
  * channel 6 is the gathered channel, not the flag; the mask is separate.
Both the plain version and csrc/warp_gather.cu keep these bit for bit.

Each public wrapper takes CPU tensors through its plain PyTorch version and
CUDA tensors through the kernel (or raises); there is no fallback between
the two. ``LAUNCHES`` counts kernel launches per wrapper (a counter group
of utils/timing.py, counted under its lock: shard threads launch
concurrently).

Not ported: the ``custom_vmap`` single-pair entries (the port is batched
throughout) and the ``RGBD360_WARP_*`` environment knobs (the window
constants are fixed).
"""

from __future__ import annotations

import ctypes

import torch

from rgbd360_torch.utils import timing

# Window constants (JAX warp_gather.py:51-70, their defaults; fixed here)
BR, BC = 8, 128  # source tile
PR = 14  # target window rows
K = 4  # per-output-row row window
PC = 256  # target window columns
_BIG = 1 << 24  # sentinel of the masked reductions (JAX :211)
_FLAG_BITS = 0x3F800000  # f32 1.0, the in-window flag of channel 6
_EXP_BITS = 0x7F800000  # f32 exponent field: 0 for +-0.0 and denormals

ANCHOR_CODES = {"mean": 0, "min": 1, "max": 2}
# anchor sets the path uses: the exact-final re-gather and full coverage
DUAL = ("min", "max")
FULL = ("mean", "min", "max")

# JAX warp_gather.py:208: False sends warp_gather_batched through the
# single-buffer pass. Read at call time; set it on the module.
PIPELINE_KERNEL = True

# kernel launches per wrapper; reset by the caller that reads them
LAUNCHES = timing.counter_group(
    "warp_gather.LAUNCHES", {"warp_gather_batched": 0, "warp_gather_batched_multi": 0, "warp_gather_single": 0})


def reset_launch_counts() -> None:
    timing.reset_counts(LAUNCHES)


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


def tile_origins(r_idx, c_idx, active, w_real, hp, wp_ext, anchor="min"):
    """Per-tile window origins on (B, hop, wop) index arrays already padded
    to the tile grid (JAX _tile_origins :214). Returns (B, nr, nc) i32
    r0s, c0s."""
    _, hop, wop = r_idx.shape
    r_t, c_t = _tile_view(r_idx, hop, wop), _tile_view(c_idx, hop, wop)
    a_t = _tile_view(active.to(torch.bool), hop, wop)
    c_t = _remap_seam(c_t, a_t, w_real)
    r0, c0 = _origins(r_t, c_t, a_t, hp, wp_ext, "max" if anchor == "max" else "min")
    return r0[..., 0, 0].to(torch.int32), c0[..., 0, 0].to(torch.int32)


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


def _check(planes, r_idx, c_idx, active):
    if planes.dim() != 4 or planes.shape[2] != 8 or planes.dtype != torch.float32:
        raise ValueError(f"planes must be (B, H, 8, W) float32, got {tuple(planes.shape)} {planes.dtype}")
    if r_idx.dim() != 3 or r_idx.shape != c_idx.shape or r_idx.shape[0] != planes.shape[0]:
        raise ValueError(f"r/c must be (B, Ho, Wo) with B={planes.shape[0]}, got {tuple(r_idx.shape)} {tuple(c_idx.shape)}")
    if r_idx.dtype != torch.int32 or c_idx.dtype != torch.int32:
        raise ValueError(f"r/c must be int32, got {r_idx.dtype} {c_idx.dtype}")
    if active is not None and (active.shape != r_idx.shape or active.dtype != torch.bool):
        raise ValueError(f"active must be bool {tuple(r_idx.shape)}, got {tuple(active.shape)} {active.dtype}")
    tensors = [planes, r_idx, c_idx] + ([active] if active is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("planes, r, c and active must lie on one device")


def warp_gather_batched_plain(planes, r_idx, c_idx, active=None, row_policy="mean", wrap=True):
    """Plain torch version of ``warp_gather_batched``."""
    if active is None:
        active = torch.ones(r_idx.shape, dtype=torch.bool, device=r_idx.device)
    return _gather_plain(planes, r_idx, c_idx, active, (row_policy,), wrap)


def warp_gather_batched_multi_plain(planes, r_idx, c_idx, active, wrap=True, anchors=DUAL):
    """Plain torch version of ``warp_gather_batched_multi``."""
    return _gather_plain(planes, r_idx, c_idx, active, tuple(anchors), wrap)


def warp_gather_single_plain(planes, r_idx, c_idx, wrap=True):
    """Plain torch version of ``warp_gather_single``: the mean pass with
    every pixel of the padded tile grid active, then the flushing f32
    accumulation of the covered read (0.0 + val: -0.0 and denormals become
    +0.0) into all 8 channels."""
    _bsz, ht, _cdim, wt = planes.shape
    every = torch.ones(r_idx.shape, dtype=torch.bool, device=r_idx.device)
    (hit,), c_rm = _windows(r_idx, c_idx, every, ("mean",), (ht, wt), wrap, pad_active=True)
    bits = _read_covered(planes, r_idx, c_rm, hit, wrap)
    out = torch.where((bits & _EXP_BITS) != 0, bits, torch.zeros((), dtype=torch.int32, device=bits.device))
    return out.view(torch.float32), hit


def _launch(planes, r_idx, c_idx, active, anchors, wrap, out=None):
    """Run csrc/warp_gather.cu on CUDA tensors; raise on any failure.
    ``anchors`` None runs the single-buffer entry (no active, no flag).
    ``out``: an (out, mask) pair to write instead of new tensors."""
    from rgbd360_torch.kernels.build import load_library

    for t, name in ((planes, "planes"), (r_idx, "r"), (c_idx, "c")):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if active is not None and not active.is_contiguous():
        raise ValueError("active must be contiguous")
    bsz, ht, _c, wt = planes.shape
    _, ho, wo = r_idx.shape
    hp, wp_ext, w_eff, halo = _geometry(ht, wt, wrap)
    if out is None:
        out = torch.empty((bsz, 8, ho, wo), dtype=torch.float32, device=planes.device)
        mask = torch.empty((bsz, ho, wo), dtype=torch.bool, device=planes.device)
    else:
        out, mask = out
        for t, shape, dtype in ((out, (bsz, 8, ho, wo), torch.float32), (mask, (bsz, ho, wo), torch.bool)):
            if tuple(t.shape) != shape or t.dtype != dtype or t.device != planes.device or not t.is_contiguous():
                raise ValueError(f"out must be contiguous {dtype} {shape} on {planes.device}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (planes, r_idx, c_idx)]
    outs = [ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(mask.data_ptr())]
    dims = (bsz, ht, wt, ho, wo, w_eff, hp, wp_ext, wt + halo)
    stream = ctypes.c_void_p(torch.cuda.current_stream(planes.device).cuda_stream)
    lib = load_library()
    if anchors is not None and (not 1 <= len(anchors) <= 3 or any(a not in ANCHOR_CODES for a in anchors)):
        raise ValueError(f"anchors must be 1-3 of {tuple(ANCHOR_CODES)}, got {anchors}")
    # <<<grid, block, 0, stream>>> launches on the calling thread's current
    # device: make it the tensors' card
    with torch.cuda.device_of(planes):
        if anchors is None:
            err = lib.rgbd360_warp_gather_single(*ptrs, *outs, *dims, stream)
        else:
            codes = [ANCHOR_CODES[a] for a in anchors] + [0] * (3 - len(anchors))
            act = ctypes.c_void_p(active.data_ptr() if active is not None else 0)
            err = lib.rgbd360_warp_gather(*ptrs, act, *outs, *dims, len(anchors), *codes, stream)
    if err != 0:
        raise RuntimeError(f"warp_gather kernel launch failed: cudaError_t {err}")
    return out, mask


def _into(out, result):
    """The plain versions' result copied into a caller's (out, mask) pair."""
    if out is None:
        return result
    out[0].copy_(result[0])
    out[1].copy_(result[1])
    return out


def warp_gather_batched(planes, r_idx, c_idx, active=None, row_policy="mean", wrap=True, out=None):
    """Windowed gather with one row policy (JAX warp_gather_batched :614).

    planes (B, Ht, 8, Wt) f32 [gray, depth, ggx, ggy, dgx, dgy, 0, 0];
    r_idx/c_idx (B, Ho, Wo) i32 clipped into (Ht, Wt); active optional
    (B, Ho, Wo) bool — only these pixels place windows and are gathered;
    wrap: columns wrap at Wt (the panorama theta seam).
    Returns (out (B, 8, Ho, Wo) f32 with the in-window flag in channel 6,
    in_window (B, Ho, Wo) bool); ``out`` given, that pair, written (the
    aligner's CUDA graphs read the gather from buffers of their own).

    With ``PIPELINE_KERNEL`` False this is ``warp_gather_single`` whatever
    the row policy, and ``active`` is ignored (JAX :688-711)."""
    _check(planes, r_idx, c_idx, active)
    if row_policy not in ANCHOR_CODES:
        raise ValueError(f"row_policy must be one of {tuple(ANCHOR_CODES)}, got {row_policy!r}")
    if not PIPELINE_KERNEL:
        return _into(out, warp_gather_single(planes, r_idx, c_idx, wrap))
    if planes.device.type == "cpu":
        return _into(out, warp_gather_batched_plain(planes, r_idx, c_idx, active, row_policy, wrap))
    result = _launch(planes, r_idx, c_idx, active, (row_policy,), wrap, out)
    timing.count(LAUNCHES, "warp_gather_batched")
    return result


def warp_gather_batched_multi(planes, r_idx, c_idx, active, wrap=True, anchors=DUAL, out=None):
    """One pass covering the union of the per-anchor windows (JAX
    warp_gather_batched_multi :535): ("min", "max") is the exact-final
    re-gather, ("mean", "min", "max") full coverage. Same contract as
    ``warp_gather_batched``; ``active`` is required."""
    _check(planes, r_idx, c_idx, active)
    if active is None:
        raise ValueError("warp_gather_batched_multi needs an active mask")
    anchors = tuple(anchors)
    if planes.device.type == "cpu":
        return _into(out, warp_gather_batched_multi_plain(planes, r_idx, c_idx, active, wrap, anchors))
    result = _launch(planes, r_idx, c_idx, active, anchors, wrap, out)
    timing.count(LAUNCHES, "warp_gather_batched_multi")
    return result


def warp_gather_single(planes, r_idx, c_idx, wrap=True):
    """The single-buffer mean pass (JAX ``_kernel`` :86, run by
    warp_gather_batched under PIPELINE_KERNEL = False :688-711). Same
    operands as ``warp_gather_batched`` without ``active``. Returns (out
    (B, 8, Ho, Wo) f32, f32-accumulated, channel 6 gathered; in_window
    (B, Ho, Wo) bool)."""
    _check(planes, r_idx, c_idx, None)
    if planes.device.type == "cpu":
        return warp_gather_single_plain(planes, r_idx, c_idx, wrap)
    result = _launch(planes, r_idx, c_idx, None, None, wrap)
    timing.count(LAUNCHES, "warp_gather_single")
    return result
