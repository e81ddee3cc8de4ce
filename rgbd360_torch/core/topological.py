"""Copy of rgbd360_tpu/core/topological.py (numpy only).

TopologicalMap360 — topological partitioning of the keyframe graph by
Sensed-Space-Overlap (reference include/TopologicalMap360.h:81-580).

Keeps per-area SSO matrices + inter-area blocks, and periodically runs
recursive spectral partitioning (normalized cut) to split the map into
local areas, re-assigning keyframes and electing the most-representative
keyframe per area (highest SSO row sum). The eigendecompositions run in
NumPy (matrices are at most a few hundred square); the structure matches
mrpt::graphs::CGraphPartitioner::RecursiveSpectralPartition with threshold
0.8 and minimum part size 3 (reference :391-411).

One difference from the JAX module: the partitioner takes every block
between a vicinity area and an outside area out before it re-homes any of
their rows. Re-homed one at a time, a row that moves to another vicinity
area landed in that area's stale block with the same outside area, still
to be re-homed: its rows were then scrambled, or, where the area shrank,
the copy raised (a topology the threaded loop closer's late closures
make).
"""

from __future__ import annotations

from typing import Dict, List, Set

import numpy as np

from rgbd360_torch.core.map360 import Map360

NCUT_THRESHOLD = 0.8
MIN_PART_SIZE = 3


def _fiedler_bipartition(A: np.ndarray):
    """Best normalized-cut bipartition via the Fiedler vector.
    Returns (part_a, part_b, ncut_value)."""
    n = len(A)
    d = A.sum(axis=1)
    d_safe = np.maximum(d, 1e-12)
    D_inv_sqrt = np.diag(1.0 / np.sqrt(d_safe))
    L = np.eye(n) - D_inv_sqrt @ A @ D_inv_sqrt
    w, v = np.linalg.eigh(L)
    fiedler = v[:, 1] if n > 1 else np.zeros(n)
    order = np.argsort(fiedler)
    best = (list(range(n)), [], np.inf)
    # sweep all threshold positions for the minimum ncut
    for cut in range(1, n):
        a = order[:cut]
        b = order[cut:]
        w_ab = A[np.ix_(a, b)].sum()
        assoc_a = A[a].sum()
        assoc_b = A[b].sum()
        if assoc_a <= 0 or assoc_b <= 0:
            continue
        ncut = w_ab / assoc_a + w_ab / assoc_b
        if ncut < best[2]:
            best = (list(a), list(b), float(ncut))
    return best


def recursive_spectral_partition(
    sso: np.ndarray,
    threshold_ncut: float = NCUT_THRESHOLD,
    min_size: int = MIN_PART_SIZE,
) -> List[List[int]]:
    """Recursive normalized-cut partitioning of a symmetric affinity matrix.
    A group is split while the best bipartition's ncut is below the threshold
    and both halves keep at least min_size members."""
    n = len(sso)
    if n <= min_size:
        return [list(range(n))]
    a, b, ncut = _fiedler_bipartition(sso)
    if ncut >= threshold_ncut or len(a) < min_size or len(b) < min_size:
        return [list(range(n))]
    parts: List[List[int]] = []
    for sub in (a, b):
        sub_parts = recursive_spectral_partition(
            sso[np.ix_(sub, sub)], threshold_ncut, min_size
        )
        parts.extend([[sub[i] for i in p] for p in sub_parts])
    return parts


class TopologicalMap360:
    def __init__(self, map360: Map360):
        self.map = map360
        # per-area symmetric SSO matrices (vSSO)
        self.v_sso: List[np.ndarray] = [np.zeros((0, 0), np.float32)]
        # inter-area SSO blocks (mmNeigSSO): (a1, a2) with a1 < a2
        self.neig_sso: Dict[tuple, np.ndarray] = {}

    # -- bookkeeping (reference :81-131) ----------------------------------------
    def add_keyframe(self, area: int) -> None:
        m = self.v_sso[area]
        k = m.shape[0]
        grown = np.zeros((k + 1, k + 1), np.float32)
        grown[:k, :k] = m
        self.v_sso[area] = grown
        for other in self.map.neighbor_areas[area]:
            if other == area:
                continue
            key = (min(area, other), max(area, other))
            blk = self.neig_sso.get(key, np.zeros((0, 0), np.float32))
            rows, cols = blk.shape
            if area < other:
                nb = np.zeros((k + 1, cols), np.float32)
                nb[:rows] = blk
            else:
                nb = np.zeros((rows, k + 1), np.float32)
                nb[:, :cols] = blk
            self.neig_sso[key] = nb

    def add_connection(self, kf1: int, kf2: int, sso: float) -> None:
        m = self.map
        a1, a2 = m.frames[kf1].node, m.frames[kf2].node
        i1, i2 = m.local_index(kf1), m.local_index(kf2)
        if a1 == a2:
            self.v_sso[a1][i1, i2] = self.v_sso[a1][i2, i1] = sso
        else:
            m.neighbor_areas[a1].add(a2)
            m.neighbor_areas[a2].add(a1)
            key = (min(a1, a2), max(a1, a2))
            blk = self.neig_sso.setdefault(key, np.zeros((0, 0), np.float32))
            r = self.v_sso[key[0]].shape[0]
            c = self.v_sso[key[1]].shape[0]
            if blk.shape != (r, c):
                nb = np.zeros((r, c), np.float32)
                nb[: blk.shape[0], : blk.shape[1]] = blk
                self.neig_sso[key] = nb
                blk = nb
            if a1 < a2:
                blk[i1, i2] = sso
            else:
                blk[i2, i1] = sso

    def get_vicinity_sso(self, vicinity: Set[int]) -> np.ndarray:
        """Assemble the block SSO over the given areas (reference :134-168)."""
        areas = sorted(vicinity)
        sizes = [self.v_sso[a].shape[0] for a in areas]
        starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        total = int(starts[-1])
        out = np.zeros((total, total), np.float32)
        for ai, a in enumerate(areas):
            sa = starts[ai]
            out[sa : sa + sizes[ai], sa : sa + sizes[ai]] = self.v_sso[a]
            for bi in range(ai + 1, len(areas)):
                b = areas[bi]
                blk = self.neig_sso.get((min(a, b), max(a, b)))
                if blk is None:
                    continue
                sb = starts[bi]
                r = min(blk.shape[0], sizes[ai])
                c = min(blk.shape[1], sizes[bi])
                out[sa : sa + r, sb : sb + c] = blk[:r, :c]
                out[sb : sb + c, sa : sa + r] = blk[:r, :c].T
        return out

    # -- partitioning (reference :391-580) ---------------------------------------
    def partitioner(self) -> bool:
        """Re-partition the vicinity of the current area; returns True when
        the topology changed."""
        m = self.map
        vicinity = set(m.neighbor_areas[m.current_area]) | {m.current_area}
        sso = self.get_vicinity_sso(vicinity)
        if sso.shape[0] < 3:
            return False
        parts = recursive_spectral_partition(sso)
        if len(parts) <= len(vicinity):
            return False
        # sort parts by smallest member (RearrangePartition, :372-389)
        parts = sorted(parts, key=lambda p: min(p))

        # global kf ids in vicinity order
        areas_sorted = sorted(vicinity)
        kf_global: List[int] = []
        for a in areas_sorted:
            kf_global.extend(sorted(m.areas[a]))
        # within each part, order members by global keyframe id: the per-area
        # SSO rows must agree with Map360.local_index (sorted-by-kf order) or
        # every later add_connection writes into the wrong row
        parts = [sorted(p, key=lambda local: kf_global[local]) for p in parts]

        with m.mutex:
            old_members = {a: sorted(m.areas[a]) for a in areas_sorted}
            # rebuild area assignment: reuse the vicinity's area ids, create new
            area_ids = areas_sorted + [
                len(m.areas) + i for i in range(len(parts) - len(areas_sorted))
            ]
            while len(m.areas) <= max(area_ids):
                m.areas.append(set())
                m.neighbor_areas.append(set())
                m.selected_kfs.append(0)
                self.v_sso.append(np.zeros((0, 0), np.float32))
            for a in areas_sorted:
                m.areas[a] = set()
            # blocks between two vicinity areas are rebuilt below — stale
            # ones must not survive with old memberships
            for key in [k for k in self.neig_sso if k[0] in vicinity and k[1] in vicinity]:
                del self.neig_sso[key]
            for part, aid in zip(parts, area_ids):
                for local in part:
                    kf = kf_global[local]
                    m.frames[kf].node = aid
                    m.areas[aid].add(kf)
                # per-area SSO = submatrix; most-representative KF = max row sum
                sub = sso[np.ix_(part, part)]
                self.v_sso[aid] = sub.astype(np.float32)
                row_sum = sub.sum(axis=1)
                m.selected_kfs[aid] = kf_global[part[int(np.argmax(row_sum))]]
                m.neighbor_areas[aid] = {aid}
            # inter-area blocks between the new areas
            for ai, (pa, aid_a) in enumerate(zip(parts, area_ids)):
                for pb, aid_b in list(zip(parts, area_ids))[ai + 1 :]:
                    blk = sso[np.ix_(pa, pb)]
                    if blk.max(initial=0.0) > 0:
                        m.neighbor_areas[aid_a].add(aid_b)
                        m.neighbor_areas[aid_b].add(aid_a)
                        self.neig_sso[(min(aid_a, aid_b), max(aid_a, aid_b))] = (
                            blk.astype(np.float32)
                            if aid_a < aid_b
                            else blk.T.astype(np.float32)
                        )
            # re-home blocks and neighbor links between old vicinity areas and
            # areas OUTSIDE the vicinity (reference ArrangeGraphSSO 'update
            # neighbors and SSO matrices of the surrounding maps')
            new_of = {}
            for aid in area_ids:
                for idx, kf in enumerate(sorted(m.areas[aid])):
                    new_of[kf] = (aid, idx)
            # NOT the inter-part blocks just built above: a block between a
            # reused vicinity id and a NEW area id has exactly one side in
            # `vicinity` (new ids never are), but it is already correctly
            # indexed by the new memberships — re-homing it through
            # old_members would scramble rows and drop neighbor links
            new_ids = set(area_ids)
            # all of them taken out before any is re-homed: a row may move to
            # another vicinity area whose block with the same outside area is
            # still to be re-homed, and must not land in that stale block
            outside = [
                (k, self.neig_sso.pop(k)) for k in list(self.neig_sso.keys())
                if ((k[0] in vicinity) != (k[1] in vicinity))
                and not (k[0] in new_ids and k[1] in new_ids)
            ]
            for key, blk in outside:
                vic, out = (key[0], key[1]) if key[0] in vicinity else (key[1], key[0])
                m.neighbor_areas[out].discard(vic)
                members = old_members.get(vic, [])
                for old_idx, kf in enumerate(members):
                    if key[0] == vic:
                        if old_idx >= blk.shape[0]:
                            break
                        row = blk[old_idx, :]
                    else:
                        if old_idx >= blk.shape[1]:
                            break
                        row = blk[:, old_idx]
                    if not np.any(row):
                        continue
                    aid, nidx = new_of[kf]
                    nkey = (min(aid, out), max(aid, out))
                    r = self.v_sso[nkey[0]].shape[0]
                    c = self.v_sso[nkey[1]].shape[0]
                    nb = self.neig_sso.get(nkey)
                    if nb is None or nb.shape != (r, c):
                        nb2 = np.zeros((r, c), np.float32)
                        if nb is not None:
                            nb2[: nb.shape[0], : nb.shape[1]] = nb
                        self.neig_sso[nkey] = nb2
                        nb = nb2
                    n = min(len(row), c if aid < out else r)
                    if aid < out:
                        nb[nidx, :n] = row[:n]
                    else:
                        nb[:n, nidx] = row[:n]
                    m.neighbor_areas[aid].add(out)
                    m.neighbor_areas[out].add(aid)
            # the current area follows the last keyframe
            m.current_area = m.frames[len(m.frames) - 1].node
        return True
