"""Intensity Scan Context (port of ``rivslam_tpu/loop/scancontext.py``):
polar max-intensity descriptors built by one scatter-max, and a batched
shift-search match.

The reference SCManager (Scancontext.cpp / .h, limited-FoV variant): 40
rings x 20 sectors over azimuth +-56.5 deg and 80 m, bin value = max
intensity (:160-212); ring key = row means, sector key = column means
(:217-244); matching = sector-key circshift alignment, then the cosine
column distance over a +-10% shift window (:80-159); candidates screened by
ring-key distance (:294-328). The descriptor database is a fixed-capacity
tensor on the device. Top-k selections use a stable ascending sort, which
orders ties by index as ``lax.top_k`` does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rivslam_tpu_torch.core.config import LoopConfig


@dataclasses.dataclass(frozen=True)
class ScanContextDB:
    """Fixed-capacity descriptor database."""

    desc: torch.Tensor  # [K, R, S]
    ring_key: torch.Tensor  # [K, R]
    sector_key: torch.Tensor  # [K, S]
    count: torch.Tensor  # [] int64 number of inserted descriptors

    @staticmethod
    def create(cfg: LoopConfig, dtype=torch.float32, device="cpu") -> "ScanContextDB":
        K = cfg.keyframe_capacity
        return ScanContextDB(
            desc=torch.zeros((K, cfg.num_ring, cfg.num_sector), dtype=dtype, device=device),
            ring_key=torch.zeros((K, cfg.num_ring), dtype=dtype, device=device),
            sector_key=torch.zeros((K, cfg.num_sector), dtype=dtype, device=device),
            count=torch.zeros((), dtype=torch.int64, device=device),
        )


def make_descriptor(xyz, intensity, mask, cfg: LoopConfig) -> torch.Tensor:
    """Polar max-intensity descriptor [R, S] (Scancontext.cpp:160-212)."""
    x, y = xyz[:, 0], xyz[:, 1]
    azim_range = torch.sqrt(x * x + y * y)
    azim_angle = (torch.atan2(x, y) - math.pi / 2) * 180.0 / math.pi
    az_max = cfg.sc_azimuth_range_deg
    az_min = -az_max - 0.1  # reference PC_AZIMUTH_ANGLE_MIN = -56.6 vs max 56.5
    valid = mask & (torch.abs(azim_angle) <= az_max) & (azim_range <= cfg.max_radius)
    R, S = cfg.num_ring, cfg.num_sector
    ring = torch.clamp(torch.ceil(azim_range / cfg.max_radius * R).to(torch.int64), 1, R) - 1
    sector = torch.clamp(
        torch.ceil((azim_angle - az_min) / (az_max - az_min) * S).to(torch.int64), 1, S
    ) - 1
    flat = torch.where(valid, ring * S + sector, R * S)  # invalid -> overflow bin
    desc = torch.zeros(R * S + 1, dtype=xyz.dtype, device=xyz.device).scatter_reduce(
        0, flat, torch.where(valid, intensity, 0.0), reduce="amax"
    )
    return desc[: R * S].reshape(R, S)


def ring_key_of(desc: torch.Tensor) -> torch.Tensor:
    return torch.mean(desc, dim=-1)


def sector_key_of(desc: torch.Tensor) -> torch.Tensor:
    return torch.mean(desc, dim=-2)


def insert(db: ScanContextDB, desc: torch.Tensor) -> tuple[ScanContextDB, bool]:
    """Append a descriptor. Returns (db', dropped). At capacity the insert
    is a no-op and ``dropped`` is True (the engine compacts first)."""
    K = db.desc.shape[0]
    n = int(db.count)
    if n >= K:
        return db, True

    def put(t, v):
        t = t.clone()
        t[n] = v
        return t

    return ScanContextDB(
        desc=put(db.desc, desc), ring_key=put(db.ring_key, ring_key_of(desc)),
        sector_key=put(db.sector_key, sector_key_of(desc)), count=db.count + 1,
    ), False


def _all_shift_distances(query: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Cosine column distance of query [R,S] vs cand [C,R,S] circshifted by
    every shift -> [C,S] (distDirectSC: the mean over columns where both
    have a nonzero norm)."""
    S = query.shape[-1]
    ar = torch.arange(S, device=query.device)
    idx = (ar[None, :] - ar[:, None]) % S  # [S(shift), S(col)]: column j - s
    cand_sh = cand[:, :, idx].movedim(2, 1)  # [C, S(shift), R, S(col)]
    qn = torch.linalg.norm(query, dim=0)  # [S]
    cn = torch.linalg.norm(cand_sh, dim=2)  # [C, S(shift), S]
    dot = torch.einsum("rs,cwrs->cws", query, cand_sh)
    both = (qn[None, None, :] > 0) & (cn > 0)
    sim = torch.where(both, dot / torch.clamp_min(qn[None, None, :] * cn, 1e-12), 0.0)
    n_eff = torch.clamp_min(torch.sum(both, dim=-1), 1)
    return 1.0 - torch.sum(sim, dim=-1) / n_eff


def _smallest(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest, ties by index (``lax.top_k`` of -x)."""
    vals, idx = torch.sort(x, stable=True)
    return vals[:k], idx[:k]


def _screened_shift_dists(db, desc, query_index: int, cand_mask, cfg: LoopConfig):
    """Ring-key top-C preselect, then the windowed shift-search distances.
    Returns (dists [C,S], inf at excluded shifts/candidates; cand_idx [C])."""
    K = db.desc.shape[0]
    ids = torch.arange(K, device=desc.device)
    allowed = cand_mask & (ids < db.count) & (ids <= query_index - cfg.num_exclude_recent)
    qkey = ring_key_of(desc)
    d2 = torch.where(allowed, torch.sum((db.ring_key - qkey[None, :]) ** 2, dim=-1), torch.inf)
    top, cand_idx = _smallest(d2, cfg.num_candidates)
    cand_ok = torch.isfinite(top)

    S = cfg.num_sector
    cand_desc = db.desc[cand_idx]  # [C, R, S]
    qvkey = sector_key_of(desc)
    ar = torch.arange(S, device=desc.device)
    idx = (ar[None, :] - ar[:, None]) % S  # [S(shift), S]
    cvkey_sh = db.sector_key[cand_idx][:, idx]  # [C, S(shift), S]
    vkey_dist = torch.linalg.norm(qvkey[None, None, :] - cvkey_sh, dim=-1)  # [C, S]
    center = torch.argmin(vkey_dist, dim=-1)
    radius = round(0.5 * cfg.search_ratio * S)
    diff = torch.abs((ar[None, :] - center[:, None] + S // 2) % S - S // 2)
    dists = _all_shift_distances(desc, cand_desc)
    dists = torch.where(diff <= radius, dists, torch.inf)
    return torch.where(cand_ok[:, None], dists, torch.inf), cand_idx


def _yaw(shift: torch.Tensor, cfg: LoopConfig, dtype) -> torch.Tensor:
    unit_sector = (2 * cfg.sc_azimuth_range_deg + 0.1) / cfg.num_sector  # PC_UNIT_SECTOR_ANGLE
    return torch.deg2rad(shift.to(dtype) * unit_sector)


def match(db: ScanContextDB, desc, query_index: int, cand_mask, cfg: LoopConfig):
    """detectLoopClosureID (Scancontext.cpp:272-379). cand_mask [K]: the
    detector's prefilter; recent keyframes are excluded here too. Returns
    (loop_idx [] int64, -1 if none; yaw_diff_rad; min_dist)."""
    dists, cand_idx = _screened_shift_dists(db, desc, query_index, cand_mask, cfg)
    S = cfg.num_sector
    best_flat = torch.argmin(dists.reshape(-1))
    min_dist = dists.reshape(-1)[best_flat]
    found = min_dist < cfg.sc_dist_thresh
    loop_idx = torch.where(found, cand_idx[best_flat // S], -1)
    return loop_idx, _yaw(best_flat % S, cfg, desc.dtype), min_dist


def match_topk(db: ScanContextDB, desc, query_index: int, cand_mask, cfg: LoopConfig, k: int):
    """Top-k variant of ``match`` for batched loop verification. Returns
    (idx [k] with -1 padding, yaw_rad [k], dist [k], valid [k])."""
    dists, cand_idx = _screened_shift_dists(db, desc, query_index, cand_mask, cfg)
    per_cand, per_shift = torch.amin(dists, dim=-1), torch.argmin(dists, dim=-1)
    min_dist, order = _smallest(per_cand, min(k, cfg.num_candidates))
    yaw = _yaw(per_shift[order], cfg, desc.dtype)
    valid = torch.isfinite(min_dist) & (min_dist < cfg.sc_dist_thresh)
    idx = torch.where(valid, cand_idx[order], -1)
    return idx, yaw, min_dist, valid


def compact(db: ScanContextDB, keep) -> ScanContextDB:
    """Move the ``keep`` rows to the front (the companion of
    ``global_graph.compact``)."""
    keep_t = torch.as_tensor(np.asarray(keep, dtype=np.int64), device=db.desc.device)
    m = len(keep_t)

    def front(t):
        out = torch.zeros_like(t)
        out[:m] = t[keep_t]
        return out

    return ScanContextDB(
        desc=front(db.desc), ring_key=front(db.ring_key), sector_key=front(db.sector_key),
        count=torch.tensor(m, dtype=torch.int64, device=db.desc.device),
    )
