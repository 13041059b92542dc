"""DTU accuracy/completeness evaluation — MATLAB-protocol-compatible Python;
a copy of damvsnet_tpu/eval/dtu_eval.py.

Reimplements the reference's evaluations/dtu/*.m:

  * reduce_points      == reducePts_haa.m: stochastic 0.2 mm thinning —
    visit points in random order, keep a point iff no previously-kept point
    lies within dst (KD-tree range search).
  * nn_distances       == MaxDistCP.m: nearest-neighbor distances capped at
    MaxDist (60 mm), computed chunk-wise (we use one scipy cKDTree with
    distance_upper_bound — identical values without the 60 mm grid walk).
  * evaluate_scan      == BaseEvalMain_web.m/PointCompareMain.m: thin the
    prediction, distances both ways, filter data points by the ObsMask
    voxel grid (Margin 10) and stl points by the ground plane, discard
    > 20 mm outliers, then acc = mean(Ddata), comp = mean(Dstl).
  * evaluate_scans     == ComputeStat_web.m: per-scan means + overall mean.

The stochastic thinning matches the statistic, not the MATLAB RNG stream
(seeded numpy permutation).

ObsMask/Plane are read from the DTU SampleSet .mat files via
scipy.io.loadmat (keys: ObsMask, BB, Res; P).

Protocol validation (tests/test_eval_dtu.py and, for this copy,
tests/test_torch_eval_dtu.py — no DTU ground truth ships with the
repository, so the pinning is analytic):
  * hand-computed acc/comp on a known grid configuration incl. the 20 mm
    outlier cutoff, ObsMask bounds, and plane filter (exact to 1e-6);
  * reducePts_haa's two invariants: kept points pairwise > dst apart AND
    every dropped point within dst of a kept one (maximal independent
    set) — the statistic the MATLAB randperm realizes;
  * MATLAB round() half-away-from-zero voxel indexing at exact half-voxel
    coordinates (np.round's half-to-even would mis-bin those points);
  * NN distances vs brute force to 1e-6 and the 60 mm MaxDistCP cap.
"""
from __future__ import annotations

import os

import numpy as np
from scipy.spatial import cKDTree


def reduce_points(pts: np.ndarray, dst: float = 0.2, seed: int = 0) -> np.ndarray:
    """Stochastic minimum-distance thinning (reducePts_haa.m).

    pts: (N, 3). Returns the thinned subset (keeps the visit-order-first
    point of every dst-ball).
    """
    n = pts.shape[0]
    keep = np.ones(n, dtype=bool)
    order = np.random.default_rng(seed).permutation(n)
    tree = cKDTree(pts)
    # chunked range search like the MATLAB (memory-bounded)
    chunk = 4_000_000
    for start in range(0, n, chunk):
        idx_chunk = order[start:start + chunk]
        neighbors = tree.query_ball_point(pts[idx_chunk], dst, workers=-1)
        for i, nbrs in zip(idx_chunk, neighbors):
            if keep[i]:
                keep[nbrs] = False
                keep[i] = True
    return pts[keep]


def nn_distances(q_to: np.ndarray, q_from: np.ndarray,
                 max_dist: float = 60.0) -> np.ndarray:
    """Distance from each q_from point to its nearest q_to point, capped at
    max_dist (MaxDistCP.m semantics)."""
    if len(q_to) == 0:
        return np.full(len(q_from), max_dist)
    tree = cKDTree(q_to)
    d, _ = tree.query(q_from, k=1, distance_upper_bound=max_dist, workers=-1)
    d = np.minimum(d, max_dist)
    return d


def _load_mask_plane(data_path: str, scan: int, margin: int = 10):
    from scipy.io import loadmat
    mask_file = os.path.join(data_path, "ObsMask",
                             f"ObsMask{scan}_{margin}.mat")
    plane_file = os.path.join(data_path, "ObsMask", f"Plane{scan}.mat")
    m = loadmat(mask_file)
    p = loadmat(plane_file)
    return m["ObsMask"], m["BB"], float(np.asarray(m["Res"]).squeeze()), \
        np.asarray(p["P"]).reshape(4)


def evaluate_scan(pred_ply_points: np.ndarray, stl_points: np.ndarray,
                  obs_mask=None, bb=None, res: float = 1.0, plane=None,
                  dst: float = 0.2, max_dist: float = 20.0, seed: int = 0):
    """Evaluate one scan. Returns dict(acc, comp, overall, ...).

    pred_ply_points: (N, 3) predicted cloud; stl_points: (M, 3) GT
    (already 0.2 mm-reduced, as shipped by DTU).
    obs_mask/bb/res/plane: the DTU observability volume + ground plane;
    if None, no mask/plane filtering is applied (synthetic tests).
    """
    qdata = reduce_points(pred_ply_points, dst, seed)
    ddata = nn_distances(stl_points, qdata, max_dist=60.0)
    dstl = nn_distances(qdata, stl_points, max_dist=60.0)

    if obs_mask is not None:
        # MATLAB: Qv = round((Q - BB(1,:))/Res + 1), 1-based; round() is
        # half-AWAY-FROM-ZERO (np.round is half-to-even — wrong at exact
        # half-voxel coordinates), so use floor(x + 0.5): coordinates are
        # >= 0 relative to the BB min corner. 0-based here (drop the +1).
        qv = np.floor((qdata - np.asarray(bb)[0][None, :]) / res
                      + 0.5).astype(int)
        in_bounds = ((qv >= 0).all(axis=1)
                     & (qv[:, 0] < obs_mask.shape[0])
                     & (qv[:, 1] < obs_mask.shape[1])
                     & (qv[:, 2] < obs_mask.shape[2]))
        data_in_mask = np.zeros(len(qdata), dtype=bool)
        ib = np.nonzero(in_bounds)[0]
        data_in_mask[ib] = obs_mask[qv[ib, 0], qv[ib, 1], qv[ib, 2]] > 0
    else:
        data_in_mask = np.ones(len(qdata), dtype=bool)

    if plane is not None:
        stl_above = (np.concatenate(
            [stl_points, np.ones((len(stl_points), 1))], axis=1) @ plane) > 0
    else:
        stl_above = np.ones(len(stl_points), dtype=bool)

    fd = ddata[data_in_mask]
    fd = fd[fd < max_dist]
    fs = dstl[stl_above]
    fs = fs[fs < max_dist]
    acc = float(np.mean(fd)) if len(fd) else float("nan")
    comp = float(np.mean(fs)) if len(fs) else float("nan")
    return {
        "acc": acc,
        "comp": comp,
        "overall": (acc + comp) / 2.0,
        "acc_med": float(np.median(fd)) if len(fd) else float("nan"),
        "comp_med": float(np.median(fs)) if len(fs) else float("nan"),
        "n_data": int(len(qdata)),
        "n_stl": int(len(stl_points)),
    }


def evaluate_scans(ply_dir: str, data_path: str, scans, method: str = "mvsnet",
                   light: str = "l3", log_fn=print):
    """Full DTU protocol over a scan list; returns per-scan dicts + means
    (ComputeStat_web.m aggregate)."""
    from ..core.ply import read_ply
    results = {}
    for scan in scans:
        pred_path = os.path.join(ply_dir, f"{method}{scan:03d}_{light}.ply")
        stl_path = os.path.join(data_path, "Points", "stl",
                                f"stl{scan:03d}_total.ply")
        pred, _ = read_ply(pred_path)
        stl, _ = read_ply(stl_path)
        obs_mask, bb, res, plane = _load_mask_plane(data_path, scan)
        r = evaluate_scan(pred, stl, obs_mask, bb, res, plane)
        results[scan] = r
        log_fn(f"scan{scan}: acc={r['acc']:.4f} comp={r['comp']:.4f} "
               f"overall={r['overall']:.4f}")
    accs = [r["acc"] for r in results.values()]
    comps = [r["comp"] for r in results.values()]
    summary = {
        "mean_acc": float(np.mean(accs)),
        "mean_comp": float(np.mean(comps)),
        "overall": float((np.mean(accs) + np.mean(comps)) / 2.0),
    }
    log_fn(f"DTU overall: acc={summary['mean_acc']:.4f} "
           f"comp={summary['mean_comp']:.4f} overall={summary['overall']:.4f}")
    return results, summary
