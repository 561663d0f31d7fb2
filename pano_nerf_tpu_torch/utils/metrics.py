"""Image, geometry and solid-angle-weighted panorama metrics (numpy).

Counterpart of pano_nerf_tpu/utils/metrics.py, without `calc_lpips`
(it needs the `lpips` package and its weights). Images are channels-last
[H, W, C]. Metrics run on the host in float64 after the render, so no
device arithmetic (TF32 convolutions included) enters them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from pano_nerf_tpu_torch.ops.shading import solid_angle_refinement


def _f64(x) -> np.ndarray:
    return np.asarray(x, np.float64)


def mse(x: np.ndarray, y: np.ndarray) -> float:
    return float(np.mean((_f64(x) - y) ** 2))


def rmse(x: np.ndarray, y: np.ndarray) -> float:
    return float(np.sqrt(mse(x, y)))


def l1(x: np.ndarray, y: np.ndarray) -> float:
    return float(np.mean(np.abs(_f64(x) - y)))


def psnr(x: np.ndarray, y: np.ndarray) -> float:
    return float(-10.0 * np.log10(mse(x, y)))


def _angles(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Angles in degrees between the 3-vectors of x and y, [...]."""
    x, y = _f64(x), _f64(y)
    denom = np.linalg.norm(x, axis=-1) * np.linalg.norm(y, axis=-1)
    cos = np.sum(x * y, axis=-1) / np.maximum(denom, 1e-12)
    return np.nan_to_num(np.arccos(np.clip(cos, -1.0, 1.0)) / np.pi * 180.0)


def mean_angular_error(x: np.ndarray, y: np.ndarray) -> float:
    """Mean angle between two 3-vector fields, in degrees."""
    return float(np.mean(_angles(np.reshape(x, (-1, 3)),
                                 np.reshape(y, (-1, 3)))))


def scale_invariant_mse(x: np.ndarray, y: np.ndarray) -> float:
    """var(x - y): scale-invariant MSE for albedo."""
    return float(np.var(np.asarray(x, np.float64) - y))


def _gaussian_1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - ksize // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d(x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Zero-padded 'same' correlation of [H, W, C] with outer(g, g)."""
    pad = (len(g) - 1) // 2
    h, w = x.shape[:2]
    xp = np.pad(x, ((pad, pad), (pad, pad), (0, 0)))
    rows = sum(g[k] * xp[k:k + h] for k in range(len(g)))
    return sum(g[k] * rows[:, k:k + w] for k in range(len(g)))


def ssim(img1: np.ndarray, img2: np.ndarray, window_size: int = 11,
         sigma: float = 1.5, max_val: float = 1.0) -> float:
    """Mean SSIM of a [H, W, C] pair: 11x11 Gaussian window (sigma 1.5),
    C1 = (0.01 max)^2, C2 = (0.03 max)^2, zero padding."""
    a = np.asarray(img1, np.float64)
    b = np.asarray(img2, np.float64)
    g = _gaussian_1d(window_size, sigma)
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    mu1, mu2 = _filter2d(a, g), _filter2d(b, g)
    sigma1 = _filter2d(a * a, g) - mu1 ** 2
    sigma2 = _filter2d(b * b, g) - mu2 ** 2
    sigma12 = _filter2d(a * b, g) - mu1 * mu2
    ssim_map = ((2 * mu1 * mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1 ** 2 + mu2 ** 2 + c1) * (sigma1 + sigma2 + c2))
    return float(np.mean(ssim_map))


def depth_metrics(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray
                  ) -> Dict[str, float]:
    """abs_rel, sq_rel, rms, log_rms and delta1..3 over mask > 0."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    m = mask > 0
    count = max(int(m.sum()), 1)
    diff = np.where(m, pred - gt, 0.0)
    safe_gt = np.maximum(gt, 1e-8)
    out = dict(abs_rel=np.sum(np.abs(diff) / safe_gt) / count,
               sq_rel=np.sum(diff ** 2 / safe_gt) / count,
               rms=np.sqrt(np.sum(diff ** 2) / count))
    valid_log = m & (pred > 1e-7) & (gt > 1e-7)
    log_diff = np.log(np.maximum(pred, 1e-7)) - np.log(np.maximum(gt, 1e-7))
    out["log_rms"] = np.sqrt(np.sum(np.where(valid_log, log_diff ** 2, 0.0))
                             / max(int(valid_log.sum()), 1))
    ratio = np.maximum(pred / safe_gt, gt / np.maximum(pred, 1e-8))
    for d in (1, 2, 3):
        out[f"delta{d}"] = np.sum(m & (ratio < 1.25 ** d)) / count
    return {k: float(v) for k, v in out.items()}


def _ws_weights(h: int, w: int) -> np.ndarray:
    weights = solid_angle_refinement(h=h, w=w).reshape(h, w, 1)
    return weights.astype(np.float64) / weights.sum(dtype=np.float64)


def ws_mse(pred: np.ndarray, gt: np.ndarray) -> float:
    """Solid-angle-weighted MSE of [H, W, C] images."""
    h, w = pred.shape[:2]
    return float(np.sum((_f64(pred) - gt) ** 2 * _ws_weights(h, w)))


def ws_psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    """Solid-angle-weighted PSNR of [H, W, C] images."""
    return float(-10.0 * np.log10(ws_mse(pred, gt)))


def ws_rmse(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(np.sqrt(ws_mse(pred, gt)))


def ws_l1(pred: np.ndarray, gt: np.ndarray) -> float:
    h, w = pred.shape[:2]
    return float(np.sum(np.abs(_f64(pred) - gt) * _ws_weights(h, w)))


def ws_mae(pred: np.ndarray, gt: np.ndarray) -> float:
    """Solid-angle-weighted mean angular error (degrees), [H, W, 3]."""
    h, w = pred.shape[:2]
    return float(np.sum(_angles(pred, gt) * _ws_weights(h, w)[..., 0]))


def ws_cos_similarity(pred: np.ndarray, gt: np.ndarray) -> float:
    """Solid-angle-weighted cosine similarity of [H, W, 3] fields."""
    h, w = pred.shape[:2]
    pred, gt = _f64(pred), _f64(gt)
    denom = np.linalg.norm(pred, axis=-1) * np.linalg.norm(gt, axis=-1)
    cos = np.sum(pred * gt, axis=-1) / np.maximum(denom, 1e-12)
    return float(np.sum(cos * _ws_weights(h, w)[..., 0]))


def eval_errors(pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """PSNR and SSIM of an [H, W, 3] LDR pair."""
    return {"psnr": psnr(pred, gt), "ssim": ssim(pred, gt)}


def summarize_metrics(records: List[dict]) -> Dict[str, float]:
    """Mean of each numeric key over a list of per-image metric dicts."""
    keys = {k for r in records for k, v in r.items()
            if isinstance(v, (int, float))}
    return {k: float(np.mean([r[k] for r in records if k in r]))
            for k in sorted(keys)}
