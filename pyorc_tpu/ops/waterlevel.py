"""Device-batched optical water-level scoring.

The reference scores waterline candidates one at a time on the host: per
candidate, rasterize two polygons, gather their pixels, histogram, compare
(reference ``pyorc/api/cross_section.py:1001-1032,1534-1620``; numba pixel
extraction ``pyorc/cv.py:1047-1083``). Here ALL candidates run in one jitted
call — SURVEY §7.7's batched water-level kernel:

- each candidate polygon pair gets its own fixed-size crop window (stacked
  [M, hc, wc]; a shared whole-scan crop would rasterize 50x more pixels per
  candidate than its own bounding box)
- point-in-polygon by vectorized even-odd ray casting at pixel centres
- histograms as a compare-and-reduce of inside-mask weights over intensity bins
- histogram-union dissimilarity per candidate

Rings arrive as camera-projected quads densified to hundreds of
near-collinear vertices and are rasterized at full vertex count (host-side
simplification costs more than the device edge tests it would save). The
first call pays a one-time XLA compile; the scorer's time on the GPU is not
measured yet.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["polygon_histogram_scores"]


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _counts_jit(img_pad, offsets, rings, valid_edges, img_lims,
                bin_size: int, n_bins: int, hc: int, wc: int):
    """img_pad: [H+hc, W+wc] uint8 (the frame, zero-padded so every crop
    window slices in-bounds); offsets: [M, 2] int32 (x0, y0) crop origins —
    cropping happens ON DEVICE so only the frame (once) and the tiny ring
    arrays cross the host->device link; rings: [M, V, 2] in crop-local
    coords; valid_edges: [M, V]; img_lims: [M, 2] crop-local (x, y) image
    bounds (polygon area past the frame edge must not count — the host path
    never samples outside the image). Returns (counts [M, n_bins],
    totals [M] = ALL polygon pixels, matching the host path's min_samples
    gate on the raw pixel count)."""
    py = (jnp.arange(hc, dtype=jnp.float32)[:, None] + jnp.zeros((1, wc), jnp.float32)).ravel()
    px = (jnp.arange(wc, dtype=jnp.float32)[None, :] + jnp.zeros((hc, 1), jnp.float32)).ravel()

    last_edge = bin_size * n_bins

    def one(args):
        off, ring, vale, lim = args
        crop = jax.lax.dynamic_slice(img_pad, (off[1], off[0]), (hc, wc))
        x1 = ring[:, 0]
        y1 = ring[:, 1]
        x2 = jnp.roll(x1, -1)
        y2 = jnp.roll(y1, -1)
        straddle = (y1[None, :] > py[:, None]) != (y2[None, :] > py[:, None])
        t = (py[:, None] - y1[None, :]) / jnp.where(y2 == y1, 1e-12, (y2 - y1))[None, :]
        xint = x1[None, :] + t * (x2 - x1)[None, :]
        hits = straddle & (px[:, None] < xint) & (vale[None, :] > 0)
        inside = (jnp.sum(hits.astype(jnp.int32), axis=1) % 2).astype(jnp.float32)  # [P]
        inside = inside * (px < lim[0]) * (py < lim[1])
        v = crop.ravel().astype(jnp.int32)
        idx = jnp.minimum(v // bin_size, n_bins - 1)
        w = inside * (v <= last_edge)
        # histogram as compare-and-reduce, not segment_sum: a [n_bins, P]
        # comparison mask reduced over P fuses into one elementwise+reduce
        # kernel, where a scatter-add serialises on colliding bins
        counts = jnp.sum(
            w[None, :] * (idx[None, :] == jnp.arange(n_bins, dtype=jnp.int32)[:, None]),
            axis=1,
        )
        return counts, inside.sum()

    # batch_size vmaps candidates in chunks: a bare lax.map is a sequential
    # scan whose tiny per-step work leaves the device idle. The chunk width
    # is bounded by the [B, hc*wc, V]
    # f32 ray-cast intermediates: a near-frame-sized crop with hundreds of
    # ring vertices at B=32 would be tens of GB, so scale B to a ~256 MB
    # footprint (all shapes here are static at trace time).
    v_pad = int(rings.shape[1])
    batch = max(1, min(32, (256 << 20) // max(hc * wc * v_pad * 4, 1)))
    return jax.lax.map(one, (offsets, rings, valid_edges, img_lims), batch_size=batch)


def polygon_histogram_scores(
    img: np.ndarray,
    pols1: Sequence[np.ndarray],
    pols2: Sequence[np.ndarray],
    bin_size: int = 5,
    min_samples: int = 50,
) -> np.ndarray:
    """Histogram-union dissimilarity scores for N candidate polygon pairs.

    img: uint8 [H, W]. polsX[i]: [Vi, 2] exterior ring (camera x, y). Returns
    scores [N] matching the per-candidate host path's semantics
    (``CrossSection.get_histogram_score``): 2 - sum(max(d1, d2) * bin_width)
    over normalized densities, or 2.0 when either side has < min_samples
    pixels. Rasterization is even-odd ray casting at pixel centres — boundary
    pixels can differ from cv2.fillPoly (which paints outlines) by up to one
    pixel, which perturbs scores at the 1e-3 level; thin sliver polygons
    whose host pixel count sits just above min_samples can mask out here.
    """
    n = len(pols1)
    assert len(pols2) == n
    h, w = img.shape[:2]
    bin_size = int(bin_size)
    n_bins = len(np.arange(0, 256, bin_size)) - 1

    # Rings are used at full vertex count: the device ray cast prices extra
    # edges cheaply, host-side RDP simplification of every ring costs more
    # than it saves, and the full ring matches the host path's cv2.fillPoly
    # rasterization more faithfully anyway.
    rings = []
    for p in list(pols1) + list(pols2):
        r = np.asarray(p, dtype=np.float64)[:, :2]
        r = r[np.isfinite(r).all(axis=1)]
        r = np.round(r)  # mirror the host path's integer rounding
        rings.append(r)

    boxes = []
    for r in rings:
        if len(r) < 3:
            boxes.append(None)
            continue
        x0 = int(np.clip(np.floor(r[:, 0].min()), 0, w - 1))
        x1 = int(np.clip(np.ceil(r[:, 0].max()), 0, w - 1))
        y0 = int(np.clip(np.floor(r[:, 1].min()), 0, h - 1))
        y1 = int(np.clip(np.ceil(r[:, 1].max()), 0, h - 1))
        boxes.append(None if (x1 <= x0 or y1 <= y0) else (x0, x1, y0, y1))

    live = [i for i, b in enumerate(boxes) if b is not None]
    scores = np.full(n, 2.0, np.float64)
    if not live:
        return scores
    # fixed crop window covering every live bbox, bucketed to limit recompiles
    hc = max(b[3] - b[2] + 2 for i, b in enumerate(boxes) if b) + 1
    wc = max(b[1] - b[0] + 2 for i, b in enumerate(boxes) if b) + 1
    hc = -(-hc // 32) * 32
    wc = -(-wc // 32) * 32
    v_pad = -(-max(len(rings[i]) for i in live) // 8) * 8
    # crops are sliced ON DEVICE from the once-uploaded padded frame (a host
    # crop batch would move M*hc*wc bytes across the link); only the
    # [M, V]-sized ring/offset arrays accompany each call
    img_dev = jnp.asarray(np.pad(img, ((0, hc), (0, wc))))
    m_max = 2048
    counts_live = np.zeros((len(live), n_bins), np.float64)
    totals_live = np.zeros(len(live), np.float64)
    for g0 in range(0, len(live), m_max):
        grp = live[g0 : g0 + m_max]
        m_pad = -(-len(grp) // 32) * 32
        offsets = np.zeros((m_pad, 2), np.int32)
        ring_arr = np.zeros((m_pad, v_pad, 2), np.float32)
        edge_valid = np.zeros((m_pad, v_pad), np.float32)
        img_lims = np.zeros((m_pad, 2), np.float32)
        for j, i in enumerate(grp):
            x0, x1, y0, y1 = boxes[i]
            offsets[j] = (x0, y0)
            img_lims[j] = (min(x0 + wc, w) - x0, min(y0 + hc, h) - y0)
            r = rings[i]
            k = min(len(r), v_pad)
            ring_arr[j, :k] = r[:k] - [x0, y0]
            ring_arr[j, k:] = r[k - 1] - [x0, y0]
            edge_valid[j, :k] = 1.0
        c, t = _counts_jit(
            img_dev, jnp.asarray(offsets), jnp.asarray(ring_arr), jnp.asarray(edge_valid),
            jnp.asarray(img_lims), bin_size, n_bins, hc, wc,
        )
        counts_live[g0 : g0 + len(grp)] = np.asarray(c, np.float64)[: len(grp)]
        totals_live[g0 : g0 + len(grp)] = np.asarray(t, np.float64)[: len(grp)]
    counts, totals = counts_live, totals_live

    # scatter (polygon-side) results back to candidate pairs
    c_all = np.zeros((2 * n, n_bins), np.float64)
    s_all = np.zeros(2 * n, np.float64)
    c_all[np.asarray(live)] = counts
    s_all[np.asarray(live)] = totals
    c1, c2 = c_all[:n], c_all[n:]
    s1, s2 = s_all[:n], s_all[n:]
    # density normalization over IN-RANGE pixels (np.histogram semantics);
    # the min_samples gate uses ALL polygon pixels like the host path
    n1 = c1.sum(axis=1)
    n2 = c2.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        d1 = np.where(n1[:, None] > 0, c1 / n1[:, None], 0.0)
        d2 = np.where(n2[:, None] > 0, c2 / n2[:, None], 0.0)
    union = np.maximum(d1, d2).sum(axis=1)
    return np.where((s1 < min_samples) | (s2 < min_samples), 2.0, 2.0 - union)
