"""Literal NumPy oracle of the reference semantics (float64 weights, as
the reference's np.ones defaults are), used as the behavioral
spec for unit tests.  Each function re-states the documented algorithm of the
cited reference lines with plain Python loops (independently written; serves
to pin the device kernels' exact semantics).
"""
from __future__ import annotations

import numpy as np


def placement_oracle(offsets, image_shape):
    """Reference composition pass 1 (Stitcher.py:387-431)."""
    h, w = image_shape
    n = len(offsets) + 1
    pos = [[0, 0] for _ in range(n)]
    range_r = [[0, 0] for _ in range(n)]
    range_c = [[0, 0] for _ in range(n)]
    range_r[0][1] = h
    range_c[0][1] = w
    rows, cols = h, w
    dr = dc = 0
    for i in range(1, n):
        dr += offsets[i - 1][0]
        dc += offsets[i - 1][1]
        if dr <= 0:
            s = -dr
            for j in range(i):
                pos[j][0] += s
                range_r[j][0] += s
                range_r[j][1] += s
            rows += s
            range_r[i][1] = rows
            dr = 0
            pos[i][0] = 0
        else:
            pos[i][0] = dr
            rows = max(rows, dr + h)
            range_r[i][1] = rows
        if dc <= 0:
            s = -dc
            for j in range(i):
                pos[j][1] += s
                range_c[j][0] += s
                range_c[j][1] += s
            cols += s
            range_c[i][1] = cols
            dc = 0
            pos[i][1] = 0
        else:
            pos[i][1] = dc
            cols = max(cols, dc + w)
            range_c[i][1] = cols
        range_r[i][0] = pos[i][0]
        range_c[i][0] = pos[i][1]
    return ([tuple(p) for p in pos], (rows, cols),
            [tuple(r) for r in range_r], [tuple(c) for c in range_c])


def _valid(a, color):
    if color:
        return a.sum(axis=-1) != -3
    return a != -1


def corner_weights_oracle(image_a, color):
    """getWeightsMatrix (ImageFusion.py:43-190), literal scans."""
    a = np.asarray(image_a)
    row, col = a.shape[:2]
    wb1 = np.ones(a.shape[:2], np.float64)
    wb2 = np.ones(a.shape[:2], np.float64)
    cmp_list = [
        np.count_nonzero(a[0:row // 2, 0:col // 2] > 0),
        np.count_nonzero(a[row // 2:row, 0:col // 2] > 0),
        np.count_nonzero(a[row // 2:row, col // 2:col] > 0),
        np.count_nonzero(a[0:row // 2, col // 2:col] > 0),
    ]
    index = cmp_list.index(min(cmp_list))
    valid = _valid(a, color)

    def px(r, c):
        return valid[r, c]

    ri = 0
    ci = 0
    if index == 2:  # overlap upper-left
        for j in range(1, col):
            for i in range(row - 1, -1, -1):
                if px(i, col - j):
                    ri = i + 1
                    break
            if ri != 0:
                break
        for i in range(col - 1, -1, -1):
            if px(ri, i):
                ci = i + 1
                break
        for i in range(ri + 1):
            if ri == 0:
                ri = 1
            wb1[ri - i, :] = (ri - i) / ri
        for i in range(ci + 1):
            if ci == 0:
                ci = 1
            wb2[:, ci - i] = (ci - i) / ci
    elif index == 3:  # overlap lower-left
        for j in range(1, col):
            for i in range(row):
                if px(i, col - j):
                    ri = i - 1
                    break
            if ri != 0:
                break
        for i in range(col - 1, -1, -1):
            if px(ri, i):
                ci = i + 1
                break
        for i in range(ri, row):
            if ri == 0:
                ri = 1
            wb1[i, :] = (row - i - 1) / (row - ri - 1)
        for i in range(ci + 1):
            if ci == 0:
                ci = 1
            wb2[:, ci - i] = (ci - i) / ci
    elif index == 0:  # overlap lower-right
        for j in range(0, col):
            for i in range(row):
                if px(i, j):
                    ri = i - 1
                    break
            if ri != 0:
                break
        for i in range(col):
            if px(ri, i):
                ci = i - 1
                break
        for i in range(ri, row):
            if ri == 0:
                ri = 1
            wb1[i, :] = (row - i - 1) / (row - ri - 1)
        for i in range(ci, col):
            if ci == 0:
                ci = 1
            wb2[:, i] = (col - i - 1) / (col - ci - 1)
    elif index == 1:  # overlap upper-right
        for j in range(0, col):
            for i in range(row - 1, -1, -1):
                if px(i, j):
                    ri = i + 1
                    break
            if ri != 0:
                break
        for i in range(col):
            if px(ri, i):
                ci = i - 1
                break
        for i in range(ri + 1):
            if ri == 0:
                ri = 1
            wb1[ri - i, :] = (ri - i) / ri
        for i in range(ci, col):
            if ci == 0:
                ci = 1
            wb2[:, i] = (col - i - 1) / (col - ci - 1)
    wb = wb1 * wb2
    return 1.0 - wb, wb


def fade_weights_oracle(shape, drow, dcol):
    """Plain fade ramps (ImageFusion.py:213-235)."""
    row, col = shape
    wa = np.ones(shape, np.float64)
    wb = np.ones(shape, np.float64)
    if col <= row:
        for i in range(col):
            if dcol >= 0:
                wa[:, col - i - 1] *= i / col
                wb[:, i] *= i / col
            else:
                wa[:, col - i - 1] *= (col - i) / col
                wb[:, i] *= (col - i) / col
    else:
        for i in range(row):
            if drow <= 0:
                wa[i, :] *= i / row
                wb[row - i - 1, :] *= i / row
            else:
                wa[i, :] *= (row - i) / row
                wb[row - i - 1, :] *= (row - i) / row
    return wa, wb


def fade_fuse_oracle(image_a, image_b, drow, dcol, color):
    """fuseByFadeInAndFadeOut (ImageFusion.py:192-244)."""
    a = np.asarray(image_a).astype(np.int64).copy()
    b = np.asarray(image_b).astype(np.int64)
    if np.count_nonzero(a > -1) / a.size > 0.65:
        wa, wb = fade_weights_oracle(a.shape[:2], drow, dcol)
    else:
        wa, wb = corner_weights_oracle(a, color)
    if color:
        wa = wa[..., None]
        wb = wb[..., None]
    a[a < 0] = b[a < 0]
    res = wa * a + wb * b
    res[res < 0] = 0
    res[res > 255] = 255
    return res.astype(np.uint8)


def mode_offset_oracle(kps_a, kps_b, matches, offset_evaluate):
    """getOffsetByMode (ImageUtility.py:139-178), literal."""
    if len(matches) == 0:
        return False, [0, 0]
    dxs, dys = [], []
    for train_idx, query_idx in matches:
        pa = (kps_a[query_idx][1], kps_a[query_idx][0])
        pb = (kps_b[train_idx][1], kps_b[train_idx][0])
        if int(pa[0] - pb[0]) == 0 and int(pa[1] - pb[1]) == 0:
            continue
        dxs.append(int(pa[0] - pb[0]))
        dys.append(int(pa[1] - pb[1]))
    if not dxs:
        dxs.append(0)
        dys.append(0)
    zl = list(zip(dxs, dys))
    counts = dict((a, zl.count(a)) for a in zl)
    ordered = dict(sorted(counts.items(), key=lambda x: x[1], reverse=True))
    key = list(ordered)[0]
    num = ordered[key]
    return (num >= offset_evaluate), [key[0], key[1]]
