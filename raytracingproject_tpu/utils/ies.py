"""IES photometric profile parsing + resampling
(ref: src/util/util_ies.cpp IESFile — re-implemented from the IESNA
LM-63 spec; the device side uses a fixed-resolution resampled grid
instead of the reference's per-file angle tables so the kernel lookup
is a single wide-row fetch).

The grid is normalized to peak 1.0; lamp `strength` scales the peak,
so swapping profiles keeps exposure stable.
"""

from __future__ import annotations

import numpy as np

IES_RES_V = 32   # vertical angle bins over [0, pi]
IES_RES_H = 16   # horizontal angle bins over [0, 2pi)


def parse_ies(text):
    """Parse IESNA LM-63 text. Returns (v_angles_rad (nv,),
    h_angles_rad (nh,), candela (nh, nv)) or raises ValueError."""
    if "TILT" not in text:
        raise ValueError("not an IES file (no TILT line)")
    head, _, rest = text.partition("TILT=")
    tilt_line, _, numbers = rest.partition("\n")
    tilt = tilt_line.strip()
    toks = numbers.replace(",", " ").split()
    if tilt == "INCLUDE":
        # <lamp-to-luminaire> <num pairs> then pairs of angles/factors
        try:
            npairs = int(float(toks[1]))
        except (IndexError, ValueError):
            raise ValueError("malformed TILT=INCLUDE block")
        toks = toks[2 + 2 * npairs:]
    vals = [float(t) for t in toks]
    if len(vals) < 13:
        raise ValueError("truncated IES numeric block")
    # [0] nlamps [1] lumens [2] multiplier [3] nv [4] nh [5] photometric
    # type [6] units [7:10] dims [10] ballast [11] future [12] watts
    mult = vals[2] if vals[2] > 0 else 1.0
    nv = int(vals[3])
    nh = int(vals[4])
    data = vals[13:]
    if len(data) < nv + nh + nv * nh:
        raise ValueError("truncated IES angle/candela data")
    v_angles = np.asarray(data[:nv], np.float64)
    h_angles = np.asarray(data[nv:nv + nh], np.float64)
    candela = np.asarray(data[nv + nh:nv + nh + nv * nh],
                         np.float64).reshape(nh, nv) * mult
    return (np.deg2rad(v_angles), np.deg2rad(h_angles), candela)


def resample_ies(v_angles, h_angles, candela,
                 res_v=IES_RES_V, res_h=IES_RES_H):
    """Resample onto a regular (res_h, res_v) grid over
    [0, 2pi) x [0, pi], peak-normalized to 1.0.

    Handles the LM-63 horizontal symmetry conventions: nh==1 is
    axially symmetric; max h == 90 deg mirrors into quadrants;
    max h == 180 deg mirrors the other half (ref: util_ies.cpp
    IESFile::process_type_c)."""
    v_angles = np.asarray(v_angles, np.float64)
    h_angles = np.asarray(h_angles, np.float64)
    candela = np.asarray(candela, np.float64)

    # expand horizontal symmetry to the full circle
    if len(h_angles) == 1:
        h_full = np.array([0.0, 2.0 * np.pi])
        c_full = np.repeat(candela, 2, axis=0)
    else:
        h_max = h_angles[-1]
        h, c = h_angles, candela
        if abs(h_max - np.pi / 2) < 1e-6:       # 0..90 -> mirror twice
            h = np.concatenate([h, np.pi - h[-2::-1]])
            c = np.concatenate([c, c[-2::-1]], axis=0)
            h_max = np.pi
        if abs(h_max - np.pi) < 1e-6:           # 0..180 -> mirror
            h = np.concatenate([h, 2.0 * np.pi - h[-2::-1]])
            c = np.concatenate([c, c[-2::-1]], axis=0)
        h_full, c_full = h, c
        if h_full[-1] < 2.0 * np.pi - 1e-6:     # close the circle
            h_full = np.concatenate([h_full, [2.0 * np.pi]])
            c_full = np.concatenate([c_full, c_full[:1]], axis=0)

    gv = np.linspace(0.0, np.pi, res_v)
    gh = np.linspace(0.0, 2.0 * np.pi, res_h, endpoint=False)
    # interp along v for each measured h, then along h
    cv = np.stack([np.interp(gv, v_angles, row,
                             left=0.0 if v_angles[0] > 1e-6 else row[0],
                             right=0.0 if v_angles[-1] < np.pi - 1e-6
                             else row[-1])
                   for row in c_full])           # (nh_full, res_v)
    out = np.stack([np.interp(gh, h_full, cv[:, j]) for j in
                    range(res_v)], axis=1)       # (res_h, res_v)
    peak = out.max()
    if peak > 0:
        out = out / peak
    return out.astype(np.float32)


def load_ies_grid(text, res_v=IES_RES_V, res_h=IES_RES_H):
    v, h, c = parse_ies(text)
    return resample_ies(v, h, c, res_v, res_h)
