"""Plain multiscale Frangi vesselness of a raw volume, as the pipeline's
configuration states it.

1. The wire format: the volume is uploaded in z slabs of ``chunk_z``
   rows; each (z, y) row of a slab is quantized to ``bits`` bits between
   its own min and max, q = rint((x - min) * (2^bits - 1) / range)
   (float32 arithmetic), and decoded as q * scale + min rounded once to
   float32.  With ``skip`` a slab's rows whose range is at most a quarter
   of its robust range (99.5th percentile of row maxima less the least
   row minimum) are sent as their row midpoint, in chunks of 8
   consecutive rows; a chunk is sent whole when one of its rows is kept;
   a slab that would keep more than half its chunks is sent whole.
2. Gaussian smoothing per scale (radius ceil(3 sigma), taps normalised in
   float64), zero outside the volume, then central differences
   (edge-replicated in y and x; in z the smoothed field continues into
   the zero padding, except for the first scale's lower face and, when
   the slabs end at the volume, its upper face, where it is zero).
3. The Hessian scaled by sigma^2 (cross terms by sigma^2 / 4), its
   eigenvalues in closed form, sorted by magnitude, Frangi's measure with
   alpha = beta = 0.5 and c = half the largest Frobenius norm of the
   scaled Hessian over the slabs' rows; bright vessels only; the maximum
   over scales.

``dtype`` is the arithmetic after decoding: float64 for the reference,
bfloat16 for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def slab_geometry(Z, sigmas, chunk_z):
    halo = int(math.ceil(3.0 * max(sigmas))) + 1
    chunk_z = max(chunk_z, halo)
    return chunk_z, -(-Z // chunk_z)


def decode_wire(raw, bits, chunk_z, skip, device):
    """The float32 volume the card receives (step 1)."""
    raw = np.asarray(raw, np.float32)
    Z, ny, nx = raw.shape
    qmax = (1 << bits) - 1
    out = torch.empty(raw.shape, dtype=torch.float32, device=device)
    for lo in range(0, Z, chunk_z):
        hi = min(Z, lo + chunk_z)
        x = torch.from_numpy(raw[lo:hi]).to(device)
        mn = x.amin(dim=2)
        mx = x.amax(dim=2)
        rng = mx - mn
        inv = torch.where(rng > 0, qmax / torch.clamp(rng, min=1e-30),
                          torch.zeros_like(rng))
        scale = rng / qmax
        q = torch.clamp(torch.round((x - mn[..., None]) * inv[..., None]),
                        max=qmax)
        row_min, row_scale = mn, scale
        if skip:
            rmn = mn.cpu().numpy()
            rsc = scale.cpu().numpy().astype(np.float32)
            rg = rsc * np.float32(qmax)
            top = float(np.percentile(rmn + rg, 99.5))
            thr = 0.25 * (top - float(rmn.min()))
            R = rmn.size
            n_ch = -(-R // 8)
            keep_rows = np.pad((rg > thr).reshape(-1), (0, n_ch * 8 - R))
            keep_ch = keep_rows.reshape(n_ch, 8).any(axis=1)
            if thr > 0 and keep_ch.mean() <= 0.5:
                keep = np.repeat(keep_ch, 8)[:R].reshape(rmn.shape)
                mid = np.where(keep, rmn, rmn + 0.5 * rg).astype(np.float32)
                sc = np.where(keep, rsc, 0.0).astype(np.float32)
                row_min = torch.from_numpy(mid).to(device)
                row_scale = torch.from_numpy(sc).to(device)
        out[lo:hi] = (q.double() * row_scale.double()[..., None]
                      + row_min.double()[..., None]).float()
    return out


def _taps(sigma):
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def _smooth(vol, sigma, dtype):
    """Zero-padded separable Gaussian of ``vol`` with one extra row of the
    smoothed padding on each z face: shape (Z + 2, Y, X)."""
    g = torch.tensor(_taps(sigma), dtype=dtype, device=vol.device)
    r = (len(g) - 1) // 2
    v = F.pad(vol.to(dtype), (0, 0, 0, 0, r + 1, r + 1))
    for axis in range(3):
        n = v.shape[axis] - (2 * r if axis == 0 else 0)
        if axis:
            pad = [0, 0, 0, 0, 0, 0]
            pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = r
            v = F.pad(v, pad)
            n = v.shape[axis] - 2 * r
        acc = v.narrow(axis, 0, n) * g[0]
        for t in range(1, len(g)):
            acc = acc + v.narrow(axis, t, n) * g[t]
        v = acc
    return v


def _diff(x, axis, order, replicate=True):
    n = x.shape[axis]
    if replicate:
        lo, hi = x.narrow(axis, 0, 1), x.narrow(axis, n - 1, 1)
        xm = torch.cat([lo, x.narrow(axis, 0, n - 1)], dim=axis)
        xp = torch.cat([x.narrow(axis, 1, n - 1), hi], dim=axis)
        return xp - xm if order == 1 else xp + xm - 2.0 * x
    c = x.narrow(axis, 1, n - 2)
    xm, xp = x.narrow(axis, 0, n - 2), x.narrow(axis, 2, n - 2)
    return xp - xm if order == 1 else xp + xm - 2.0 * c


def hessian(sm_ext, sigma, dtype):
    """(zz, yy, xx, zy, zx, yx) on the interior rows of a z-extended
    smoothed field."""
    s2 = torch.tensor(sigma * sigma, dtype=torch.float32).to(dtype).item()
    q = 0.25 * s2
    inner = sm_ext[1:-1]
    dz = _diff(sm_ext, 0, 1, replicate=False)
    dx_ext = _diff(sm_ext, 2, 1)
    return (_diff(sm_ext, 0, 2, replicate=False) * s2,
            _diff(inner, 1, 2) * s2, _diff(inner, 2, 2) * s2,
            _diff(dz, 1, 1) * q,
            _diff(dx_ext, 0, 1, replicate=False) * q,
            _diff(dx_ext[1:-1], 1, 1) * q)


def eigenvalues(h):
    """Eigenvalues of the symmetric 3x3 matrices, sorted by magnitude."""
    a11, a22, a33, a12, a13, a23 = h
    q = (a11 + a22 + a33) / 3.0
    b11, b22, b33 = a11 - q, a22 - q, a33 - q
    p1 = a12 * a12 + a13 * a13 + a23 * a23
    p2 = b11 * b11 + b22 * b22 + b33 * b33 + 2.0 * p1
    p = torch.sqrt(p2 / 6.0)
    safe = torch.where(p > 0, p, torch.ones_like(p))
    c11, c22, c33 = b11 / safe, b22 / safe, b33 / safe
    c12, c13, c23 = a12 / safe, a13 / safe, a23 / safe
    det = (c11 * (c22 * c33 - c23 * c23) - c12 * (c12 * c33 - c23 * c13)
           + c13 * (c12 * c23 - c22 * c13))
    phi = torch.acos(torch.clamp(det / 2.0, -1.0, 1.0)) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    lam = torch.stack([e1, e2, e3])
    order = torch.argsort(lam.abs(), dim=0)
    return torch.gather(lam, 0, order)


def frangi(hs, g, alpha=0.5, beta=0.5):
    lam = eigenvalues(hs)
    l1, l2, l3 = lam[0], lam[1], lam[2]
    eps = 1e-10
    s = torch.sqrt(l1 * l1 + l2 * l2 + l3 * l3)
    ra = l2.abs() / (l3.abs() + eps)
    rb = l1.abs() / (torch.sqrt((l2 * l3).abs()) + eps)
    v = ((1.0 - torch.exp(-(ra * ra) / (2 * alpha ** 2)))
         * torch.exp(-(rb * rb) / (2 * beta ** 2))
         * (1.0 - torch.exp(-(s * s) / (2 * (g * g) + eps))))
    return torch.where((l2 < 0) & (l3 < 0), v, torch.zeros_like(v))


def vesselness(raw, sigmas, bits=4, skip=True, chunk_z=48,
               dtype=torch.float64, device="cpu", block=16):
    """Frangi vesselness [Z, Y, X] as ``dtype`` on ``device``."""
    Z = raw.shape[0]
    chunk_z, n_chunks = slab_geometry(Z, sigmas, chunk_z)
    Zp = n_chunks * chunk_z
    vol = decode_wire(raw, bits, chunk_z, skip, device)
    if Zp > Z:                      # the slabs' trailing zero rows
        vol = F.pad(vol, (0, 0, 0, 0, 0, Zp - Z))
    best = torch.zeros((Z,) + tuple(raw.shape[1:]), dtype=dtype,
                       device=device)
    for i, sigma in enumerate(sigmas):
        sm = _smooth(vol, float(sigma), dtype)          # (Zp + 2, Y, X)
        gmax = torch.zeros((), dtype=dtype, device=device)
        for z0 in range(0, Zp, block):
            z1 = min(Zp, z0 + block)
            hs = hessian(sm[z0:z1 + 2], float(sigma), dtype)
            s2 = (hs[0] ** 2 + hs[1] ** 2 + hs[2] ** 2
                  + 2.0 * (hs[3] ** 2 + hs[4] ** 2 + hs[5] ** 2))
            gmax = torch.maximum(gmax, s2.max())
        g = torch.sqrt(gmax) * 0.5
        if i == 0:                  # the first scale's cached field
            sm[0] = 0
            if Zp == Z:
                sm[-1] = 0
        for z0 in range(0, Z, block):
            z1 = min(Z, z0 + block)
            hs = hessian(sm[z0:z1 + 2], float(sigma), dtype)
            best[z0:z1] = torch.maximum(best[z0:z1], frangi(hs, g))
        del sm
    return best
