"""Multiscale Frangi vesselness in PyTorch.

Port of the JAX package's ops/vesselness.py: the streamed raw-volume
driver (``frangi_vesselness_streamed``), the whole-volume filter
(``frangi_vesselness``) and the halo'd z-slab driver for volumes too
large for one pass (``frangi_vesselness_chunked``).  Per scale:

  1. gamma-normalized Hessian at each scale: Gaussian smoothing as three
     separable zero-padded passes (shifted-slice weighted sums in f32 —
     no TF32 or reduced-precision contraction anywhere: one bf16 pass
     visibly corrupts the Hessian eigen-structure), then edge-replicated
     central differences;
  2. closed-form eigenvalues of the symmetric 3x3 Hessian per voxel
     (trigonometric method);
  3. Frangi's tubularity measure (Ra, Rb, S with the alpha/beta/c weights);
  4. max over scales.

In the two slab drivers the response pass (steps 2-4 from the smoothed
field) is the Frangi-response kernel of ops/vesselness_fused.py: the
hand-written CUDA kernel for tensors on a CUDA device, its plain PyTorch
twin on the CPU.  Every x extent takes the kernel; there is no VMEM-size
guard as on the TPU, and ``VesselnessConfig.fused_response`` (a TPU
dispatch switch) is not read.  ``frangi_vesselness`` is plain PyTorch
ops throughout, as the JAX package's is XLA.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from . import grow_loop


def _gaussian_kernel(sigma: float, radius: int | None = None):
    """Normalised Gaussian taps, radius ceil(3 sigma), as f32."""
    if radius is None:
        radius = max(int(np.ceil(3.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    return np.asarray(g, dtype=np.float32)


def _conv_axis(vol, kernel, axis):
    """Separable 1D convolution along ``axis`` with zero padding, as a
    shifted-slice weighted sum accumulated in f32."""
    r = len(kernel) // 2
    n = vol.shape[axis]
    pad = [0, 0] * 3
    pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = r  # F.pad: last dim first
    vp = F.pad(vol, pad)
    out = vp.narrow(axis, 0, n) * float(kernel[0])
    for t in range(1, len(kernel)):
        out.add_(vp.narrow(axis, t, n), alpha=float(kernel[t]))
    return out


def _smooth(vol, sigma: float):
    """Gaussian smoothing, three separable passes (z, then y, then x)."""
    g0 = _gaussian_kernel(sigma)
    sm = vol
    for axis in range(3):
        sm = _conv_axis(sm, g0, axis)
    return sm


def _d_shift(x, axis, order):
    """Edge-replicated central difference via shifted slices."""
    n = x.shape[axis]
    lo = x.narrow(axis, 0, 1)
    hi = x.narrow(axis, n - 1, 1)
    xm = torch.cat([lo, x.narrow(axis, 0, n - 1)], dim=axis)
    xp = torch.cat([x.narrow(axis, 1, n - 1), hi], dim=axis)
    return xp - xm if order == 1 else xp + xm - 2.0 * x


def _hessian_from_smoothed(sm, sigma: float):
    """gamma=1 normalized Hessian components from the smoothed field:
    (zz, yy, xx, zy, zx, yx), second derivatives scaled by sigma^2 and
    cross terms by sigma^2/4."""
    s2 = float(np.float32(sigma * sigma))
    q = 0.25 * s2
    dz, dx = _d_shift(sm, 0, 1), _d_shift(sm, 2, 1)
    return (_d_shift(sm, 0, 2) * s2, _d_shift(sm, 1, 2) * s2,
            _d_shift(sm, 2, 2) * s2,
            _d_shift(dz, 1, 1) * q,   # axes 0,1
            _d_shift(dx, 0, 1) * q,   # axes 0,2
            _d_shift(dx, 1, 1) * q)   # axes 1,2


def hessian_at_scale(vol, sigma: float):
    """gamma=1 normalized Hessian (zz, yy, xx, zy, zx, yx) of ``vol``:
    Gaussian smoothing, then edge-replicated central differences of the
    smoothed field (the derivative-of-smoothed formulation)."""
    return _hessian_from_smoothed(_smooth(vol, float(sigma)), float(sigma))


def symmetric_eigvals_3x3(a11, a22, a33, a12, a13, a23):
    """Eigenvalues of symmetric 3x3 matrices, ascending, elementwise
    (trigonometric closed form)."""
    p1 = a12 * a12 + a13 * a13 + a23 * a23
    q = (a11 + a22 + a33) / 3.0
    b11, b22, b33 = a11 - q, a22 - q, a33 - q
    p2 = b11 * b11 + b22 * b22 + b33 * b33 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))

    inv_p = 1.0 / p
    c11, c22, c33 = b11 * inv_p, b22 * inv_p, b33 * inv_p
    c12, c13, c23 = a12 * inv_p, a13 * inv_p, a23 * inv_p
    # det(B/p) / 2
    detb = (c11 * (c22 * c33 - c23 * c23)
            - c12 * (c12 * c33 - c23 * c13)
            + c13 * (c12 * c23 - c22 * c13))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0

    e1 = q + 2.0 * p * torch.cos(phi)                         # largest
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)   # smallest
    e2 = 3.0 * q - e1 - e3
    # degenerate (p ~ 0): all eigenvalues = q
    tiny = p2 < 1e-24
    return (torch.where(tiny, q, e3), torch.where(tiny, q, e2),
            torch.where(tiny, q, e1))  # ascending


def _sorted_eigvals(hs):
    """Hessian eigenvalues sorted by |lambda| ascending (a 3-element
    compare-swap network)."""
    a, b, c = symmetric_eigvals_3x3(*hs)

    def swap_if(cond, x, y):
        return torch.where(cond, y, x), torch.where(cond, x, y)

    a, b = swap_if(torch.abs(a) > torch.abs(b), a, b)
    b, c = swap_if(torch.abs(b) > torch.abs(c), b, c)
    a, b = swap_if(torch.abs(a) > torch.abs(b), a, b)
    return a, b, c


def _norm(lam):
    lam1, lam2, lam3 = lam
    return torch.sqrt(lam1 * lam1 + lam2 * lam2 + lam3 * lam3)


def _tubularity(lam, s, alpha, beta, g, bright):
    """Frangi's measure from the sorted eigenvalues and their norm ``s``;
    ``g`` is the scale weight (a 0-dim tensor or a float)."""
    lam1, lam2, lam3 = lam
    eps = 1e-10
    ra = torch.abs(lam2) / (torch.abs(lam3) + eps)
    rb = torch.abs(lam1) / (torch.sqrt(torch.abs(lam2 * lam3)) + eps)
    v = ((1.0 - torch.exp(-(ra * ra) / (2 * alpha ** 2)))
         * torch.exp(-(rb * rb) / (2 * beta ** 2))
         * (1.0 - torch.exp(-(s * s) / (2 * (g * g) + eps))))
    if bright:
        keep = (lam2 < 0) & (lam3 < 0)
    else:
        keep = (lam2 > 0) & (lam3 > 0)
    return torch.where(keep, v, 0.0)


def _response_from_hessian(hs, alpha, beta, g, bright):
    """Frangi tubularity from the Hessian components; ``g`` is the scale
    weight (a 0-dim tensor from the S-max pass, or a float)."""
    lam = _sorted_eigvals(hs)
    return _tubularity(lam, _norm(lam), alpha, beta, g, bright)


def _scale_response(vol, sigma, alpha, beta, g, bright):
    """Single-scale Frangi response given the scale weight ``g``."""
    return _response_from_hessian(hessian_at_scale(vol, float(sigma)),
                                  alpha, beta, g, bright)


STREAMED_CHUNK_Z = 48     # frangi_vesselness_streamed's slab rows


def slab_plan(Z, sigmas, chunk_z, streamed=False):
    """(halo, chunk_z, n_chunks) of a slab driver over ``Z`` rows: the
    halo is the smoothing radius ceil(3 max sigma) plus the central
    difference; the streamed driver grows a slab to at least its halo."""
    halo = int(np.ceil(3.0 * max(sigmas))) + 1
    if streamed:
        chunk_z = max(chunk_z, halo)
    return halo, chunk_z, -(-Z // chunk_z)


def k1_launches(Z, sigmas, chunk_z, streamed=False):
    """K1 launches of one slab-driver call over ``Z`` rows on a card: one
    per slab and scale."""
    return slab_plan(Z, sigmas, chunk_z, streamed)[2] * len(tuple(sigmas))


def _smax_chunk(volp, start, sigma, halo, chunk_z):
    """Frobenius S-max of one chunk (the gamma pass), without caching
    the smoothed field."""
    sm = _smooth(volp[start:start + chunk_z + 2 * halo], sigma)
    return _frobenius_max(sm, sigma, halo, chunk_z)


def _smax_chunk_cache(smf, volp, start, sigma, halo, chunk_z):
    """Frobenius S-max of one chunk; writes the chunk's interior smoothed
    rows into the full-frame cache ``smf`` in place (read by
    ``_apply_chunk_sm``)."""
    sm = _smooth(volp[start:start + chunk_z + 2 * halo], sigma)
    smf[start + halo:start + halo + chunk_z] = sm[halo:halo + chunk_z]
    return _frobenius_max(sm, sigma, halo, chunk_z)


def _frobenius_max(sm, sigma, halo, chunk_z):
    hxx, hyy, hzz, hxy, hxz, hyz = _hessian_from_smoothed(sm, sigma)
    s2 = (hxx * hxx + hyy * hyy + hzz * hzz
          + 2.0 * (hxy * hxy + hxz * hxz + hyz * hyz))
    return torch.sqrt(torch.max(s2[halo:halo + chunk_z]))


def _apply_chunk_sm(best, smf, start, g, sigma, alpha, beta, bright,
                    halo, chunk_z):
    """Fold one chunk's response, from the cached smoothed field, into
    ``best`` (in place).  At the volume faces the cache's halo rows are
    exact zeros, whereas ``_apply_chunk`` smooths the zero padding into a
    nonzero tail: the two differ slightly on the outermost z rows only,
    as in the JAX reference."""
    from .vesselness_fused import frangi_response_max_
    frangi_response_max_(best, start, smf, start + halo, chunk_z, sigma, g,
                         alpha, beta, bright)


def _apply_chunk(best, volp, start, g, sigma, alpha, beta, bright,
                 halo, chunk_z):
    """Smooth one halo'd slab of the resident volume and fold its
    response into ``best`` (in place)."""
    from .vesselness_fused import frangi_response_max_
    sm = _smooth(volp[start:start + chunk_z + 2 * halo], sigma)
    frangi_response_max_(best, start, sm, halo, chunk_z, sigma, g,
                         alpha, beta, bright)


# frangi_vesselness's per-voxel passes (eigenvalues, norm, tubularity:
# ~40 temporaries of their input's size) run over z slabs of at most
# this many voxels.  They are elementwise, so the slabs give the whole
# volume's bits.
SLAB_VOXELS = 1 << 26


@grow_loop.frees_loop_caches
def frangi_vesselness(volume, sigmas=(1.0, 2.0, 3.0), alpha=0.5, beta=0.5,
                      gamma=None, bright=True, device=None):
    """Multiscale Frangi tubularity in [0, 1] of the whole volume at
    once, on ``device`` (by default the device of a ``volume`` tensor;
    host arrays go to the card).  With ``gamma=None`` each scale's weight
    is ``0.5 * max(S)``, S the eigenvalue norm (not the Frobenius norm
    the slab drivers take: the two round differently).  The faces
    edge-replicate the smoothed field.  The Hessian of a scale is held
    whole; the passes after it run slab by slab (``SLAB_VOXELS``)."""
    from .region_grow import _as_device, _resolve_device

    vol = _as_device(volume, _resolve_device(volume, device), torch.float32)
    best = torch.zeros_like(vol)
    rows = max(1, SLAB_VOXELS // max(1, vol[0].numel()))
    slabs = [slice(z, z + rows) for z in range(0, vol.shape[0], rows)]
    for sigma in sigmas:
        hs = hessian_at_scale(vol, float(sigma))
        parts = []
        for sl in slabs:
            lam = _sorted_eigvals(tuple(h[sl] for h in hs))
            parts.append((lam, _norm(lam)))
        del hs
        g = gamma if gamma is not None else 0.5 * torch.max(
            torch.stack([torch.max(s) for _, s in parts]))
        for sl, (lam, s) in zip(slabs, parts):
            b = best[sl]
            torch.maximum(b, _tubularity(lam, s, alpha, beta, g, bright),
                          out=b)
        del parts
    return best


@grow_loop.frees_loop_caches
def frangi_vesselness_chunked(volume, sigmas=(1.0, 2.0, 3.0),
                              alpha=0.5, beta=0.5, gamma=None,
                              bright=True, chunk_z: int = 96,
                              donate_input: bool = False,
                              fused_response="auto", device=None):
    """Multiscale Frangi for volumes whose full-grid temporaries do not
    fit one pass: halo'd z slabs of ``chunk_z`` rows, each scale's
    response folded into the running max by the Frangi-response kernel
    K1 (its twin on the CPU), ``len(sigmas)`` launches per slab.  With
    ``gamma=None`` the per-scale weight ``0.5 * max(S)`` (Frobenius S)
    comes from a first chunked pass, which caches the slabs' smoothed
    rows for the response pass.

    Matches ``frangi_vesselness`` on interior z rows up to the two
    response routes' rounding and the weight's norm; the two volume-face
    rows differ more (the whole-volume differences edge-replicate the
    smoothed field at the face, a slab sees the zero-padded tail).
    ``donate_input`` and ``fused_response`` are accepted for the JAX
    package's signature and not read: the caller's tensor is not freed,
    and there is no switch that bypasses K1 on a card."""
    from .region_grow import _as_device, _resolve_device

    device = _resolve_device(volume, device)
    vol = _as_device(volume, device, torch.float32)
    Z = vol.shape[0]
    shape_yx = tuple(vol.shape[1:])
    halo, chunk_z, n_chunks = slab_plan(Z, sigmas, chunk_z)
    Zp = n_chunks * chunk_z
    volp = F.pad(vol, (0, 0, 0, 0, halo, Zp - Z + halo))
    del vol

    starts = [c * chunk_z for c in range(n_chunks)]
    best = torch.zeros((Zp,) + shape_yx, dtype=torch.float32, device=device)
    for sigma in sigmas:
        sigma = float(sigma)
        if gamma is None:
            smf = torch.zeros_like(volp)
            parts = [_smax_chunk_cache(smf, volp, s, sigma, halo, chunk_z)
                     for s in starts]
            g = torch.max(torch.stack(parts)) * 0.5
            for s in starts:
                _apply_chunk_sm(best, smf, s, g, sigma, float(alpha),
                                float(beta), bool(bright), halo, chunk_z)
            del smf
        else:
            g = torch.tensor(gamma, dtype=torch.float32, device=device)
            for s in starts:
                _apply_chunk(best, volp, s, g, sigma, float(alpha),
                             float(beta), bool(bright), halo, chunk_z)
    return best[:Z]


def _fma_f32(q, scale, offset):
    """``q * scale + offset`` rounded once to f32, as the reference's XLA
    program computes it (one fused multiply-add).  ``q`` holds integers
    below 2^12 and ``scale``/``offset`` are f32 values, so the product is
    exact in f64 and the f64 sum rounds to the fused result (a double
    rounding could differ only on an exact f32 tie)."""
    f64 = torch.float64
    if isinstance(scale, torch.Tensor):
        scale, offset = scale.to(f64), offset.to(f64)
    else:
        scale, offset = float(np.float32(scale)), float(np.float32(offset))
    return (q.to(f64) * scale + offset).to(torch.float32)


def _upload_slab_u8(volp, slab_u8, start, scale, offset):
    """Dequantize one uint8 slab into ``volp`` rows [start, ...)."""
    sl = _fma_f32(slab_u8, scale, offset)
    volp[start:start + sl.shape[0]] = sl


def _upload_slab_u12(volp, packed, start, scale, offset, rows, yx):
    """Unpack one 12-bit-packed slab (3 bytes / 2 voxels) into volp.
    ``scale``/``offset`` are f32 0-dim tensors."""
    b0 = packed[:, 0].to(torch.int32)
    b1 = packed[:, 1].to(torch.int32)
    b2 = packed[:, 2].to(torch.int32)
    v0 = (b0 << 4) | (b1 >> 4)
    v1 = ((b1 & 0xF) << 8) | b2
    n = rows * int(np.prod(yx))
    vals = torch.stack([v0, v1], dim=1).reshape(-1)[:n]
    sl = _fma_f32(vals, scale, offset).reshape((rows,) + tuple(yx))
    volp[start:start + rows] = sl


def _upload_slab_f16(volp, slab_f16, start):
    volp[start:start + slab_f16.shape[0]] = slab_f16.to(torch.float32)


def _bq_dequant_packed(packed, row_scale, row_min, bits):
    """bq-packed (rows, ny, nxp) bytes -> dequantized f32 (rows, ny, nx).

    Shared by the dense and the occupancy-skipped uploads."""
    p = packed.to(torch.int32)
    lead = tuple(p.shape[:2])
    if bits == 4:
        vs = [p >> 4, p & 0xF]
    elif bits == 3:
        b = p.reshape(lead + (-1, 3))
        w = (b[..., 0] << 16) | (b[..., 1] << 8) | b[..., 2]
        vs = [(w >> (21 - 3 * k)) & 7 for k in range(8)]
    else:  # 2-bit
        vs = [(p >> s) & 3 for s in (6, 4, 2, 0)]
    q = torch.stack(vs, dim=-1).reshape(lead + (-1,))
    return _fma_f32(q, row_scale[..., None], row_min[..., None])


def _upload_slab_bq(volp, packed, row_scale, row_min, start, bits):
    """Unpack one row-adaptive low-bit slab into volp."""
    sl = _bq_dequant_packed(packed, row_scale, row_min, bits)
    volp[start:start + sl.shape[0]] = sl


def _upload_slab_bq_sparse(volp, payload, chunk_idx, row_scale, row_min,
                           start, *, bits, cs, n_chunks, rows, ny):
    """Occupancy-skipped row-adaptive upload: only row-chunks whose range
    clears the background threshold carry payload bytes; the rest
    dequantize to their row midpoint through a zeroed scale sideband.

    ``payload``: uint8 (bucket, cs*nxp) — the kept chunks of ``cs``
    consecutive (z,y) rows; pad slots carry ``chunk_idx == n_chunks``,
    which lands in a dropped sentinel row.  The dense packed array is
    rebuilt with one ``index_copy_``, so kept chunks decode bit-identically
    to the dense path."""
    nxp = payload.shape[1] // cs
    dense = payload.new_zeros((n_chunks + 1, payload.shape[1]))
    dense.index_copy_(0, chunk_idx, payload)
    q8 = dense[:n_chunks].reshape(n_chunks * cs, nxp)[:rows * ny]
    sl = _bq_dequant_packed(q8.reshape(rows, ny, nxp), row_scale, row_min,
                            bits)
    volp[start:start + rows] = sl


def _sparse_bucket(n: int) -> int:
    """Pad count -> {2^k, 1.5*2^k} sizes (<=1.33x padding)."""
    b = 64
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b *= 2


# background-row skip: a (z,y) row whose range is below this fraction of
# the slab's intensity range carries no vessel (vessel contrast >> noise
# range on MRA-like data); measured bimodal on the bench phantoms
# (background rows ~0.15, vessel rows >0.75 of range — any threshold in
# 0.25-0.4 selects the same rows)
_SKIP_BG_FRACTION = 0.25
_SKIP_CHUNK_ROWS = 8


def _skip_threshold(rmn, rng):
    """Keep/skip threshold from a ROBUST slab range.

    The slab top is the 99.5th percentile of row maxima, not the max:
    an isolated hyperintense artifact row must not inflate the range and
    reclassify real vessel rows as background.  If vessels ever occupy
    <0.5% of rows the threshold collapses toward the noise range and the
    >50%-kept dense fallback engages — failing safe rather than losing
    vessels."""
    smax = float(np.percentile(rmn + rng, 99.5))
    smin = float(rmn.min())
    return _SKIP_BG_FRACTION * (smax - smin)


def _pack_compact_native(slf, bits):
    """Stats-then-pack-selected host path for the occupancy-skipped
    upload: one native row min/max scan decides keep/skip, then only the
    kept chunks' rows are quantized+packed.  Returns the same tuple as
    ``_compact_bq_slab`` or ``None`` (caller falls back to the full
    pack).  Kept payload and sideband are bit-identical to the full-pack
    path (same native row scan and rounding)."""
    from .native import bq_pack_rows_native, bq_row_stats_native

    rows, ny, nx = slf.shape
    R = rows * ny
    cs = _SKIP_CHUNK_ROWS
    if R % cs:
        return None
    rmn, rmx = bq_row_stats_native(slf)
    qmax = float((1 << bits) - 1)
    # derive the range through the quantized scale (rng -> rsc -> rng)
    # so thresholds and midpoints match ``_compact_bq_slab`` bit for bit
    rsc_all = ((rmx - rmn) / qmax).astype(np.float32)
    rng = rsc_all * qmax
    thr = _skip_threshold(rmn, rng)
    if thr <= 0:
        return None
    nch = R // cs
    keep_chunk = (rng > thr).reshape(nch, cs).any(axis=1)
    if keep_chunk.mean() > 0.5:
        return None
    idx = np.nonzero(keep_chunk)[0].astype(np.int32)
    rowlist = (idx[:, None].astype(np.int64) * cs
               + np.arange(cs, dtype=np.int64)[None, :]).reshape(-1)
    rb = nx * bits // 8
    pay = bq_pack_rows_native(slf, rowlist, bits).reshape(len(idx),
                                                          cs * rb)
    bucket = _sparse_bucket(len(idx))
    pad = bucket - len(idx)
    if pad:
        idx = np.concatenate([idx, np.full(pad, nch, np.int32)])
        pay = np.pad(pay, ((0, pad), (0, 0)))
    keep_eff = np.repeat(keep_chunk, cs).reshape(rows, ny)
    rmn2 = np.where(keep_eff, rmn, rmn + 0.5 * rng).astype(np.float32)
    rsc2 = np.where(keep_eff, rsc_all, 0.0).astype(np.float32)
    return pay, idx, rsc2, rmn2, nch


def _compact_bq_slab(packed, rsc, rmn, bits):
    """Host-side compaction for the occupancy-skipped upload.

    Returns ``None`` when skipping would not pay (kept fraction > 50%),
    else ``(payload, chunk_idx, rsc2, rmn2, n_chunks)`` ready for
    ``_upload_slab_bq_sparse``.  Rows inside kept chunks keep their real
    sideband (they decode bit-exactly); rows in skipped chunks get
    scale 0 / min = midpoint."""
    qmax = float((1 << bits) - 1)
    rng = rsc * qmax
    thr = _skip_threshold(rmn, rng)
    if thr <= 0:
        return None
    rows, ny, nxp = packed.shape
    R = rows * ny
    cs = _SKIP_CHUNK_ROWS
    nch = -(-R // cs)
    keep_rows = (rng > thr).reshape(-1)
    keep_chunk = np.pad(keep_rows, (0, nch * cs - R)).reshape(
        nch, cs).any(axis=1)
    if keep_chunk.mean() > 0.5:
        return None
    idx = np.nonzero(keep_chunk)[0].astype(np.int32)
    flat = packed.reshape(R, nxp)
    if nch * cs != R:
        flat = np.pad(flat, ((0, nch * cs - R), (0, 0)))
    pay = flat.reshape(nch, cs * nxp)[idx]
    bucket = _sparse_bucket(len(idx))
    pad = bucket - len(idx)
    if pad:
        idx = np.concatenate([idx, np.full(pad, nch, np.int32)])
        pay = np.pad(pay, ((0, pad), (0, 0)))
    keep_eff = np.repeat(keep_chunk, cs)[:R].reshape(rows, ny)
    rmn2 = np.where(keep_eff, rmn, rmn + 0.5 * rng).astype(np.float32)
    rsc2 = np.where(keep_eff, rsc, 0.0).astype(np.float32)
    return pay, idx, rsc2, rmn2, nch


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@grow_loop.frees_loop_caches
def frangi_vesselness_streamed(raw, sigmas=(1.0, 2.0, 3.0),
                               alpha=0.5, beta=0.5, gamma=None,
                               bright=True,
                               chunk_z: int = STREAMED_CHUNK_Z,
                               bits: int = 8,
                               skip_background: bool = False,
                               device="cuda"):
    """Multiscale Frangi from a HOST volume, uploaded slab by slab.

    The chunk structure is the JAX reference's: slab ``c+1`` is uploaded
    before chunk ``c``'s S-max pass; every scale's gamma (S-max) pass
    runs inside the upload loop; scale 0 then applies from its cached
    smoothed field and later scales apply directly from the resident
    volume.  The face-row semantics therefore match the reference exactly
    (the direct applies smooth the zero padding into the halo).

    ``bits``: wire format — 2/3/4 (row-adaptive), 8 / 12 (packed fixed
    point) or 16 (f16); the dequantization runs on ``device``.
    Returns ``(vesselness, upload_phase_s, compute_phase_s)``: the
    interleaved upload + gamma passes, then the response passes, each
    ended by a device synchronization.
    """
    from .native import bq_pack_native

    raw = np.asarray(raw)
    Z = raw.shape[0]
    shape_yx = tuple(raw.shape[1:])
    sigmas = tuple(float(s) for s in sigmas)
    halo, chunk_z, n_chunks = slab_plan(Z, sigmas, chunk_z, streamed=True)
    Zp = n_chunks * chunk_z

    # sub-byte packing needs an aligned x extent; degrade to the next
    # finer format that fits instead of silently jumping to u8
    while bits in (2, 3, 4) and raw.shape[2] % {4: 2, 3: 8, 2: 4}[bits]:
        bits = {2: 3, 3: 4, 4: 8}[bits]
    if bits in (8, 12):
        # only the global fixed-point formats need the volume range
        mn = float(raw.min())
        scale = (float(raw.max()) - mn) or 1.0
    else:
        mn, scale = 0.0, 1.0

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    t0 = time.perf_counter()
    volp = torch.zeros((Zp + 2 * halo,) + shape_yx, dtype=torch.float32,
                       device=device)

    def upload(c):
        lo = c * chunk_z
        hi = min(Z, lo + chunk_z)
        rows = hi - lo
        sl = raw[lo:hi]
        if bits in (2, 3, 4):
            # row-adaptive low-bit: per-(z,y)-row min/scale sideband
            slf = np.ascontiguousarray(sl, dtype=np.float32)
            sp = None
            if skip_background:
                # native stats scan + pack of kept rows only
                sp = _pack_compact_native(slf, bits)
            if sp is None:
                packed, rsc, rmn = bq_pack_native(slf, bits)
                if skip_background:
                    sp = _compact_bq_slab(packed, rsc, rmn, bits)
            if sp is not None:
                pay, idx, rsc2, rmn2, nch = sp
                _upload_slab_bq_sparse(
                    volp, dev(pay), dev(idx.astype(np.int64)), dev(rsc2),
                    dev(rmn2), lo + halo, bits=bits, cs=_SKIP_CHUNK_ROWS,
                    n_chunks=nch, rows=rows, ny=int(shape_yx[0]))
                return
            _upload_slab_bq(volp, dev(packed), dev(rsc), dev(rmn),
                            lo + halo, bits)
            return
        if bits == 8:
            q = np.round((sl.astype(np.float32) - mn)
                         * (255.0 / scale)).astype(np.uint8)
            _upload_slab_u8(volp, dev(q), lo + halo, scale / 255.0, mn)
            return
        if bits == 12:
            flat = sl.reshape(-1).astype(np.float32)
            pad = (-flat.shape[0]) % 2
            if pad:
                flat = np.concatenate([flat, flat[-1:]])
            q = np.round((flat - mn) * (4095.0 / scale)).astype(np.uint16)
            q0, q1 = q[0::2], q[1::2]
            packed = np.empty((q0.shape[0], 3), np.uint8)
            packed[:, 0] = q0 >> 4
            packed[:, 1] = ((q0 & 0xF) << 4) | (q1 >> 8)
            packed[:, 2] = q1 & 0xFF
            f32 = torch.float32
            _upload_slab_u12(
                volp, dev(packed), lo + halo,
                torch.tensor(np.float32(scale / 4095.0), dtype=f32,
                             device=device),
                torch.tensor(np.float32(mn), dtype=f32, device=device),
                rows, shape_yx)
            return
        _upload_slab_f16(volp, dev(sl.astype(np.float16)), lo + halo)

    starts = [c * chunk_z for c in range(n_chunks)]
    sigma0 = sigmas[0]
    best = torch.zeros((Zp,) + shape_yx, dtype=torch.float32, device=device)
    upload(0)
    if gamma is None:
        # scale 0 caches its smoothed field; the other scales' gamma
        # (S-max) passes run cache-less in the same loop
        smf0 = torch.zeros_like(volp)
        parts0 = []
        parts_rest = [[] for _ in sigmas[1:]]
        for c in range(n_chunks):
            if c + 1 < n_chunks:
                upload(c + 1)
            parts0.append(_smax_chunk_cache(smf0, volp, starts[c], sigma0,
                                            halo, chunk_z))
            for si, sigma in enumerate(sigmas[1:]):
                parts_rest[si].append(_smax_chunk(volp, starts[c], sigma,
                                                  halo, chunk_z))
        _sync(device)
        t_upload = time.perf_counter() - t0

        t0 = time.perf_counter()
        g0 = torch.max(torch.stack(parts0)) * 0.5
        for s in starts:
            _apply_chunk_sm(best, smf0, s, g0, sigma0, float(alpha),
                            float(beta), bool(bright), halo, chunk_z)
        del smf0
        # remaining scales: direct applies from the resident volume
        for si, sigma in enumerate(sigmas[1:]):
            g = torch.max(torch.stack(parts_rest[si])) * 0.5
            for s in starts:
                _apply_chunk(best, volp, s, g, sigma, float(alpha),
                             float(beta), bool(bright), halo, chunk_z)
    else:
        for c in range(1, n_chunks):
            upload(c)
        _sync(device)
        t_upload = time.perf_counter() - t0
        t0 = time.perf_counter()
        g = torch.tensor(gamma, dtype=torch.float32, device=device)
        for sigma in sigmas:
            for s in starts:
                _apply_chunk(best, volp, s, g, sigma, float(alpha),
                             float(beta), bool(bright), halo, chunk_z)
    out = best[:Z]
    _sync(device)
    t_compute = time.perf_counter() - t0
    return out, t_upload, t_compute
