"""Nister 5-point minimal essential-matrix solver in JAX.

BASELINE config 3 names ``cv2.findEssentialMat`` whose RANSAC engine is
Nister's 5-point algorithm (cv2 five-point.cpp); round 2 shipped 8-point
hypotheses, which degenerate on planar scenes. This module implements the
true 5-point minimal solver in a fully vectorized, fixed-shape form that
``vmap``s over RANSAC hypotheses:

 1. nullspace: SVD of the 5x9 epipolar system -> 4 basis matrices
    X, Y, Z, W with E = x*X + y*Y + z*Z + W;
 2. the 10 cubic constraints (det E = 0 and the trace constraint
    2*E*E^T*E - tr(E*E^T)*E = 0) are expanded SYMBOLICALLY AT TRACE TIME
    by tiny polynomial arithmetic over (x, y, z) monomials — no
    hand-derived 10x20 coefficient tables to get wrong;
 3. Gauss-Jordan elimination (one 10x10 solve) and Nister's row
    combinations reduce the system to B(z) [x, y, 1]^T = 0 with B 3x3
    polynomial in z, hence n(z) = det B(z) of degree 10;
 4. real roots: without a nonsymmetric eigensolver on the device, roots are found
    by a homogeneous sign-change scan over theta = atan(z) (evaluating
    sum_i c_i sin^i cos^(N-i), overflow-free over the whole real line)
    followed by fixed-count bisection — branch-free and vmappable;
 5. back-substitution per root via nullvector cross-products -> up to 10
    candidate E's per 5-point sample (validity-masked, fixed shape).

Planar scenes: the calibrated 2-view geometry of a plane admits exactly a
twisted-pair E ambiguity which 5-point RESOLVES via cheirality, while the
8-point DLT collapses (rank deficiency) — the practical reason cv2
defaults to 5-point. ransac_essential_5pt therefore breaks inlier-count
ties among candidate E's with a cheirality vote (pose/ransac.recover_pose
support counts).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


# Nister's 20-monomial order: the first 10 columns are eliminated by
# Gauss-Jordan; the last 10 are the x/y/1-times-z-power groups.
_MONOMIALS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_MONO_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}


def _pmul(a: dict, b: dict) -> dict:
    out = {}
    for ka, ca in a.items():
        for kb, cb in b.items():
            k = (ka[0] + kb[0], ka[1] + kb[1], ka[2] + kb[2])
            term = ca * cb
            out[k] = out[k] + term if k in out else term
    return out


def _padd(a: dict, b: dict, s=1.0) -> dict:
    out = dict(a)
    for k, c in b.items():
        out[k] = out[k] + s * c if k in out else s * c
    return out


def _constraint_rows(basis):
    """The 10 cubic constraint polynomials as a (10, 20) coefficient
    matrix. ``basis`` is (4, 3, 3): X, Y, Z, W with E = xX + yY + zZ + W.
    All arithmetic is on traced scalars; the expansion itself happens at
    trace time (static monomial bookkeeping)."""
    e = [[{(1, 0, 0): basis[0, r, c], (0, 1, 0): basis[1, r, c],
           (0, 0, 1): basis[2, r, c], (0, 0, 0): basis[3, r, c]}
          for c in range(3)] for r in range(3)]

    def det3(m):
        t0 = _pmul(m[0][0], _padd(_pmul(m[1][1], m[2][2]),
                                  _pmul(m[1][2], m[2][1]), -1.0))
        t1 = _pmul(m[0][1], _padd(_pmul(m[1][0], m[2][2]),
                                  _pmul(m[1][2], m[2][0]), -1.0))
        t2 = _pmul(m[0][2], _padd(_pmul(m[1][0], m[2][1]),
                                  _pmul(m[1][1], m[2][0]), -1.0))
        return _padd(_padd(t0, t1, -1.0), t2)

    polys = [det3(e)]

    eet = [[functools.reduce(_padd, (_pmul(e[i][k], e[j][k])
                                     for k in range(3)))
            for j in range(3)] for i in range(3)]
    tr = functools.reduce(_padd, (eet[i][i] for i in range(3)))
    # M = 2*EE^T - tr(EE^T) I, then G = M E (9 constraint polys).
    m = [[_padd({}, eet[i][j], 2.0) for j in range(3)] for i in range(3)]
    for i in range(3):
        m[i][i] = _padd(m[i][i], tr, -1.0)
    for i in range(3):
        for j in range(3):
            polys.append(functools.reduce(
                _padd, (_pmul(m[i][k], e[k][j]) for k in range(3))))

    rows = []
    for p in polys:
        row = [jnp.zeros(())] * 20
        for k, c in p.items():
            row[_MONO_INDEX[k]] = c
        rows.append(jnp.stack(row))
    return jnp.stack(rows)  # (10, 20)


def _z_matrix(M):
    """Nister's reduction: from the eliminated system P = -M Q build the
    3x3 polynomial matrix B(z) with B(z) [x, y, 1]^T = 0.

    Rows 4..9 of the reduced system have pivots x^2 z, x^2, y^2 z, y^2,
    xyz, xy; the combinations <e> - z<f>, <g> - z<h>, <i> - z<j> cancel
    the pivots and leave equations linear in (x, y) with z-polynomial
    coefficients. Returns (3, 3, 5): [row][col][z-power], column degrees
    (3, 3, 4)."""
    def pair(pe, pf):
        a, b = M[pe], M[pf]
        c1 = jnp.stack([a[2], a[1] - b[2], a[0] - b[1], -b[0],
                        jnp.zeros(())])
        c2 = jnp.stack([a[5], a[4] - b[5], a[3] - b[4], -b[3],
                        jnp.zeros(())])
        c3 = jnp.stack([a[9], a[8] - b[9], a[7] - b[8], a[6] - b[7],
                        -b[6]])
        return jnp.stack([c1, c2, c3])

    return jnp.stack([pair(4, 5), pair(6, 7), pair(8, 9)])


def _conv(a, b):
    return jnp.convolve(a, b)


def _det_poly(B):
    """det of the (3, 3, 5) z-polynomial matrix -> degree-<=12 coeff
    vector (true degree 10; the top coefficients vanish analytically)."""
    def minor(r0, r1, c0, c1):
        return _conv(B[r0, c0], B[r1, c1]) - _conv(B[r0, c1], B[r1, c0])

    n = (_conv(B[0, 0], minor(1, 2, 1, 2))
         - _conv(B[0, 1], minor(1, 2, 0, 2))
         + _conv(B[0, 2], minor(1, 2, 0, 1)))
    return n  # (13,)


_N_GRID = 512
_N_BISECT = 48
_MAX_ROOTS = 10


def _real_roots(n_coeffs):
    """Up to 10 real roots of the degree-<=12 polynomial, found on the
    FULL real line via the homogeneous substitution z = tan(theta):
    q(theta) = sum_i c_i sin^i cos^(N-i) is bounded and has the same sign
    pattern as n(z). Returns (roots (10,), valid (10,))."""
    deg = n_coeffs.shape[0] - 1
    scale = jnp.max(jnp.abs(n_coeffs)) + 1e-30
    c = n_coeffs / scale

    def q(theta):
        s, co = jnp.sin(theta), jnp.cos(theta)
        # sum_i c[i] * s^i * co^(deg-i), Horner-free (deg+1 terms)
        powers_s = jnp.power(s[..., None], jnp.arange(deg + 1))
        powers_c = jnp.power(co[..., None], deg - jnp.arange(deg + 1))
        return jnp.sum(c * powers_s * powers_c, axis=-1)

    eps = 1e-4
    grid = jnp.linspace(-jnp.pi / 2 + eps, jnp.pi / 2 - eps, _N_GRID)
    qs = q(grid)
    sc = qs[:-1] * qs[1:] < 0
    # Select up to 10 sign-change cells (fixed shape).
    sel = jnp.where(sc, 1.0, 0.0) - jnp.arange(_N_GRID - 1) * 1e-9
    top, idx = jax.lax.top_k(sel, _MAX_ROOTS)
    valid = top > 0.5
    lo = grid[idx]
    hi = grid[jnp.minimum(idx + 1, _N_GRID - 1)]
    qlo = q(lo)

    def body(_, state):
        lo, hi, qlo = state
        mid = 0.5 * (lo + hi)
        qm = q(mid)
        same = qm * qlo > 0
        lo2 = jnp.where(same, mid, lo)
        qlo2 = jnp.where(same, qm, qlo)
        hi2 = jnp.where(same, hi, mid)
        return lo2, hi2, qlo2

    lo, hi, _ = jax.lax.fori_loop(0, _N_BISECT, body, (lo, hi, qlo))
    roots = jnp.tan(0.5 * (lo + hi))
    return roots, valid


def five_point_candidates(x1, x2):
    """Essential-matrix candidates from 5 normalized correspondences
    (each (5, 2)). Returns (Es (10, 3, 3), valid (10,)) — fixed shape,
    invalid slots masked."""
    a = jnp.stack(
        [
            x2[:, 0] * x1[:, 0], x2[:, 0] * x1[:, 1], x2[:, 0],
            x2[:, 1] * x1[:, 0], x2[:, 1] * x1[:, 1], x2[:, 1],
            x1[:, 0], x1[:, 1], jnp.ones_like(x1[:, 0]),
        ],
        axis=1,
    )  # (5, 9)
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    basis = vt[5:9][::-1].reshape(4, 3, 3)  # X, Y, Z (free), W (affine)

    A = _constraint_rows(basis)  # (10, 20)
    # Gauss-Jordan: P = -A1^{-1} A2 Q. Regularize the (rare) singular A1:
    # a NaN/garbage M just produces candidates that lose the RANSAC vote.
    M = -jnp.linalg.solve(A[:, :10], A[:, 10:])  # (10, 10)
    B = _z_matrix(M)       # (3, 3, 5)
    n = _det_poly(B)       # (13,)
    roots, valid = _real_roots(n)

    zp = jnp.power(roots[:, None], jnp.arange(5))          # (10, 5)
    Bz = jnp.einsum("rcp,kp->krc", B, zp)                  # (10, 3, 3)
    # Nullvector of each B(z) via the best-conditioned row cross product.
    c01 = jnp.cross(Bz[:, 0], Bz[:, 1])
    c02 = jnp.cross(Bz[:, 0], Bz[:, 2])
    c12 = jnp.cross(Bz[:, 1], Bz[:, 2])
    cands = jnp.stack([c01, c02, c12], axis=1)             # (10, 3, 3)
    norms = jnp.abs(cands[..., 2])                         # prefer |v_3|
    pick = jnp.argmax(norms, axis=1)
    v = jnp.take_along_axis(cands, pick[:, None, None], axis=1)[:, 0]
    w = v[:, 2]
    ok_w = jnp.abs(w) > 1e-12
    w_safe = jnp.where(ok_w, w, 1.0)
    x = v[:, 0] / w_safe
    y = v[:, 1] / w_safe

    Es = (x[:, None, None] * basis[0] + y[:, None, None] * basis[1]
          + roots[:, None, None] * basis[2] + basis[3])
    fro = jnp.linalg.norm(Es.reshape(10, 9), axis=1, keepdims=True)
    Es = (Es.reshape(10, 9) / jnp.maximum(fro, 1e-12)).reshape(10, 3, 3)
    valid = valid & ok_w & jnp.all(jnp.isfinite(Es.reshape(10, 9)),
                                   axis=1)
    return Es, valid
