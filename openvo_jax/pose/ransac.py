"""Fixed-iteration, vmapped RANSAC — the accelerator idiom for robust estimation.

BASELINE.json's north star mandates RANSAC "rewritten as fixed-iteration
vmapped hypothesis sampling with vectorized inlier scoring". Two estimators
live here:

 - :func:`ransac_rigid`: robust 3D-3D rigid fit (minimal 3-point Kabsch
   hypotheses), an optional robustness upgrade over the reference's
   all-inlier fit.
 - :func:`ransac_essential` + :func:`recover_pose`: the monocular VO path
   (``cv2.findEssentialMat`` + ``cv2.recoverPose`` equivalent, a capability
   extension mandated by BASELINE config 3 — the reference has no mono path).
   Hypotheses use the normalized 8-point algorithm (SVD of an 8x9 system,
   batched over hypotheses with vmap); scoring uses the Sampson distance;
   pose recovery decomposes E into the 4 (R, t) candidates and picks the one
   with maximal cheirality support from a vectorized midpoint triangulation.

Everything is static-shape: N correspondences padded with a validity mask,
``iters`` hypotheses evaluated in parallel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from openvo_jax.pose.kabsch import kabsch, transform_points


def _sample_indices(key, iters: int, k: int, n: int, mask):
    """(iters, k) random indices drawn from valid rows (with replacement
    across hypotheses; degenerate duplicates just yield bad hypotheses that
    lose the vote)."""
    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    return jax.random.choice(key, n, shape=(iters, k), p=probs)


def ransac_rigid(src, dst, mask, key, iters: int = 64,
                 inlier_threshold: float = 0.05):
    """Robust rigid 3D-3D fit. Returns (T, inlier_mask, n_inliers)."""
    n = src.shape[0]
    idx = _sample_indices(key, iters, 3, n, mask)

    def hypothesis(ids):
        T = kabsch(src[ids], dst[ids], jnp.ones((3,), bool))
        pred = transform_points(T, src)
        err = jnp.linalg.norm(pred - dst, axis=-1)
        inl = (err < inlier_threshold) & mask
        return jnp.sum(inl.astype(jnp.int32)), T

    scores, Ts = jax.vmap(hypothesis)(idx)
    scores = jnp.where(jnp.any(jnp.isnan(Ts), axis=(1, 2)), -1, scores)
    best = jnp.argmax(scores)
    T_best = Ts[best]
    err = jnp.linalg.norm(transform_points(T_best, src) - dst, axis=-1)
    inliers = (err < inlier_threshold) & mask
    T_final = kabsch(src, dst, inliers)
    ok = ~jnp.any(jnp.isnan(T_final))
    T_final = jnp.where(ok, T_final, T_best)
    return T_final, inliers, jnp.sum(inliers.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Essential matrix (monocular path)
# ---------------------------------------------------------------------------


def _eight_point(x1, x2):
    """Essential matrix from 8 normalized correspondences (each (8, 2))."""
    a = jnp.stack(
        [
            x2[:, 0] * x1[:, 0], x2[:, 0] * x1[:, 1], x2[:, 0],
            x2[:, 1] * x1[:, 0], x2[:, 1] * x1[:, 1], x2[:, 1],
            x1[:, 0], x1[:, 1], jnp.ones_like(x1[:, 0]),
        ],
        axis=1,
    )  # (8, 9) rows: x2^T E x1 = 0
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    E = vt[-1].reshape(3, 3)
    # Enforce the essential-matrix spectrum (1, 1, 0).
    u, _, v = jnp.linalg.svd(E)
    return u @ jnp.diag(jnp.array([1.0, 1.0, 0.0])) @ v


def sampson_error(E, x1, x2):
    """Squared Sampson distance of normalized correspondences under E."""
    ones = jnp.ones((x1.shape[0], 1), x1.dtype)
    h1 = jnp.concatenate([x1, ones], axis=1)
    h2 = jnp.concatenate([x2, ones], axis=1)
    Ex1 = h1 @ E.T      # (N, 3)
    Etx2 = h2 @ E       # (N, 3)
    num = jnp.sum(h2 * Ex1, axis=1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def ransac_essential(x1, x2, mask, key, iters: int = 256,
                     inlier_threshold: float = 1e-3):
    """Robust essential matrix from normalized image points (N, 2) each,
    with 8-point hypotheses (kept for comparison/tests; the production
    mono path uses :func:`ransac_essential_5pt`, the cv2.findEssentialMat
    parity engine).

    ``inlier_threshold`` is on the Sampson distance in normalized coords
    (cv2.findEssentialMat's default 1px threshold at f=700 is ~(1/700)^2).
    Returns (E, inlier_mask, n_inliers).
    """
    n = x1.shape[0]
    idx = _sample_indices(key, iters, 8, n, mask)

    def hypothesis(ids):
        E = _eight_point(x1[ids], x2[ids])
        err = sampson_error(E, x1, x2)
        inl = (err < inlier_threshold) & mask
        return jnp.sum(inl.astype(jnp.int32)), E

    scores, Es = jax.vmap(hypothesis)(idx)
    best = jnp.argmax(scores)
    E = Es[best]
    inliers = (sampson_error(E, x1, x2) < inlier_threshold) & mask
    return E, inliers, jnp.sum(inliers.astype(jnp.int32))


def _masked_eight_point(x1, x2, w):
    """Least-squares essential matrix from ALL correspondences weighted by
    ``w`` (0/1 inlier mask), projected to the essential manifold. Used as
    the post-RANSAC refinement: a minimal 5-point sample interpolates its
    5 noisy points exactly, so the winning hypothesis carries pixel noise
    straight into the pose; refitting over the full inlier set averages it
    away (same role as cv2's inlier refit in estimateAffine-family APIs)."""
    a = jnp.stack(
        [
            x2[:, 0] * x1[:, 0], x2[:, 0] * x1[:, 1], x2[:, 0],
            x2[:, 1] * x1[:, 0], x2[:, 1] * x1[:, 1], x2[:, 1],
            x1[:, 0], x1[:, 1], jnp.ones_like(x1[:, 0]),
        ],
        axis=1,
    ) * w[:, None].astype(x1.dtype)
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    E = vt[-1].reshape(3, 3)
    u, _, v = jnp.linalg.svd(E)
    return u @ jnp.diag(jnp.array([1.0, 1.0, 0.0])) @ v


def ransac_essential_5pt(x1, x2, mask, key, iters: int = 64,
                         inlier_threshold: float = 1e-3,
                         top_candidates: int = 8,
                         refit_rounds: int = 2):
    """Robust essential matrix with Nister 5-POINT minimal hypotheses
    (cv2.findEssentialMat's RANSAC engine; pose/fivepoint.py). Each
    sample yields up to 10 candidate E's.

    Model selection is MSAC-first with a margin-gated cheirality vote:

     - primary score = truncated-Sampson sum (MSAC). Binary inlier counts
       barely discriminate on forward motion (most candidates fit ~90% of
       points inside a 1px threshold) and the cheirality vote actively
       anti-correlates with correctness there (points near the focus of
       expansion triangulate to unstable depth signs, so WRONG models
       score full support) — measured on the synthetic corridor, inlier
       count picked 31-89 deg translation-direction errors while MSAC
       picks 4-15 deg.
     - candidates within a small MSAC margin of the best are near-ties
       (the planar E family fits all points equally); ONLY those are
       tie-broken by cheirality support, which resolves the planar
       twisted-pair ambiguity the 8-point DLT cannot.
     - GUARDED inlier refit: the minimal winner interpolates its 5 noisy
       points exactly, carrying pixel noise into the pose; a masked
       8-point least-squares refit over the inlier set averages it away
       (1-3 deg direction error measured, vs 4-15 before). Each refit is
       accepted only if MSAC does not worsen AND cheirality support keeps
       >= 70% — on planar scenes the rank-deficient DLT returns an
       arbitrary family member whose support collapses, so the guarded
       update keeps the cheirality-disambiguated minimal model.

    Returns (E, inlier_mask, n_inliers).
    """
    from openvo_jax.pose.fivepoint import five_point_candidates

    n = x1.shape[0]
    idx = _sample_indices(key, iters, 5, n, mask)

    def msac_of(E):
        err = sampson_error(E, x1, x2)
        return jnp.sum(jnp.where(mask, jnp.minimum(err, inlier_threshold),
                                 0.0))

    def hypothesis(ids):
        Es, valid = five_point_candidates(x1[ids], x2[ids])
        s = jax.vmap(msac_of)(Es)
        return jnp.where(valid, s, jnp.inf), Es

    msacs, Es = jax.vmap(hypothesis)(idx)          # (iters, 10)
    flat_m = msacs.reshape(-1)
    flat_E = Es.reshape(-1, 3, 3)
    k = min(top_candidates, flat_m.shape[0])
    neg_top, top_i = jax.lax.top_k(-flat_m, k)     # ascending MSAC
    top_m = -neg_top
    top_E = flat_E[top_i]

    def support_of(E):
        inl = (sampson_error(E, x1, x2) < inlier_threshold) & mask
        _, _, good = recover_pose(E, x1, x2, inl)
        return jnp.sum(good.astype(jnp.int32))

    support = jax.vmap(support_of)(top_E)
    m_best = top_m[0]
    # Near-tie margin: 2% relative, floored at 0.1% of the all-points
    # truncated maximum (so exact-fit planar families, msac ~ 0, still
    # count as tied under float noise).
    margin = jnp.maximum(0.02 * m_best,
                         1e-3 * inlier_threshold * jnp.sum(mask))
    eligible = top_m <= m_best + margin
    # Among near-ties: max support; argmax picks the lowest-MSAC one on
    # equal support (top_E is MSAC-ascending).
    best = jnp.argmax(jnp.where(eligible, support, -1))
    E = top_E[best]
    cur_m = top_m[best]
    cur_sup = support[best]
    inliers = (sampson_error(E, x1, x2) < inlier_threshold) & mask

    for _ in range(refit_rounds):
        E_ref = _masked_eight_point(x1, x2, inliers)
        m_ref = msac_of(E_ref)
        sup_ref = support_of(E_ref)
        # The LSQ refit minimizes ALGEBRAIC error, which can sit a few
        # percent off the MSAC optimum while being much closer to the
        # true pose (measured: 14 deg -> 2 deg direction error at +5%
        # MSAC), so the refit is trusted by default; the guards only
        # catch blow-ups (outlier-pulled fit, 1.5x MSAC) and the planar
        # rank-deficient DLT (cheirality support collapse).
        ok = ((m_ref <= 1.5 * cur_m)
              & (sup_ref.astype(jnp.float32)
                 >= 0.7 * cur_sup.astype(jnp.float32))
              & jnp.all(jnp.isfinite(E_ref)))
        E = jnp.where(ok, E_ref, E)
        cur_m = jnp.where(ok, m_ref, cur_m)
        cur_sup = jnp.where(ok, sup_ref, cur_sup)
        inliers = (sampson_error(E, x1, x2) < inlier_threshold) & mask
    return E, inliers, jnp.sum(inliers.astype(jnp.int32))


def _triangulate_depths(R, t, x1, x2):
    """Vectorized two-view midpoint triangulation; returns per-point depths
    (z1, z2) in both cameras for the cheirality count.

    Camera 1 at identity; camera 2: x_c2 = R @ x_c1 + t.
    """
    ones = jnp.ones((x1.shape[0], 1), x1.dtype)
    f1 = jnp.concatenate([x1, ones], axis=1)
    f1 = f1 / jnp.linalg.norm(f1, axis=1, keepdims=True)
    f2 = jnp.concatenate([x2, ones], axis=1)
    f2 = f2 / jnp.linalg.norm(f2, axis=1, keepdims=True)
    # Rays in camera-1 frame: r1 = f1 from origin, r2 = R^T f2 from -R^T t.
    r2 = f2 @ R
    o2 = -(R.T @ t)
    # Solve min || o1 + a r1 - (o2 + b r2) ||.
    r1r2 = jnp.sum(f1 * r2, axis=1)
    d = o2  # o2 - o1
    a = (jnp.sum(f1 * d[None, :], axis=1)
         - r1r2 * jnp.sum(r2 * d[None, :], axis=1)) / jnp.maximum(
        1 - r1r2**2, 1e-12)
    b = r1r2 * a - jnp.sum(r2 * d[None, :], axis=1)
    p1 = f1 * a[:, None]                      # point in cam-1 frame
    p2 = p1 @ R.T + t                          # same point in cam-2 frame
    return a, b, p1[:, 2], p2[:, 2]


def recover_pose(E, x1, x2, mask):
    """Decompose E and select the (R, t) with max cheirality support
    (cv2.recoverPose equivalent). Returns (R, t_unit, support_mask)."""
    u, _, vt = jnp.linalg.svd(E)
    # Keep proper rotations.
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    w = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = u @ w @ vt
    R2 = u @ w.T @ vt
    t = u[:, 2]

    def support(R, tv):
        a, b, z1, z2 = _triangulate_depths(R, tv, x1, x2)
        good = (a > 0) & (b > 0) & (z1 > 0) & (z2 > 0) & mask
        return jnp.sum(good.astype(jnp.int32)), good

    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    counts = []
    goods = []
    for R, tv in cands:
        c, g = support(R, tv)
        counts.append(c)
        goods.append(g)
    counts = jnp.stack(counts)
    best = jnp.argmax(counts)
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    good = jnp.stack(goods)
    return Rs[best], ts[best], good[best]
