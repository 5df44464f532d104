"""Global pose-graph refinement over ALL confident pairwise edges.

The reference chains transforms over the max spanning tree only
(map_merge_3d/src/map_merging.cpp:137-186): per-hop error compounds, so an
N-map merge drifts with graph diameter even when every pairwise estimate is
good. This module is the improvement the batched pair stage makes natural:
estimate_maps_transforms already registers ALL O(N^2) pairs, so after the
MST seed we relax the full edge set with a damped Gauss-Newton on SE(3)
(host-side numpy — the problem is 6N unknowns for N maps, microscopic next
to the device stages). The batch pipeline first re-chooses the seed's
spanning tree by edge consensus (consensus_seed), so one wrong but
highly confident registration cannot misplace a block of maps.

Conventions (match graph/merge_graph.py chaining):
  - global[i] maps map-i coordinates into the reference frame;
  - an edge (source i, target j, T) constrains global[i] = global[j] @ T
    (merge_graph._get_transform walks j->i with T);
  - se(3) vectors are (rho, phi): translation first, rotation second;
  - right perturbation G <- G @ exp(delta).

Residual per edge: r = log( (G_j T)^-1 G_i ), weighted by edge confidence
under a Huber kernel (bad edges that survived the confidence threshold are
down-weighted, not trusted). The MST reference node is held fixed (gauge).

Disabled by MergeParams.strict_parity() — MST-only chaining is the
reference behavior.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-9


# ------------------------------------------------------------- SO(3)/SE(3)
def _hat(w: np.ndarray) -> np.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    out = np.zeros(w.shape[:-1] + (3, 3), w.dtype)
    out[..., 0, 1] = -w[..., 2]
    out[..., 0, 2] = w[..., 1]
    out[..., 1, 0] = w[..., 2]
    out[..., 1, 2] = -w[..., 0]
    out[..., 2, 0] = -w[..., 1]
    out[..., 2, 1] = w[..., 0]
    return out


def so3_log(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 3) rotation vector (batched, stable to pi)."""
    tr = np.trace(R, axis1=-2, axis2=-1)
    cos = np.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos)
    vee = np.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin = np.sin(theta)
    small = theta < 1e-5
    # theta/(2 sin theta), Taylor 1/2 + theta^2/12 near zero
    factor = np.where(
        small, 0.5 + theta**2 / 12.0, theta / np.maximum(2.0 * sin, _EPS)
    )
    w = factor[..., None] * vee
    # near pi the vee part vanishes: recover axis from the diagonal
    near_pi = theta > np.pi - 1e-3
    if np.any(near_pi):
        diag = np.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
        axis_sq = np.maximum((diag + 1.0) * 0.5, 0.0)
        axis = np.sqrt(axis_sq)
        # fix signs from off-diagonals (largest-axis reference)
        k = np.argmax(axis_sq, axis=-1)
        flat_axis = axis.reshape(-1, 3)
        flat_R = R.reshape(-1, 3, 3)
        for n, kk in enumerate(np.ravel(k)):
            a, b = (kk + 1) % 3, (kk + 2) % 3
            if flat_R[n, kk, a] + flat_R[n, a, kk] < 0:
                flat_axis[n, a] = -flat_axis[n, a]
            if flat_R[n, kk, b] + flat_R[n, b, kk] < 0:
                flat_axis[n, b] = -flat_axis[n, b]
        w = np.where(near_pi[..., None], theta[..., None] * axis, w)
    return w


def so3_exp(w: np.ndarray) -> np.ndarray:
    """(..., 3) -> (..., 3, 3) Rodrigues."""
    theta = np.linalg.norm(w, axis=-1)
    small = theta < 1e-7
    th = np.where(small, 1.0, theta)
    a = np.where(small, 1.0 - theta**2 / 6.0, np.sin(th) / th)
    b = np.where(small, 0.5 - theta**2 / 24.0, (1.0 - np.cos(th)) / th**2)
    W = _hat(w)
    eye = np.broadcast_to(np.eye(3), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _so3_left_jacobian(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w, axis=-1)
    small = theta < 1e-7
    th = np.where(small, 1.0, theta)
    b = np.where(small, 0.5 - theta**2 / 24.0, (1.0 - np.cos(th)) / th**2)
    c = np.where(small, 1.0 / 6.0 - theta**2 / 120.0, (th - np.sin(th)) / th**3)
    W = _hat(w)
    eye = np.broadcast_to(np.eye(3), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * (W @ W)


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """(..., 6) (rho, phi) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = _so3_left_jacobian(phi)
    T = np.zeros(xi.shape[:-1] + (4, 4), np.float64)
    T[..., :3, :3] = R
    T[..., :3, 3] = np.einsum("...ij,...j->...i", V, rho)
    T[..., 3, 3] = 1.0
    return T


def se3_log(T: np.ndarray) -> np.ndarray:
    """(..., 4, 4) -> (..., 6) (rho, phi)."""
    phi = so3_log(T[..., :3, :3])
    V = _so3_left_jacobian(phi)
    rho = np.linalg.solve(V, T[..., :3, 3, None])[..., 0]
    return np.concatenate([rho, phi], axis=-1)


def _se3_adjoint(T: np.ndarray) -> np.ndarray:
    """Adjoint of SE(3) matrices for (rho, phi) ordering: (..., 6, 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    out = np.zeros(T.shape[:-2] + (6, 6), np.float64)
    out[..., :3, :3] = R
    out[..., :3, 3:] = _hat(t) @ R
    out[..., 3:, 3:] = R
    return out


def _se3_ad(xi: np.ndarray) -> np.ndarray:
    """Little adjoint ad(xi) for (rho, phi) ordering: (..., 6, 6)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    out = np.zeros(xi.shape[:-1] + (6, 6), np.float64)
    P = _hat(phi)
    out[..., :3, :3] = P
    out[..., :3, 3:] = _hat(rho)
    out[..., 3:, 3:] = P
    return out


def _jr_inv(r: np.ndarray) -> np.ndarray:
    """Inverse right Jacobian of SE(3), 2nd-order series (exact enough for
    the <60 deg residuals the MST seed leaves): I + ad/2 + ad^2/12."""
    ad = _se3_ad(r)
    eye = np.broadcast_to(np.eye(6), ad.shape)
    return eye + 0.5 * ad + (ad @ ad) / 12.0


def _inv44(T: np.ndarray) -> np.ndarray:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    out = np.zeros_like(T)
    Rt = np.swapaxes(R, -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


# ------------------------------------------------------- consensus seed
#: an edge agrees with a set of global poses when its residual is within
#: these bounds (a few hops of ICP-grade chain drift; wrong registrations
#: of the all-pairs graphs sit at 5-180 deg)
CONSENSUS_TOL_DEG = 5.0
CONSENSUS_TOL_M = 0.5
#: tree edges consensus_seed may swap out, one per round
_MAX_SWAPS = 3


def _usable_edges(estimates, active, confidence_threshold):
    """Confident, successful edges between registered maps."""
    return [
        e
        for e in estimates
        if e.confidence >= confidence_threshold
        and np.asarray(e.transform)[:3, :3].any()
        and active[e.source_idx]
        and active[e.target_idx]
    ]


def _spanning_tree(order, src, tgt, n, skip) -> list[int]:
    """Kruskal over edge indices in `order` (descending confidence),
    leaving out the indices in `skip`."""
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    tree = []
    for k in order:
        if k in skip:
            continue
        a, b = find(src[k]), find(tgt[k])
        if a != b:
            parent[a] = b
            tree.append(k)
    return tree


def _chain(tree, src, tgt, T, n, ref):
    """Global poses chained over `tree` from `ref` (identity); None where
    a node is not reached."""
    adj: dict[int, list] = {i: [] for i in range(n)}
    for k in tree:
        # edge k: global[src] = global[tgt] @ T[k]
        adj[tgt[k]].append((src[k], T[k]))
        adj[src[k]].append((tgt[k], _inv44(T[k])))
    G: list = [None] * n
    G[ref] = np.eye(4)
    queue = [ref]
    while queue:
        u = queue.pop(0)
        for v, M in adj[u]:
            if G[v] is None:
                G[v] = G[u] @ M
                queue.append(v)
    return G


def _agreement(G, src, tgt, T, w) -> float:
    """Weight of the edges whose transform agrees with poses G."""
    D = _inv44(T) @ _inv44(G[tgt]) @ G[src]
    cos = np.clip((np.trace(D[:, :3, :3], axis1=-2, axis2=-1) - 1.0) * 0.5,
                  -1.0, 1.0)
    ok = (np.degrees(np.arccos(cos)) <= CONSENSUS_TOL_DEG) & (
        np.linalg.norm(D[:, :3, 3], axis=-1) <= CONSENSUS_TOL_M
    )
    return float(np.sum(w[ok]))


def consensus_seed(
    estimates,
    global_t: list[np.ndarray],
    confidence_threshold: float = 0.0,
) -> list[np.ndarray]:
    """Re-choose the spanning tree the refinement starts from by how many
    edges agree with it.

    The max-confidence spanning tree trusts its edges blindly. On
    all-pairs graphs of self-similar scenes one wrong registration can
    carry more confidence than every correct edge that could replace it;
    which part of the graph it then misplaces depends on near-ties
    between correct edges, so float rounding flips the outcome between
    runs, and the refinement can rarely pull a misplaced block back
    through the seed gate. Here each tree edge in turn is left out, the
    spanning tree is rebuilt without it, and the poses chained over it
    are scored by the sqrt-confidence weight of ALL edges that agree with
    them (CONSENSUS_TOL_DEG / _M). The best-scoring tree replaces the
    seed when it beats it; up to _MAX_SWAPS such swaps.

    Zero matrices (unregistered maps) pass through; the reference node
    (identity seed) stays the reference. Graphs of fewer than 3 maps are
    returned as they are.
    """
    n = len(global_t)
    active = np.array([np.asarray(t)[:3, :3].any() for t in global_t])
    if active.sum() < 3:
        return global_t
    ref = next(
        (i for i in range(n) if active[i]
         and np.allclose(global_t[i], np.eye(4), atol=1e-6)),
        None,
    )
    edges = _usable_edges(estimates, active, confidence_threshold)
    if ref is None or len(edges) <= int(active.sum()) - 1:
        return global_t
    src = np.asarray([e.source_idx for e in edges])
    tgt = np.asarray([e.target_idx for e in edges])
    T = np.stack([np.asarray(e.transform, np.float64) for e in edges])
    w = np.sqrt(np.maximum([e.confidence for e in edges], _EPS))
    order = sorted(range(len(edges)), key=lambda k: -edges[k].confidence)

    def score(G):
        if any(G[i] is None for i in range(n) if active[i]):
            return -1.0  # a tree that no longer reaches every map
        full = np.stack([g if g is not None else np.eye(4) for g in G])
        return _agreement(full, src, tgt, T, w)

    seed = [np.asarray(t, np.float64) if active[i] else None
            for i, t in enumerate(global_t)]
    best_score, best_g = score(seed), None
    skip: set[int] = set()
    tree = _spanning_tree(order, src, tgt, n, skip)
    for _ in range(_MAX_SWAPS):
        round_best = None
        for k in tree:
            cand = _spanning_tree(order, src, tgt, n, skip | {k})
            G = _chain(cand, src, tgt, T, n, ref)
            s = score(G)
            if s > best_score and (round_best is None or s > round_best[0]):
                round_best = (s, k, cand, G)
        if round_best is None:
            break
        best_score, k, tree, best_g = round_best
        skip.add(k)
    if best_g is None:
        return global_t
    return [
        best_g[i].astype(np.float32) if active[i]
        else np.zeros((4, 4), np.float32)
        for i in range(n)
    ]


# ------------------------------------------------------------ the refiner
def refine_global_transforms(
    estimates,
    global_t: list[np.ndarray],
    confidence_threshold: float = 0.0,
    max_iterations: int = 50,
    huber_delta: float | None = None,
    tol: float = 1e-10,
    reject_outliers: bool = True,
    seed_gate_deg: float = 25.0,
    seed_gate_m: float = 1.5,
    rot_scale_m: float | None = None,
    _reject_depth: int = 3,
) -> list[np.ndarray]:
    """Relax all confident pairwise edges from the MST seed.

    `estimates`: TransformEstimate list (graph/merge_graph.py);
    `global_t`: the MST-chained seed — zero matrices mark unregistered maps
    and are passed through untouched. Returns refined transforms with the
    gauge fixed at the node whose seed is the identity (the MST reference),
    so the reference frame is unchanged.

    `huber_delta=None` (default) re-estimates the Huber knee every IRLS
    iteration from the residuals themselves: delta = clip(3 * median |r|,
    0.01, 0.1). A fixed knee mis-weights clean graphs badly — measured on
    the 20-map eval config, per-hop error is ~0.004 rad, so a 0.1 knee
    left 0.2-rad junk edges at HALF weight and they bent the whole map by
    mass (6 deg end-to-end drift over 0.2-deg hops).

    After each convergence, edges whose residual is gross (beyond
    6x the median and the knee) are dropped outright and the solve repeats
    (up to `_reject_depth` rounds) — the Huber kernel bounds a bad edge's
    pull but does not remove it, and one wrong registration that cleared
    the confidence threshold should not bend the whole map (reference
    analog: RANSAC's in-band zero-matrix failure, matching.cpp:128-133,
    just later in the pipeline).

    `rot_scale_m` makes rotation and translation residuals commensurate:
    the se(3) log mixes meters (rho) with radians (phi), and ICP-grade
    edge noise is centimeters of translation but only millidegrees of
    rotation — unscaled, the solve happily trades degrees of rotation to
    shave centimeters (measured on the 50-map stream: translation drift
    4x better, rotation 2x WORSE). Scaling phi by the MAP's spatial
    radius expresses rotational misfit as the displacement it causes at
    the map's edge. Callers that know the map radius pass it
    (pipeline/incremental.WorldModel.refine does); the default (None)
    keeps the classic mixed-unit residual — inferring the scale from
    node-position spread measurably mis-balances junk-heavy all-pairs
    graphs and is NOT done.
    """
    n = len(global_t)
    active = np.array([t[:3, :3].any() for t in global_t])
    if active.sum() < 3:
        return global_t  # MST on <3 nodes is already exact

    # edge set: confident, successful, both endpoints registered
    edges = _usable_edges(estimates, active, confidence_threshold)

    # seed-consistency gate: an edge that wildly disagrees with the MST
    # seed is almost surely a wrong registration that cleared the
    # confidence threshold (low-overlap pair), NOT a loop closure — a
    # correct edge disagrees with the seed by at most the accumulated
    # chain drift, which seed_gate_deg/_m comfortably cover. Without this,
    # an outlier-heavy graph (e.g. all-pairs over a long strip of views,
    # where most pairs barely overlap) drags the solve off the seed; the
    # Huber kernel bounds each edge's pull but 100+ junk edges still win
    # by mass.
    def _seed_residual(e):
        Gs = np.asarray(global_t[e.source_idx], np.float64)
        Gt_ = np.asarray(global_t[e.target_idx], np.float64)
        M = _inv44(Gt_) @ Gs
        D = _inv44(np.asarray(e.transform, np.float64)) @ M
        rot = np.degrees(
            np.arccos(np.clip((np.trace(D[:3, :3]) - 1.0) * 0.5, -1.0, 1.0))
        )
        return rot, float(np.linalg.norm(D[:3, 3]))

    gated = []
    for e in edges:
        rot, trans = _seed_residual(e)
        if rot <= seed_gate_deg and trans <= seed_gate_m:
            gated.append(e)
    # keep every active node attached (MST edges always pass their own
    # seed by construction — residual 0 — so connectivity is guaranteed,
    # but guard anyway in case the caller seeded differently)
    deg = np.zeros(n, int)
    for e in gated:
        deg[e.source_idx] += 1
        deg[e.target_idx] += 1
    if all(deg[i] > 0 for i in range(n) if active[i]):
        edges = gated

    n_active = int(active.sum())
    if len(edges) <= n_active - 1:
        return global_t  # nothing beyond the tree itself to relax

    # gauge: the MST reference (identity seed); fall back to first active
    ref = next(
        (i for i in range(n) if active[i]
         and np.allclose(global_t[i], np.eye(4), atol=1e-6)),
        int(np.argmax(active)),
    )

    G = np.stack([np.asarray(t, np.float64) for t in global_t])  # (N,4,4)
    G[~active] = np.eye(4)  # keep linalg happy; restored at the end

    src = np.asarray([e.source_idx for e in edges])
    tgt = np.asarray([e.target_idx for e in edges])
    T = np.stack([np.asarray(e.transform, np.float64) for e in edges])
    conf = np.asarray([e.confidence for e in edges], np.float64)
    # information weights: confidence is the 1/score information proxy;
    # sqrt-compress so one sharp edge cannot dominate the whole solve
    w = np.sqrt(np.maximum(conf, _EPS))
    w /= w.mean()
    # edges flagged ambiguous at registration time (low coverage / RANSAC
    # consensus spread, TransformEstimate.ambiguous) carry weak evidence
    # regardless of their 1/score confidence — a floor-dominated pair can
    # ace the score while its pose is unconstrained along the plane. Keep
    # them at HALF weight: harsher (0.25) measurably breaks all-pairs
    # graphs of strip-like scenes, where the only TRUE long-range
    # connectors are themselves low-overlap (flagged) and junk edges
    # take over once they are suppressed.
    amb = np.asarray(
        [bool(getattr(e, "ambiguous", False)) for e in edges]
    )
    if amb.any() and not amb.all():
        w = np.where(amb, 0.5 * w, w)

    # commensurate units: with rot_scale_m given, rotational residual
    # components are scaled by the MAP's spatial extent so "cost" means
    # displacement at the map edge for rotation and translation alike
    # (see docstring — callers who know the map radius pass it; the
    # stream's WorldModel does). Default is the classic mixed-unit
    # residual (rot_l = 1): measured on the junk-heavy 20-map all-pairs
    # graph, inferring the scale from node-position spread flips the
    # rotation/translation balance enough to split the graph into two
    # 15-deg blocks, while mixed units solve it to 19/20 — scale
    # inference from poses alone is NOT a safe default.
    rot_l = 1.0 if rot_scale_m is None else float(rot_scale_m)
    svec = np.array([1.0, 1.0, 1.0, rot_l, rot_l, rot_l])

    def residuals(G):
        # r = log((G_j T)^-1 G_i): zero iff G_i = G_j @ T
        M = _inv44(G[tgt]) @ G[src]  # (E,4,4)
        Z = _inv44(T) @ M
        return se3_log(Z) * svec, M

    def knee_of(r):
        if huber_delta is not None:
            return huber_delta
        rn = np.linalg.norm(r, axis=-1)
        # knee in [0.01, 0.1] (r2-r4 calibration, svec units): a tighter
        # ceiling (0.05) measured better on a synthetic noisy ring but
        # SPLITS the junk-heavy 20-map all-pairs graph (10/20 vs 19/20
        # within 1 deg) — the wider ceiling lets the solve keep pulling
        # on the few true cross-block edges whose residuals sit above a
        # tight knee
        return float(np.clip(3.0 * np.median(rn), 0.01, 0.1))

    def cost_of(r, delta):
        rn = np.linalg.norm(r, axis=-1)
        # Huber: quadratic core, linear tail
        quad = rn <= delta
        c = np.where(quad, 0.5 * rn**2, delta * (rn - 0.5 * delta))
        return float(np.sum(w * c))

    lam = 1e-6
    r, M = residuals(G)
    delta_h = knee_of(r)
    cost = cost_of(r, delta_h)
    # graduated non-convexity: the MST seed satisfies exactly the (noisy)
    # tree edges, so at the seed the off-tree edges — including the loop
    # closures that carry the drift signal — hold ALL the residual and an
    # adaptive knee would tail-weight precisely them. Start wide (90th
    # percentile: everything inside the gate is quadratic, the solve is
    # balanced least squares) and halve toward the adaptive knee so
    # robustness returns once the estimate has moved off the seed.
    gnc0 = float(np.quantile(np.linalg.norm(r, axis=-1), 0.9)) + _EPS
    for it in range(max_iterations):
        # robust reweighting (IRLS form of the Huber kernel), knee
        # re-estimated from the current residual scale
        delta_h = max(knee_of(r), gnc0 * 0.5**it)
        cost = cost_of(r, delta_h)
        rn = np.linalg.norm(r, axis=-1)
        w_eff = w * np.where(
            rn <= delta_h, 1.0, delta_h / np.maximum(rn, _EPS)
        )

        # Jacobians of the SCALED residual: S * d log / d xi (the raw
        # right-Jacobian argument is the unscaled log residual)
        Jri = _jr_inv(r / svec)  # (E,6,6)
        Ji = Jri * svec[None, :, None]
        Jj = (-Jri @ _se3_adjoint(_inv44(M))) * svec[None, :, None]

        # assemble H (6N,6N), b (6N) via scatter-add of 6x6 blocks
        H = np.zeros((6 * n, 6 * n))
        b = np.zeros(6 * n)
        WJi = w_eff[:, None, None] * Ji
        WJj = w_eff[:, None, None] * Jj
        JiT, JjT = np.swapaxes(Ji, -1, -2), np.swapaxes(Jj, -1, -2)
        Hii = JiT @ WJi
        Hjj = JjT @ WJj
        Hij = JiT @ WJj
        bi = np.einsum("eab,ea->eb", WJi, r)
        bj = np.einsum("eab,ea->eb", WJj, r)
        for e in range(len(edges)):
            i6, j6 = 6 * src[e], 6 * tgt[e]
            H[i6:i6 + 6, i6:i6 + 6] += Hii[e]
            H[j6:j6 + 6, j6:j6 + 6] += Hjj[e]
            H[i6:i6 + 6, j6:j6 + 6] += Hij[e]
            H[j6:j6 + 6, i6:i6 + 6] += Hij[e].T
            b[i6:i6 + 6] += bi[e]
            b[j6:j6 + 6] += bj[e]

        # gauge + inactive nodes: pin their 6 params
        free = np.ones(n, bool)
        free[ref] = False
        free &= active
        sel = np.repeat(free, 6)
        Hf = H[np.ix_(sel, sel)]
        bf = b[sel]

        # Levenberg damping with adaptive lambda
        for _try in range(8):
            try:
                delta_f = np.linalg.solve(
                    Hf + lam * np.diag(np.maximum(np.diag(Hf), 1e-12)), -bf
                )
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            delta = np.zeros(6 * n)
            delta[sel] = delta_f
            G_new = G @ se3_exp(delta.reshape(n, 6))
            r_new, M_new = residuals(G_new)
            c_new = cost_of(r_new, delta_h)
            if c_new < cost:
                G, r, M, cost = G_new, r_new, M_new, c_new
                lam = max(lam * 0.3, 1e-9)
                break
            lam *= 10.0
        else:
            break  # no damping made progress: converged/stuck
        if np.linalg.norm(delta) < tol:
            break

    if reject_outliers and _reject_depth > 0:
        rn = np.linalg.norm(r, axis=-1)
        # gross = clearly outside the converged inlier population: beyond
        # the (adaptive) knee AND 6x the median residual
        gross = rn > np.maximum(3.0 * delta_h, 6.0 * np.median(rn))
        if gross.any() and not gross.all():
            kept = [e for e, g in zip(edges, gross) if not g]
            # connectivity: a node whose every edge is gross keeps its
            # LEAST-BAD edge instead of blocking the whole rejection (the
            # previous all-or-nothing guard let one poorly-attached map
            # preserve every junk edge in the graph)
            deg = np.zeros(n, int)
            for e in kept:
                deg[e.source_idx] += 1
                deg[e.target_idx] += 1
            for i in range(n):
                if active[i] and deg[i] == 0:
                    cand = [
                        (rn[k], e)
                        for k, e in enumerate(edges)
                        if e.source_idx == i or e.target_idx == i
                    ]
                    if cand:
                        _, best = min(cand, key=lambda c: c[0])
                        kept.append(best)
                        deg[best.source_idx] += 1
                        deg[best.target_idx] += 1
            if len(kept) < len(edges):
                seeded = [
                    G[i].astype(np.float32) if active[i]
                    else np.zeros((4, 4), np.float32)
                    for i in range(n)
                ]
                return refine_global_transforms(
                    kept, seeded, confidence_threshold, max_iterations,
                    huber_delta, tol,
                    reject_outliers=True,
                    seed_gate_deg=seed_gate_deg,
                    seed_gate_m=seed_gate_m,
                    rot_scale_m=rot_scale_m,
                    _reject_depth=_reject_depth - 1,
                )

    out = []
    for i in range(n):
        out.append(
            G[i].astype(np.float32) if active[i]
            else np.zeros((4, 4), np.float32)
        )
    return out
