"""Batched mate-pair EM — JAX device path.

Vectorizes the reference's per-bin-pair mixture EM (see
``cluster/matepair_em.py`` for the exact host oracle and the
``tools/MatePairEM.cpp`` citations) across many bin-pair instances and all
candidate component counts K at once:

* every (instance, K) pair becomes one batch element; K-masked components
  keep zero responsibilities and are excluded from the likelihood;
* seeding (KKZ + AS 136 k-means) runs on the host — it is inherently
  point-sequential and tiny — producing one-hot responsibilities that are
  shipped to the device once;
* the exact piecewise-linear M-step is vectorized by enumerating the
  merged breakpoint events of the two responsibility cumsums with a
  lexicographic sort instead of the reference's sequential two-pointer
  merge (``MatePairEM.cpp:192-325``); the chosen breakpoint is the first
  event with positive derivative, exactly as in the reference;
* BIC selection over K is an argmin per instance (first minimum wins,
  matching the strict ``<`` in ``MatePairEM.cpp:601``).

The device path is *decision-equivalent* to the oracle (same memberships);
bit-level float trajectories differ because reductions are parallel.
Golden-parity tests use the oracle; ``tests/test_em_batch.py`` checks
decision agreement.
"""

from __future__ import annotations

import dataclasses
import math
import time

import jax
import jax.numpy as jnp
import numpy as np

from .kmeans import kmns
from .matepair_em import K_MAX, LAMBDA, TOLERANCE, EMParams

MAX_ITERS = 300
BIG = np.float64(1e30)


# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EMBatch:
    """Padded batch of (instance, K) EM problems."""
    x: np.ndarray          # (B, N)
    y: np.ndarray          # (B, N)
    u: np.ndarray          # (B, N)
    n: np.ndarray          # (B,) valid points
    k: np.ndarray          # (B,) active components
    r0: np.ndarray         # (B, KMAX, N) initial responsibilities
    xo_idx: np.ndarray     # (B, N) descending-x sort order (stable)
    yo_idx: np.ndarray     # (B, N)
    x_runend: np.ndarray   # (B, N) bool: last position of a value run
    y_runend: np.ndarray   # (B, N)
    instance: np.ndarray   # (B,) original instance id


def prepare_batch(instances, params: EMParams, k_max: int = K_MAX,
                  pad_n: int | None = None) -> EMBatch | None:
    """Build an EMBatch from [(x, y, u)] float64 arrays.

    Expands each instance into one element per candidate K (1..min(kmax,n))
    with host-computed seeds.
    """
    rows = []
    for inst_id, (x, y, u) in enumerate(instances):
        n = len(x)
        if n < params.min_cluster_size:
            continue  # MatePairEM.cpp:542-545
        for k in range(1, min(k_max, n) + 1):
            rows.append((inst_id, k, x, y, u))
    if not rows:
        return None

    # Seeds via the threaded native KKZ + AS136 batch when built: the
    # per-row Python kmns was ~7s of host time on the bench workload
    # (3806 rows) — 3x the entire device EM it was preparing.  Identical
    # math (shared kmns twin, same fallback set), so R0 is unchanged.
    seed_ic1 = seed_uniform = seed_offs = None
    if len(rows) > 64:
        from . import native as _native
        if _native.available():
            try:
                seed_ic1, seed_uniform, seed_offs = _native.em_seed_batch(
                    instances, rows)
            except Exception:
                seed_ic1 = None  # Python _seed fallback below

    max_n = pad_n or max(len(r[2]) for r in rows)
    B = len(rows)
    X = np.zeros((B, max_n))
    Y = np.zeros((B, max_n))
    U = np.zeros((B, max_n))
    N = np.zeros(B, dtype=np.int32)
    K = np.zeros(B, dtype=np.int32)
    R0 = np.zeros((B, k_max, max_n))
    XOI = np.zeros((B, max_n), dtype=np.int32)
    YOI = np.zeros((B, max_n), dtype=np.int32)
    XRE = np.zeros((B, max_n), dtype=bool)
    YRE = np.zeros((B, max_n), dtype=bool)
    INST = np.zeros(B, dtype=np.int32)

    for b, (inst_id, k, x, y, u) in enumerate(rows):
        n = len(x)
        X[b, :n] = x
        Y[b, :n] = y
        U[b, :n] = u
        N[b] = n
        K[b] = k
        INST[b] = inst_id
        xo = np.argsort(-np.asarray(x), kind="stable")
        yo = np.argsort(-np.asarray(y), kind="stable")
        XOI[b, :n] = xo
        XOI[b, n:] = n - 1 if n else 0
        YOI[b, :n] = yo
        YOI[b, n:] = n - 1 if n else 0
        xs = np.asarray(x)[xo]
        ys = np.asarray(y)[yo]
        XRE[b, :n] = np.r_[xs[:-1] != xs[1:], True]
        YRE[b, :n] = np.r_[ys[:-1] != ys[1:], True]
        if seed_ic1 is not None:
            if seed_uniform[b]:
                R0[b, :k, :n] = 1.0 / k
            else:
                ic1 = seed_ic1[seed_offs[b]:seed_offs[b] + n]
                R0[b, ic1, np.arange(n)] = 1.0
        else:
            R0[b, :k, :n] = _seed(np.asarray(x), np.asarray(y), k)

    return EMBatch(X, Y, U, N, K, R0, XOI, YOI, XRE, YRE, INST)


def _seed(x: np.ndarray, y: np.ndarray, k: int) -> np.ndarray:
    """Initial responsibilities: uniform for K in {1, N}, else KKZ +
    AS136 k-means one-hot (``MatePairEM.cpp:405-453``)."""
    n = len(x)
    if k == 1 or k == n:
        return np.full((k, n), 1.0 / k)
    px, py = _select_kkz(x, y, k)
    if px is None:
        # degenerate geometry: fall back to uniform (the reference
        # reports EM failure for this K; BIC will rarely choose it)
        return np.full((k, n), 1.0 / k)
    a_mat = np.stack([y, x], axis=1)
    c_mat = np.stack([py, px], axis=1)
    ic1, _, _, ifault = kmns(a_mat, c_mat)
    if ic1 is None:
        return np.full((k, n), 1.0 / k)
    onehot = np.zeros((k, n))
    onehot[ic1, np.arange(n)] = 1.0
    return onehot


def _select_kkz(x, y, k):
    l2 = x * y
    i_max = int(np.argmax(l2))  # first max (ties) — matches strict >
    ax = [x[i_max]]
    ay = [y[i_max]]
    dist = (x - ax[0]) ** 2 + (y - ay[0]) ** 2
    while len(ax) < k:
        i_far = int(np.argmax(dist))
        if dist[i_far] == 0.0:
            return None, None
        ax.append(x[i_far])
        ay.append(y[i_far])
        dist = np.minimum(dist, (x - ax[-1]) ** 2 + (y - ay[-1]) ** 2)
    return np.asarray(ax), np.asarray(ay)


# ---------------------------------------------------------------------------
# Device EM
# ---------------------------------------------------------------------------

def _exponents(a, b, x, y, u, sigma, lam):
    # a,b: (B,K); x,y,u: (B,N) -> (B,K,N)
    diff = (a[..., None] + b[..., None]
            - x[:, None, :] - y[:, None, :] - u[:, None, :]) / sigma
    return (-0.5 * diff * diff
            - lam * jnp.maximum(0.0, x[:, None, :] - a[..., None])
            - lam * jnp.maximum(0.0, y[:, None, :] - b[..., None]))


def _onehot_gather(vals, idx, n):
    """Gather ``vals[..., idx]`` along the last axis WITHOUT a gather op.

    A masked one-hot sum is one fused compare+select+reduce and is
    bit-exact: every output element sums exactly one nonzero, so no
    reduction-order or matmul-precision effects exist.

    vals: (..., N) broadcastable against idx (..., Q) -> (..., Q).
    """
    oh = idx[..., None] == jnp.arange(n, dtype=idx.dtype)
    return jnp.sum(jnp.where(oh, vals[..., None, :], 0), axis=-1)


def _side_static(sorted_vals, runend, n_valid):
    """Loop-invariant per-side structures for the M-step event merge.

    Everything here depends only on the coordinate sort order — NOT on
    the responsibilities — so it is computed once per EM problem and
    carried through the while_loop instead of being rebuilt (argsort +
    serialized gathers) every iteration.
    """
    B, N = sorted_vals.shape
    iota = jnp.arange(N, dtype=jnp.int32)[None, :]
    order = jnp.argsort(~runend, axis=1, stable=True)   # run-end positions
    count = jnp.sum(runend, axis=1)
    mvalid = iota < count[:, None]
    rpos = jnp.where(mvalid, order, N - 1)              # (B, N)
    # value at each run end / at the next sorted position (one-time
    # gathers outside the loop body)
    runend_vals = jnp.take_along_axis(sorted_vals, rpos, axis=1)
    runend_next = jnp.take_along_axis(
        sorted_vals, jnp.clip(rpos + 1, 0, N - 1), axis=1)
    has_next = (rpos + 1) < n_valid                      # (B, N)
    n_runs = count[:, None]                              # (B, 1)
    # one-hot of rpos for the per-iteration rcum pick (sx at run ends)
    rpos_oh = rpos[:, :, None] == iota[:, None, :]       # (B, N, N)
    return dict(rpos=rpos, rpos_oh=rpos_oh, mvalid=mvalid,
                runend_vals=runend_vals, runend_next=runend_next,
                has_next=has_next, n_runs=n_runs)


def _m_step(r, batch_static, sigma, lam):
    """Exact piecewise-linear M-step, vectorized over (B, K).

    r: (B, K, N) responsibilities.  Returns a, b: (B, K) and ok mask.

    Formulated gather-free: all data-dependent indexing is a
    one-hot masked sum (see ``_onehot_gather``) and the two-pointer
    merge's binary searches are broadcast compare+count reductions —
    both bit-exact re-expressions of the previous take_along_axis /
    searchsorted formulation.
    """
    (x, y, u, point_valid, xo_oh, yo_oh, xo, yo,
     xs_static, ys_static) = batch_static
    B, K, N = r.shape

    rm = jnp.where(point_valid[:, None, :], r, 0.0)
    nk = jnp.sum(rm, axis=2)                      # (B, K)
    rxyu = jnp.sum(rm * (x + y + u)[:, None, :], axis=2)

    # permute rm into coordinate-sorted order via the static one-hot
    # (B,N,N) masks: rxo[b,k,q] = rm[b,k,xo_idx[b,q]] — a fused masked
    # reduce, not a serialized gather
    rxo = jnp.sum(jnp.where(xo_oh[:, None, :, :], rm[:, :, None, :], 0),
                  axis=3)
    ryo = jnp.sum(jnp.where(yo_oh[:, None, :, :], rm[:, :, None, :], 0),
                  axis=3)
    sx = jnp.cumsum(rxo, axis=2)                  # (B, K, N)
    sy = jnp.cumsum(ryo, axis=2)

    # --- event construction at value-run granularity --------------------
    # The reference's two-pointer merge walks *runs* of equal coordinate
    # values (``MatePairEM.cpp:210-222`` skips duplicate coordinates).  At
    # each merge step it emits the current (x_run, y_run) pair at
    # threshold t = min(SX, SY), plus an "advanced" pair: the next x-run
    # when SX < SY, the next y-run when SY < SX, and BOTH advanced when
    # SX == SY (the == branch).  We enumerate the same entries per run
    # end, resolving the active other-side run (and tie advancement) with
    # vectorized lt/le counts over the other side's run-end cumsums.
    inf = jnp.asarray(BIG, rm.dtype)

    def rcum_at_runends(cum, side):
        rcum = jnp.sum(jnp.where(side["rpos_oh"][:, None, :, :],
                                 cum[:, :, None, :], 0), axis=3)
        return jnp.where(side["mvalid"][:, None, :], rcum, inf)

    x_rcum = rcum_at_runends(sx, xs_static)
    y_rcum = rcum_at_runends(sy, ys_static)

    def entries_for(source_is_x):
        if source_is_x:
            side, rcum = xs_static, x_rcum
            o_side, o_rcum = ys_static, y_rcum
        else:
            side, rcum = ys_static, y_rcum
            o_side, o_rcum = xs_static, x_rcum
        t = rcum  # (B, K, N) event thresholds (inf where invalid)

        # rank of this run among equal-cum self runs.  rcum is
        # nondecreasing along the run axis (cumsum of nonnegative
        # responsibilities at ascending run ends, inf-padded), so the
        # count of strictly-smaller self entries is simply the first
        # index of the equal-value block — an O(N) cummax, NOT a
        # pairwise O(N^2) comparison (which at production batch sizes
        # materializes multi-GB (B,K,N,N) intermediates).
        idxN = jnp.arange(N, dtype=jnp.int32)[None, None, :]
        is_new = jnp.concatenate(
            [jnp.ones_like(rcum[:, :, :1], bool),
             rcum[:, :, 1:] != rcum[:, :, :-1]], axis=2)
        n_self_lt = jax.lax.cummax(
            jnp.where(is_new, idxN, 0), axis=2)
        rank = idxN - n_self_lt

        # other-side structure at t: the two-pointer merge pairs equal-cum
        # runs by rank (== branch advances both), then parks on the first
        # other run beyond t (< branch).  Both sides are sorted; the lt/le
        # counts are broadcast compare+count reductions, which XLA
        # fuses.
        n_o_lt = jnp.sum(
            (o_rcum[:, :, :, None] < t[:, :, None, :]), axis=2,
            dtype=jnp.int32)
        n_o_le = jnp.sum(
            (o_rcum[:, :, :, None] <= t[:, :, None, :]), axis=2,
            dtype=jnp.int32)
        n_o_ties = n_o_le - n_o_lt
        n_o_runs = o_side["n_runs"][:, None, :]

        tie = rank < n_o_ties
        o_idx = n_o_lt + jnp.minimum(rank, n_o_ties)
        event_exists = tie | (n_o_lt + n_o_ties < n_o_runs)
        o_idx = jnp.clip(o_idx, 0, N - 1)

        # all remaining dynamic indexing happens through o_idx on static
        # (B, N) run-end vectors: one fused one-hot reduce for the three
        # of them (values, advanced values, has-next flag)
        o_stack = jnp.stack([o_side["runend_vals"],
                             o_side["runend_next"],
                             o_side["has_next"].astype(rm.dtype)], axis=1)
        picked = _onehot_gather(o_stack[:, None, :, :],
                                o_idx[:, :, None, :], N)  # (B,K,3,N)
        other_primary = picked[:, :, 0, :]
        other_adv_raw = picked[:, :, 1, :]
        other_has_next = picked[:, :, 2, :] > 0.5

        self_primary = jnp.broadcast_to(
            side["runend_vals"][:, None, :], (B, K, N))
        self_adv = jnp.broadcast_to(
            side["runend_next"][:, None, :], (B, K, N))
        self_has_next = jnp.broadcast_to(
            side["has_next"][:, None, :], (B, K, N))

        other_adv = jnp.where(tie, other_adv_raw, other_primary)
        adv_valid = self_has_next & jnp.where(tie, other_has_next, True)
        valid = side["mvalid"][:, None, :] & (t < inf) & event_exists

        if source_is_x:
            return (t, self_primary, other_primary,
                    self_adv, other_adv, valid, valid & adv_valid)
        return (t, other_primary, self_primary,
                other_adv, self_adv, valid, valid & adv_valid)

    tx, xcx1, xcy1, xcx2, xcy2, xv1, xv2 = entries_for(True)
    ty, ycx1, ycy1, ycx2, ycy2, yv1, yv2 = entries_for(False)

    ent_t = [jnp.zeros((B, K, 1), rm.dtype), tx, tx, ty, ty]
    ent_cx = [jnp.broadcast_to(xo[:, None, :1], (B, K, 1)),
              xcx1, xcx2, ycx1, ycx2]
    ent_cy = [jnp.broadcast_to(yo[:, None, :1], (B, K, 1)),
              xcy1, xcy2, ycy1, ycy2]
    ent_valid = [jnp.ones((B, K, 1), bool), xv1, xv2, yv1, yv2]
    # path-order tiebreak code: tier (primary-before-advanced) then run
    idx_base = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, None, :],
                                (B, K, N))
    ent_code = [jnp.zeros((B, K, 1), jnp.int32)] + \
        [tier * N + idx_base + 1 for tier in (1, 2, 3, 4)]

    T = jnp.concatenate(ent_t, axis=2)
    CX = jnp.concatenate(ent_cx, axis=2)
    CY = jnp.concatenate(ent_cy, axis=2)
    VALID = jnp.concatenate(ent_valid, axis=2)
    CODE = jnp.concatenate(ent_code, axis=2)

    # The derivative ``partial`` is nondecreasing along the merge path
    # (CS nondecreasing, CX+CY nonincreasing), so the reference's
    # first-positive scan reduces to: among positive entries, the
    # lexicographic minimum of (t, partial, path-code) — no sort needed.
    sigma2 = sigma * sigma
    partial = (rxyu[..., None] - nk[..., None] * (CX + CY)) / sigma2 \
        + lam * T
    positive = (partial > 0) & VALID

    def select(mask, key_t, key_p, key_c, minimize):
        big_t = inf if minimize else -inf
        m = jnp.where(mask, key_t, big_t)
        t_sel = (jnp.min(m, axis=2) if minimize else jnp.max(m, axis=2))
        mask2 = mask & (key_t == t_sel[..., None])
        m2 = jnp.where(mask2, key_p, big_t)
        p_sel = (jnp.min(m2, axis=2) if minimize else jnp.max(m2, axis=2))
        mask3 = mask2 & (key_p == p_sel[..., None])
        big_c = jnp.int32(1 << 30)
        m3 = jnp.where(mask3, key_c, big_c if minimize else -big_c)
        c_sel = (jnp.min(m3, axis=2) if minimize else jnp.max(m3, axis=2))
        sel = mask3 & (key_c == c_sel[..., None])
        return sel

    inf = jnp.asarray(BIG, rm.dtype)
    neg_inf = -inf
    any_pos = jnp.any(positive, axis=2)

    sel_pos = select(positive, T, partial, CODE, minimize=True)
    nonpos = VALID & ~positive
    any_nonpos = jnp.any(nonpos, axis=2)
    sel_prev = select(nonpos, T, partial, CODE, minimize=False)
    # no positive derivative: reference behaviour is to park on the last
    # entry (guarded UB, cluster/matepair_em.py); use the path-last entry
    sel_mi = jnp.where(any_pos[..., None], sel_pos, sel_prev)

    def gather(vals, sel):
        return jnp.sum(jnp.where(sel, vals, 0), axis=2)

    cs_mi = gather(T, sel_mi)
    cx_mi = gather(CX, sel_mi)
    cy_mi = gather(CY, sel_mi)
    cs_pv = gather(T, sel_prev)
    cx_pv = gather(CX, sel_prev)
    cy_pv = gather(CY, sel_prev)

    ok = nk > 0.0
    nk_safe = jnp.where(ok, nk, 1.0)
    aplusb = (rxyu + sigma2 * lam * cs_mi) / nk_safe

    # three cases (MatePairEM.cpp:304-322)
    a0 = 0.5 * (cx_mi + (aplusb - cy_mi))
    case_break = (cs_mi != cs_pv) | ~any_pos | ~any_nonpos
    a_break = cx_mi
    b_break = cy_mi
    min_a = jnp.maximum(cx_mi, aplusb - cy_pv)
    max_a = jnp.minimum(cx_pv, aplusb - cy_mi)
    a_mid = 0.5 * (min_a + max_a)

    # minindex == 0  <=>  the initial path entry is already positive
    first = positive[:, :, 0]
    a = jnp.where(first, a0, jnp.where(case_break, a_break, a_mid))
    b = jnp.where(first, aplusb - a0,
                  jnp.where(case_break, b_break, aplusb - a_mid))
    return a, b, ok


import functools


def _build_em_run(sigma: float, lam: float = LAMBDA,
                  tol: float = TOLERANCE):
    """The traceable batched EM driver (unjitted) — shared by the plain
    jitted entry (``make_em_step``) and the device-resident slab step
    (``make_em_slab_step``)."""
    def em_run(x, y, u, n, k, r0, ll0=None, max_iters=MAX_ITERS):
        """One EM drive: runs up to ``max_iters`` iterations from the
        responsibilities ``r0`` (fresh seeds or a resumed carry) and the
        per-row last log-likelihood ``ll0`` (-BIG for fresh rows).
        Returns (a, b, w, ll, ok, iters, r, done, failed, it_done) so a
        caller can compact converged rows out and resume the stragglers
        — per-row trajectories are identical whether run in one launch
        or in resumed segments (every op is row-independent)."""
        B, KM, N = r0.shape
        if ll0 is None:
            ll0 = jnp.full((B,), -BIG)
        big = jnp.asarray(BIG, x.dtype)
        point_valid = jnp.arange(N)[None, :] < n[:, None]
        comp_active = jnp.arange(KM)[None, :] < k[:, None]

        # static structures recomputed on device (cheap, avoids host
        # state), then expanded into the loop-invariant one-hot masks and
        # run-end tables the gather-free M-step consumes (hoisted out of
        # the while_loop: they depend only on the sort order)
        xo_idx = jnp.argsort(jnp.where(point_valid, -x, big), axis=1,
                             stable=True).astype(jnp.int32)
        yo_idx = jnp.argsort(jnp.where(point_valid, -y, big), axis=1,
                             stable=True).astype(jnp.int32)
        xo = jnp.take_along_axis(x, xo_idx, axis=1)
        yo = jnp.take_along_axis(y, yo_idx, axis=1)
        pv_sorted = jnp.take_along_axis(point_valid, xo_idx, axis=1)

        def runends(sorted_vals, valid):
            nxt = jnp.concatenate(
                [sorted_vals[:, 1:], sorted_vals[:, -1:]], axis=1)
            nxt_valid = jnp.concatenate(
                [valid[:, 1:], jnp.zeros_like(valid[:, :1])], axis=1)
            return valid & ((sorted_vals != nxt) | ~nxt_valid)

        x_runend = runends(xo, pv_sorted)
        y_runend = runends(yo, jnp.take_along_axis(point_valid, yo_idx,
                                                   axis=1))

        iota_n = jnp.arange(N, dtype=jnp.int32)
        xo_oh = xo_idx[:, :, None] == iota_n[None, None, :]   # (B, N, N)
        yo_oh = yo_idx[:, :, None] == iota_n[None, None, :]
        n_valid = jnp.sum(point_valid, axis=1)[:, None]
        xs_static = _side_static(xo, x_runend, n_valid)
        ys_static = _side_static(yo, y_runend, n_valid)

        static = (x, y, u, point_valid, xo_oh, yo_oh, xo, yo,
                  xs_static, ys_static)

        def ll_and_norm(a, b, w):
            exps = _exponents(a, b, x, y, u, sigma, lam)
            exps = jnp.where(comp_active[..., None], exps, -big)
            maxexp = jnp.max(exps, axis=1, keepdims=True)
            weighted = w[..., None] * jnp.exp(exps - maxexp)
            s = jnp.sum(weighted, axis=1)  # (B, N)
            tiny = jnp.finfo(s.dtype).tiny
            logp = jnp.log(jnp.maximum(s, tiny)) + maxexp[:, 0, :]
            ll = jnp.sum(jnp.where(point_valid, logp, 0.0), axis=1)
            failed = jnp.any((s == 0.0) & point_valid, axis=1)
            resp = weighted / jnp.maximum(s[:, None, :], 1e-300)
            return ll, failed, resp

        def body(state):
            (r, a, b, w, last_ll, done, failed, it, it_done) = state
            a_new, b_new, ok = _m_step(r, static, sigma, lam)
            a_upd = jnp.where(ok & comp_active, a_new, a)
            b_upd = jnp.where(ok & comp_active, b_new, b)
            nk = jnp.sum(jnp.where(point_valid[:, None, :], r, 0.0), axis=2)
            # keep the carry dtype stable under x64 promotion rules
            w_upd = nk / jnp.maximum(n[:, None], 1).astype(x.dtype)
            ll, ll_failed, resp = ll_and_norm(a_upd, b_upd, w_upd)
            newly_done = jnp.abs(ll - last_ll) < tol
            live = ~done & ~failed
            r_next = jnp.where((live & ~newly_done)[:, None, None],
                               resp, r)
            a = jnp.where(live[:, None], a_upd, a)
            b = jnp.where(live[:, None], b_upd, b)
            w = jnp.where(live[:, None], w_upd, w)
            last_ll = jnp.where(live, ll, last_ll)
            failed = failed | (live & ll_failed)
            done = done | (live & newly_done)
            it_done = jnp.where(done | failed,
                                jnp.minimum(it_done, it + 1), it_done)
            return r_next, a, b, w, last_ll, done, failed, it + 1, it_done

        def cond(state):
            *_, done, failed, it, it_done = state
            return (it < max_iters) & ~jnp.all(done | failed)

        r = jnp.where(comp_active[..., None], r0, 0.0)
        state0 = (r, jnp.zeros((B, KM), x.dtype), jnp.zeros((B, KM), x.dtype),
                  jnp.zeros((B, KM), x.dtype),
                  jnp.asarray(ll0, x.dtype),
                  jnp.zeros((B,), bool), jnp.zeros((B,), bool),
                  jnp.zeros((), jnp.int32),
                  jnp.full((B,), MAX_ITERS + 1, jnp.int32))
        r, a, b, w, ll, done, failed, iters, it_done = jax.lax.while_loop(
            cond, body, state0)
        return a, b, w, ll, done & ~failed, iters, r, done, failed, it_done

    return em_run


@functools.lru_cache(maxsize=32)
def make_em_step(sigma: float, lam: float = LAMBDA,
                 tol: float = TOLERANCE):
    """Build the jitted batched EM iteration + driver (cached so repeated
    runs reuse the compiled executable)."""
    return jax.jit(_build_em_run(sigma, lam, tol),
                   static_argnames=("max_iters",))


@functools.lru_cache(maxsize=32)
def make_em_slab_step(sigma: float, lam: float = LAMBDA,
                      tol: float = TOLERANCE):
    """Device-resident slab step for the bucketed driver.

    The step keeps ALL state on the device: the group's inputs are
    uploaded once,
    each slab is selected with a tiny (chunk,) index vector, the
    responsibility/log-likelihood carry is gathered and scattered
    in-place (donated buffers — no reallocation, no transfer), and the
    only per-slab download is one packed (chunk, 2K+3) result matrix.

    Gather/scatter of whole rows is exact, and every EM op is
    row-independent, so per-row trajectories are bit-identical to a
    single uncompacted launch.
    Padded slab positions repeat a live row; their scattered updates are
    byte-identical copies of that row's update, so duplicate-index
    scatter order cannot change the result.
    """
    em_run = _build_em_run(sigma, lam, tol)

    def slab_step(xyu, nk, R, LL, sel, max_iters):
        x = jnp.take(xyu[0], sel, axis=0)
        y = jnp.take(xyu[1], sel, axis=0)
        u = jnp.take(xyu[2], sel, axis=0)
        n = jnp.take(nk[0], sel, axis=0)
        k = jnp.take(nk[1], sel, axis=0)
        r0 = jnp.take(R, sel, axis=0)
        ll0 = jnp.take(LL, sel, axis=0)
        a, b, _w, ll, _ok, _it, r, done, failed, _itd = em_run(
            x, y, u, n, k, r0, ll0, max_iters=max_iters)
        R = R.at[sel].set(r)
        LL = LL.at[sel].set(ll)
        packed = jnp.concatenate(
            [a, b, ll[:, None], done[:, None].astype(a.dtype),
             failed[:, None].astype(a.dtype)], axis=1)
        return R, LL, packed

    return jax.jit(slab_step, static_argnames=("max_iters",),
                   donate_argnums=(2, 3))


# Largest (instance, k) row count shipped to the GPU in one program.
# Compile time grows with the row count, and uniform slabs give ONE
# compiled shape per (K, N) bucket.  Rows are independent, so slabs
# (padded by repeating a slab's first row) are result-identical to a
# single launch.
DEVICE_CHUNK_ROWS = 256

# Device launch granularity between straggler compactions: every
# SEGMENT_ITERS iterations the converged rows are retired on the host
# and only the stragglers are re-slabbed.  The per-iteration cost is
# O(K*N^2) per live row, and a 256-row slab syncs to its slowest row —
# without compaction a single 300-iteration straggler makes 255
# already-converged rows pay full fare (the r3 bench ran ~1.15M
# row-iterations where only ~0.2M were live).  Must divide MAX_ITERS so
# every launch shares one static max_iters (one executable per shape).
SEGMENT_ITERS = 100

# Shape buckets: rows are grouped by (smallest K bucket >= k, smallest
# N bucket >= n) and each group is padded only to ITS bucket, not the
# global maxima.  The M-step is exactly invariant to K/N padding width
# in exact arithmetic (padding contributes only exact zeros / -BIG
# sentinels); f32 sums can drift across widths, which the hybrid
# exact-resolve margins in select_memberships already absorb.  Bucket
# counts are kept small because each (chunk, K, N) shape is a separate
# XLA compile (amortized by the persistent cache).
K_BUCKETS = (3, 6, K_MAX)
N_BUCKETS_BASE = (36, 80, 144)


def _shape_buckets(width: int) -> list[int]:
    buckets = [b for b in N_BUCKETS_BASE if b < width]
    b = N_BUCKETS_BASE[-1]
    while b < width:
        b *= 2
    buckets.append(min(b, width) if b != width else width)
    buckets[-1] = min(buckets[-1], width)
    return buckets


def _bucket_of(v: int, buckets) -> int:
    for b in buckets:
        if v <= b:
            return b
    return buckets[-1]


def run_batch(batch: EMBatch, params: EMParams, dtype=None,
              chunk_rows=None, exact_resolve=None):
    """Run the batched EM and select K by BIC.  Returns per-instance
    memberships: {instance_id: list of member index lists}.

    dtype defaults to f64 when x64 is enabled (exact decision parity)
    and f32 otherwise.  exact_resolve
    defaults to on for f32: instances whose decision is within the f32
    drift margins are re-solved exactly on the host (see
    ``select_memberships``), making the hybrid output match the
    f64/native answer except when f32 and f64 EM trajectories land in
    different optima undetectably.
    """
    from ..core.devices import gpu_device
    gpu = gpu_device()
    if dtype is None:
        # without jax_enable_x64 an f64 request silently truncates with
        # a UserWarning — pick f32 (+ exact_resolve) then
        x64 = bool(jax.config.read("jax_enable_x64"))
        dtype = jnp.float64 if x64 else jnp.float32
    if chunk_rows is None:
        chunk_rows = DEVICE_CHUNK_ROWS if gpu is not None else 0
    em = make_em_step(params.fragment_stddev)
    rows = len(batch.n)

    # bucketed driver when the row count exceeds the slab width — which
    # the M-step's (B, N, N) mask footprint can shrink well below
    # chunk_rows at bin-pair widths in the thousands (a 20-row N=8192
    # batch needs 8-row slabs to stay inside the HBM budget)
    slab_bytes = _slab_bytes(gpu) if chunk_rows else 0
    eff_chunk = (_chunk_for(batch.x.shape[1], batch.r0.shape[1],
                            chunk_rows, slab_bytes) if chunk_rows else 0)
    if chunk_rows and rows > eff_chunk:
        a, b, ll, ok = _run_bucketed(params, batch, dtype, chunk_rows,
                                     slab_bytes)
    else:
        a, b, _w, ll, ok = (np.asarray(o) for o in em(
            jnp.asarray(batch.x, dtype), jnp.asarray(batch.y, dtype),
            jnp.asarray(batch.u, dtype), jnp.asarray(batch.n),
            jnp.asarray(batch.k), jnp.asarray(batch.r0, dtype))[:5])
    exact = exact_resolve
    if exact is None:
        exact = np.dtype(dtype) != np.float64
    return select_memberships(batch, params, a, b, ll, ok,
                              exact_resolve=exact)


# Device-memory budget for one slab's M-step working set: this share
# of the memory JAX may use on the card.  The gather-free M-step
# materializes four (B, N, N)-byte one-hot masks (xo_oh/yo_oh + one
# rpos_oh per side) plus O(B*K*N) state; slabs are sized so that
# footprint stays well inside the card's memory even at the large-N
# bin-pair regime (defuse_run.pl:475's 32GB setcover shapes), where
# N^2 masks dominate.
EM_SLAB_SHARE = 8
# the budget where the device reports no limit (the CPU)
EM_SLAB_BYTES_DEFAULT = 2 << 30


def _slab_bytes(device) -> int:
    stats = device.memory_stats() if device is not None else None
    if not stats or "bytes_limit" not in stats:
        return EM_SLAB_BYTES_DEFAULT
    return int(stats["bytes_limit"]) // EM_SLAB_SHARE


def _chunk_for(nb: int, kb: int, chunk_rows: int, slab_bytes: int) -> int:
    per_row = 4 * nb * nb + 64 * kb * nb
    c = int(max(8, min(chunk_rows, slab_bytes // per_row)))
    return c // 8 * 8


def _group_pad(g: int) -> int:
    """Bucket the per-group row count so executables are reused across
    datasets (every distinct (Gb, chunk, kb, nb) is one XLA compile)."""
    b = 64
    while b < g:
        b *= 2
    return b


# observability: per-phase attribution of the last bucketed run, filled
# by _run_bucketed (consumed by scripts_dev/em_roofline_probe.py and the
# bench kernel_rooflines collector)
EM_RUN_STATS: dict = {}


def _run_bucketed(params: EMParams, batch: EMBatch, dtype,
                  chunk_rows: int, slab_bytes: int):
    """Bucketed + segmented + device-resident driver for large batches.

    Rows are grouped by (K, N) shape bucket.  Each group's inputs are
    uploaded to the device ONCE (one stacked coordinate tensor, one
    stacked n/k tensor, the seed responsibilities, and the
    log-likelihood carry); slabs of ``chunk`` rows are then selected
    with a tiny on-device gather, run for SEGMENT_ITERS iterations, and
    scattered back into the donated device-resident carry
    (``make_em_slab_step``).  Converged rows are retired on the host
    from the packed per-slab result (the only per-slab download, ~30KB)
    and stragglers are re-slabbed by index — the (B, K, N)
    responsibility state never leaves the device.

    Per-row trajectories are identical to a single uncompacted launch at
    the same padded shape (row independence; gather/scatter moves whole
    rows exactly).
    """
    t_wall0 = time.time()
    stats = {"t_upload": 0.0, "t_dispatch": 0.0, "t_device_wait": 0.0,
             "t_pull": 0.0, "up_MB": 0.0, "down_MB": 0.0,
             "slabs": 0, "groups": 0, "segments": 0}
    slab_step = make_em_slab_step(params.fragment_stddev)
    rows = len(batch.n)
    kmax = batch.r0.shape[1]
    np_dtype = np.dtype(dtype)
    n_buckets = _shape_buckets(batch.x.shape[1])
    k_buckets = [min(b, kmax) for b in K_BUCKETS if b < kmax] + [kmax]

    a_out = np.zeros((rows, kmax), np_dtype)
    b_out = np.zeros((rows, kmax), np_dtype)
    ll_out = np.full(rows, -BIG, np_dtype)
    ok_out = np.zeros(rows, bool)

    groups: dict[tuple[int, int], list[int]] = {}
    for i in range(rows):
        key = (_bucket_of(int(batch.k[i]), k_buckets),
               _bucket_of(int(batch.n[i]), n_buckets))
        groups.setdefault(key, []).append(i)

    n_segments = -(-MAX_ITERS // SEGMENT_ITERS)
    for (kb, nb), idx_list in sorted(groups.items()):
        idx0 = np.asarray(idx_list, np.intp)
        G = len(idx0)
        Gb = _group_pad(G)
        chunk = _chunk_for(nb, kb, chunk_rows, slab_bytes)

        t0 = time.time()
        xyu = np.zeros((3, Gb, nb), np_dtype)
        xyu[0, :G] = batch.x[idx0][:, :nb]
        xyu[1, :G] = batch.y[idx0][:, :nb]
        xyu[2, :G] = batch.u[idx0][:, :nb]
        nk = np.zeros((2, Gb), np.int32)
        nk[0, :G] = batch.n[idx0]
        nk[1, :G] = batch.k[idx0]
        r_init = np.zeros((Gb, kb, nb), np_dtype)
        r_init[:G] = batch.r0[idx0][:, :kb, :nb]
        ll_init = np.full(Gb, -BIG, np_dtype)
        xyu_d = jax.device_put(xyu)
        nk_d = jax.device_put(nk)
        R_d = jax.device_put(r_init)
        LL_d = jax.device_put(ll_init)
        jax.block_until_ready((xyu_d, nk_d, R_d, LL_d))
        stats["t_upload"] += time.time() - t0
        stats["up_MB"] += (xyu.nbytes + nk.nbytes + r_init.nbytes
                           + ll_init.nbytes) / 1e6
        stats["groups"] += 1

        alive = np.arange(G)  # group-row positions still running
        for seg in range(n_segments):
            last = seg == n_segments - 1
            pending = []
            t0 = time.time()
            for lo in range(0, len(alive), chunk):
                hi = min(lo + chunk, len(alive))
                sel = alive[lo:hi]
                if hi - lo < chunk:  # pad: repeat the first live row
                    sel = np.concatenate(
                        [sel, np.full(chunk - (hi - lo), sel[0],
                                      sel.dtype)])
                R_d, LL_d, packed = slab_step(
                    xyu_d, nk_d, R_d, LL_d,
                    jnp.asarray(sel.astype(np.int32)),
                    max_iters=SEGMENT_ITERS)
                pending.append((lo, hi, packed))
            stats["t_dispatch"] += time.time() - t0
            stats["segments"] += 1
            t0 = time.time()
            jax.block_until_ready(pending[-1][2])
            stats["t_device_wait"] += time.time() - t0
            t0 = time.time()
            keep = []
            for lo, hi, packed in pending:
                pk = np.asarray(packed)
                stats["down_MB"] += pk.nbytes / 1e6
                stats["slabs"] += 1
                take = hi - lo
                a_c = pk[:take, :kb]
                b_c = pk[:take, kb:2 * kb]
                ll_c = pk[:take, 2 * kb]
                done = pk[:take, 2 * kb + 1] > 0.5
                failed = pk[:take, 2 * kb + 2] > 0.5
                fin = (done | failed) | last
                g = alive[lo:hi]
                gi = idx0[g[fin]]
                a_out[gi, :kb] = a_c[fin]
                b_out[gi, :kb] = b_c[fin]
                ll_out[gi] = ll_c[fin]
                ok_out[gi] = (done & ~failed)[fin]
                if not last and not fin.all():
                    keep.append(g[~fin])
            stats["t_pull"] += time.time() - t0
            if not keep:
                break
            alive = np.concatenate(keep)
        del xyu_d, nk_d, R_d, LL_d
    stats["wall_s"] = round(time.time() - t_wall0, 3)
    EM_RUN_STATS.clear()
    EM_RUN_STATS.update(
        {k: (round(v, 3) if isinstance(v, float) else v)
         for k, v in stats.items()})
    return a_out, b_out, ll_out, ok_out


# ambiguity thresholds for exact_resolve, calibrated on the bench
# dataset (device f32 vs host f64, 381 instances): f32 trajectory drift
# moves per-point log-probabilities by up to ~5e-3 and instance
# log-likelihoods by well under 0.25, so decisions closer to a boundary
# than these margins are re-solved exactly on the host (~10% of
# instances there; the other 90% are provably unaffected by drift of
# that size)
PROB_LOG_MARGIN = 0.01
BIC_MARGIN = 0.5

# observability: filled by select_memberships on every call
LAST_SELECT_STATS: dict = {}


def select_memberships(batch: EMBatch, params: EMParams, a, b, ll, ok,
                       exact_resolve: bool = False):
    """BIC model selection + membership thresholding from per-(instance,
    K) EM results — the host tail of ``run_batch``, shared by the mesh-
    sharded EM path (``__graft_entry__.dryrun_multichip``).

    exact_resolve: hybrid device/host mode for reduced-precision (f32)
    device results.  Any instance whose decision sits within the f32
    drift margins — a non-converged/failed K row (trajectory basins can
    differ between f32 and f64), a BIC near-tie across K, or a point
    within PROB_LOG_MARGIN of the membership threshold — is re-solved
    with the exact f64 host oracle (``matepair_em.MatePairEM``, bit-
    parity with the native C++).  Everything else keeps the device
    answer, which the margins certify equal to the host's.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    ll = np.asarray(ll)
    ok = np.asarray(ok)

    # BIC per (instance, k) element; argmin per instance
    bic = -2.0 * ll + batch.k * 2.0 * np.log(np.maximum(batch.n, 1))
    bic = np.where(ok, bic, np.inf)

    best: dict[int, int] = {}
    inst_rows: dict[int, list[int]] = {}
    for bi in range(len(batch.n)):
        inst = int(batch.instance[bi])
        inst_rows.setdefault(inst, []).append(bi)
        if inst not in best or bic[bi] < bic[best[inst]]:
            best[inst] = bi

    from .matepair_em import MatePairEM
    em_host = MatePairEM(params)
    minp = em_host.min_probability
    log_minp = np.log(minp)
    result: dict[int, list[list[int]]] = {}
    pending: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
    for inst, bi in sorted(best.items()):
        rows = inst_rows[inst]
        n = int(batch.n[bi])
        xs = batch.x[bi, :n]
        ys = batch.y[bi, :n]
        us = batch.u[bi, :n]
        ambiguous = False
        if exact_resolve:
            if not all(ok[r] for r in rows):
                ambiguous = True
            elif len(rows) > 1:
                bics = np.sort(np.asarray([bic[r] for r in rows]))
                if np.isfinite(bics[1]) and bics[1] - bics[0] < BIC_MARGIN:
                    ambiguous = True
        if ambiguous:
            pending.append((inst, xs, ys, us))
            continue
        if not np.isfinite(bic[bi]):
            result[inst] = []
            continue
        k = int(batch.k[bi])
        clusters = []
        for j in range(k):
            prob = em_host.pair_probability(xs, ys, us, a[bi, j], b[bi, j])
            if exact_resolve and not ambiguous:
                gap = np.abs(np.log(np.maximum(prob, 1e-300)) - log_minp)
                if float(np.min(gap)) < PROB_LOG_MARGIN:
                    ambiguous = True
            members = np.nonzero(prob > minp)[0]
            if len(members) >= params.min_cluster_size:
                clusters.append(members.tolist())
        if ambiguous:
            pending.append((inst, xs, ys, us))
        else:
            result[inst] = clusters
    if pending:
        result.update(_resolve_exact(pending, params, em_host))
    LAST_SELECT_STATS.clear()
    LAST_SELECT_STATS.update(
        n_instances=len(best), n_host_resolved=len(pending),
        exact_resolve=exact_resolve)
    return result


def _resolve_exact(pending, params, em_host):
    """Exact f64 host re-solve of the drift-ambiguous instances, batched
    through the threaded native C++ solver when built (bit-identical to
    the Python oracle — the em_mode native/oracle parity contract),
    oracle fallback otherwise.  Deferring + batching matters: at ~10%
    ambiguity on the bench workload the per-instance Python re-solves
    were ~19s of the hybrid's 22s warm wall, dwarfing the 2.6s of
    device EM they certified."""
    from . import native
    if native.available():
        try:
            mems = native.em_cluster_batch(
                [(xs, ys, us) for _i, xs, ys, us in pending], params)
            return {inst: [list(m) for m in mm]
                    for (inst, *_), mm in zip(pending, mems)}
        except Exception:
            pass  # fall back to the oracle below
    return {inst: [list(m) for m in em_host.do_clustering(xs, ys, us)]
            for inst, xs, ys, us in pending}
