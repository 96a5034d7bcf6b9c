"""Batched split-read DP — JAX/XLA device path.

Computes, for a padded batch of (read, reference) pairs, the per-row DP
maxima needed by the split-read breakpoint search
(``align/split_dp.py``).  All scores are int32, so device results are
bit-exact vs the host oracle — no fp tolerance needed.

Layout: references padded to R lanes, reads padded to L; the row loop is a
``lax.scan`` over read positions, each step a vectorized column update
with a cumulative max along the reference axis (the prefix-max-with-decay
form of the horizontal gap recurrence).

A full split alignment of one read against a fusion's two flanks runs the
kernel twice per read — (ref1, read) and (ref2 reversed, read reversed) —
batched together as 2B instances.  The combine step (anchor threshold, +
reduction over split offsets) also runs on device; tie *enumeration* (all
equal-scoring ref columns) runs on the host for accepted reads only,
which are rare.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..align.split_dp import GAP, MATCH, MIN_SPLIT_SCORE, MISMATCH

NEG = jnp.int32(-(1 << 30))


@functools.partial(jax.jit, static_argnames=("return_matrix",))
def dp_row_maxima(refs, ref_lens, reads, read_lens, return_matrix=False):
    """Row maxima of the split DP for a batch.

    refs: (B, R) uint8 padded reference characters
    ref_lens: (B,) int32
    reads: (B, L) uint8
    read_lens: (B,) int32
    Returns rowmax (B, L+1) int32: max over valid ref columns of DP row j,
    clamped to 0 when below MIN_SPLIT_SCORE; rows j > read_len are 0.
    If return_matrix, also returns the full DP tensor (B, L+1, R+1).
    """
    B, R = refs.shape
    L = reads.shape[1]

    iota_r = jnp.arange(R + 1, dtype=jnp.int32)
    decay = GAP * iota_r
    # lane validity: DP column i corresponds to ref position i-1; i==0 valid
    valid = iota_r[None, :] <= ref_lens[:, None]  # (B, R+1)

    init_col = jnp.zeros((B, R + 1), dtype=jnp.int32)

    def step(prev, j):
        # j: 1-based read position
        ch = jnp.take_along_axis(reads, (j - 1)[None].repeat(B)[:, None],
                                 axis=1)[:, 0]  # (B,)
        sub = jnp.where(refs == ch[:, None], MATCH, MISMATCH).astype(
            jnp.int32)  # (B, R)
        vert0 = (GAP * j) * jnp.ones((B, 1), dtype=jnp.int32)
        cand = jnp.maximum(prev[:, :-1] + sub, prev[:, 1:] + GAP)
        vert = jnp.concatenate([vert0, cand], axis=1)  # (B, R+1)
        col = jax.lax.cummax(vert - decay[None, :], axis=1) + decay[None, :]
        rowmax = jnp.max(jnp.where(valid, col, NEG), axis=1)
        return col, (rowmax, col if return_matrix else jnp.int32(0))

    js = jnp.arange(1, L + 1, dtype=jnp.int32)
    _, (rowmaxes, cols) = jax.lax.scan(step, init_col, js)
    rowmaxes = rowmaxes.T  # (B, L)
    rowmax0 = jnp.zeros((B, 1), dtype=jnp.int32)  # row j=0 is all zeros
    rowmax = jnp.concatenate([rowmax0, rowmaxes], axis=1)  # (B, L+1)

    # anchor threshold + row validity
    row_valid = jnp.arange(L + 1, dtype=jnp.int32)[None, :] \
        <= read_lens[:, None]
    rowmax = jnp.where(rowmax >= MIN_SPLIT_SCORE, rowmax, 0)
    rowmax = jnp.where(row_valid, rowmax, 0)

    if return_matrix:
        # cols: (L, B, R+1) -> (B, L+1, R+1) with row 0 = zeros/gap line
        full = jnp.concatenate(
            [init_col[:, None, :], jnp.moveaxis(cols, 0, 1)], axis=1)
        return rowmax, full
    return rowmax


@jax.jit
def combine_split_scores(rowmax1, rowmax2, read_lens, min_scores):
    """Split-score search (``SplitReadAligner::GetAlignments`` max phase).

    rowmax1/rowmax2: (B, L+1) row maxima for the forward and reversed
    matrices.  Returns (max_score, best_k) where best_k is the smallest
    split offset achieving the max (ties enumerated host-side), and
    max_score==0 when no split passes ``min_scores``.
    """
    B, L1 = rowmax1.shape
    L = L1 - 1
    ks = jnp.arange(L + 1, dtype=jnp.int32)[None, :]
    k_valid = ks <= read_lens[:, None]
    # totals[k] = rm1[k] + rm2[read_len - k]
    idx2 = jnp.clip(read_lens[:, None] - ks, 0, L)
    rm2_at = jnp.take_along_axis(rowmax2, idx2, axis=1)
    totals = rowmax1 + rm2_at
    totals = jnp.where(k_valid, totals, 0)
    totals = jnp.where(totals >= min_scores[:, None], totals, 0)
    max_score = jnp.max(totals, axis=1)
    best_k = jnp.argmax(totals, axis=1).astype(jnp.int32)
    return max_score, best_k


@jax.jit
def dp_tie_columns(refs, ref_lens, reads, read_lens, row_sel):
    """Tie-column bitmasks for requested DP rows.

    row_sel: (B, M) int32 row indices (-1 for unused slots).
    For each requested row, computes the anchored row maximum and a
    bit-packed mask of the columns achieving it (``FindMaxRowEntry``
    column collection) — transferring ~30x less data than raw rows,
    which matters on high-latency links.

    Returns (rowmax (B, M) int32, packed (B, M, ceil((R+1)/32)) uint32).
    """
    B, R = refs.shape
    L = reads.shape[1]
    iota_r = jnp.arange(R + 1, dtype=jnp.int32)
    decay = GAP * iota_r
    M = row_sel.shape[1]
    valid = iota_r[None, :] <= ref_lens[:, None]  # (B, R+1)

    init_col = jnp.zeros((B, R + 1), dtype=jnp.int32)

    def capture(col, j, rows_acc):
        # rows_acc: (B, M, R+1) int32 captured rows
        return jnp.where((row_sel == j)[..., None], col[:, None, :],
                         rows_acc)

    init_rows = capture(init_col, 0,
                        jnp.full((B, M, R + 1), NEG, jnp.int32))

    def step(carry, j):
        prev, rows_acc = carry
        ch = jnp.take_along_axis(reads, (j - 1)[None].repeat(B)[:, None],
                                 axis=1)[:, 0]
        sub = jnp.where(refs == ch[:, None], MATCH, MISMATCH).astype(
            jnp.int32)
        vert0 = (GAP * j) * jnp.ones((B, 1), dtype=jnp.int32)
        cand = jnp.maximum(prev[:, :-1] + sub, prev[:, 1:] + GAP)
        vert = jnp.concatenate([vert0, cand], axis=1)
        col = jax.lax.cummax(vert - decay[None, :], axis=1) + decay[None, :]
        return (col, capture(col, j, rows_acc)), jnp.int32(0)

    js = jnp.arange(1, L + 1, dtype=jnp.int32)
    (_, rows), _ = jax.lax.scan(step, (init_col, init_rows), js)

    masked = jnp.where(valid[:, None, :], rows, NEG)
    rowmax = jnp.max(masked, axis=2)
    rowmax = jnp.where(rowmax >= MIN_SPLIT_SCORE, rowmax, 0)
    tie = (masked == rowmax[..., None]) & (rowmax[..., None]
                                           >= MIN_SPLIT_SCORE)

    W = (R + 1 + 31) // 32
    pad = W * 32 - (R + 1)
    tie_p = jnp.pad(tie, ((0, 0), (0, 0), (0, pad)))
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    packed = jnp.sum(
        tie_p.reshape(B, M, W, 32).astype(jnp.uint32)
        * weights[None, None, None, :], axis=3, dtype=jnp.uint32)
    return rowmax, packed


# candidates per device call: the batch is padded to a whole number of
# chunks so that one executable serves every run with the same (R, L)
# and flank-count bucket (and the persistent compile cache hits)
SCREEN_CHUNK = 16384


def _pow2_at_least(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@jax.jit
def _screen_chunk(uref1, ulen1, uref2r, ulen2, ref_idx, reads, read_lens,
                  min_scores):
    with jax.named_scope("split_dp_screen"):
        L = reads.shape[1]
        # device-side reversal of the padded variable-length reads
        pos = read_lens[:, None] - 1 - jnp.arange(L, dtype=jnp.int32)[None]
        rev = jnp.take_along_axis(reads, jnp.clip(pos, 0, L - 1), axis=1)
        rev = jnp.where(jnp.arange(L, dtype=jnp.int32)[None]
                        < read_lens[:, None], rev, 0)
        rowmax = dp_row_maxima(
            jnp.concatenate([uref1[ref_idx], uref2r[ref_idx]]),
            jnp.concatenate([ulen1[ref_idx], ulen2[ref_idx]]),
            jnp.concatenate([reads, rev]),
            jnp.concatenate([read_lens, read_lens]))
        B = reads.shape[0]
        max_score, _ = combine_split_scores(rowmax[:B], rowmax[B:],
                                            read_lens, min_scores)
        return max_score


_SCREEN_EXECUTABLES: dict = {}


def screen_candidates(uref1, ulen1, uref2r, ulen2, ref_idx, reads,
                      read_lens, min_scores, chunk: int = SCREEN_CHUNK,
                      stats: dict | None = None):
    """Per-candidate max split score (0 = reject) for the split-read
    screen.

    Only the *unique* fusion flanks go to the device (``uref1`` and the
    reversed second flank ``uref2r``, (U, R) uint8, padded to a
    power-of-two row count); ``ref_idx`` (B,) picks each candidate's
    flank pair there.  Reads (B, L) uint8 go up once, chunk by chunk,
    and are reversed on the device; only the (B,) scores come back.
    ``stats``, when given, receives ``compile_s`` (0 when the shape was
    compiled before in this process) and ``chunks``.
    """
    import time

    B = len(ref_idx)
    out = np.zeros(B, np.int32)
    if B == 0:
        return out
    Up = _pow2_at_least(uref1.shape[0], 1024)

    def pad_rows(a, n):
        return np.pad(a, [(0, n - len(a))] + [(0, 0)] * (a.ndim - 1))

    flanks = [jnp.asarray(pad_rows(np.asarray(a, dt), Up)) for a, dt in
              ((uref1, np.uint8), (ulen1, np.int32),
               (uref2r, np.uint8), (ulen2, np.int32))]
    parts = []
    for lo in range(0, B, chunk):
        hi = min(lo + chunk, B)
        parts.append((lo, hi, [
            pad_rows(np.asarray(a[lo:hi], dt), chunk) for a, dt in
            ((ref_idx, np.int32), (reads, np.uint8),
             (read_lens, np.int32), (min_scores, np.int32))]))
    # ahead-of-time compile, timed apart from the run
    key = (tuple(f.shape for f in flanks), parts[0][2][1].shape,
           jax.devices()[0].platform)
    t0 = time.time()
    exe = _SCREEN_EXECUTABLES.get(key)
    if exe is None:
        exe = _screen_chunk.lower(*flanks, *parts[0][2]).compile()
        _SCREEN_EXECUTABLES[key] = exe
    if stats is not None:
        stats["compile_s"] = time.time() - t0
        stats["chunks"] = len(parts)
    pending = [(lo, hi, exe(*flanks, *arrs)) for lo, hi, arrs in parts]
    for lo, hi, scores in pending:
        out[lo:hi] = np.asarray(scores)[:hi - lo]
    return out


def pad_batch(seqs: list[str], width: int) -> tuple[np.ndarray, np.ndarray]:
    """Encode + right-pad a list of sequences to (B, width) uint8."""
    out = np.zeros((len(seqs), width), dtype=np.uint8)
    lens = np.empty(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        b = s.encode()
        if len(b) > width:
            raise ValueError(f"sequence longer than pad width {width}")
        out[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    return out, lens
