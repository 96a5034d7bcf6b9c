"""The split-read screen (``ops/split_dp_batch``) on the CPU: the DP row
maxima against the exact host oracle across edge shapes, the batched
screen against the per-pair XLA path, and the fixed-chunk padding."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from defuse_tpu.align.split_dp import (MIN_SPLIT_SCORE, SplitReadAligner,
                                       accept_threshold, fill_matrix)
from defuse_tpu.ops.split_dp_batch import (combine_split_scores,
                                           dp_row_maxima, pad_batch,
                                           screen_candidates)


def _rand_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


# (R, L): reference widths at and around 128-column boundaries, short
# and long reads, and the 101/151 bp read lengths of current libraries
@pytest.mark.parametrize("R,L", [
    (60, 24), (90, 24), (100, 24), (130, 64), (128, 64), (257, 64),
    (384, 64), (300, 101), (400, 151)])
def test_row_maxima_matches_fill_matrix(R, L):
    rng = random.Random(R * 1000 + L)
    refs, reads = [], []
    for _ in range(8):
        refs.append(_rand_seq(rng, rng.randint(max(1, R // 2), R)))
        n = rng.randint(max(1, L // 2), L)
        if rng.random() < 0.5 and len(refs[-1]) >= n:
            # a read that aligns, so that rows reach MIN_SPLIT_SCORE
            p = rng.randrange(len(refs[-1]) - n + 1)
            reads.append(refs[-1][p:p + n])
        else:
            reads.append(_rand_seq(rng, n))
    refs_p, ref_lens = pad_batch(refs, R)
    reads_p, read_lens = pad_batch(reads, L)
    rowmax = np.asarray(dp_row_maxima(refs_p, ref_lens, reads_p,
                                      read_lens))
    assert rowmax.max() >= MIN_SPLIT_SCORE
    for b, (ref, read) in enumerate(zip(refs, reads)):
        m = fill_matrix(ref, read).max(axis=0)
        want = np.where(m >= MIN_SPLIT_SCORE, m, 0)
        assert (rowmax[b, :len(read) + 1] == want).all(), b
        assert (rowmax[b, len(read) + 1:] == 0).all(), b


def _screen_case(seed, n_flanks=5, n_cand=40, read_len=24):
    rng = random.Random(seed)
    uref1 = [_rand_seq(rng, rng.randint(40, 90)) for _ in range(n_flanks)]
    uref2 = [_rand_seq(rng, rng.randint(40, 90)) for _ in range(n_flanks)]
    reads, idx = [], []
    for i in range(n_cand):
        k = rng.randrange(n_flanks)
        idx.append(k)
        if i % 3 == 0:
            half = rng.randrange(8, 16)
            reads.append(uref1[k][-half:] + uref2[k][:read_len - half])
        else:
            reads.append(_rand_seq(rng, read_len))
    u1p, u1l = pad_batch(uref1, 128)
    u2p, u2l = pad_batch([s[::-1] for s in uref2], 128)
    rp, rl = pad_batch(reads, read_len)
    mins = np.array([accept_threshold(len(r)) for r in reads], np.int32)
    return (u1p, u1l, u2p, u2l, np.array(idx, np.int32), rp, rl,
            mins), uref1, uref2, reads


def test_screen_matches_per_pair_path():
    """screen_candidates == per-candidate flank rows through
    dp_row_maxima + combine, and == the host aligner's max split
    score."""
    args, uref1, uref2, reads = _screen_case(3)
    u1p, u1l, u2p, u2l, idx, rp, rl, mins = args
    got = screen_candidates(*args)

    rm1 = dp_row_maxima(u1p[idx], u1l[idx], rp, rl)
    rev = np.zeros_like(rp)
    for i, r in enumerate(reads):
        rev[i, :len(r)] = rp[i, :len(r)][::-1]
    rm2 = dp_row_maxima(u2p[idx], u2l[idx], rev, rl)
    want, _ = combine_split_scores(jnp.asarray(rm1), jnp.asarray(rm2),
                                   jnp.asarray(rl), jnp.asarray(mins))
    assert (got == np.asarray(want)).all()
    assert got.max() > 0, "no candidate passed — screen untested"
    host = [SplitReadAligner(uref1[k], uref2[k]).max_score(r, int(m))
            for k, r, m in zip(idx, reads, mins)]
    assert got.tolist() == host


def test_screen_chunk_padding_invariant():
    """B not a multiple of the chunk: the padded tail rows change
    nothing, whatever the chunk."""
    args, *_ = _screen_case(8, n_cand=37)
    stats = {}
    whole = screen_candidates(*args, chunk=64, stats=stats)
    assert stats["chunks"] == 1
    for chunk in (5, 16, 36):
        stats = {}
        got = screen_candidates(*args, chunk=chunk, stats=stats)
        assert stats["chunks"] == -(-37 // chunk)
        assert (got == whole).all(), chunk
    assert whole.max() > 0
    empty = tuple(a[:0] if i >= 4 else a for i, a in enumerate(args))
    assert screen_candidates(*empty).shape == (0,)
