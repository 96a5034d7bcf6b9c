"""Batched candidate verification — device mismatch counting for the
seed-and-extend aligner.

The aligner's verify step compares every candidate placement window
against its read end-to-end (no gaps, bowtie -v model; the ``-k 100 -m
100`` runs at ``alignjob.pl:246-256`` are what this replaces).  On the
device it is gathers and bit operations:

* the reference ships once per index as a **3-bit-per-base plane** — 10
  bases per uint32 word (codes 0..4 incl. N fit in 3 bits, so N==N
  compares equal with no separate N plane), 0.4 bytes/base — a human
  genome+cdna resident set of ~1.6GB;
* per candidate the window's packed words are funnel-shifted out of two
  adjacent reference words (the packing uses bits 0..29, so the shift
  by ``30 - 3*lane`` is branch-free for every lane 0..9), XORed against
  the packed read word, and mismatching bases counted by OR-folding each
  3-bit group to its low bit and ``population_count`` — 10 bases per
  32-bit word instead of one base per int32 element;
* reads ship once per verify call packed the same way; the
  per-candidate read rows are gathered on device by ``read_idx``, so the
  upload carries ~0.4*B*L read bytes + 8 bytes/candidate instead of C*L
  (candidates outnumber reads ~10x);
* only the (C,) int32 mismatch counts return.

Bit-exact contract: identical mismatch counts to the NumPy oracle in
``SeedIndex.verify`` for any codes (including N=4 on either side: N==N
compares equal there, which the 3-bit XOR reproduces exactly).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# 3-bit packing: 10 bases per uint32 word, base i of a word at bits
# [3i, 3i+3).  Bits 30,31 unused so funnel shifts never need a
# shift-by-32 special case.
BASES_PER_WORD = 10
_GROUP_LOW_BITS = 0x09249249  # bits 0,3,6,...,27 — one per base slot
_WORD_MASK = 0x3FFFFFFF       # low 30 bits


def pack_codes3(codes: np.ndarray, block: int = 1 << 22) -> np.ndarray:
    """Pack int8 codes (0..4, N=4) into a 3-bit-per-base uint32 plane:
    10 bases per word in bits 0..29 (zero-padded tail).  Packs
    ``block`` words at a time, so a genome-size plane needs no
    genome-size uint32 temporaries."""
    n = len(codes)
    n_words = (n + BASES_PER_WORD - 1) // BASES_PER_WORD
    packed = np.empty(n_words, np.uint32)
    for w0 in range(0, n_words, block):
        w1 = min(w0 + block, n_words)
        p = np.zeros((w1 - w0) * BASES_PER_WORD, np.int8)
        chunk = codes[w0 * BASES_PER_WORD:w1 * BASES_PER_WORD]
        p[:len(chunk)] = chunk
        packed[w0:w1] = pack_rows3(p.reshape(-1, BASES_PER_WORD))[:, 0]
    return packed


def pack_rows3(codes: np.ndarray) -> np.ndarray:
    """Row-wise 3-bit packing of an (B, L) int8 code matrix into
    (B, ceil(L/10)) uint32 (positions >= L packed as 0)."""
    b, length = codes.shape
    w = (length + BASES_PER_WORD - 1) // BASES_PER_WORD
    p = np.zeros((b, w * BASES_PER_WORD), np.uint32)
    p[:, :length] = codes.astype(np.uint32)
    p = p.reshape(b, w, BASES_PER_WORD)
    packed = np.zeros((b, w), np.uint32)
    for j in range(BASES_PER_WORD):
        packed |= p[:, :, j] << np.uint32(3 * j)
    return packed


@functools.partial(jax.jit, static_argnames=("L",))
def _verify_packed3(ref3, word10, lane10, reads3, read_idx, read_lens, L):
    """Mismatch counts for candidate placements against the 3-bit packed
    reference plane.

    Candidate start positions arrive split as (word10, lane10) =
    (start // 10, start % 10) so every on-device index stays int32
    (word indices cover references up to ~21 Gbp; ``pack_codes3``'s
    caller guards beyond that).

    ref3: (ceil(N/10),) uint32 plane; word10/lane10: (C,) int32;
    reads3: (B, W) uint32 packed reads; read_idx: (C,) int32;
    read_lens: (B,) int32; L: read-matrix base length (static).

    Per word the candidate window is funnel-shifted out of two adjacent
    reference words (the shift by ``30 - 3*lane`` is in [3, 30] —
    branch-free since only bits 0..29 are populated), XORed with the
    packed read word, each 3-bit group OR-folded to its low bit, length-
    masked, and popcounted.
    """
    w = (L + BASES_PER_WORD - 1) // BASES_PER_WORD
    k = jnp.arange(w + 1, dtype=jnp.int32)[None, :]
    idx = jnp.minimum(word10[:, None] + k, ref3.shape[0] - 1)
    g = ref3[idx]                                  # (C, W+1) uint32
    sh = (3 * lane10).astype(jnp.uint32)[:, None]  # 0..27
    lo = g[:, :-1] >> sh
    hi = (g[:, 1:] << (jnp.uint32(30) - sh)) & _WORD_MASK
    win = (lo | hi) & _WORD_MASK                   # (C, W)
    rw = reads3[read_idx]                          # (C, W)
    x = win ^ rw
    t = (x | (x >> 1) | (x >> 2)) & _GROUP_LOW_BITS
    # length mask: word k holds bases [10k, 10k+10); valid count v in
    # [0, 10] -> mask of the low 3v bits (1 << 30 stays in uint32)
    lens = read_lens[read_idx][:, None]
    v = jnp.clip(lens - BASES_PER_WORD
                 * jnp.arange(w, dtype=jnp.int32)[None, :],
                 0, BASES_PER_WORD).astype(jnp.uint32)
    lm = (jnp.uint32(1) << (3 * v)) - jnp.uint32(1)
    counts = jax.lax.population_count(t & lm)
    return jnp.sum(counts, axis=1).astype(jnp.int32)


class DeviceVerifier:
    """verify_fn adapter for ``SeedIndex.verify``: keeps the packed
    reference plane resident on device and batches candidate
    verification."""

    def __init__(self, batch: int = 1 << 17):
        self.batch = batch
        # id(codes) alone is unsafe as a cache key (a GC'd array's address
        # can be reused): hold a strong reference to the host array next to
        # its device buffers and verify identity on hit.  One entry per
        # distinct reference so alternating cdna/genome batches don't
        # re-upload the genome every call.
        self._resident: dict[int, tuple] = {}

    def _device_plane(self, codes):
        key = id(codes)
        entry = self._resident.get(key)
        if entry is None or entry[0] is not codes:
            if len(codes) >= (1 << 31) * BASES_PER_WORD:
                raise NotImplementedError(
                    "3-bit packed verify addresses references < ~21 Gbp; "
                    "shard the reference across indices beyond that")
            entry = (codes, jax.device_put(pack_codes3(np.asarray(codes))))
            self._resident[key] = entry
        return entry[1]

    def __call__(self, codes, cand_pos, reads_codes, read_idx, read_lens):
        n = len(cand_pos)
        ref3 = self._device_plane(codes)
        L = reads_codes.shape[1]
        # out-of-bounds candidates are filtered by the caller afterwards;
        # clip here so the packed gathers stay in range.  Positions split
        # into (word, lane) on the host: device indexing stays int32
        starts = np.clip(np.asarray(cand_pos, np.int64), 0,
                         max(0, len(codes) - 1))
        word10 = (starts // BASES_PER_WORD).astype(np.int32)
        lane10 = (starts % BASES_PER_WORD).astype(np.int32)
        reads_dev = jnp.asarray(pack_rows3(np.asarray(reads_codes)))
        lens_dev = jnp.asarray(read_lens, jnp.int32)
        ridx = np.asarray(read_idx, np.int32)
        out = np.empty(n, dtype=np.int64)
        for lo in range(0, n, self.batch):
            hi = min(lo + self.batch, n)
            out[lo:hi] = np.asarray(_verify_packed3(
                ref3, jnp.asarray(word10[lo:hi]),
                jnp.asarray(lane10[lo:hi]), reads_dev,
                jnp.asarray(ridx[lo:hi]), lens_dev, L))
        return out
