"""Batched device EM vs the exact host oracle — decision equivalence.

The device path uses parallel float reductions, so float trajectories are
not bit-identical to the oracle; the contract is identical *memberships*
(which integer outputs downstream consume).  Random mixture instances and
degenerate shapes are checked.
"""

import numpy as np
import pytest

from defuse_tpu.cluster.matepair_em import EMParams, MatePairEM
from defuse_tpu.cluster.matepair_em_batch import prepare_batch, run_batch

PARAMS = EMParams(fragment_mean=200.0, fragment_stddev=20.0,
                  precision=0.95, min_cluster_size=3)


def _instance(rng, n_clusters, n_points):
    """Simulated bin-pair: clusters of mate pairs around breakpoints."""
    xs, ys, us = [], [], []
    for _ in range(n_clusters):
        ax = rng.integers(1000, 200000)
        by = rng.integers(1000, 200000)
        for _ in range(n_points // n_clusters):
            flen = int(rng.normal(200, 20))
            left = rng.integers(20, flen - 70)
            xs.append(ax - left)
            ys.append(by - (flen - left - 100))
            us.append(200.0 - 100.0)
    return (np.array(xs, float), np.array(ys, float), np.array(us, float))


def test_membership_agreement():
    rng = np.random.default_rng(0)
    instances = []
    for _ in range(12):
        instances.append(_instance(rng, rng.integers(1, 4), 24))
    # degenerate: minimal sizes
    instances.append((np.array([100.0, 101.0, 102.0]),
                      np.array([500.0, 501.0, 499.0]),
                      np.array([100.0, 100.0, 100.0])))

    oracle = MatePairEM(PARAMS)
    expected = [oracle.do_clustering(*inst) for inst in instances]

    batch = prepare_batch(instances, PARAMS)
    got = run_batch(batch, PARAMS)

    n_match = 0
    for i, exp in enumerate(expected):
        exp_sets = [sorted(c) for c in exp]
        got_sets = [sorted(c) for c in got.get(i, [])]
        if exp_sets == got_sets:
            n_match += 1
        else:
            print(f"instance {i}: oracle {exp_sets} vs device {got_sets}")
    # allow at most one boundary-case disagreement across the suite
    assert n_match >= len(instances) - 1, \
        f"only {n_match}/{len(instances)} instances agree"


def test_chunked_run_batch_identical():
    """The GPU slab-chunked path (uniform slabs, last one padded by
    repeating row 0) must be bit-identical to the unchunked path — on
    CPU the default is unchunked, so this exercises the chunk logic
    explicitly with a chunk smaller than the batch."""
    rng = np.random.default_rng(7)
    instances = [_instance(rng, rng.integers(1, 4), 24) for _ in range(9)]
    batch = prepare_batch(instances, PARAMS)
    assert len(batch.n) > 7  # several slabs incl. a padded tail
    want = run_batch(batch, PARAMS, chunk_rows=0)
    got = run_batch(batch, PARAMS, chunk_rows=7)
    assert want.keys() == got.keys()
    for inst in want:
        assert [sorted(c) for c in want[inst]] == \
            [sorted(c) for c in got[inst]], inst


def test_exact_resolve_f32_matches_oracle():
    """Hybrid device/host mode: f32 device EM + host re-solve of
    margin-ambiguous instances must EXACTLY match the f64 oracle.  This
    is the production contract without x64 (run_batch defaults
    exact_resolve=on for f32)."""
    rng = np.random.default_rng(21)
    instances = [_instance(rng, rng.integers(1, 4), 24) for _ in range(14)]
    instances.append((np.array([100.0, 101.0, 102.0]),
                      np.array([500.0, 501.0, 499.0]),
                      np.array([100.0, 100.0, 100.0])))
    oracle = MatePairEM(PARAMS)
    expected = [oracle.do_clustering(*inst) for inst in instances]
    batch = prepare_batch(instances, PARAMS)
    got = run_batch(batch, PARAMS, dtype=np.float32)  # exact_resolve auto
    from defuse_tpu.cluster.matepair_em_batch import LAST_SELECT_STATS
    assert LAST_SELECT_STATS["exact_resolve"]
    for i, exp in enumerate(expected):
        assert [sorted(c) for c in exp] == \
            [sorted(c) for c in got.get(i, [])], i


def test_fixture_instances_agree(ref_binaries, tmp_path):
    """Memberships agree on every bin-pair instance arising from the
    bundled discordant SAM."""
    from helpers import TEST_SAM, sam_to_compact
    from defuse_tpu.io.sam import iter_compact, load_alignments
    from defuse_tpu.cluster import discordant

    compact = tmp_path / "disc.compact"
    sam_to_compact(TEST_SAM, compact)
    table = load_alignments(iter_compact(compact))

    # capture EM instances by monkeypatching the EM entry point
    captured = []
    orig = MatePairEM.do_clustering

    def capture(self, x, y, u):
        captured.append((np.array(x), np.array(y), np.array(u)))
        return orig(self, x, y, u)

    MatePairEM.do_clustering = capture
    try:
        # force the oracle path so instances are observable
        discordant.cluster_alignments(table, PARAMS, em_mode="oracle")
    finally:
        MatePairEM.do_clustering = orig

    assert captured, "no EM instances captured"
    oracle = MatePairEM(PARAMS)
    expected = [oracle.do_clustering(*inst) for inst in captured]
    batch = prepare_batch(captured, PARAMS)
    got = run_batch(batch, PARAMS)
    mismatches = 0
    for i, exp in enumerate(expected):
        if [sorted(c) for c in exp] != [sorted(c) for c in got.get(i, [])]:
            mismatches += 1
    assert mismatches == 0, f"{mismatches}/{len(expected)} instances differ"


def test_native_seed_batch_matches_python():
    """prepare_batch's threaded native KKZ+AS136 seeding (the ~7s host
    hotspot on the bench workload) must produce R0 BIT-IDENTICAL to the
    per-row Python _seed — including the uniform fallbacks (k==1, k==n,
    degenerate geometry)."""
    import unittest.mock as um

    from defuse_tpu.cluster import matepair_em_batch as mb
    from defuse_tpu.cluster import native

    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(11)
    instances = [_instance(rng, rng.integers(1, 4), 24)
                 for _ in range(20)]
    # degenerate geometry: one distinct point repeated (KKZ fails)
    instances.append((np.full(8, 5.0), np.full(8, 7.0),
                      np.full(8, 100.0)))
    with um.patch.object(mb, "_seed",
                         side_effect=AssertionError("python _seed ran")):
        b_native = mb.prepare_batch(instances, PARAMS)
    with um.patch.object(native, "available", lambda: False):
        b_py = mb.prepare_batch(instances, PARAMS)
    assert len(b_native.n) > 64  # native path engaged (size gate)
    assert np.array_equal(b_native.r0, b_py.r0)


def test_exact_resolve_native_and_oracle_identical():
    """select_memberships' drift-ambiguous re-solves batch through the
    native C++ solver when built (the per-instance Python re-solves were
    ~19s of the 22s warm hybrid wall); the answer must be identical to
    the Python-oracle resolve path."""
    import unittest.mock as um

    from defuse_tpu.cluster import matepair_em_batch as mb
    from defuse_tpu.cluster import native

    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(33)
    instances = [_instance(rng, rng.integers(1, 4), 24)
                 for _ in range(10)]
    batch = prepare_batch(instances, PARAMS)
    via_native = run_batch(batch, PARAMS, dtype=np.float32)
    assert mb.LAST_SELECT_STATS["exact_resolve"]
    with um.patch.object(native, "available", lambda: False):
        via_oracle = run_batch(batch, PARAMS, dtype=np.float32)
    assert via_native.keys() == via_oracle.keys()
    for inst in via_native:
        assert [sorted(c) for c in via_native[inst]] == \
            [sorted(c) for c in via_oracle[inst]], inst
