"""Multi-host launch + artifact merge — the distribution layer.

The reference scales with cmdrunner submitters (SGE/PBS/LSF fork jobs
per fastq shard, ``cmdrunner.pm:161-292``) and merges shard artifacts
with dedicated Perl mergers.  The equivalent here is SPMD: every
host runs the same program over its fastq shard, device compute runs
under one global ``jax.sharding.Mesh`` (XLA collectives), and the
order-sensitive tail stages run replicated from merged host artifacts.

``init_distributed`` wraps ``jax.distributed.initialize`` with
environment-based wiring (JAX_COORDINATOR, JAX_NUM_PROCESSES,
JAX_PROCESS_ID — or single-process when unset).  ``merge_artifacts``
implements the shard-merge contracts (tested single-host in
tests/test_sharding.py; the contracts are associative so host count
does not change results):

- spanning/improper/concordant files: concatenation in shard order
  (fragment ids are disjoint by construction of ``split_fastq``);
- read stats: additive merge via ``stats.readstats.merge_read_stats``;
- clusters: re-cluster per chr-pair partition then renumber
  (``cluster.setcover.merge_clusters`` equivalence with whole-input
  clustering is pinned by tests).
"""

from __future__ import annotations

import os
import pathlib


def init_distributed() -> tuple[int, int]:
    """Initialize multi-host JAX from the environment.

    Returns (process_id, num_processes).  With no coordinator in the
    environment this is a no-op single-process setup, so the same entry
    point serves one host and many.
    """
    coordinator = os.environ.get("JAX_COORDINATOR")
    n_proc = os.environ.get("JAX_NUM_PROCESSES")
    proc_id = os.environ.get("JAX_PROCESS_ID")
    if coordinator and n_proc and proc_id:
        import jax
        if jax.config.jax_platforms == "cpu":
            # CPU multi-process collectives need an explicit backend;
            # gloo ships with jaxlib.  (GPUs use NCCL and ignore this
            # setting.)
            try:
                jax.config.update("jax_cpu_collectives_implementation",
                                  "gloo")
            except Exception:
                pass
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=int(n_proc),
            process_id=int(proc_id))
        return int(proc_id), int(n_proc)
    return 0, 1


class DistContext:
    """Rank handle for the distributed pipeline-tail stages.

    The reference fans the clustering stage per chr-pair across cluster
    jobs (``defuse_run.pl:448-459``); the rebuild partitions the
    canonical bin-pair sequence round-robin across ranks and interleaves
    the outputs back byte-identically (``shard.merge_cluster_parts``).
    Rank 0 runs ``run_pipeline(dist=ctx)``; every other rank runs
    ``cluster_partition_worker(ctx, outdir)`` — the two sides meet at
    named gloo barriers."""

    def __init__(self, pid: int, n_proc: int):
        self.pid = int(pid)
        self.n_proc = int(n_proc)
        # per-barrier progress flags: the abort path must drain exactly
        # the barriers the workers are still waiting on — re-entering a
        # barrier both sides already passed would mismatch the gloo
        # name sequence and hang every rank (ADVICE r4 medium)
        self.cov_inputs_done = False
        self.cov_parts_done = False
        self.cluster_inputs_done = False
        self.cluster_parts_done = False
        # set once rank 0 has drained both clustering barriers; the
        # run_pipeline abort guard uses it to decide whether workers
        # still need a rendezvous on failure (ADVICE r4 medium)
        self.cluster_rendezvous_done = False

    def barrier(self, name: str) -> None:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(f"defuse:{name}")


def abort_cluster_partition(ctx: DistContext, outdir, error) -> None:
    """Rank-0 failure path: publish abort metas and drain exactly the
    rendezvous barriers ranks>0 have not yet passed, so workers blocked
    in ``tail_partition_worker``/``cluster_partition_worker`` wake up,
    see the abort, and exit loudly instead of hanging in gloo forever
    (ADVICE r4 medium).  Consults the per-barrier progress flags — a
    failure BETWEEN the two barriers of a rendezvous must drain only
    the second one.  Called from the ``run_pipeline`` exception
    wrapper."""
    import json

    def _publish(name):
        if outdir is None:
            return
        try:
            out = pathlib.Path(outdir)
            out.mkdir(parents=True, exist_ok=True)
            (out / name).write_text(json.dumps(
                {"mode": "abort", "error": str(error)[:500]}))
        except OSError:
            pass  # workers fall back to the missing-file abort path

    if not ctx.cov_parts_done:
        if not ctx.cov_inputs_done:
            _publish("cov.partmeta.json")
            ctx.barrier("cov_inputs")
            ctx.cov_inputs_done = True
        ctx.barrier("cov_parts")
        ctx.cov_parts_done = True
    if not ctx.cluster_parts_done:
        if not ctx.cluster_inputs_done:
            _publish("clusters.partmeta.json")
            ctx.barrier("cluster_inputs")
            ctx.cluster_inputs_done = True
        ctx.barrier("cluster_parts")
        ctx.cluster_parts_done = True
    ctx.cluster_rendezvous_done = True


def cluster_partition_worker(ctx: DistContext, outdir) -> None:
    """Ranks>0 side of the distributed clustering stage: wait for rank
    0 to publish the partition inputs (merged spanning path + exact EM
    params as float hex), cluster the owned bin-pair partition, and
    rendezvous for the rank-0 merge.

    Aborts loudly (after draining both barriers, so rank 0 is never
    stranded either) when rank 0 published ``mode: abort`` (it failed
    before clustering), ``mode: local`` (it routed clustering locally —
    an em_mode/native-availability disagreement), or no readable
    partmeta at all."""
    import json

    from ..cluster import native
    from ..cluster.matepair_em import EMParams
    out = pathlib.Path(outdir)
    ctx.barrier("cluster_inputs")
    try:
        meta = json.loads((out / "clusters.partmeta.json").read_text())
    except (OSError, ValueError) as e:
        meta = {"mode": "abort", "error": f"partmeta unreadable: {e}"}
    mode = meta.get("mode", "part")
    part_error = None
    if mode == "part":
        try:
            params = EMParams(float.fromhex(meta["frag_mean"]),
                              float.fromhex(meta["frag_std"]),
                              float.fromhex(meta["precision"]),
                              int(meta["min_cluster_size"]))
            native.clustermatepairs_part(
                meta["spanning"], out / f"clusters.part{ctx.pid}",
                out / f"clusters.part{ctx.pid}.counts", params, ctx.pid,
                ctx.n_proc)
        except Exception as e:
            # still drain the merge barrier so rank 0 is not stranded;
            # its merge then fails loudly on the short/missing part file
            part_error = e
    ctx.barrier("cluster_parts")
    ctx.cluster_rendezvous_done = True
    if part_error is not None:
        raise part_error
    if mode != "part":
        raise RuntimeError(
            f"rank 0 did not run distributed clustering (mode={mode}): "
            f"{meta.get('error', 'rank 0 routed clustering locally — '
                        'em_mode/native availability disagree across ranks')}")


def tail_partition_worker(ctx: DistContext, outdir,
                          pair_table=None) -> None:
    """Ranks>0 side of the full distributed pipeline tail: covariance
    sampling over this rank's own pair-table part, then the clustering
    partition (``cluster_partition_worker``).

    The covariance rendezvous mirrors the clustering one: rank 0
    publishes ``cov.partmeta.json`` (mode ``part``/``skip``/``abort``
    plus the exact sampling parameters) before the ``cov_inputs``
    barrier; in ``part`` mode this rank scans its OWN part table into a
    binary COVBN001 sample part (``cov.part<pid>.covbin``), which rank
    0 merges in rank order — bit-identical to the single-process fused
    merge because the concatenated sample sequence equals one scan of
    the concatenated table.  Both barriers are always drained so no
    rank can strand another; a scan failure surfaces after the
    clustering rendezvous (rank 0 fails loudly on the missing part)."""
    import json

    from ..cluster import native
    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    ctx.barrier("cov_inputs")
    try:
        meta = json.loads((out / "cov.partmeta.json").read_text())
    except (OSError, ValueError) as e:
        meta = {"mode": "abort", "error": f"cov partmeta unreadable: {e}"}
    cov_error = None
    if meta.get("mode") == "part" and pair_table:
        try:
            from ..core.exons import ExonRegions
            from ..stats.calccov import sample_positions
            er = ExonRegions.from_file(meta["cdna_regions"])
            ref_index, positions = sample_positions(
                er, float.fromhex(meta["density"]), bool(meta["multi"]))
            names = [""] * len(ref_index)
            for tid, idx in ref_index.items():
                names[idx] = tid
            rc = native.calccov_tbl(
                pair_table, names, [r for r, _p in positions],
                [p for _r, p in positions],
                trim_length=int(meta["trim"]), anchor=int(meta["anchor"]),
                span_path=None, pos_path=None, min_path=None,
                bin_path=out / f"cov.part{ctx.pid}.covbin")
            if rc is None:
                raise RuntimeError("native calccov unavailable on "
                                   f"rank {ctx.pid}")
        except Exception as e:
            cov_error = e
    ctx.barrier("cov_parts")
    if meta.get("mode") == "part" and pair_table and cov_error is None \
            and 1 <= ctx.pid <= 2:
        # delegated kind merge (kind == this rank): every rank's part
        # is on disk after the barrier; deliver the merged (mean, cov)
        # by atomic rename — rank 0 polls and falls back to merging
        # this kind itself if nothing arrives
        try:
            parts = [out / f"cov.part{r}.covbin"
                     for r in range(ctx.n_proc)]
            try:
                mc = native.cov_merge_bin_kind(parts, ctx.pid)
            except ValueError:
                mc = "insufficient"
            if mc is not None:
                tmp = out / f"cov.kind{ctx.pid}.merged.tsv.tmp"
                tmp.write_text(
                    "insufficient\n" if mc == "insufficient"
                    else f"{mc[0].hex()}\t{mc[1].hex()}\n")
                tmp.rename(out / f"cov.kind{ctx.pid}.merged.tsv")
        except Exception:
            pass  # rank 0 merges this kind itself on poll timeout
    cluster_partition_worker(ctx, outdir)
    if cov_error is not None:
        raise cov_error


def global_mesh(data_axis: str = "data", inst_axis: str = "inst",
                inst_size: int = 1):
    """Global device mesh over all hosts' devices: outer data-parallel
    axis, inner instance axis for batched-EM/DP sharding (the dryrun in
    ``__graft_entry__.py`` exercises the same layout)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices())
    n = devices.size
    if n % inst_size:
        raise ValueError(f"{n} devices not divisible by inst={inst_size}")
    return Mesh(devices.reshape(n // inst_size, inst_size),
                (data_axis, inst_axis))


def merge_artifacts(shard_dirs, outdir, filenames=("spanning.compact",
                                                   "improper.sam")):
    """Concatenate per-shard alignment artifacts in shard order (shard
    fragment-id spaces are disjoint; see ``parallel.shard.split_fastq``).
    Returns {filename: merged_path}."""
    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    merged = {}
    for name in filenames:
        dst = out / name
        with open(dst, "wb") as fh:
            for shard in shard_dirs:
                src = pathlib.Path(shard) / name
                if src.exists():
                    fh.write(src.read_bytes())
        merged[name] = str(dst)
    return merged


def merge_stats_files(paths, out_path):
    """Additive merge of per-shard read-stats files
    (``merge_read_stats.pl`` contract; associative — the same math runs
    as a ``psum`` on device in the SPMD path)."""
    from ..stats.readstats import ReadStats, merge_read_stats

    stats = []
    for path in paths:
        with open(path) as fh:
            fh.readline()  # header
            f = fh.readline().rstrip("\n").split("\t")
        stats.append(ReadStats(
            int(f[0]), float(f[1]), float(f[2]), int(f[3]), int(f[4]),
            tuple(int(x) for x in f[5].split(",") if x)))
    merged = merge_read_stats(stats)
    with open(out_path, "w") as fh:
        fh.write(merged.format())
    return out_path


MAX_READLEN_GATHER = 512  # readlength bitmask width for the gather


def _allgather_bits(arr):
    """``process_allgather`` that survives ``jax_enable_x64=False``:
    without x64, jax silently truncates float64 -> float32 and
    uint64 -> uint32 on the way into the gather (measured: a 50M-pair
    run's exact fragment-length sums came back with float32 precision
    and an empty readlength mask, zeroing every downstream flank).
    64-bit payloads are therefore gathered as uint32 BIT VIEWS (32-bit
    dtypes are never truncated) and re-viewed after.  Returns shape
    (n_proc, len(arr)) in the original dtype."""
    import jax
    import numpy as np
    from jax.experimental import multihost_utils

    a = np.ascontiguousarray(arr)
    view = a.view(np.uint32)
    g = np.asarray(multihost_utils.process_allgather(view))
    if jax.process_count() == 1:
        g = g.reshape(1, -1)
    return np.ascontiguousarray(g).view(a.dtype)


def allgather_read_stats(local):
    """Cross-process read-stats merge over the live distributed runtime.

    Each process contributes its shard's ``ReadStats`` packed as fixed
    vectors (count/mean/stddev + a readlength bitmask); the gather runs
    through the jax coordination service, and the exact
    ``merge_read_stats`` math (``merge_read_stats.pl`` contract) is then
    applied to the per-process stats in process order — numerically
    identical to the sequential shard merge.  Readlengths above
    ``MAX_READLEN_GATHER`` degrade to the (min, max) pair, mirroring
    the file-based merge's fallback.
    """
    import numpy as np

    from ..stats.readstats import ReadStats, merge_read_stats

    scalars = np.array([float(local.frag_count), local.fraglength_mean,
                        local.fraglength_stddev,
                        float(local.readlength_min),
                        float(local.readlength_max)], dtype=np.float64)
    mask = np.zeros(MAX_READLEN_GATHER // 64, dtype=np.uint64)
    overflow = False
    for ln in (local.readlengths
               or (local.readlength_min, local.readlength_max)):
        if 0 < ln < MAX_READLEN_GATHER:
            mask[ln // 64] |= np.uint64(1) << np.uint64(ln % 64)
        elif ln:
            overflow = True
    g_scalars = _allgather_bits(scalars)
    g_mask = _allgather_bits(mask)
    g_over = _allgather_bits(np.array([1.0 if overflow else 0.0]))
    stats = []
    for p in range(g_scalars.shape[0]):
        s = g_scalars[p]
        lengths = [ln for ln in range(1, MAX_READLEN_GATHER)
                   if g_mask[p][ln // 64] >> np.uint64(ln % 64)
                   & np.uint64(1)]
        if g_over[p][0]:
            lengths = []  # degrade to (min, max) exactly like the
            # file merge with no readlengths list
        stats.append(ReadStats(int(s[0]), float(s[1]), float(s[2]),
                               int(s[3]), int(s[4]), tuple(lengths)))
    return merge_read_stats(stats)


def allgather_read_stats_sums(n, s, ss, readlengths):
    """Exact cross-process read-stats merge from RAW SUMS (each rank's
    ``native.read_stats_tbl_sums`` over its own pair-table part).

    Fragment-length totals are exact integers carried in doubles (they
    stay far below 2^53), so adding the per-rank sums in rank order and
    applying the shared final formula (``stats_from_sums``) is
    BIT-IDENTICAL to a single scan of the concatenated table — unlike
    ``allgather_read_stats``, whose mean/stddev reconstruction can
    differ in the last ulp.  The distributed pipeline passes the result
    straight into ``run_pipeline(read_stats=...)``."""
    import numpy as np

    from ..stats.readstats import stats_from_sums

    scalars = np.array([float(n), float(s), float(ss)],
                       dtype=np.float64)
    mask = np.zeros(MAX_READLEN_GATHER // 64, dtype=np.uint64)
    big = sorted(ln for ln in readlengths
                 if not 0 <= ln < MAX_READLEN_GATHER)
    if big:
        raise ValueError(f"read lengths beyond the gather bitmask: "
                         f"{big[:5]}")
    for ln in readlengths:
        mask[ln // 64] |= np.uint64(1) << np.uint64(ln % 64)
    g_scalars = _allgather_bits(scalars)
    g_mask = _allgather_bits(mask)
    tn = ts = tss = 0.0
    for p in range(g_scalars.shape[0]):
        tn += float(g_scalars[p][0])
        ts += float(g_scalars[p][1])
        tss += float(g_scalars[p][2])
    m = np.bitwise_or.reduce(g_mask, axis=0)
    lengths = [ln for ln in range(MAX_READLEN_GATHER)
               if m[ln // 64] >> np.uint64(ln % 64) & np.uint64(1)]
    return stats_from_sums(tn, ts, tss, lengths)
