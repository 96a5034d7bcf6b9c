"""Fusion discovery pipeline: cluster -> set cover -> split align -> vote.

The in-process equivalent of the reference chain
``clustermatepairs | setcover | get_align_regions | dosplitalign |
sort -n | evalsplitalign`` (``defuse_run.pl:448-542``), producing
byte-identical output files.  With ``use_device`` and a GPU present,
the split-read candidates are screened on the card
(``ops.split_dp_batch.screen_candidates``) before native realignment.
"""

from __future__ import annotations

import os
import pathlib

from ..align.batch_realign import collect_candidates, realign_candidates
from ..align.tasks import (SplitReadRealigner, create_tasks, evaluate_file,
                           read_align_region_pairs)
from ..cluster.discordant import cluster_alignments, write_clusters
from ..cluster.matepair_em import EMParams
from ..cluster.setcover import run_setcover_file
from ..core.exons import ExonRegions
from ..io.fasta import FastaStore
from ..io.sam import iter_compact, iter_sam, load_alignments
from .regions import align_regions_file


def screen_on_device(use_device: bool) -> bool:
    """Whether the split-read screen runs on the device: whenever the
    run uses the device and a GPU is present.  ``DEFUSE_DEVICE_SCREEN``
    = ``off`` / ``force`` overrides the second condition (``force`` runs
    it on whatever device JAX has, the CPU included)."""
    mode = os.environ.get("DEFUSE_DEVICE_SCREEN", "auto")
    if not use_device or mode == "off":
        return False
    if mode == "force":
        return True
    from ..core.devices import gpu_device
    return gpu_device() is not None


def split_tasks(ref_store, exons, fragment_mean, fragment_stddev,
                min_read_length, max_read_length, regions_path):
    """Split-alignment tasks for the fusion regions in ``regions_path``,
    and the realigner that bins their mate regions."""
    tasks = create_tasks(ref_store, ExonRegions.from_file(exons),
                         fragment_mean, fragment_stddev, min_read_length,
                         max_read_length,
                         read_align_region_pairs(str(regions_path)))
    realigner = SplitReadRealigner()
    for task in tasks.values():
        realigner.add_task(task)
    return tasks, realigner


def screen_inputs(driver, flank1s, flank2s, max_read_length):
    """The arguments of ``ops.split_dp_batch.screen_candidates`` for the
    candidates of a native ``RealignDriver``: unique flanks (the second
    reversed), each candidate's flank index, reads, read lengths and
    accept thresholds."""
    import numpy as np

    from ..align.batch_realign import _pad_len
    from ..align.split_dp import accept_threshold
    from ..ops.split_dp_batch import pad_batch

    reads_p, read_lens, fidx = driver.read_matrix(
        _pad_len(max_read_length, 64))
    R = _pad_len(max(max(len(a), len(b))
                     for a, b in zip(flank1s, flank2s)))
    u1p, u1l = pad_batch(flank1s, R)
    u2rp, u2l = pad_batch([s[::-1] for s in flank2s], R)
    min_scores = np.array([accept_threshold(int(n)) for n in read_lens],
                          dtype=np.int32)
    return (u1p, u1l, u2rp, u2l, np.maximum(fidx, 0), reads_p, read_lens,
            min_scores)


def discover_fusions(spanning, improper, fastq1, fastq2, reference, exons,
                     fragment_mean, fragment_stddev, precision,
                     min_cluster_size, min_read_length, max_read_length,
                     outdir, use_device=True, em_mode="auto",
                     gene_models=None, mt_chromosome="MT",
                     dna_concordant_length=2000, dist=None,
                     reads_sources=None):
    import os as _os_t

    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    from ..utils import checks
    from ..utils.profiling import Tracer
    _tracer = Tracer(str(out), "metrics.discover.json")

    def _mark(stage):
        _tracer.mark(f"discover:{stage}")

    checks.check_spanning_file(spanning)
    params = EMParams(fragment_mean, fragment_stddev, precision,
                      min_cluster_size)

    # --- clustering -----------------------------------------------------
    clusters_path = out / "clusters"
    from ..cluster import native
    reads_handle = None
    if native.available() and reads_sources:
        # distributed tail: the per-rank frontends already indexed
        # their own shards — group those stores by global fragment-id
        # base instead of building a whole-library index (a full
        # two-file scan, ~12s at 50M pairs)
        parts = [native.reads_index(f1, f2) for f1, f2, _b in
                 reads_sources]
        if all(p is not None for p in parts):
            reads_handle = native.reads_group(
                parts, [b for _f1, _f2, b in reads_sources])
        if reads_handle is None:
            for p in parts:
                if p is not None:
                    native.reads_free(p)
    if native.available() and reads_handle is None:
        # prefer the deferred .fqi-indexed store (the driver preads only
        # its candidate records); fall back to the eager full parse in
        # native threads, overlapping the clustering stage
        reads_handle = native.reads_index(fastq1, fastq2)
        if reads_handle is None:
            # renamed fastqs without the sidecar index (flows that
            # imported alignments instead of running index_paired_fastq):
            # build the offset index with an IO-bound scan — candidates
            # are <1% of fragments, so pread retrieval beats parsing the
            # whole library into memory by ~30x at the 10M-pair scale.
            # The scan validates every header, so a non-renamed library
            # falls through to the full parse below.
            fqi = out / "reads.fqi"
            try:
                fresh = fqi.exists() and fqi.stat().st_mtime >= max(
                    _os_t.stat(fastq1).st_mtime,
                    _os_t.stat(fastq2).st_mtime)
            except OSError:
                fresh = False
            if fresh or native.build_fqi(fastq1, fastq2, str(fqi)):
                reads_handle = native.reads_index(fastq1, fastq2,
                                                  str(fqi))
        if reads_handle is None:
            reads_handle = native.load_reads_async(fastq1, fastq2)
    native_cluster = em_mode in ("auto", "native") and native.available()
    if dist is not None and dist.n_proc > 1:
        # distributed clustering (defuse_run.pl:448-459 fans clustering
        # per chr-pair across jobs): every rank owns the bin pairs with
        # canonical index ≡ rank (mod n); rank 0 publishes the exact
        # inputs, clusters its share, and interleaves the parts back
        # byte-identically.  The rendezvous (partmeta publish + both
        # barriers) runs UNCONDITIONALLY whenever a DistContext is live
        # — including when this rank routes clustering locally (em_mode
        # or native availability disagreement) — so ranks>0 can never
        # be stranded in the gloo barrier (ADVICE r4 medium); the
        # published ``mode`` tells workers which side they are on.
        import json as _json
        mode = "part" if native_cluster else "local"
        (out / "clusters.partmeta.json").write_text(_json.dumps({
            "mode": mode,
            "frag_mean": float(params.fragment_mean).hex(),
            "frag_std": float(params.fragment_stddev).hex(),
            "precision": float(params.precision).hex(),
            "min_cluster_size": int(params.min_cluster_size),
            "spanning": str(spanning)}))
        dist.barrier("cluster_inputs")
        dist.cluster_inputs_done = True
        if native_cluster:
            native.clustermatepairs_part(
                spanning, out / "clusters.part0",
                out / "clusters.part0.counts", params, 0, dist.n_proc)
        dist.barrier("cluster_parts")
        dist.cluster_parts_done = True
        dist.cluster_rendezvous_done = True
        if native_cluster:
            from ..parallel.shard import merge_cluster_parts
            merge_cluster_parts(
                [out / f"clusters.part{r}" for r in range(dist.n_proc)],
                [out / f"clusters.part{r}.counts"
                 for r in range(dist.n_proc)], clusters_path)
    elif native_cluster:
        # full native file->file driver: parse + bin + filter + EM +
        # emit all in C++ (byte-identical; test_cluster_parity pins it)
        native.clustermatepairs(spanning, clusters_path, params)
    if not native_cluster:
        table = load_alignments(iter_compact(spanning))
        rows = cluster_alignments(table, params, use_device=use_device,
                                  em_mode=em_mode)
        write_clusters(rows, str(clusters_path))

    _mark("cluster")
    checks.check_clusters_file(str(clusters_path), min_cluster_size)
    ref_store = None
    if gene_models is not None:
        # mitochondrial segregation runs before setcover
        # (defuse_run.pl:466-468)
        from ..filters.cluster_filters import segregate_mitochondrial
        ref_store = FastaStore.from_file(reference)
        with open(clusters_path) as fh:
            lines = fh.readlines()
        lines = segregate_mitochondrial(lines, gene_models, mt_chromosome)
        clusters_path.write_text("".join(lines))

    _mark("segregate_mt")
    # --- set cover ------------------------------------------------------
    sc_path = out / "clusters.sc"
    run_setcover_file(str(clusters_path), str(sc_path), min_cluster_size)

    _mark("setcover")
    checks.check_setcover_file(str(clusters_path), str(sc_path))
    if gene_models is not None:
        from ..filters.cluster_filters import apply_post_setcover_filters
        with open(sc_path) as fh:
            lines = fh.readlines()
        lines = apply_post_setcover_filters(
            lines, gene_models, ref_store,
            seq_range=dna_concordant_length,
            min_cluster_size=min_cluster_size)
        sc_path.write_text("".join(lines))

    _mark("post_setcover_filters")
    # --- align regions --------------------------------------------------
    regions_path = out / "clusters.sc.regions"
    align_regions_file(sc_path, regions_path)

    _mark("regions")
    # --- split alignment ------------------------------------------------
    if ref_store is None:
        ref_store = FastaStore.from_file(reference)
    tasks, realigner = split_tasks(ref_store, exons, fragment_mean,
                                   fragment_stddev, min_read_length,
                                   max_read_length, regions_path)

    _mark("tasks_build")
    split_path = out / "splitreads.alignments"
    from ..cluster import native as native_lib
    have_native = native_lib.available()
    if have_native:
        # native driver: fastq + SAM parsing, candidate nomination,
        # realignment and row emission all in C++; the device screen
        # (when enabled) sits between the two phases
        cluster_ids = sorted(tasks)
        flank1s = [tasks[cid].split_align_seq[0] for cid in cluster_ids]
        flank2s = [tasks[cid].split_align_seq[1] for cid in cluster_ids]
        driver = native_lib.RealignDriver(
            improper, reads_handle if reads_handle is not None
            else (fastq1, fastq2), realigner.binned, cluster_ids,
            flank1s, flank2s)
        _mark("realign:driver_build")
        if _os_t.environ.get("DEFUSE_STAGE_TIMING"):
            mx = max((max(len(a), len(b))
                      for a, b in zip(flank1s, flank2s)), default=0)
            print(f"[discover] candidates={driver.n_candidates} "
                  f"clusters={len(cluster_ids)} max_flank={mx}",
                  flush=True)
        survivors = None
        if screen_on_device(use_device) and driver.n_candidates \
                and cluster_ids:
            from ..ops.split_dp_batch import screen_candidates
            inputs = screen_inputs(driver, flank1s, flank2s,
                                   max_read_length)
            _mark("screen:inputs")
            from ..utils.profiling import device_trace
            stats: dict = {}
            with device_trace("split_dp_screen"):
                max_scores = screen_candidates(*inputs, stats=stats)
            _mark("screen:device")
            survivors = max_scores > 0
            import jax
            _tracer.info["screen_device"] = jax.devices()[0].platform
            _tracer.count("screen_candidates", driver.n_candidates)
            _tracer.count("screen_survivors", int(survivors.sum()))
            _tracer.count("screen_compile_s", stats["compile_s"])
        # full realign tail in C++ when possible: emit + sort +
        # breakpoint vote (byte-identical artifacts; falls back to the
        # Python sort/evaluate chain below on failure)
        _sorted_path = out / "splitreads.alignments.sorted"
        _eval_outs = {name: out / f"splitreads.{name}" for name in
                      ("seq", "break", "predalign")}
        _native_eval = driver.emit_eval(
            tasks, cluster_ids, split_path, _sorted_path,
            _eval_outs["seq"], _eval_outs["break"],
            _eval_outs["predalign"], survivors) is not None
        if not _native_eval:
            driver.emit(split_path, survivors)
        _mark("realign:emit")
        driver.close()
        if _native_eval:
            _mark("sort")
            checks.check_split_alignments_sorted(str(_sorted_path))
            _mark("evaluate")
            _tracer.flush()
            return {name: str(path)
                    for name, path in _eval_outs.items()} | {
                "clusters": str(clusters_path), "clusters_sc": str(sc_path),
                "regions": str(regions_path), "split": str(split_path)}
    else:
        realigner.add_reads_fastq(fastq1)
        realigner.add_reads_fastq(fastq2)
        candidates = collect_candidates(realigner, iter_sam(improper))
        from ..ops.split_dp_batch import dp_row_maxima
        split_rows = realign_candidates(realigner, candidates,
                                        dp_row_maxima)
        with open(split_path, "w") as fh:
            for row in split_rows:
                fh.write(row.format() + "\n")

    _mark("realign")
    # --- sort -n equivalent --------------------------------------------
    sorted_path = out / "splitreads.alignments.sorted"
    with open(split_path) as fh:
        lines = fh.readlines()
    lines.sort(key=lambda l: (int(l.split("\t", 1)[0]), l.encode()))
    with open(sorted_path, "w") as fh:
        fh.writelines(lines)

    _mark("sort")
    checks.check_split_alignments_sorted(str(sorted_path))
    # --- evaluate -------------------------------------------------------
    outs = {name: out / f"splitreads.{name}" for name in
            ("seq", "break", "predalign")}
    with open(outs["seq"], "w") as seq_out, \
            open(outs["break"], "w") as break_out, \
            open(outs["predalign"], "w") as pred_out:
        evaluate_file(tasks, str(sorted_path), seq_out, break_out, pred_out)

    _mark("evaluate")
    _tracer.flush()
    return {name: str(path) for name, path in outs.items()} | {
        "clusters": str(clusters_path), "clusters_sc": str(sc_path),
        "regions": str(regions_path), "split": str(split_path)}
