#!/usr/bin/env python
"""BASELINE cohort deployment shape (VERDICT r3 item 6): 8 libraries
fanned across 4 real rank processes, restart-resume exercised, and the
gene-pair recurrence table checked against the hand-computed
expectation.  Writes COHORT_r4.md.

Library composition (one shared genome/reference; per-library read sets
differ in which fusion they carry):

  lib1..lib4, lib8 : GA-GB   (5 libraries)
  lib5, lib6       : GB-GD   (2 libraries)
  lib7             : GA-GD   (1 library)

Expected recurrence: GA-GB x5, GB-GD x2, GA-GD x1 — descending order in
cohort_recurrent.tsv.  (Pairs involving GC are avoided: its fusions
legitimately classify below the probability threshold on this tiny
synthetic feature set — adjacent=N + interchromosomal=Y lands in a
low-probability classifier leaf.)

Usage: python scripts_dev/cohort_bench.py [workdir]
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

ENV = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
       "JAX_PLATFORMS": "cpu", "HOME": "/root",
       }

PAIRS = {  # library -> (fusion transcripts, gene names)
    "lib1": ("TA", "TB"), "lib2": ("TA", "TB"), "lib3": ("TA", "TB"),
    "lib4": ("TA", "TB"), "lib5": ("TB", "TD"), "lib6": ("TB", "TD"),
    "lib7": ("TA", "TD"), "lib8": ("TA", "TB"),
}
GENE_OF = {"TA": "GA", "TB": "GB", "TC": "GC", "TD": "GD"}
N_RANKS = 4


def build(tmp):
    from synthdata import make_dataset, write_dataset, \
        write_genome_fasta, write_gtf, write_repeats
    libs = {}
    shared = None
    for i, (name, pair) in enumerate(sorted(PAIRS.items())):
        # same seed -> same genome/genes for every library; read seeds
        # vary via n_fusion_frags jitter so libraries are not clones
        # >=242 fusion fragments: below that the tiny synthetic feature
        # vectors step across classifier leaves unpredictably (the ada
        # model is a step function of splitr support at this scale)
        ds = make_dataset(seed=7, fusion_pair=pair,
                          n_fusion_frags=242 + 7 * i,
                          n_background_frags=60 + 5 * i)
        d = tmp / name
        paths = write_dataset(ds, d)
        libs[name] = paths
        if shared is None:
            gtf = tmp / "genes.gtf"
            write_gtf(ds, gtf)
            genome_fa = tmp / "genome.fa"
            write_genome_fasta(ds, genome_fa)
            write_repeats(ds, tmp / "repeats.regions")
            shared = (gtf, genome_fa)
    gtf, genome_fa = shared
    config = tmp / "config.txt"
    config.write_text("\n".join([
        f"genome_fasta = {genome_fa}",
        f"gene_models = {gtf}",
        "gene_biotypes = synth",
        "chromosomes = 1,2",
        "span_count_threshold = 3",
        f"repeats_regions = {tmp}/repeats.regions",
        "dataset_prefix = $(dataset_directory)/defuse",
        "cdna_regions = $(dataset_prefix).cdna.regions",
        "cdna_fasta = $(dataset_prefix).cdna.fa",
        "exons_fasta = $(dataset_prefix).exons.fa",
        "cds_fasta = $(dataset_prefix).cds.fa",
        "reference_fasta = $(dataset_prefix).reference.fa",
        "rrna_fasta = $(dataset_prefix).rrna.fa",
        "ig_gene_list = $(dataset_prefix).ig.gene.list",
    ]) + "\n")
    dataset = tmp / "dataset"
    proc = subprocess.run(
        [sys.executable, "-m", "defuse_tpu", "create-ref",
         "-c", str(config), "-d", str(dataset)],
        capture_output=True, text=True, env=ENV, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    manifest = tmp / "cohort.tsv"
    manifest.write_text("".join(
        f"{name}\t{libs[name]['fastq1']}\t{libs[name]['fastq2']}\n"
        for name in sorted(PAIRS)))
    return config, dataset, manifest


def launch_ranks(config, dataset, manifest, out, n_ranks=N_RANKS):
    procs = []
    t0 = time.time()
    run_id = str(time.time_ns())  # shared across ranks: stale-shard guard
    for r in range(n_ranks):
        env = dict(ENV)
        env.update({"DEFUSE_COHORT_RANK": str(r),
                    "DEFUSE_COHORT_NPROCS": str(n_ranks),
                    "DEFUSE_COHORT_RUN_ID": run_id})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "defuse_tpu", "cohort",
             "-c", str(config), "-d", str(dataset), "-m", str(manifest),
             "-o", str(out), "-w", "2", "--no-device"],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    logs = []
    for r, p in enumerate(procs):
        stdout, stderr = p.communicate(timeout=1800)
        logs.append((r, p.returncode, stdout, stderr))
        assert p.returncode == 0, f"rank {r}: {stderr[-2000:]}"
    return time.time() - t0, logs


def main(workdir=None):
    tmp = pathlib.Path(workdir) if workdir else pathlib.Path(
        tempfile.mkdtemp(prefix="defuse_cohort_"))
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    config, dataset, manifest = build(tmp)
    t_build = time.time() - t0

    out = tmp / "cohort_out"
    shutil.rmtree(out, ignore_errors=True)
    wall_cold, _ = launch_ranks(config, dataset, manifest, out)

    summary = (out / "cohort_summary.tsv").read_text().splitlines()
    statuses = {ln.split("\t")[0]: ln.split("\t")[1]
                for ln in summary[1:]}
    assert set(statuses) == set(PAIRS), statuses
    assert all(v == "ok" for v in statuses.values()), statuses

    recurrent = (out / "cohort_recurrent.tsv").read_text().splitlines()
    rec_rows = [ln.split("\t") for ln in recurrent[1:]]
    got = {frozenset((r[0], r[1])): (int(r[2]), r[3])
           for r in rec_rows}
    expect = {
        frozenset(("GA", "GB")): (5, "lib1,lib2,lib3,lib4,lib8"),
        frozenset(("GB", "GD")): (2, "lib5,lib6"),
        frozenset(("GA", "GD")): (1, "lib7"),
    }
    rec_ok = all(got.get(k) == v for k, v in expect.items())
    order_ok = [int(r[2]) for r in rec_rows] == \
        sorted((int(r[2]) for r in rec_rows), reverse=True)

    # restart-resume: clobber one library's terminal artifact and the
    # merge outputs; rerun — 7 libraries must report cached, the one
    # recomputes, the merge reproduces byte-identically
    fus_bytes = (out / "cohort_fusions.tsv").read_bytes()
    victim = out / "lib5" / "results.filtered.tsv"
    victim.unlink()
    wall_resume, _ = launch_ranks(config, dataset, manifest, out)
    summary2 = (out / "cohort_summary.tsv").read_text().splitlines()
    statuses2 = {ln.split("\t")[0]: ln.split("\t")[1]
                 for ln in summary2[1:]}
    cached = sum(1 for v in statuses2.values() if v == "cached")
    resume_ok = cached == 7 and statuses2["lib5"] == "ok"
    merge_identical = (out / "cohort_fusions.tsv").read_bytes() \
        == fus_bytes

    report = {
        "n_libraries": len(PAIRS), "n_ranks": N_RANKS,
        "build_s": round(t_build, 1),
        "cohort_wall_cold_s": round(wall_cold, 1),
        "cohort_wall_resume_s": round(wall_resume, 1),
        "statuses": statuses, "recurrence_ok": rec_ok,
        "recurrence_order_ok": order_ok,
        "resume_cached_7_of_8": resume_ok,
        "resume_merge_byte_identical": merge_identical,
        "recurrent_rows": rec_rows,
    }
    print(json.dumps(report), flush=True)

    md = REPO / "COHORT_r4.md"
    md.write_text(
        "# 8-library cohort at the BASELINE deployment shape (round 4)"
        "\n\nBASELINE config 5 names an 8+ library cohort on a v5p pod;"
        " the pod cannot exist here, but the contract can: 8 libraries"
        f" fanned across {N_RANKS} real rank processes"
        " (DEFUSE_COHORT_RANK/NPROCS static round-robin, 2 concurrent"
        " library subprocesses per rank), one shared create-ref"
        " dataset, rank-0 merge.\n\n"
        "Library composition (one genome; per-library fusion content"
        " differs):\n\n"
        "| libraries | fusion |\n|---|---|\n"
        "| lib1-lib4, lib8 | GA-GB |\n| lib5, lib6 | GB-GD |\n"
        "| lib7 | GA-GD |\n\n"
        "| metric | value |\n|---|---|\n" +
        "".join(f"| {k} | {json.dumps(v)} |\n" for k, v in report.items()
                if k not in ("statuses", "recurrent_rows")) +
        "\nRecurrence table (cohort_recurrent.tsv) vs hand-computed"
        " expectation — GA-GB x5 (lib1,lib2,lib3,lib4,lib8),"
        " GB-GD x2 (lib5,lib6), GA-GD x1 (lib7): "
        f"{'MATCH' if rec_ok and order_ok else 'MISMATCH'}\n\n"
        "Restart-resume: lib5's results.filtered.tsv deleted, all 4"
        " ranks relaunched — 7/8 libraries reported `cached`, lib5"
        " recomputed, cohort_fusions.tsv byte-identical: "
        f"{resume_ok and merge_identical}\n\n"
        "Generated by scripts_dev/cohort_bench.py.\n")
    print(f"wrote {md}")
    return report


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
