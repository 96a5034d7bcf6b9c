"""Cohort launcher: multi-library fan-out, restartability, merge.

Covers the BASELINE cohort deployment shape (N libraries through the
full pipeline with one shared dataset) at test scale: 3 libraries, one
of them sharing reads with another so the recurrence table has a
2-library gene pair.
"""

import os
import subprocess
import sys

from synthdata import make_dataset, write_dataset, write_genome_fasta, \
    write_gtf, write_repeats

ENV = {"PYTHONPATH": "/root/repo", "PATH": "/usr/bin:/bin",
       "JAX_PLATFORMS": "cpu", "HOME": "/root",
       }


def _dataset(tmp_path):
    ds = make_dataset(seed=7)
    paths = write_dataset(ds, tmp_path)
    gtf = tmp_path / "genes.gtf"
    write_gtf(ds, gtf)
    genome_fa = tmp_path / "genome.fa"
    write_genome_fasta(ds, genome_fa)
    write_repeats(ds, tmp_path / "repeats.regions")
    dataset = tmp_path / "dataset"
    config = tmp_path / "config.txt"
    config.write_text("\n".join([
        f"genome_fasta = {genome_fa}",
        f"gene_models = {gtf}",
        "gene_biotypes = synth",
        "chromosomes = 1,2",
        "span_count_threshold = 3",
        f"repeats_regions = {tmp_path}/repeats.regions",
        "dataset_prefix = $(dataset_directory)/defuse",
        "cdna_regions = $(dataset_prefix).cdna.regions",
        "cdna_fasta = $(dataset_prefix).cdna.fa",
        "exons_fasta = $(dataset_prefix).exons.fa",
        "cds_fasta = $(dataset_prefix).cds.fa",
        "reference_fasta = $(dataset_prefix).reference.fa",
        "rrna_fasta = $(dataset_prefix).rrna.fa",
        "ig_gene_list = $(dataset_prefix).ig.gene.list",
    ]) + "\n")
    proc = subprocess.run(
        [sys.executable, "-m", "defuse_tpu", "create-ref",
         "-c", str(config), "-d", str(dataset)],
        capture_output=True, text=True, env=ENV, cwd="/root/repo")
    assert proc.returncode == 0, proc.stderr
    return config, dataset, paths


def test_cohort_end_to_end(tmp_path):
    config, dataset, paths = _dataset(tmp_path)
    # 3 libraries: A and C share the fusion dataset (recurrence), B too
    # (same synth reads — each library is an independent pipeline run)
    manifest = tmp_path / "cohort.tsv"
    manifest.write_text(
        "# cohort manifest\n" +
        "".join(f"lib{x}\t{paths['fastq1']}\t{paths['fastq2']}\n"
                for x in "ABC"))
    out = tmp_path / "cohort_out"
    proc = subprocess.run(
        [sys.executable, "-m", "defuse_tpu", "cohort",
         "-c", str(config), "-d", str(dataset), "-m", str(manifest),
         "-o", str(out), "-w", "2", "--no-device"],
        capture_output=True, text=True, env=ENV, cwd="/root/repo",
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]

    summary = (out / "cohort_summary.tsv").read_text().splitlines()
    assert summary[0].startswith("library\t")
    assert [ln.split("\t")[0] for ln in summary[1:]] == \
        ["libA", "libB", "libC"]
    assert all(ln.split("\t")[1] == "ok" for ln in summary[1:])

    fusions = (out / "cohort_fusions.tsv").read_text().splitlines()
    assert fusions[0].startswith("library\t")
    libs_seen = {ln.split("\t")[0] for ln in fusions[1:]}
    assert libs_seen == {"libA", "libB", "libC"}

    recurrent = (out / "cohort_recurrent.tsv").read_text().splitlines()
    assert recurrent[0] == "gene1\tgene2\tn_libraries\tlibraries"
    top = recurrent[1].split("\t")
    assert {top[0], top[1]} == {"GA", "GB"}
    assert top[2] == "3"
    assert top[3] == "libA,libB,libC"

    # restartability: rerun must skip all libraries (status cached) and
    # reproduce the merge byte-identically
    fus_bytes = (out / "cohort_fusions.tsv").read_bytes()
    proc = subprocess.run(
        [sys.executable, "-m", "defuse_tpu", "cohort",
         "-c", str(config), "-d", str(dataset), "-m", str(manifest),
         "-o", str(out), "--no-device"],
        capture_output=True, text=True, env=ENV, cwd="/root/repo",
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary2 = (out / "cohort_summary.tsv").read_text().splitlines()
    assert all(ln.split("\t")[1] == "cached" for ln in summary2[1:])
    assert (out / "cohort_fusions.tsv").read_bytes() == fus_bytes


def test_merge_rejects_stale_shards(tmp_path):
    """Stale-shard guard: when a run id is in force, rank 0's merge must
    not accept a shard written by a previous run (observed failure: a
    resumed cohort merged run-1 shards while run-2 ranks were still
    recomputing, breaking cohort_fusions byte-identity)."""
    import pytest

    from defuse_tpu.pipeline.cohort import Library, merge_cohort

    out = tmp_path
    libs = [Library("libA", "", ""), Library("libB", "", "")]
    # rank 0 shard from THIS run, rank 1 shard from a PREVIOUS run
    (out / "cohort_summary.rank0.tsv").write_text(
        "#run_id=run2\nlibA\tok\t0\t1.0\t-\n")
    (out / "cohort_summary.rank1.tsv").write_text(
        "#run_id=run1\nlibB\tok\t0\t1.0\t-\n")
    with pytest.raises(TimeoutError, match="stale"):
        merge_cohort(str(out), 2, libs, timeout_s=0.1, run_id="run2")

    # once rank 1's fresh shard lands, the merge proceeds and the
    # header comment lines never leak into the merged summary
    (out / "cohort_summary.rank1.tsv").write_text(
        "#run_id=run2\nlibB\tok\t0\t1.0\t-\n")
    paths = merge_cohort(str(out), 2, libs, timeout_s=5.0, run_id="run2")
    lines = open(paths["summary"]).read().splitlines()
    assert lines[1:] == ["libA\tok\t0\t1.0\t-", "libB\tok\t0\t1.0\t-"]
    assert not any(ln.startswith("#") for ln in lines)

    # no run id (single-process legacy path): any existing shard is fresh
    paths = merge_cohort(str(out), 2, libs, timeout_s=5.0)
    assert open(paths["summary"]).read().count("\t") >= 8


def test_cohort_two_rank_fanout(tmp_path):
    """Static round-robin ownership across 2 ranks: each rank runs only
    its libraries; rank 0 waits for rank 1's shard and merges."""
    config, dataset, paths = _dataset(tmp_path)
    manifest = tmp_path / "cohort.tsv"
    manifest.write_text(
        "".join(f"lib{x}\t{paths['fastq1']}\t{paths['fastq2']}\n"
                for x in "AB"))
    out = tmp_path / "cohort_out"

    env1 = dict(ENV, DEFUSE_COHORT_RANK="1", DEFUSE_COHORT_NPROCS="2")
    env0 = dict(ENV, DEFUSE_COHORT_RANK="0", DEFUSE_COHORT_NPROCS="2")
    cmd = [sys.executable, "-m", "defuse_tpu", "cohort",
           "-c", str(config), "-d", str(dataset), "-m", str(manifest),
           "-o", str(out), "--no-device"]
    p1 = subprocess.Popen(cmd, env=env1, cwd="/root/repo",
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    p0 = subprocess.Popen(cmd, env=env0, cwd="/root/repo",
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    _, err1 = p1.communicate(timeout=600)
    _, err0 = p0.communicate(timeout=600)
    assert p1.returncode == 0, err1[-3000:]
    assert p0.returncode == 0, err0[-3000:]

    summary = (out / "cohort_summary.tsv").read_text().splitlines()
    assert [ln.split("\t")[0] for ln in summary[1:]] == ["libA", "libB"]
    assert all(ln.split("\t")[1] == "ok" for ln in summary[1:])
    # rank shards exist for both ranks (proof both participated)
    assert (out / "cohort_summary.rank0.tsv").exists()
    assert (out / "cohort_summary.rank1.tsv").exists()
    assert os.path.getsize(out / "cohort_summary.rank0.tsv") > 0
    assert os.path.getsize(out / "cohort_summary.rank1.tsv") > 0
