"""The in-process discovery pipeline reproduces the golden chain
byte-for-byte, including the batched realigner path."""

import subprocess

import pytest

from defuse_tpu.pipeline.discover import discover_fusions

from synthdata import make_dataset, write_dataset
from test_split_chain_parity import (MEAN, STD, PREC, MINCL, MINREAD,
                                     MAXREAD, _sort_n)


@pytest.mark.parametrize("use_device,em_mode", [
    (False, "oracle"), (True, "device"), (False, "native")])
def test_discover_matches_golden(ref_binaries, tmp_path, use_device,
                                 em_mode, monkeypatch):
    if em_mode == "native":
        from defuse_tpu.cluster import native
        if not native.available():
            pytest.skip("native library not built")
    if use_device:
        # keep the device screen on under the CPU test backend (it runs
        # only where a GPU is found otherwise)
        monkeypatch.setenv("DEFUSE_DEVICE_SCREEN", "force")
    ds = make_dataset(seed=31, fusion_pair=("TA", "TD"), break_a=2400,
                      break_b=1000)
    paths = write_dataset(ds, tmp_path)

    outs = discover_fusions(
        spanning=str(paths["spanning"]), improper=str(paths["improper"]),
        fastq1=str(paths["fastq1"]), fastq2=str(paths["fastq2"]),
        reference=str(paths["reference"]), exons=str(paths["exons"]),
        fragment_mean=MEAN, fragment_stddev=STD, precision=PREC,
        min_cluster_size=MINCL, min_read_length=MINREAD,
        max_read_length=MAXREAD, outdir=str(tmp_path / "ours"),
        use_device=use_device, em_mode=em_mode)

    # golden chain on our own clusters artifacts
    clusters = tmp_path / "ours" / "clusters"
    golden_clusters = tmp_path / "g.clusters"
    subprocess.run(
        [str(ref_binaries / "clustermatepairs"),
         "-a", str(paths["spanning"]), "-c", str(golden_clusters),
         "-u", str(MEAN), "-s", str(STD), "-p", str(PREC),
         "-m", str(MINCL)], check=True, capture_output=True)
    assert clusters.read_text() == golden_clusters.read_text()

    golden_sc = tmp_path / "g.clusters.sc"
    subprocess.run(
        [str(ref_binaries / "setcover"), "-c", str(golden_clusters),
         "-o", str(golden_sc), "-m", str(MINCL)],
        check=True, capture_output=True)
    assert (tmp_path / "ours" / "clusters.sc").read_text() \
        == golden_sc.read_text()

    golden_split = tmp_path / "g.split"
    subprocess.run(
        [str(ref_binaries / "dosplitalign"),
         "-f", str(paths["reference"]), "-e", str(paths["exons"]),
         "-u", str(MEAN), "-s", str(STD), "-n", str(MINREAD),
         "-x", str(MAXREAD), "-r", str(tmp_path / "ours" /
                                       "clusters.sc.regions"),
         "-i", str(paths["improper"]), "-1", str(paths["fastq1"]),
         "-2", str(paths["fastq2"]), "-a", str(golden_split)],
        check=True, capture_output=True)
    ours_split = (tmp_path / "ours" / "splitreads.alignments").read_text()
    assert ours_split == golden_split.read_text()
    assert ours_split, "no split rows produced"

    golden_sorted = tmp_path / "g.split.sorted"
    _sort_n(golden_split, golden_sorted)
    g_out = {n: tmp_path / f"g.{n}" for n in ("seq", "break", "predalign")}
    subprocess.run(
        [str(ref_binaries / "evalsplitalign"),
         "-f", str(paths["reference"]), "-e", str(paths["exons"]),
         "-u", str(MEAN), "-s", str(STD), "-n", str(MINREAD),
         "-x", str(MAXREAD), "-r", str(tmp_path / "ours" /
                                       "clusters.sc.regions"),
         "-a", str(golden_sorted), "-q", str(g_out["seq"]),
         "-b", str(g_out["break"]), "-p", str(g_out["predalign"])],
        check=True, capture_output=True)
    for name in ("seq", "break", "predalign"):
        with open(outs[name]) as fh:
            assert fh.read() == g_out[name].read_text(), name
