#!/usr/bin/env python
"""Smoke run of the fusion pipeline on an NVIDIA GPU.

    python chip_smoke.py            # one card: phases (a)-(d)
    python chip_smoke.py --four     # four cards: the cohort path only

Phases, each printed as it passes:

(a) the device as JAX reports it, and the card's name and power limit
    from nvidia-smi; fails when JAX finds no GPU;
(b) the native host library, built here from ``native/defuse_host.cpp``;
(c) a 2,000,000-pair 2x50 bp library made to the deFuse paper's
    simulation protocol (``scripts_dev/ext_validation.py``) on a
    2x16 Mbp genome with 100 fusions, run through ``python -m defuse_tpu
    create-ref`` and ``run`` twice, with the device and with
    ``--no-device``: the artifacts must be byte-identical and the
    split-read screen must have run on the GPU;
(d) the device code at real widths against the plain references, with
    integer results compared exactly: the screen against native
    realignment on the run's candidates, the DP row maxima against
    ``align/split_dp.fill_matrix`` at 50, 101 and 151 bp, candidate
    verify on a 3.1 Gbp plane against the NumPy oracle, and the batched
    EM on the run's bin pairs against the native EM.

``--four`` runs ``python -m defuse_tpu cohort -w 4`` over four
500,000-pair libraries, one worker per card, and compares each
library's ``results.filtered.tsv`` with the same library run alone on
one card.

The last line of standard output is a JSON object with ``"ok": true``
and the device; the script exits 0 only when every phase passed.  This
process starts JAX only after the pipeline's own processes are done, so
that each card has one JAX process at a time.
"""

import argparse
import json
import os
import pathlib
import random
import shutil
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent

# the paper protocol's set-up (ext_validation.py) and its own seed
SEED = 20110526
SCREEN_ARTIFACTS = ("clusters", "clusters.sc", "splitreads.break",
                    "splitreads.seq", "results.tsv", "results.filtered.tsv")


class PhaseFailed(Exception):
    pass


def say(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def child_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                       else []))
    env.update(extra)
    return env


def run_cmd(args, log=None, **env):
    """Run a command to its end; raise PhaseFailed on a non-zero exit."""
    t0 = time.time()
    proc = subprocess.run(args, capture_output=True, text=True,
                          env=child_env(**env), cwd=REPO)
    if log is not None:
        pathlib.Path(log).write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0,
          f"{' '.join(map(str, args[:4]))} exited {proc.returncode}:\n"
          + proc.stderr[-3000:])
    return time.time() - t0, proc.stdout


# --- (a) ---------------------------------------------------------------

def phase_device(want_count):
    """The device check runs in a child process, so that this process
    holds no card while the pipeline's processes run."""
    probe = ("import json, jax; d = jax.devices(); print(json.dumps("
             "{'platform': d[0].platform, 'kind': d[0].device_kind, "
             "'count': len(d)}))")
    _t, out = run_cmd([sys.executable, "-c", probe])
    dev = json.loads(out.strip().splitlines()[-1])
    say(f"[a] JAX device: platform={dev['platform']} "
        f"kind={dev['kind']} count={dev['count']}")
    check(dev["platform"] == "gpu", "JAX finds no GPU")
    check(dev["count"] >= want_count,
          f"need {want_count} GPUs, JAX has {dev['count']}")
    cards = card_lines()
    say("[a] card (nvidia-smi name, power.limit):")
    for ln in cards:
        say(ln)
    return cards


# --- (b) ---------------------------------------------------------------

def phase_native():
    dt, _out = run_cmd(["bash", str(REPO / "native" / "build.sh")])
    from defuse_tpu.cluster import native
    check(native.available(), "native library built but does not load")
    say(f"[b] native library built on this machine in {dt:.1f} s")


# --- (c) ---------------------------------------------------------------

def write_library(work, name, reads1, reads2):
    fq1, fq2 = work / f"{name}.1.fastq", work / f"{name}.2.fastq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i, (a, b) in enumerate(zip(reads1, reads2)):
            f1.write(f"@{i}/1\n{a}\n+\n{'I' * len(a)}\n")
            f2.write(f"@{i}/2\n{b}\n+\n{'I' * len(b)}\n")
    return fq1, fq2


def write_reference(work, genome, genes):
    """Genome FASTA, GTF, repeats and config.txt for create-ref."""
    from synthdata import (SynthDataset, write_genome_fasta, write_gtf,
                           write_repeats)
    ds = SynthDataset(genome, genes, ("", 0, "", 0), "", [], [], [])
    write_gtf(ds, work / "genes.gtf")
    write_genome_fasta(ds, work / "genome.fa")
    write_repeats(ds, work / "repeats.regions")
    config = work / "config.txt"
    config.write_text("\n".join([
        f"genome_fasta = {work / 'genome.fa'}",
        f"gene_models = {work / 'genes.gtf'}",
        "gene_biotypes = synth",
        "chromosomes = 1,2",
        "span_count_threshold = 5",
        f"repeats_regions = {work / 'repeats.regions'}",
        "dataset_prefix = $(dataset_directory)/defuse",
        "cdna_regions = $(dataset_prefix).cdna.regions",
        "cdna_fasta = $(dataset_prefix).cdna.fa",
        "exons_fasta = $(dataset_prefix).exons.fa",
        "cds_fasta = $(dataset_prefix).cds.fa",
        "reference_fasta = $(dataset_prefix).reference.fa",
        "rrna_fasta = $(dataset_prefix).rrna.fa",
        "ig_gene_list = $(dataset_prefix).ig.gene.list",
    ]) + "\n")
    return config


def create_ref(work, config):
    dataset = work / "dataset"
    dt, _ = run_cmd([sys.executable, "-m", "defuse_tpu", "create-ref",
                     "-c", str(config), "-d", str(dataset)],
                    log=work / "create_ref.log")
    return dataset, dt


def run_library(config, dataset, fq1, fq2, out, device, **env):
    args = [sys.executable, "-m", "defuse_tpu", "run", "-c", str(config),
            "-d", str(dataset), "-o", str(out), "-1", str(fq1),
            "-2", str(fq2), "-n", "smoke"]
    if not device:
        args.append("--no-device")
    out.mkdir(parents=True, exist_ok=True)
    dt, _ = run_cmd(args, log=out.parent / f"{out.name}.log", **env)
    return dt


def recall(truth, filtered_path):
    lines = pathlib.Path(filtered_path).read_text().splitlines()
    header = lines[0].split("\t")
    g1, g2 = header.index("gene1"), header.index("gene2")
    called = {frozenset((r.split("\t")[g1], r.split("\t")[g2]))
              for r in lines[1:]}
    detectable = [t for t in truth if t["frags_spanning"] >= 5]
    hit = sum(1 for t in detectable if frozenset(t["genes"]) in called)
    keys = {frozenset(t["genes"]) for t in truth}
    return hit, len(detectable), sum(1 for c in called if c not in keys)


def phase_library(work, n_pairs, card):
    sys.path[:0] = [str(REPO / "scripts_dev"), str(REPO / "tests")]
    import ext_validation

    t0 = time.time()
    genome, genes, reads1, reads2, truth = ext_validation.generate(
        random.Random(SEED), n_pairs)
    fq1, fq2 = write_library(work, "lib", reads1, reads2)
    config = write_reference(work, genome, genes)
    t_gen = time.time() - t0
    del reads1, reads2
    dataset, t_ref = create_ref(work, config)
    say(f"[c] library: {n_pairs} pairs, 2x{ext_validation.READ_LEN} bp, "
        f"2x{ext_validation.CHROM_MB} Mbp genome, {len(truth)} fusions, "
        f"seed {SEED}; data generation {t_gen:.1f} s (host), "
        f"create-ref {t_ref:.1f} s (host)")
    dev_out, host_out = work / "run_device", work / "run_host"
    t_dev = run_library(config, dataset, fq1, fq2, dev_out, True)
    t_host = run_library(config, dataset, fq1, fq2, host_out, False)
    for name in SCREEN_ARTIFACTS:
        a, b = dev_out / name, host_out / name
        check(a.exists() and b.exists(), f"{name} missing")
        check(a.read_bytes() == b.read_bytes(),
              f"{name} differs between the device and --no-device runs")
    say(f"[c] device and --no-device artifacts byte-identical: "
        f"{', '.join(SCREEN_ARTIFACTS)}")
    metrics = json.loads((dev_out / "metrics.json").read_text())
    disc = json.loads((dev_out / "metrics.discover.json").read_text())
    check(metrics.get("device") == "gpu",
          f"device run recorded device {metrics.get('device')!r}")
    check(disc.get("screen_device") == "gpu",
          f"screen ran on {disc.get('screen_device')!r}, not the GPU")
    n_cand = int(disc["counters"].get("screen_candidates", 0))
    check(n_cand > 0, "the screen saw no candidates")
    say(f"[c] split-read screen on gpu: {n_cand} candidates, "
        f"{int(disc['counters']['screen_survivors'])} survivors")
    hit, det, fp = recall(truth, dev_out / "results.filtered.tsv")
    say(f"[c] recall: {hit}/{det} detectable fusions (>=5 spanning "
        f"fragments) in results.filtered.tsv, {fp} false gene pairs")
    align = json.loads((dev_out / "metrics.align.json").read_text())
    stages = {s["stage"]: s["seconds"] for s in
              align["stages"] + metrics["stages"]}
    say(f"[c] {card}: device run {t_dev:.1f} s wall, --no-device run "
        f"{t_host:.1f} s wall (each including process start)")
    say(f"[c] {card}: device run stages (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    host = json.loads((host_out / "metrics.json").read_text())
    say(f"[c] {card}: --no-device run stages (s): "
        + ", ".join(f"{s['stage']} {s['seconds']:.2f}"
                    for s in host["stages"]))
    dstages = {s["stage"]: s["seconds"] for s in disc["stages"]}
    say(f"[c] {card}: discover stages (s): "
        + ", ".join(f"{k.split(':', 1)[1]} {v:.2f}"
                    for k, v in dstages.items()))
    say(f"[c] {card}: screen compile {disc['counters']['screen_compile_s']:.2f}"
        " s (inside screen:device above)")
    return {"work": work, "out": dev_out, "truth": truth,
            "discover_s": stages["discover"], "config": config}


# --- (d) ---------------------------------------------------------------

def trace_device_ns(trace_dir, markers):
    """(time of the GPU events whose name or stats mention one of
    ``markers``, busy time of every GPU event), both in ns, from the
    ``jax.profiler`` trace under ``trace_dir``: the union of event
    intervals on the GPU planes.  A sample of the event names goes to
    stderr, to keep the reduction checkable."""
    from jax.profiler import ProfileData

    def union(iv):
        total, end = 0, -1
        for s, e in sorted(iv):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total

    hit, every, sample = [], [], {}
    for path in pathlib.Path(trace_dir).rglob("*.xplane.pb"):
        pd = ProfileData.from_file(str(path))
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                for ev in line.events:
                    iv = (ev.start_ns, ev.start_ns + ev.duration_ns)
                    every.append(iv)
                    text = ev.name + " " + " ".join(
                        f"{k}={v}" for k, v in ev.stats)
                    matched = any(m in text for m in markers)
                    if matched:
                        hit.append(iv)
                    key = (line.name, matched)
                    if len(sample.setdefault(key, [])) < 4:
                        sample[key].append(text[:160])
    print("GPU trace lines (matched?): event samples", file=sys.stderr)
    for (line, matched), texts in sample.items():
        print(f"  {line} ({matched}): {texts}", file=sys.stderr)
    return union(hit), union(every)


def screen_setup(run):
    """The run's split-read candidates as the screen takes them, and the
    candidate reads and flanks native realignment takes."""
    from defuse_tpu.cluster import native
    from defuse_tpu.io.fasta import FastaStore
    from defuse_tpu.pipeline.discover import screen_inputs, split_tasks
    from defuse_tpu.pipeline.run import _read_stats_file

    out = run["out"]
    stats = _read_stats_file(out / "concordant.read.stats")
    dataset = run["work"] / "dataset"
    tasks, realigner = split_tasks(
        FastaStore.from_file(str(dataset / "defuse.reference.fa")),
        str(dataset / "defuse.cdna.regions"), stats.fraglength_mean,
        stats.fraglength_stddev, stats.readlength_min,
        stats.readlength_max, out / "clusters.sc.regions")
    cids = sorted(tasks)
    f1 = [tasks[c].split_align_seq[0] for c in cids]
    f2 = [tasks[c].split_align_seq[1] for c in cids]
    driver = native.RealignDriver(
        str(out / "aligned" / "improper.sam"),
        (str(out / "reads" / "reads.1.fastq"),
         str(out / "reads" / "reads.2.fastq")),
        realigner.binned, cids, f1, f2)
    inputs = screen_inputs(driver, f1, f2, stats.readlength_max)
    driver.close()
    return inputs, f1, f2


def phase_screen(run, work, card):
    """The screen's scores on the run's candidates: exact against the
    host split aligner on a sample, and as a filter against native
    realignment on all of them (no candidate that native realignment
    keeps is rejected, and realigning only the survivors gives the same
    rows)."""
    import numpy as np

    from defuse_tpu.align.split_dp import SplitReadAligner
    from defuse_tpu.cluster import native
    from defuse_tpu.ops.split_dp_batch import screen_candidates

    inputs, f1, f2 = screen_setup(run)
    _u1, _l1, _u2, _l2, fidx, reads_p, read_lens, mins = inputs
    B = len(fidx)
    scores = screen_candidates(*inputs)  # compiles
    reads = [reads_p[i, :read_lens[i]].tobytes().decode()
             for i in range(B)]
    ref1s = [f1[i] for i in fidx]
    ref2s = [f2[i] for i in fidx]
    rows = native.split_realign(ref1s, ref2s, reads)
    kept = np.zeros(B, bool)
    kept[rows[:, 0]] = True
    lost = int(np.sum(kept & (scores == 0)))
    surv = np.nonzero(scores > 0)[0]
    rows_s = native.split_realign([ref1s[i] for i in surv],
                                  [ref2s[i] for i in surv],
                                  [reads[i] for i in surv])
    rows_s[:, 0] = surv[rows_s[:, 0]]
    same_rows = rows_s.shape == rows.shape and bool((rows_s == rows).all())
    rng = random.Random(SEED)
    sample = sorted(rng.sample(range(B), min(B, 2048)))
    bad = 0
    for i in sample:
        bad += int(scores[i]) != SplitReadAligner(
            ref1s[i], ref2s[i]).max_score(reads[i], int(mins[i]))
    say(f"[d] screen on the run's {B} candidates: {len(surv)} survive; "
        f"native realignment keeps {int(kept.sum())}, of which the screen"
        f" rejected {lost}; realigning survivors only gives "
        f"{'the same' if same_rows else 'DIFFERENT'} {len(rows)} rows; "
        f"max split score vs the host split aligner on {len(sample)} "
        f"sampled candidates: {bad} mismatches (exact, int32)")
    check(lost == 0 and same_rows and bad == 0,
          "screen disagrees with native realignment / the host aligner")
    import jax
    tdir = work / "trace"
    with jax.profiler.trace(str(tdir)):
        t0 = time.time()
        screen_candidates(*inputs)  # warm; returns host (blocked) scores
        wall = time.time() - t0
    screen_ns, busy_ns = trace_device_ns(
        tdir, ("split_dp_screen", "_screen_chunk"))
    disc = run["discover_s"]
    say(f"[d] {card}: screen device time {screen_ns / 1e6:.3f} ms "
        f"(module _screen_chunk / scope split_dp_screen; all GPU events "
        f"{busy_ns / 1e6:.3f}"
        f" ms; host wall {wall * 1e3:.1f} ms) at {B} candidates = "
        f"{100 * screen_ns / 1e9 / disc:.2f}% of the run's discover "
        f"stage ({disc:.2f} s)")
    check(screen_ns > 0, "no screen events in the device trace")
    return f1, f2


def phase_rowmax(f1, f2):
    import numpy as np

    from defuse_tpu.align.split_dp import MIN_SPLIT_SCORE, fill_matrix
    from defuse_tpu.align.batch_realign import _pad_len
    from defuse_tpu.ops.split_dp_batch import dp_row_maxima, pad_batch

    rng = random.Random(SEED)
    n = 2048
    for L in (50, 101, 151):
        refs, reads = [], []
        for i in range(n):
            u = rng.randrange(len(f1))
            a, b = f1[u], f2[u]
            k = rng.randrange(5, L - 5)
            if i % 2 == 0 and len(a) >= k and len(b) >= L - k:
                read = a[len(a) - k:] + b[:L - k]
            else:
                read = "".join(rng.choice("ACGT") for _ in range(L))
            refs.append(a)
            reads.append(read)
        R = _pad_len(max(len(a) for a in refs))
        rp, rl = pad_batch(refs, R)
        qp, ql = pad_batch(reads, _pad_len(L, 64))
        got = np.asarray(dp_row_maxima(rp, rl, qp, ql))
        bad = 0
        for b_, (ref, read) in enumerate(zip(refs, reads)):
            m = fill_matrix(ref, read).max(axis=0)
            want = np.where(m >= MIN_SPLIT_SCORE, m, 0)
            if not (got[b_, :L + 1] == want).all() \
                    or got[b_, L + 1:].any():
                bad += 1
        say(f"[d] DP row maxima vs fill_matrix, {n} candidates, L={L}, "
            f"R={R}: {bad} mismatching candidates (exact, int32)")
        check(bad == 0, f"row maxima disagree with fill_matrix at L={L}")


def phase_verify(n_bases=3_100_000_000):
    import numpy as np

    from defuse_tpu.ops.verify_batch import BASES_PER_WORD, DeviceVerifier

    L, n_reads, n_cand = 50, 1 << 16, 1 << 20
    rng = np.random.default_rng(SEED)
    t0 = time.time()
    codes = rng.integers(0, 4, n_bases, dtype=np.int8)
    codes[rng.integers(0, n_bases, n_bases // 1000)] = 4  # N
    cand = rng.integers(0, n_bases - L, n_cand)
    read_idx = rng.integers(0, n_reads, n_cand).astype(np.int32)
    # reads copied from their first candidate's window, then mutated, so
    # that mismatch counts range from 0 up
    first = np.zeros(n_reads, np.int64)
    first[read_idx[::-1]] = cand[::-1]
    reads = codes[first[:, None] + np.arange(L)[None, :]]
    flip = rng.random(reads.shape) < 0.02
    reads[flip] = (reads[flip] + 1) % 4
    read_lens = rng.integers(36, L + 1, n_reads).astype(np.int32)
    t_gen = time.time() - t0
    verifier = DeviceVerifier()
    t0 = time.time()
    got = verifier(codes, cand, reads, read_idx, read_lens)
    t_dev = time.time() - t0
    win = codes[cand[:, None] + np.arange(L)[None, :]]
    want = ((win != reads[read_idx])
            & (np.arange(L)[None, :] < read_lens[read_idx][:, None])
            ).sum(axis=1)
    bad = int(np.sum(got != want))
    plane = (n_bases + BASES_PER_WORD - 1) // BASES_PER_WORD * 4
    say(f"[d] verify on a {n_bases / 1e9:.1f} Gbp 3-bit plane "
        f"({plane / 1e9:.2f} GB resident), {n_cand} candidates in "
        f"{verifier.batch}-candidate batches vs the NumPy oracle: {bad} "
        f"mismatches (exact, int32; {int(np.sum(want == 0))} exact "
        f"windows); generation {t_gen:.1f} s, pack + upload + verify "
        f"{t_dev:.1f} s (host wall, first call)")
    check(bad == 0, "device verify disagrees with the NumPy oracle")


def phase_em(run):
    import jax

    from defuse_tpu.cluster import native
    from defuse_tpu.cluster.discordant import collect_bin_pair_tasks
    from defuse_tpu.cluster.matepair_em import EMParams
    from defuse_tpu.cluster.matepair_em_batch import (LAST_SELECT_STATS,
                                                      prepare_batch,
                                                      run_batch)
    from defuse_tpu.config import Config
    from defuse_tpu.io.sam import iter_compact, load_alignments
    from defuse_tpu.pipeline.run import _read_stats_file

    out = run["out"]
    stats = _read_stats_file(out / "concordant.read.stats")
    config = Config.read(str(run["config"]), str(run["work"] / "dataset"))
    params = EMParams(stats.fraglength_mean, stats.fraglength_stddev,
                      config.get_float("clustering_precision"),
                      config.get_int("span_count_threshold"))
    table = load_alignments(iter_compact(str(out / "aligned"
                                             / "spanning.compact")))
    tasks = collect_bin_pair_tasks(table, params)
    instances = [(t.x, t.y, t.u) for t in tasks]
    t0 = time.time()
    want = native.em_cluster_batch(instances, params)
    t_native = time.time() - t0
    jax.config.update("jax_enable_x64", True)
    t0 = time.time()
    with jax.default_matmul_precision("highest"):
        got = run_batch(prepare_batch(instances, params), params,
                        exact_resolve=True)
    t_dev = time.time() - t0
    bad = sum(1 for i in range(len(instances))
              if [sorted(c) for c in got.get(i, [])]
              != [sorted(c) for c in want[i]])
    n = max((len(x) for x, _y, _u in instances), default=0)
    say(f"[d] batched EM (float64, exact_resolve on: "
        f"{LAST_SELECT_STATS.get('n_host_resolved')} of "
        f"{len(instances)} instances re-solved on the host) on the run's "
        f"bin pairs (largest {n} points) vs native EM: {bad} "
        f"mismatching memberships; {t_dev:.1f} s host wall incl. "
        f"compile (native EM {t_native:.3f} s)")
    check(bad == 0, "device EM memberships disagree with native EM")


def smoke_one(args, work):
    cards = phase_device(1)
    card = cards[0]
    phase_native()
    run = phase_library(work, args.pairs, card)
    import jax
    from defuse_tpu.core.devices import gpu_device
    dev = gpu_device()
    check(dev is not None, "JAX finds no GPU in this process")
    f1, f2 = phase_screen(run, work, card)
    phase_rowmax(f1, f2)
    phase_verify()
    phase_em(run)
    peak = dev.memory_stats().get("peak_bytes_in_use", 0)
    say(f"[d] {card}: peak_bytes_in_use {peak / 1e9:.2f} GB")
    say(card)
    return jax.devices()


# --- (e) ---------------------------------------------------------------

def smoke_four(args, work):
    cards = phase_device(4)
    phase_native()
    sys.path[:0] = [str(REPO / "scripts_dev"), str(REPO / "tests")]
    import ext_validation

    t0 = time.time()
    genome, genes = ext_validation.make_reference(random.Random(SEED))
    config = write_reference(work, genome, genes)
    libs = []
    for i in range(4):
        r1, r2, _truth = ext_validation.make_library(
            random.Random(SEED + 1 + i), genome, genes, args.pairs // 4)
        libs.append((f"lib{i}",) + write_library(work, f"lib{i}", r1, r2))
    t_gen = time.time() - t0
    dataset, t_ref = create_ref(work, config)
    say(f"[e] 4 libraries x {args.pairs // 4} pairs; data generation "
        f"{t_gen:.1f} s, create-ref {t_ref:.1f} s (host)")
    manifest = work / "cohort.tsv"
    manifest.write_text("".join(f"{n}\t{a}\t{b}\n" for n, a, b in libs))
    cohort = work / "cohort"
    t_coh, _ = run_cmd([sys.executable, "-m", "defuse_tpu", "cohort",
                        "-c", str(config), "-d", str(dataset),
                        "-m", str(manifest), "-o", str(cohort), "-w", "4"],
                       log=work / "cohort.log")
    used = []
    for name, _a, _b in libs:
        m = json.loads((cohort / name / "metrics.json").read_text())
        check(m.get("device") == "gpu", f"{name} did not run on a GPU")
        used.append(m.get("visible_gpus"))
    check(len(set(used)) == 4 and all(u is not None and "," not in u
                                      for u in used),
          f"cohort workers were not one per card: {used}")
    say(f"[e] {cards[0]}: cohort -w 4 over 4 libraries in {t_coh:.1f} s "
        f"wall; library -> card: "
        + ", ".join(f"{n}->{u}" for (n, _a, _b), u in zip(libs, used)))
    # each library alone on one card; run at once, each on another card
    # than its cohort worker had
    procs = []
    for i, (name, fq1, fq2) in enumerate(libs):
        out = work / "single" / name
        out.mkdir(parents=True)
        log = open(work / "single" / f"{name}.log", "w")
        procs.append((name, log, subprocess.Popen(
            [sys.executable, "-m", "defuse_tpu", "run", "-c", str(config),
             "-d", str(dataset), "-o", str(out), "-1", str(fq1),
             "-2", str(fq2), "-n", name],
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
            env=child_env(CUDA_VISIBLE_DEVICES=str((i + 1) % 4)))))
    for name, log, proc in procs:
        rc = proc.wait()
        log.close()
        check(rc == 0, f"single-card run of {name} exited {rc}")
    for name, _a, _b in libs:
        pa = cohort / name / "results.filtered.tsv"
        pb = work / "single" / name / "results.filtered.tsv"
        check(pa.exists() and pb.exists(),
              f"{name}: results.filtered.tsv missing")
        a, b = pa.read_bytes(), pb.read_bytes()
        check(a == b, f"{name}: cohort and single-card results differ")
        say(f"[e] {name}: results.filtered.tsv byte-identical, cohort "
            f"vs alone on one card ({len(a.splitlines()) - 1} calls)")
    for ln in cards:
        say(ln)
    import jax
    return jax.devices()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card cohort path only")
    ap.add_argument("--pairs", type=int, default=None,
                    help="read pairs (default 2,000,000; with --four "
                         "4 x 500,000)")
    args = ap.parse_args(argv)
    if args.pairs is None:
        args.pairs = 2_000_000
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        devices = (smoke_four if args.four else smoke_one)(args, work)
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
