"""Guard the bench output contract (VERDICT r4 items 1/10).

Round 4's headline was lost because bench.py printed one monolithic
JSON line that outgrew the driver's 2000-char tail capture.  The
contract now is: the FINAL stdout line is a compact headline JSON
guaranteed under 1.5KB that still carries the metric/value/vs_baseline
triple plus one-number summaries of every extras block.  These tests
pin that contract so it cannot silently regress again.
"""

import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench


def _full_result(extra_pad=None):
    """A result shaped like the round-4 blob that broke the capture."""
    extra = {
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1, "card": "NVIDIA H100 80GB HBM3, 700.00 W"},
        "n_read_pairs": 92800,
        "baseline_pairs_s": 6270.2,
        "exact_match_vs_reference": True,
        "frontend_pairs_s": 329645.1,
        "verify_kernel": {"ms": "231.90", "C": "262144",
                          "marginal_us": "0.0489"},
        "stage_times_s": {f"discover:stage{i}": 0.01 for i in range(12)},
        "em_ablation_s": {"native": 0.801, "device": 79.075,
                          "device_warm": 22.193,
                          "device_matches_native": True},
        "forced_device_verify": {
            "elapsed_s": 0.5, "pairs_s": 190000.0,
            "stage_times_s": {f"s{i}": 0.01 for i in range(40)},
            "frontend_hash_matches": True, "note": "x" * 2000},
    }
    if extra_pad:
        extra.update(extra_pad)
    return {
        "metric": "read-pairs/s/chip (cluster+split-align); "
                  "fusion calls exact-match vs reference",
        "value": 305862.2,
        "unit": "read-pairs/s/chip",
        "vs_baseline": 48.781,
        "extra": extra,
    }


def test_headline_fits_capture_window():
    full = _full_result()
    # the full blob really is too big for the tail (the r4 failure mode)
    assert len(json.dumps(full)) > 2000
    line = json.dumps(bench.compact_headline(full, "BENCH_EXTRAS.json"))
    assert len(line) < 1500
    parsed = json.loads(line)
    assert parsed["value"] == 305862.2
    assert parsed["vs_baseline"] == 48.781
    assert parsed["unit"] == "read-pairs/s/chip"
    ex = parsed["extra"]
    assert ex["exact_match_vs_reference"] is True
    assert ex["device"]["platform"] == "gpu"
    assert ex["device"]["count"] == 1
    assert ex["em_native_s"] == 0.801
    assert ex["forced_device_verify_pairs_s"] == 190000.0
    assert ex["full_extras_file"] == "BENCH_EXTRAS.json"


def test_headline_survives_pathological_extras():
    """Even absurd extras cannot push the final line past the budget:
    compaction only copies known keys, and the byte-budget loop drops
    from the tail if a known field itself bloats."""
    full = _full_result({"junk": "z" * 100000})
    line = json.dumps(bench.compact_headline(full, None))
    assert len(line) < 1500
    assert json.loads(line)["value"] == 305862.2


def test_headline_handles_missing_extras():
    """Partial runs (no ablation, no forced legs) still produce a
    parseable headline."""
    device = {"platform": "gpu", "kind": "k", "count": 1, "card": None}
    full = {"metric": "m", "value": 1.0, "unit": "u",
            "vs_baseline": None, "extra": {"device": device}}
    parsed = json.loads(json.dumps(bench.compact_headline(full, None)))
    assert parsed["vs_baseline"] is None
    assert parsed["extra"]["device"] == device
