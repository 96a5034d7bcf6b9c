"""The device check, the compilation cache, cohort worker pinning and
the smoke script's refusal to run without a GPU — on the CPU."""

import json
import pathlib
import subprocess
import sys

import pytest

from defuse_tpu.core import devices

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_gpu_device_is_none_on_cpu_without_subprocess(monkeypatch):
    def no_spawn(*a, **k):
        raise AssertionError("the device check must not spawn a process")

    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    monkeypatch.setattr(subprocess, "run", no_spawn)
    assert devices.gpu_device() is None


@pytest.mark.parametrize("env_dir", [True, False])
def test_compilation_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; without
    it the cache goes to the fixed <checkout>/.jax_cache."""
    import jax

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    monkeypatch.setattr(devices, "_cache_dir", None)
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert devices.enable_compilation_cache() == str(tmp_path)
        assert updates == {}
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(REPO / ".jax_cache")
        assert devices.enable_compilation_cache() == want
        assert updates["jax_compilation_cache_dir"] == want
        assert ".jax_cache/" in (REPO / ".gitignore").read_text()
    # set up once per process
    updates.clear()
    devices.enable_compilation_cache()
    assert updates == {}


def test_cohort_workers_pinned_one_per_card(monkeypatch, tmp_path):
    """Libraries go round the visible cards, least-loaded first; more
    workers than cards split each card's memory."""
    from defuse_tpu.pipeline import cohort

    launched = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, stdout=None, stderr=None, env=None):
            launched.append(env)

        def wait(self):
            return 0

    monkeypatch.setattr(cohort.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(devices, "visible_gpus", lambda: ["0", "1"])
    manifest = tmp_path / "m.tsv"
    manifest.write_text("".join(f"lib{i}\ta.fq\tb.fq\n" for i in range(4)))
    cohort.run_cohort("c", "d", str(manifest), str(tmp_path / "out"),
                      workers=2, merge_timeout_s=1)
    assert [e["CUDA_VISIBLE_DEVICES"] for e in launched] == \
        ["0", "1", "0", "1"]
    assert not any("XLA_PYTHON_CLIENT_MEM_FRACTION" in e for e in launched)

    launched.clear()
    cohort.run_cohort("c", "d", str(manifest), str(tmp_path / "out4"),
                      workers=4, merge_timeout_s=1)
    assert sorted(e["CUDA_VISIBLE_DEVICES"] for e in launched) == \
        ["0", "0", "1", "1"]
    assert {e["XLA_PYTHON_CLIENT_MEM_FRACTION"] for e in launched} == \
        {cohort.mem_fraction(2)}

    launched.clear()
    cohort.run_cohort("c", "d", str(manifest), str(tmp_path / "host"),
                      workers=2, use_device=False, merge_timeout_s=1)
    assert not any("XLA_PYTHON_CLIENT_MEM_FRACTION" in e for e in launched)
    import os
    assert all(e.get("CUDA_VISIBLE_DEVICES")
               == os.environ.get("CUDA_VISIBLE_DEVICES") for e in launched)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert "JAX finds no GPU" in proc.stderr
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() \
        else ""
    assert '"ok"' not in last
    with pytest.raises(json.JSONDecodeError):
        json.loads(last)


def test_bench_refuses_without_gpu(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "JAX_PLATFORMS": "cpu", "TMPDIR": str(tmp_path)}
    proc = subprocess.run([sys.executable, str(REPO / "bench.py")],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert "JAX finds no GPU" in proc.stderr
    assert "BENCH_FULL" not in proc.stdout
