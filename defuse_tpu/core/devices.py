"""The accelerator check and the persistent compilation cache.

The device stages (split-read screen, candidate verify, batched EM) run
on an NVIDIA GPU when JAX finds one.  ``gpu_device`` is the one place
that decides it, in process: it returns the first JAX device when its
platform is ``"gpu"`` and None otherwise, and points JAX at the
compilation cache the first time it finds a card.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess

# <checkout>/.jax_cache: a fixed path, so the cache key (which includes
# the directory) is the same from run to run; listed in .gitignore
_DEFAULT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"

_cache_dir: str | None = None


def gpu_device():
    """The first JAX device when it is a GPU, else None."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        return None
    enable_compilation_cache()
    return dev


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at
    ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it itself;
    nothing else is set), else at ``<checkout>/.jax_cache``.  Returns the
    directory in use."""
    global _cache_dir
    if _cache_dir is not None:
        return _cache_dir
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        _cache_dir = env
        return env
    import jax

    _DEFAULT_CACHE.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(_DEFAULT_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _cache_dir = str(_DEFAULT_CACHE)
    return _cache_dir


def visible_gpus() -> list[str]:
    """Ids of the GPUs this process may hand to worker processes, read
    without starting JAX (a JAX process reserves most of a card's
    memory): ``CUDA_VISIBLE_DEVICES`` when set, else the indices
    ``nvidia-smi`` lists; [] on a machine without either."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [d.strip() for d in env.split(",") if d.strip()]
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return []
    out = subprocess.run(
        [smi, "--query-gpu=index", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        return []
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
