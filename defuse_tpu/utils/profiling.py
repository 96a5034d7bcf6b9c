"""Tracing / profiling subsystem.

The reference's observability is per-stage wall-clock lines in the
driver log (``defuse_run.pl:311,412,463`` pattern ``[date] step [N
sec]``) plus per-job ``time`` output.  This module upgrades that to a
structured, always-on metrics artifact plus opt-in JAX device profiling:

* ``Tracer`` — records stage wall times, counters and run facts (such
  as the device a stage ran on) and writes ``metrics.json`` into the
  run output directory; stage lines
  still print when ``DEFUSE_STAGE_TIMING`` is set, preserving the
  familiar log format.
* ``device_trace()`` — context manager wrapping device-heavy stages in
  ``jax.profiler.trace`` when ``DEFUSE_JAX_PROFILE=<dir>`` is set; the
  resulting TensorBoard trace carries per-kernel timings (the
  per-kernel metrics the reference never had).
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import time


class Tracer:
    """Stage wall-clock + counter collector with a JSON artifact."""

    def __init__(self, outdir: str | None = None,
                 artifact: str = "metrics.json"):
        self._t0 = time.time()
        self._last = self._t0
        self.stages: list[dict] = []
        self.counters: dict[str, float] = {}
        # run facts written at the top level of the artifact
        self.info: dict[str, str] = {}
        self._path = (pathlib.Path(outdir) / artifact) if outdir else None
        self._echo = bool(os.environ.get("DEFUSE_STAGE_TIMING"))

    def mark(self, stage: str, **extra) -> float:
        """Close the current stage interval under ``stage``."""
        now = time.time()
        dt = now - self._last
        self._last = now
        rec = {"stage": stage, "seconds": round(dt, 4)}
        if extra:
            rec.update(extra)
        self.stages.append(rec)
        if self._echo:
            print(f"[stage] {stage}: {dt:.2f}s", flush=True)
        return dt

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def flush(self) -> str | None:
        if self._path is None:
            return None
        self._path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "total_seconds": round(time.time() - self._t0, 4),
            "stages": self.stages,
            "counters": self.counters,
            **self.info,
        }
        tmp = self._path.with_name(self._path.name + ".tmp")
        tmp.write_text(json.dumps(payload, indent=1))
        tmp.replace(self._path)
        return str(self._path)


@contextlib.contextmanager
def device_trace(label: str):
    """Wrap a device-heavy stage in a JAX profiler trace when
    ``DEFUSE_JAX_PROFILE=<dir>`` is set (per-kernel timings land in
    ``<dir>/<label>`` for TensorBoard/xprof); no-op otherwise."""
    trace_dir = os.environ.get("DEFUSE_JAX_PROFILE")
    if not trace_dir:
        yield
        return
    import jax

    path = pathlib.Path(trace_dir) / label
    path.mkdir(parents=True, exist_ok=True)
    with jax.profiler.trace(str(path)):
        yield
