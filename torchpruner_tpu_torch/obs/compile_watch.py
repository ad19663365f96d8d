"""Compile accounting — counterpart of
``torchpruner_tpu/obs/compile_watch.py``.

The JAX package counts XLA compilations through ``jax.monitoring``
listeners.  The port runs eagerly; its only compile is the kernel build
of ``ops/_build.py``: one ``nvcc`` run per CUDA source at first use,
then a ``ctypes`` load of the library.  ``_build`` reports each of those
to its listeners (:data:`torchpruner_tpu_torch.ops._build.listeners`),
and :class:`CompileWatcher` counts them under the JAX package's counter
names, so the summary table, ``report.json`` and ``obs diff`` read the
same columns:

- ``compile_count_total`` / ``compile_seconds_total`` — ``nvcc`` builds
  (a library already built is not a compile), charged to the innermost
  span of the building thread;
- ``lower_count_total`` / ``lower_seconds_total`` — library loads (the
  counterpart of turning a lowered program into an executable);
- ``trace_count_total`` / ``trace_seconds_total`` — kept at 0: nothing
  is traced.

``by_executable`` names the library of each build (``flash_attention``,
``dequant_matmul``, ...), the top-compilers table of ``obs report``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

#: build-hook event -> (kind charged to spans, counter, seconds counter)
_EVENTS = {
    "build": ("compile", "compile_count_total", "compile_seconds_total"),
    "load": (None, "lower_count_total", "lower_seconds_total"),
}
_TRACE_COUNTERS = ("trace_count_total", "trace_seconds_total")


class CompileWatcher:
    """Counts kernel builds and loads into ``registry`` and charges build
    seconds to the innermost active span of ``tracer``."""

    def __init__(self, registry, tracer=None):
        self.registry = registry
        self.tracer = tracer
        self._listener: Optional[Callable] = None
        #: library name -> {"count", "seconds"} of its builds
        self.by_executable: Dict[str, Dict[str, float]] = {}
        for _, cname, sname in _EVENTS.values():
            registry.counter(cname)
            registry.counter(sname)
        for name in _TRACE_COUNTERS:
            registry.counter(name)

    def start(self):
        if self._listener is not None:
            return
        from torchpruner_tpu_torch.ops import _build

        def listener(event: str, name: str, seconds: float) -> None:
            spec = _EVENTS.get(event)
            if spec is None:
                return
            kind, cname, sname = spec
            self.registry.counter(cname).inc()
            self.registry.counter(sname).inc(seconds)
            if kind is None:
                return
            agg = self.by_executable.setdefault(
                name, {"count": 0, "seconds": 0.0})
            agg["count"] += 1
            agg["seconds"] += seconds
            if self.tracer is not None:
                self.tracer.attribute_compile(kind, seconds)

        _build.listeners.append(listener)
        self._listener = listener

    def stop(self):
        if self._listener is None:
            return
        from torchpruner_tpu_torch.ops import _build

        try:
            _build.listeners.remove(self._listener)
        except ValueError:
            pass
        self._listener = None

    def top_compilers(self, n: int = 5) -> list:
        """The libraries that paid the most build seconds:
        ``[{"name", "count", "seconds"}, ...]``, most expensive first."""
        rows = [{"name": name, "count": int(v["count"]),
                 "seconds": round(v["seconds"], 3)}
                for name, v in self.by_executable.items()]
        rows.sort(key=lambda r: -r["seconds"])
        return rows[:n]

    def counts(self) -> dict:
        """Current totals, rounded for reporting."""
        g = self.registry.counter
        out = {
            "compile_count": int(g("compile_count_total").value),
            "compile_s": round(g("compile_seconds_total").value, 3),
            "trace_count": int(g("trace_count_total").value),
            "trace_s": round(g("trace_seconds_total").value, 3),
            "lower_count": int(g("lower_count_total").value),
            "lower_s": round(g("lower_seconds_total").value, 3),
        }
        if self.by_executable:
            out["by_executable"] = self.top_compilers()
        return out
