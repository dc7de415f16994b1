"""Observability hooks of the port (the call sites that the reference
engine and KV tier make into ray_tpu/util/{events,spans,metrics,tracing}).

The reference records into process-global singletons of `ray_tpu.util`:
the flight recorder (`events.record(plane, kind, **fields)`), durational
spans on it (`spans.begin` / `spans.end`), named metrics (`Counter.inc`,
`Gauge.set`, `Histogram.observe`) and the active trace context
(`tracing.current_context()`).  The port imports no `ray_tpu` module, so
its engine and tier take an `Observer` from the caller instead and call
the same methods with the reference's (plane, kind) pairs and metric
names unchanged (`engine/submit`, `engine/step`, `engine/finish`,
`kv/export`, `kv/import`, `kv/spilled`, `kv/restored`,
`inference_prefix_hit_tokens`, `inference_ttft_s`, `inference_tbt_s`,
`kv_tier_spilled_blocks`, ...).  `observer=None` means the base class,
whose every method does nothing.  A caller that wants the cluster's
`cli metrics` and `cli events` binds a subclass that forwards each method
to `ray_tpu.util`.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional


class Observer:
    """The no-op observer; subclass it and override what you record.

    - `record(plane, kind, **fields)`: one instant event (the reference's
      `events.record`; `trace=` carries the request's trace context).
    - `begin(plane, kind, **fields) -> token` / `end(token, **fields)`: a
      span (`spans.begin` / `spans.end`; `ctx=` is the trace context).
      `end` gets whatever `begin` returned; a None token is no span and
      records nothing.
    - `span(plane, kind, **fields)`: `begin` and `end` around a `with`
      block (the reference's `spans.span`).
    - `inc(name, n)`, `set(name, value)`, `observe(name, value)`: a
      counter, a gauge and a histogram sample, by metric name.
    - `context()`: the caller's trace context at submit time (the
      reference's `tracing.current_context()`), or None for untraced
      requests, which then open no per-request spans.
    """

    def record(self, plane: str, kind: str, **fields: Any) -> None:
        pass

    def begin(self, plane: str, kind: str, **fields: Any) -> Any:
        return None

    def end(self, token: Any, **fields: Any) -> None:
        pass

    @contextlib.contextmanager
    def span(self, plane: str, kind: str, **fields: Any) -> Iterator[Any]:
        tok = self.begin(plane, kind, **fields)
        try:
            yield tok
        finally:
            self.end(tok)

    def inc(self, name: str, n: float = 1.0) -> None:
        pass

    def set(self, name: str, value: float) -> None:
        pass

    def observe(self, name: str, value: float) -> None:
        pass

    def context(self) -> Optional[tuple]:
        return None


NOOP = Observer()
