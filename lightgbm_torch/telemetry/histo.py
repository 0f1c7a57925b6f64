"""Streaming log-bucketed histograms: fixed memory, quantiles.

The port's copy of the ``Histogram`` class of lightgbm_tpu/telemetry/histo.py
(the servers' instance-local latency, queue-wait and queue-depth stats).
The JAX package's process-global registry and counters are not ported
(ROADMAP queue A, item 10).

  * **log-bucketed**: bucket ``i`` covers ``[lo * growth^i, lo *
    growth^(i+1))``, so a fixed array of a few hundred int counts spans
    nanoseconds to gigaseconds with a bounded RELATIVE quantile error of
    ``growth - 1`` (default 5%);
  * **fixed memory**: recording is O(1); values past the range land in
    ``underflow`` / ``overflow`` counters instead of bending the layout;
  * **quantiles**: ``percentile(q)`` walks the cumulative counts and
    returns the geometric midpoint of the target bucket, clamped to the
    observed ``[min, max]``.

A histogram is not thread-safe: its owner records under its own lock.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

DEFAULT_LO = 1e-9
DEFAULT_HI = 1e9
DEFAULT_GROWTH = 1.05
QUANTILES = (0.5, 0.95, 0.99, 0.999)


class Histogram:
    """One log-bucketed streaming histogram (see the module doc)."""

    __slots__ = ("name", "unit", "category", "lo", "hi", "growth",
                 "_log_growth", "num_buckets", "buckets", "count", "total",
                 "underflow", "overflow", "vmin", "vmax")

    def __init__(self, name: str = "", lo: float = DEFAULT_LO,
                 hi: float = DEFAULT_HI, growth: float = DEFAULT_GROWTH,
                 unit: str = "", category: str = "histo"):
        if not (0.0 < lo < hi):
            raise ValueError("need 0 < lo < hi (got lo=%r hi=%r)" % (lo, hi))
        if growth <= 1.0:
            raise ValueError("growth must be > 1 (got %r)" % growth)
        self.name = name
        self.unit = unit
        self.category = category
        self.lo = float(lo)
        self.hi = float(hi)
        self.growth = float(growth)
        self._log_growth = math.log(self.growth)
        self.num_buckets = int(math.ceil(
            math.log(self.hi / self.lo) / self._log_growth))
        self.buckets: List[int] = [0] * self.num_buckets
        self.count = 0
        self.total = 0.0
        self.underflow = 0           # v < 0: not log-representable
        self.overflow = 0            # v >= hi: the layout saturated
        self.vmin = math.inf
        self.vmax = -math.inf

    # -- recording -----------------------------------------------------
    def bucket_index(self, value: float) -> int:
        """Bucket holding `value` (callers guarantee lo <= value < hi;
        sub-lo positives clamp into bucket 0 — lo is the resolution
        floor, not a validity bound)."""
        if value < self.lo:
            return 0
        i = int(math.log(value / self.lo) / self._log_growth)
        return min(i, self.num_buckets - 1)

    def record(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        if value < 0.0:
            self.underflow += 1
        elif value >= self.hi:
            self.overflow += 1
        else:
            # 0 <= v < lo (incl. exact 0: a zero queue wait is a real
            # observation) clamps into bucket 0 — lo is the resolution
            # floor, not a validity bound
            self.buckets[self.bucket_index(value)] += 1

    # -- quantiles -----------------------------------------------------
    def percentile(self, q: float) -> float:
        """q in [0, 1]. Relative error <= growth - 1 inside the layout
        range; exact at the observed extremes (the min/max clamp). NaN
        when empty."""
        if self.count == 0:
            return math.nan
        if q <= 0.0:
            return self.vmin
        if q >= 1.0:
            return self.vmax
        target = q * self.count
        # rank walk over [underflow][buckets...][overflow]
        seen = self.underflow
        if target <= seen:
            return self.vmin
        for i, c in enumerate(self.buckets):
            if not c:
                continue
            seen += c
            if target <= seen:
                lo_edge = self.lo * self.growth ** i
                hi_edge = lo_edge * self.growth
                est = math.sqrt(lo_edge * hi_edge)   # geometric midpoint
                return min(max(est, self.vmin), self.vmax)
        return self.vmax

    def quantiles(self, qs: Sequence[float] = QUANTILES) -> Dict[str, float]:
        return {("p%g" % (q * 100)).replace(".", "_"): self.percentile(q)
                for q in qs}

    # -- export ----------------------------------------------------------
    def to_dict(self) -> dict:
        """The layout, count, total, extremes and quantiles (no buckets)."""
        d = {"name": self.name, "unit": self.unit,
             "category": self.category, "lo": self.lo, "hi": self.hi,
             "growth": self.growth, "count": self.count,
             "total": self.total, "underflow": self.underflow,
             "overflow": self.overflow,
             "min": None if self.count == 0 else self.vmin,
             "max": None if self.count == 0 else self.vmax}
        d.update({k: (None if math.isnan(v) else v)
                  for k, v in self.quantiles().items()})
        return d
