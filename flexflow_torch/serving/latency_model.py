"""Serving latency model: modeled prefill and decode costs in virtual ms,
the port of ``flexflow_tpu/serving/latency_model.py``.

The prices (``runtime/serving.py``'s programs):

- prefill of bucket L: one dispatch + one fence + L tokens of
  full-sequence forward: ``dispatch_ms + fence_ms + L * prefill_token_ms``
  (the offset prefill of prefix sharing computes ``L - offset``);
- decode superstep of k steps over the whole slot batch:
  ``dispatch_ms + fence_ms + k * decode_token_ms``;
- speculative round d: ``dispatch_ms + fence_ms + (d + 1) *
  draft_token_ms + (d + 1) * decode_token_ms``; the draft prefill of an
  admission prices like the prefill of its bucket.

The scheduler's virtual clock advances by exactly these numbers, so every
latency it reports is in virtual ms: a deterministic currency, the same
on every box, that prices dispatches and fences.  Without a fitted run
the constants are unitless model defaults, the JAX package's own
(``DEFAULT_DISPATCH_MS`` and ``DEFAULT_FENCE_MS`` of its
``search/cost_model.py``, the three slopes below), so that a port run's
decisions compare with JAX's decision for decision; they are not
measurements of any device.

A fit (:meth:`ServingLatencyModel.from_run`) takes ``dispatch_ms`` and
``fence_ms`` from a port run's own ``calibration`` block
(``Telemetry.calibration_summary``: the fence floor, and the dispatch
cost when the run was dispatch-audited at >= 2 programs per step) and
the per-token slopes from the run's ``prefill``, ``decode_superstep``
and ``spec_verify`` events (:meth:`fit_events`).  The execution search's
``Calibration`` comes with ROADMAP.md queue 1, item 11.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

#: Model defaults of the two per-program constants (virtual ms), the JAX
#: package's uncalibrated ``Calibration`` values.
DEFAULT_DISPATCH_MS = 1.5
DEFAULT_FENCE_MS = 1.5
#: Model defaults of the per-token slopes (virtual ms), JAX's.
DEFAULT_PREFILL_TOKEN_MS = 0.05
DEFAULT_DECODE_TOKEN_MS = 0.2
DEFAULT_DRAFT_TOKEN_MS = 0.1


@dataclasses.dataclass
class ServingLatencyModel:
    dispatch_ms: float = DEFAULT_DISPATCH_MS
    fence_ms: float = DEFAULT_FENCE_MS
    prefill_token_ms: float = DEFAULT_PREFILL_TOKEN_MS
    decode_token_ms: float = DEFAULT_DECODE_TOKEN_MS
    draft_token_ms: float = DEFAULT_DRAFT_TOKEN_MS
    #: Prefix-cache behaviour of the fitted run: the fraction of
    #: admissions that shared a resident prefix and the mean span a hit
    #: skipped.  At 0.0, :meth:`expected_prefill_ms` equals
    #: :meth:`prefill_ms`.
    prefix_hit_rate: float = 0.0
    prefix_mean_offset: float = 0.0
    calibrated: bool = False
    source: Optional[str] = None

    # -- the program prices --------------------------------------------------

    def prefill_ms(self, bucket: int, offset: int = 0) -> float:
        """``offset``: the span the offset prefill skips."""
        return self.dispatch_ms + self.fence_ms + \
            max(bucket - offset, 0) * self.prefill_token_ms

    def expected_prefill_ms(self, bucket: int) -> float:
        """The prefill price discounted by the fitted hit rate times the
        mean skipped span: an estimate for the preemption decision only;
        the clock always advances by the :meth:`prefill_ms` of the program
        that runs."""
        saved = self.prefix_hit_rate * self.prefix_mean_offset
        return self.dispatch_ms + self.fence_ms + \
            max(bucket - saved, 0.0) * self.prefill_token_ms

    def decode_ms(self, k: int) -> float:
        return self.dispatch_ms + self.fence_ms + k * self.decode_token_ms

    def spec_ms(self, d: int) -> float:
        """One speculative round: d + 1 draft and d + 1 verify steps
        behind one dispatch and one fence."""
        return self.dispatch_ms + self.fence_ms + \
            (d + 1) * self.draft_token_ms + (d + 1) * self.decode_token_ms

    def draft_prefill_ms(self, bucket: int) -> float:
        """The draft cache's prefill at a speculative admission, priced
        like the full prefill."""
        return self.prefill_ms(bucket)

    def describe(self) -> str:
        tag = f"calibrated from {self.source}" if self.calibrated else \
            "uncalibrated model defaults"
        prefix = ""
        if self.prefix_hit_rate:
            prefix = (f", prefix hit {self.prefix_hit_rate:.2f} × "
                      f"{self.prefix_mean_offset:.1f} tok")
        return (f"serving latency model ({tag}): dispatch "
                f"{self.dispatch_ms:.3f} + fence {self.fence_ms:.3f} ms, "
                f"prefill {self.prefill_token_ms:.4f} ms/token, decode "
                f"{self.decode_token_ms:.4f} ms/token, draft "
                f"{self.draft_token_ms:.4f} ms/token{prefix}")

    def to_json(self) -> Dict[str, Any]:
        return {
            "dispatch_ms": round(self.dispatch_ms, 4),
            "fence_ms": round(self.fence_ms, 4),
            "prefill_token_ms": round(self.prefill_token_ms, 5),
            "decode_token_ms": round(self.decode_token_ms, 5),
            "draft_token_ms": round(self.draft_token_ms, 5),
            "prefix_hit_rate": round(self.prefix_hit_rate, 4),
            "prefix_mean_offset": round(self.prefix_mean_offset, 3),
            "calibrated": self.calibrated,
            "source": self.source,
        }

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_calibration(block: Optional[Dict[str, Any]] = None,
                         source: Optional[str] = None,
                         ) -> "ServingLatencyModel":
        """Dispatch and fence constants from a run's ``calibration``
        block, by the rule of JAX's ``Calibration.from_summary``:
        ``fence_ms`` when the block has one; ``dispatch_ms_per_program``
        (else ``step_ms_p50 / programs_per_step``) only when the run was
        dispatch-audited at >= 2 programs per step.  The slopes stay at
        their defaults until :meth:`fit_events`."""
        model = ServingLatencyModel(source=source)
        block = block or {}
        if block.get("fence_ms") is not None:
            model.fence_ms = float(block["fence_ms"])
            model.calibrated = True
        p50 = block.get("step_ms_p50")
        if p50 is not None:
            model.calibrated = True
            pps = float(block.get("programs_per_step") or 1.0)
            if pps >= 2.0:
                model.dispatch_ms = float(block.get(
                    "dispatch_ms_per_program", float(p50) / pps))
        return model

    def fit_events(self, events: Iterable[Any],
                   source: Optional[str] = None) -> "ServingLatencyModel":
        """Fit the per-token slopes from a serving run's raw events:
        slope = median of ``(wall_ms - dispatch_ms - fence_ms) / tokens``
        over ``prefill`` (``bucket``; offset prefills left out) and
        ``decode_superstep`` (``k``) events, floored at 0; the draft slope
        is the ``spec_verify`` residual after the decode slope prices the
        d + 1 verify steps.  ``prefix_hit`` events fit the hit rate over
        admissions (``prefill`` events and full hits) and the mean
        ``tokens_saved``.  Returns a new model."""
        pf, dc, sp = [], [], []
        admissions = hits = 0
        saved_total = 0.0
        overhead = self.dispatch_ms + self.fence_ms
        for ev in events:
            kind = ev.get("ev")
            if kind == "prefix_hit":
                hits += 1
                saved_total += float(ev.get("tokens_saved") or 0)
                if ev.get("full"):
                    admissions += 1  # a full hit emits no prefill event
                continue
            wall = ev.get("wall_s")
            if wall is None:
                continue
            wall_ms = float(wall) * 1e3
            if kind == "prefill" and ev.get("bucket"):
                admissions += 1
                if ev.get("offset"):
                    continue
                pf.append(max(wall_ms - overhead, 0.0)
                          / float(ev["bucket"]))
            elif kind == "decode_superstep" and ev.get("k"):
                dc.append(max(wall_ms - overhead, 0.0) / float(ev["k"]))
            elif kind == "spec_verify" and ev.get("d"):
                sp.append((float(ev["d"]), max(wall_ms - overhead, 0.0)))

        def med(xs, default):
            if not xs:
                return default
            xs = sorted(xs)
            return xs[len(xs) // 2]

        decode_slope = med(dc, self.decode_token_ms)
        draft = med(
            [max(w - (d + 1) * decode_slope, 0.0) / (d + 1) for d, w in sp],
            self.draft_token_ms,
        )
        return ServingLatencyModel(
            dispatch_ms=self.dispatch_ms,
            fence_ms=self.fence_ms,
            prefill_token_ms=med(pf, self.prefill_token_ms),
            decode_token_ms=decode_slope,
            draft_token_ms=draft,
            prefix_hit_rate=(hits / admissions) if admissions
            else self.prefix_hit_rate,
            prefix_mean_offset=(saved_total / hits) if hits
            else self.prefix_mean_offset,
            calibrated=self.calibrated or bool(pf or dc or sp),
            source=source or self.source,
        )

    @staticmethod
    def from_run(run) -> "ServingLatencyModel":
        """The constants of ``run``'s own calibration block (defaults when
        it has none) and the slopes fitted from its serving events.
        ``run`` is an ``obs.reader.RunLog``."""
        base = ServingLatencyModel.from_calibration(run.calibration(),
                                                    source=run.path)
        return base.fit_events(run.iter_raw(), source=run.path)
