"""SLO plane: declarative objectives -> multi-window burn-rate alerts
(counterpart of bert_pytorch_tpu/telemetry/slo.py; stdlib only, like it).

- `load_slo_config(path)` reads a config such as `configs/slo.json`:
  per-phase SLO specs (serve: availability, a latency bound, a
  cost-per-1k-tokens ceiling) and the alerting windows; a malformed spec
  raises `ValueError` naming it.
- `SLOEngine` evaluates the specs against the server's MetricsRegistry
  (the scheduler's `bert_serve_*` families are the ground truth; no
  second measurement path). Each tick folds good/bad deltas into a
  sliding ring, then runs the multi-window multi-burn-rate rule per
  severity:

      burn = (bad fraction over a window) / error budget
      fire(severity) iff burn > threshold in BOTH the short and the long
      window of that severity's pair, with at least `min_events` events
      in the short one

  The defaults are the SRE workbook's: page 5 min / 1 h at 14.4x, ticket
  30 min / 6 h at 6x. The alert state is served as `GET /v1/alerts` and
  `GET /v1/slo` and folds into `/healthz` as `status: ok|degraded|failing`
  (a page firing -> failing, a ticket -> degraded). A firing latency alert
  carries the trace ids of the slowest retained requests.
- `FaultInjector` is the chaos drill (`--slo_inject`): it wraps the
  serving engine's `forward` on the host, after warmup, so the CUDA
  graphs are untouched. `error_burst` fails every batch, `latency_burst`
  sleeps before each, `corrupt_answers` negates one task's outputs
  (every request still answers 200; only the canary prober,
  serving/prober.py, sees it).

Time is injectable (`time_fn`) so tests drive the windows
deterministically.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

SEVERITIES = ("page", "ticket")
STATUS_BY_SEVERITY = {"page": "failing", "ticket": "degraded"}

# Google SRE workbook's multiwindow multi-burn-rate table: page on a
# fast burn (budget gone in ~2 days), ticket on a slow one (~5 days)
DEFAULT_WINDOWS = {
    "page": {"short_s": 300.0, "long_s": 3600.0, "burn_rate": 14.4},
    "ticket": {"short_s": 1800.0, "long_s": 21600.0, "burn_rate": 6.0},
}

KINDS = ("availability", "latency", "counter_ratio", "threshold")

# outcomes of bert_serve_requests_total that are the SERVER's fault;
# too_long is a 413 client error and burns no budget
DEFAULT_BAD_OUTCOMES = ("error", "timeout", "overloaded")


class SLOSpec:
    """One declarative objective. `budget` is the allowed bad fraction
    (1 - target); burn rate is measured against it."""

    def __init__(self, raw: Dict[str, Any], phase: str):
        if not isinstance(raw, dict):
            raise ValueError(f"SLO spec must be an object, got {raw!r}")
        self.name = raw.get("name")
        self.kind = raw.get("kind")
        self.phase = phase
        self.description = raw.get("description", "")
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"SLO spec without a 'name': {raw!r}")
        if self.kind not in KINDS:
            raise ValueError(f"SLO {self.name!r}: kind {self.kind!r} not "
                             f"one of {KINDS}")
        if "budget" in raw:
            self.budget = float(raw["budget"])
        else:
            self.budget = 1.0 - float(raw.get("target", 0.99))
        if not (0.0 < self.budget < 1.0):
            raise ValueError(f"SLO {self.name!r}: budget {self.budget} "
                             "must be in (0, 1) — set 'target' or "
                             "'budget'")
        self.min_events = max(1, int(raw.get("min_events", 1)))
        sevs = raw.get("severities", list(SEVERITIES))
        bad = sorted(set(sevs) - set(SEVERITIES))
        if bad:
            raise ValueError(f"SLO {self.name!r}: unknown severities "
                             f"{bad}")
        self.severities = tuple(s for s in SEVERITIES if s in sevs)
        # kind-specific knobs
        self.metric = raw.get("metric")
        if self.kind == "availability":
            self.metric = self.metric or "bert_serve_requests_total"
            self.label = raw.get("label", "outcome")
            self.good_values = tuple(raw.get("good_outcomes", ("ok",)))
            self.bad_values = tuple(raw.get("bad_outcomes",
                                            DEFAULT_BAD_OUTCOMES))
        elif self.kind == "latency":
            self.metric = self.metric or "bert_serve_request_latency_ms"
            self.bound_ms = float(raw["bound_ms"])
        elif self.kind == "counter_ratio":
            self.bad_metric = raw["bad_metric"]
            self.total_metric = raw["total_metric"]
        elif self.kind == "threshold":
            self.source = raw["source"]
            self.bound = float(raw["bound"])
            self.direction = raw.get("direction", "above")
            if self.direction not in ("above", "below"):
                raise ValueError(f"SLO {self.name!r}: direction must be "
                                 "'above' or 'below'")
            self.agg = raw.get("agg", "max")
            self.skip_zero = bool(raw.get("skip_zero", False))


class SLOConfig:
    """Parsed configs/slo.json: windows + per-phase spec lists."""

    def __init__(self, windows: Dict[str, Dict[str, float]],
                 specs: Dict[str, List[SLOSpec]]):
        self.windows = windows
        self.specs = specs

    def specs_for(self, phase: str) -> List[SLOSpec]:
        return list(self.specs.get(phase, []))


def load_slo_config(path: str) -> SLOConfig:
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: SLO config must be a JSON object")
    unknown = sorted(set(raw) - {"comment", "windows", "serve", "train"})
    if unknown:
        raise ValueError(f"{path}: unknown keys {unknown} — spec lists "
                         "go under a phase key ('serve' or 'train')")
    windows: Dict[str, Dict[str, float]] = {}
    for sev, dfl in DEFAULT_WINDOWS.items():
        w = dict(dfl)
        w.update(raw.get("windows", {}).get(sev, {}))
        w = {k: float(w[k]) for k in ("short_s", "long_s", "burn_rate")}
        if not (0 < w["short_s"] <= w["long_s"]):
            raise ValueError(f"{path}: {sev} windows need "
                             f"0 < short_s <= long_s, got {w}")
        if w["burn_rate"] <= 0:
            raise ValueError(f"{path}: {sev} burn_rate must be > 0")
        windows[sev] = w
    specs: Dict[str, List[SLOSpec]] = {}
    for phase in ("serve", "train"):
        phase_specs = [SLOSpec(entry, phase)
                       for entry in raw.get(phase, [])]
        names = [s.name for s in phase_specs]
        if len(set(names)) != len(names):
            raise ValueError(f"{path}: duplicate SLO names in {phase!r}")
        specs[phase] = phase_specs
    return SLOConfig(windows, specs)


class _SpecState:
    __slots__ = ("ring", "prev", "primed", "last_value")

    def __init__(self):
        # ring of (t, good_delta, bad_delta); pruned past the longest
        # window each tick
        self.ring: deque = deque()
        self.prev: Tuple[float, float] = (0.0, 0.0)
        # cumulative sources prime on the first tick so pre-engine
        # history is a baseline, not a burst stamped "now"
        self.primed = False
        self.last_value: Optional[float] = None


class SLOEngine:
    """Evaluate SLO specs against a MetricsRegistry; hold alert state.

    `evaluate()` is one tick (the SLOEvaluator thread or a test calls
    it); everything else is a read of the state it left behind. All
    public methods are thread-safe."""

    def __init__(self, specs: List[SLOSpec],
                 windows: Optional[Dict[str, Dict[str, float]]] = None,
                 registry=None, phase: str = "serve",
                 trace_ring=None, time_fn: Callable[[], float] = time.time,
                 log: Optional[Callable[[str], None]] = None):
        self.specs = list(specs)
        self.windows = {s: dict(w) for s, w in
                        (windows or DEFAULT_WINDOWS).items()}
        self.registry = registry
        self.phase = phase
        self.trace_ring = trace_ring
        self.time_fn = time_fn
        self.log = log
        self._lock = threading.Lock()
        self._state = {s.name: _SpecState() for s in self.specs}
        self._firing: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._resolved: deque = deque(maxlen=16)
        self._external: List[Callable[[], List[Dict[str, Any]]]] = []
        self._sources: Dict[str, Callable[[], Optional[float]]] = {}
        self._evaluations = 0
        self._last_eval_unix: Optional[float] = None
        self._max_window = max((w["long_s"]
                                for w in self.windows.values()),
                               default=0.0)
        if registry is not None:
            self._m_evals = registry.counter(
                "bert_slo_evaluations_total",
                "SLO engine evaluation ticks")
            self._m_fired = registry.counter(
                "bert_slo_alerts_fired_total",
                "alert firing transitions by SLO and severity",
                labels=("slo", "severity"))
            self._m_firing = registry.gauge(
                "bert_slo_alerts_firing",
                "alerts currently firing by severity",
                labels=("severity",))
            self._m_budget = registry.gauge(
                "bert_slo_budget_remaining",
                "error-budget fraction left over the longest window",
                labels=("slo",))
            for sev in SEVERITIES:
                self._m_firing.set(0.0, severity=sev)
        else:
            self._m_evals = self._m_fired = None
            self._m_firing = self._m_budget = None

    # -- wiring ---------------------------------------------------------------

    def set_source(self, name: str,
                   fn: Callable[[], Optional[float]]) -> None:
        """Register a named value source for `threshold` specs that is
        not a gauge (e.g. train's checkpoint_age_s). Returning None
        means "no data this tick" — the sample is skipped, not bad."""
        self._sources[name] = fn

    def add_alert_source(self,
                         fn: Callable[[], List[Dict[str, Any]]]) -> None:
        """Merge an external producer's firing alerts (the canary
        prober) into alerts()/status(). Each dict needs at least
        'slo' and 'severity'."""
        self._external.append(fn)

    # -- reading the registry -------------------------------------------------

    def _families(self) -> Dict[str, Any]:
        if self.registry is None:
            return {}
        return {m.name: m for m in self.registry.families()}

    def _read_cumulative(self, spec: SLOSpec,
                         fams: Dict[str, Any]
                         ) -> Optional[Tuple[float, float]]:
        """Cumulative (good_total, bad_total) for counter-backed kinds."""
        if spec.kind == "availability":
            m = fams.get(spec.metric)
            if m is None:
                return None
            good = bad = 0.0
            for labels, value in m.labeled_series():
                v = labels.get(spec.label)
                if v in spec.bad_values:
                    bad += value
                elif v in spec.good_values:
                    good += value
            return good, bad
        if spec.kind == "latency":
            m = fams.get(spec.metric)
            if m is None or not hasattr(m, "buckets"):
                return None
            good = total = 0.0
            # largest bucket edge <= bound: conservative when the bound
            # falls between edges (requests in the straddling bucket
            # count bad)
            n_le = sum(1 for b in m.buckets if b <= spec.bound_ms)
            for _labels, s in m.labeled_series():
                total += s.count
                good += sum(s.counts[:n_le])
            return good, total - good
        if spec.kind == "counter_ratio":
            mb = fams.get(spec.bad_metric)
            mt = fams.get(spec.total_metric)
            if mb is None or mt is None:
                return None
            bad = sum(v for _l, v in mb.labeled_series())
            total = sum(v for _l, v in mt.labeled_series())
            return max(total - bad, 0.0), bad
        return None

    def _read_threshold(self, spec: SLOSpec,
                        fams: Dict[str, Any]) -> Optional[float]:
        src = spec.source
        if src.startswith("gauge:"):
            m = fams.get(src[len("gauge:"):])
            if m is None:
                return None
            vals = [v for _l, v in m.labeled_series()
                    if isinstance(v, (int, float))]
            if spec.skip_zero:
                vals = [v for v in vals if v != 0.0]
            if not vals:
                return None
            return min(vals) if spec.agg == "min" else max(vals)
        fn = self._sources.get(src)
        if fn is None:
            return None
        try:
            v = fn()
        except Exception:
            return None  # a broken source must not take the plane down
        return float(v) if isinstance(v, (int, float)) else None

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One tick: fold deltas into each spec's ring, run the
        multi-window rule, transition alerts. Returns the alerts view."""
        with self._lock:
            now = self.time_fn() if now is None else float(now)
            fams = self._families()
            for spec in self.specs:
                st = self._state[spec.name]
                if spec.kind == "threshold":
                    v = self._read_threshold(spec, fams)
                    st.last_value = v
                    if v is None:
                        dg = db = 0.0
                    else:
                        breach = (v > spec.bound
                                  if spec.direction == "above"
                                  else v < spec.bound)
                        dg, db = (0.0, 1.0) if breach else (1.0, 0.0)
                else:
                    tot = self._read_cumulative(spec, fams)
                    if tot is None:
                        dg = db = 0.0
                    elif not st.primed:
                        st.prev, st.primed = tot, True
                        dg = db = 0.0
                    else:
                        dg = max(tot[0] - st.prev[0], 0.0)
                        db = max(tot[1] - st.prev[1], 0.0)
                        st.prev = tot
                st.ring.append((now, dg, db))
                cutoff = now - self._max_window - 1.0
                while st.ring and st.ring[0][0] < cutoff:
                    st.ring.popleft()
                self._judge(spec, st, now)
            self._evaluations += 1
            self._last_eval_unix = now
            if self._m_evals is not None:
                self._m_evals.inc()
                for sev in SEVERITIES:
                    n = sum(1 for (_s, s2) in self._firing if s2 == sev)
                    self._m_firing.set(float(n), severity=sev)
            return self._alerts_view_locked(now)

    def _window_sums(self, st: _SpecState, now: float,
                     window_s: float) -> Tuple[float, float]:
        good = bad = 0.0
        for t, g, b in reversed(st.ring):
            if t < now - window_s:
                break
            good += g
            bad += b
        return good, bad

    def _burn(self, st: _SpecState, now: float, window_s: float,
              budget: float) -> Tuple[float, float]:
        """(burn_rate, events) over the window; burn 0 with no events."""
        good, bad = self._window_sums(st, now, window_s)
        events = good + bad
        if events <= 0:
            return 0.0, 0.0
        return (bad / events) / budget, events

    def _judge(self, spec: SLOSpec, st: _SpecState, now: float) -> None:
        for sev in spec.severities:
            w = self.windows[sev]
            burn_s, ev_s = self._burn(st, now, w["short_s"], spec.budget)
            burn_l, _ev_l = self._burn(st, now, w["long_s"], spec.budget)
            firing = (ev_s >= spec.min_events
                      and burn_s > w["burn_rate"]
                      and burn_l > w["burn_rate"])
            key = (spec.name, sev)
            cur = self._firing.get(key)
            if firing and cur is None:
                alert = {
                    "slo": spec.name, "severity": sev,
                    "phase": self.phase, "kind": spec.kind,
                    "description": spec.description,
                    "budget": spec.budget,
                    "windows": {"short_s": w["short_s"],
                                "long_s": w["long_s"],
                                "burn_threshold": w["burn_rate"]},
                    "since_unix": round(now, 3),
                }
                self._firing[key] = alert
                if self._m_fired is not None:
                    self._m_fired.inc(slo=spec.name, severity=sev)
                if self.log:
                    self.log(f"SLO ALERT firing [{sev}] {spec.name}: "
                             f"burn {burn_s:.1f}x/{burn_l:.1f}x over "
                             f"{w['short_s']:g}s/{w['long_s']:g}s "
                             f"(threshold {w['burn_rate']:g}x, budget "
                             f"{spec.budget:g})")
                cur = alert
            elif not firing and cur is not None:
                cur = self._firing.pop(key)
                cur["resolved_unix"] = round(now, 3)
                self._resolved.append(cur)
                if self.log:
                    self.log(f"SLO alert resolved [{sev}] {spec.name} "
                             f"after {now - cur['since_unix']:.1f}s")
                cur = None
            if cur is not None:
                cur["burn_short"] = round(burn_s, 3)
                cur["burn_long"] = round(burn_l, 3)
                cur["last_eval_unix"] = round(now, 3)
                if spec.kind == "latency" and self.trace_ring is not None:
                    # the slowest retained in-window requests ARE the
                    # alert's evidence (GET /v1/traces?id=... finds them)
                    try:
                        cur["trace_ids"] = [
                            t.trace_id
                            for t in self.trace_ring.traces(limit=8)]
                    except Exception:
                        pass
                if spec.kind == "threshold" \
                        and st.last_value is not None:
                    cur["value"] = round(st.last_value, 6)
                    cur["bound"] = spec.bound

    # -- views ----------------------------------------------------------------

    def _external_alerts(self) -> List[Dict[str, Any]]:
        out = []
        for fn in self._external:
            try:
                for a in fn() or []:
                    if isinstance(a, dict) and a.get("slo") \
                            and a.get("severity") in SEVERITIES:
                        out.append(dict(a))
            except Exception:
                pass  # an alert source must never take the server down
        return out

    def _alerts_view_locked(self, now: float) -> Dict[str, Any]:
        firing = sorted((dict(a) for a in self._firing.values()),
                        key=lambda a: (a["severity"] != "page",
                                       a["slo"]))
        firing += self._external_alerts()
        sevs = {a["severity"] for a in firing}
        status = ("failing" if "page" in sevs
                  else "degraded" if "ticket" in sevs else "ok")
        return {"status": status, "phase": self.phase,
                "firing": firing,
                "resolved": list(self._resolved),
                "evaluations": self._evaluations,
                "last_eval_unix": self._last_eval_unix}

    def alerts_view(self) -> Dict[str, Any]:
        """The /v1/alerts payload."""
        with self._lock:
            return self._alerts_view_locked(
                self._last_eval_unix or self.time_fn())

    def status(self) -> str:
        """ok | degraded | failing — the /healthz verdict."""
        return self.alerts_view()["status"]

    def page_firing_since(self) -> Optional[float]:
        """Earliest since_unix among firing page-severity alerts (None
        when no page is firing)."""
        view = self.alerts_view()
        stamps = [a.get("since_unix") for a in view["firing"]
                  if a.get("severity") == "page"]
        stamps = [s for s in stamps if isinstance(s, (int, float))]
        return min(stamps) if stamps else None

    def slo_view(self) -> Dict[str, Any]:
        """The /v1/slo budget-remaining payload."""
        with self._lock:
            now = self._last_eval_unix or self.time_fn()
            slos: Dict[str, Any] = {}
            for spec in self.specs:
                st = self._state[spec.name]
                longest = max(self.windows[s]["long_s"]
                              for s in spec.severities)
                good, bad = self._window_sums(st, now, longest)
                events = good + bad
                bad_frac = bad / events if events else 0.0
                remaining = max(0.0, 1.0 - bad_frac / spec.budget)
                burns = {}
                for sev in spec.severities:
                    w = self.windows[sev]
                    bs, _ = self._burn(st, now, w["short_s"],
                                       spec.budget)
                    bl, _ = self._burn(st, now, w["long_s"],
                                       spec.budget)
                    burns[sev] = {
                        "short": round(bs, 3), "long": round(bl, 3),
                        "threshold": w["burn_rate"],
                        "firing": (spec.name, sev) in self._firing}
                entry = {
                    "kind": spec.kind,
                    "description": spec.description,
                    "budget": spec.budget,
                    "window_s": longest,
                    "events": round(events, 3),
                    "bad": round(bad, 3),
                    "bad_frac": round(bad_frac, 6),
                    "budget_remaining": round(remaining, 6),
                    "burn": burns,
                    "firing": sorted(s for (n, s) in self._firing
                                     if n == spec.name),
                }
                if spec.kind == "threshold":
                    entry["value"] = st.last_value
                    entry["bound"] = spec.bound
                slos[spec.name] = entry
                if self._m_budget is not None:
                    self._m_budget.set(remaining, slo=spec.name)
            return {"phase": self.phase,
                    "status": self._alerts_view_locked(now)["status"],
                    "windows": self.windows,
                    "evaluations": self._evaluations,
                    "last_eval_unix": self._last_eval_unix,
                    "slos": slos}

    def health_summary(self) -> Dict[str, Any]:
        """Compact block for /healthz (the full views live on /v1/*)."""
        view = self.alerts_view()
        return {
            "status": view["status"],
            "alerts_firing": len(view["firing"]),
            "firing": [f"{a['slo']}:{a['severity']}"
                       for a in view["firing"]],
            "evaluations": view["evaluations"],
            "last_eval_unix": view["last_eval_unix"],
        }


class SLOEvaluator:
    """Daemon thread ticking engine.evaluate() at a fixed interval —
    the serve/train loops never block on SLO math."""

    def __init__(self, engine: SLOEngine, interval_s: float = 1.0):
        self.engine = engine
        self.interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="slo-evaluator", daemon=True)

    def start(self) -> "SLOEvaluator":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.engine.evaluate()
            except Exception:
                pass  # the evaluator must outlive a bad tick

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def _negate_tree(out):
    """Negate every array leaf (tuples/lists/dicts recursed): the
    engine's host numpy outputs implement __neg__."""
    if isinstance(out, (tuple, list)):
        return type(out)(_negate_tree(o) for o in out)
    if isinstance(out, dict):
        return {k: _negate_tree(v) for k, v in out.items()}
    return -out


class FaultInjector:
    """The --slo_inject chaos drill: wraps serving engines' HOST-side
    forward so the alert path can be proven live (same convention as
    --chaos / --stream_inject / --inject elsewhere).

    - error_burst:    every wave raises -> outcome=error 500s -> the
                      availability SLO burns -> page within one fast
                      window.
    - latency_burst:  sleep before each wave -> the latency SLO burns.
    - corrupt_answers: negate ONE task's logits -> every request still
                      200s fast, but decoded answers change — the
                      corruption only the canary prober catches.

    Activation is time-based (`after_s` after install) so a drill run
    has a clean head for baselines; tests flip `force(True/False)`
    directly. Wrapping happens AFTER warmup — the CUDA graphs are
    untouched, the fault lives on the host."""

    MODES = ("error_burst", "latency_burst", "corrupt_answers")

    def __init__(self, mode: str, after_s: float = 2.0,
                 task: Optional[str] = None, latency_ms: float = 400.0,
                 time_fn: Callable[[], float] = time.monotonic):
        if mode not in self.MODES:
            raise ValueError(f"--slo_inject {mode!r} not one of "
                             f"{self.MODES}")
        self.mode = mode
        self.task = task
        self.after_s = float(after_s)
        self.latency_ms = float(latency_ms)
        self._time_fn = time_fn
        self._t0 = time_fn()
        self._forced: Optional[bool] = None

    def active(self) -> bool:
        if self._forced is not None:
            return self._forced
        return (self._time_fn() - self._t0) >= self.after_s

    def force(self, active: Optional[bool]) -> None:
        """Override the timer: True/False pins the state, None returns
        to time-based activation (tests drive drills this way)."""
        self._forced = active

    def set_mode(self, mode: str) -> None:
        if mode not in self.MODES:
            raise ValueError(f"mode {mode!r} not one of {self.MODES}")
        self.mode = mode

    def install(self, engine) -> None:
        """Wrap engine.forward(task, batch) in place (idempotent per
        engine instance)."""
        orig = engine.forward

        def forward(task, batch):
            if self.active():
                if self.mode == "error_burst":
                    raise RuntimeError(
                        "slo_inject: synthetic error burst")
                if self.mode == "latency_burst":
                    time.sleep(self.latency_ms / 1e3)
                elif self.mode == "corrupt_answers" and (
                        self.task is None or task == self.task):
                    return _negate_tree(orig(task, batch))
            return orig(task, batch)

        engine.forward = forward
