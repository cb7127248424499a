"""Training-health observatory: per-layer telemetry on the device and the
detectors on the host (counterpart of ``paddle_tpu/observe/health.py``).

This module answers "is the model healthy".  Two halves:

- **Device side** (``--health_interval N > 0``): the trainer folds one
  step's per-layer gradient norms, parameter norms, update norms (for the
  ‖Δw‖/‖w‖ ratio) and non-finite flags into a small
  :class:`HealthState` of device tensors (one of length L per field plus
  a step counter), keyed to the reference's layer names
  (:func:`layer_param_map`).  The step never reads the state back: the
  non-finite bookkeeping is ``torch.where`` on the device, and the
  per-parameter reductions are grouped (``torch._foreach_norm`` over the
  gradients, the old parameters and the deltas, one ``index_add_`` into
  the layers), always in fp32.  The trainer drains the state every N
  steps and at pass ends: one device-to-host copy of the stacked state
  (with the step's loss) is the only fence the feature buys.  With the
  flag at its default 0 the step runs none of this.
- **Host side**: :class:`HealthMonitor` turns the drained stream into
  verdicts — first-non-finite localization (which layer's gradient went
  inf/nan first, with ``--precision=bf16`` loss-scale skip steps counted
  as *benign* and never alerted), loss-spike and plateau detection over
  a rolling median/MAD window, and dead-/exploding-layer flags from the
  update ratio.  Each detector emits a warn-once log line, a
  ``health_alerts_total{kind,layer}`` increment, and a structured entry
  served by ``/health`` (and summarized as degraded-but-alive detail on
  ``/healthz``).

Sharded parameters (FSDP, tensor parallel): a norm is of the whole
parameter.  Each rank folds the sums of squares of the shards it owns —
a replicated parameter, or the replicated part of a placement, is owned
by the rank at coordinate 0 of the axes it is not sharded on, so no
parameter is summed twice — and the drain gathers every rank's partial
sums in one collective and reduces them (the sums added, non-finite
step counts by their maximum, the first non-finite step by its
minimum).  The step adds no collective.

Importing this module imports no torch; torch enters the functions that
build and fold the device state.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

from ..analysis.lockorder import named_lock
from .metrics import counter, gauge, histogram

#: Region name for parameters no layer claims (the roofline
#: attribution's fallback bucket, so the two surfaces stay joinable).
UNATTRIBUTED = "_unattributed"

#: ``first_nonfinite`` sentinel: the layer never went non-finite.
NEVER = -1

#: Loss histogram buckets: losses live on a log scale, not a latency
#: scale — 1e-4 … 1e4 in decades plus the DEFAULT_BUCKETS-style tail.
LOSS_BUCKETS = (1e-4, 1e-3, 1e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                25.0, 100.0, 1e3, 1e4)


# --------------------------------------------------------- layer keying
def layer_param_map(network) -> List[Tuple[str, List[str]]]:
    """``[(layer_name, [param names])...]`` for every parameter-owning
    layer, keyed as the reference's roofline regions: top-level layers
    by name, recurrent-group step layers as ``"<layer>.<group>"``.  A
    parameter two layers declare belongs to its first declarer;
    parameters in ``network.param_specs`` that no layer claims land in
    :data:`UNATTRIBUTED`."""
    owned: Dict[str, List[str]] = {}
    order: List[str] = []
    seen: set = set()

    def claim(layer_key: str, layer) -> None:
        try:
            specs = layer.param_specs()
        except Exception:  # noqa: BLE001 — telemetry never kills
            return
        for spec in specs:
            if spec.name in seen or spec.name not in network.param_specs:
                continue
            seen.add(spec.name)
            if layer_key not in owned:
                owned[layer_key] = []
                order.append(layer_key)
            owned[layer_key].append(spec.name)

    for name, layer in network.layers.items():
        claim(name, layer)
    for gname, grp in getattr(network, "groups", {}).items():
        for name, layer in getattr(grp, "layers", {}).items():
            claim(f"{name}.{gname}", layer)
    unclaimed = [n for n in sorted(network.param_specs) if n not in seen]
    if unclaimed:
        owned[UNATTRIBUTED] = unclaimed
        order.append(UNATTRIBUTED)
    return [(k, owned[k]) for k in order]


# ------------------------------------------------------ device-side state
class HealthState(NamedTuple):
    """Per-layer device accumulators carried on the trainer (tensors of
    length L = number of parameter-owning layers).  ``steps`` counts
    steps since the last drain; norms hold the LAST step's values
    (gauges are point-in-time), the non-finite fields accumulate so an
    incident between drains is never missed."""
    steps: Any                    # i32 []
    grad_sq: Any                  # f32 [L]  ‖g‖² per layer, last step
    param_sq: Any                 # f32 [L]  ‖w‖² per layer, last step
    update_sq: Any                # f32 [L]  ‖Δw‖² per layer, last step
    nonfinite_steps: Any          # i32 [L]  steps with inf/nan grads,
    #                                        update APPLIED (pathological)
    benign_nonfinite_steps: Any   # i32 [L]  steps with inf/nan grads,
    #                                        update SKIPPED (loss scale)
    first_nonfinite: Any          # i32 [L]  step index of first inf/nan
    #                                        since drain; NEVER = none


def init_state(num_layers: int, device=None) -> HealthState:
    """A zeroed accumulator on ``device`` (each field its own tensor)."""
    import torch

    def z(dtype, fill=0):
        return torch.full((num_layers,), fill, dtype=dtype, device=device)

    return HealthState(
        steps=torch.zeros((), dtype=torch.int32, device=device),
        grad_sq=z(torch.float32), param_sq=z(torch.float32),
        update_sq=z(torch.float32),
        nonfinite_steps=z(torch.int32),
        benign_nonfinite_steps=z(torch.int32),
        first_nonfinite=z(torch.int32, NEVER))


def layer_stats(index, grads: Sequence, params: Sequence,
                new_params: Sequence, num_layers: int, finite_flags=None):
    """(grad_sq[L], param_sq[L], update_sq[L], nonfinite[L]) of one step.

    ``grads``, ``params`` and ``new_params`` are lists in one order;
    ``index`` (an int64 device tensor) gives each entry's layer.  Each
    quantity is one grouped ``torch._foreach_norm`` over the fp32 views,
    squared and added into its layer by one ``index_add_``.
    ``finite_flags`` (a bool tensor, one flag an entry) lets the bf16
    step hand over the per-parameter flags its loss-scale skip decision
    already computed (``loss_scale.leaf_finite_flags``); without them an
    entry is non-finite when its max-norm is (no overflow can fake it)."""
    import torch

    device = index.device
    zeros = torch.zeros(3, num_layers, dtype=torch.float32, device=device)
    nf = torch.zeros(num_layers, dtype=torch.int32, device=device)
    if not grads:
        return zeros[0], zeros[1], zeros[2], nf
    g = [x.float() for x in grads]
    w = [x.float() for x in params]
    d = torch._foreach_sub([x.float() for x in new_params], w)
    norms = torch.stack(torch._foreach_norm(g) + torch._foreach_norm(w)
                        + torch._foreach_norm(d)).float()
    sums = zeros.index_add_(1, index, norms.square().view(3, len(g)))
    if finite_flags is None:
        finite_flags = torch.isfinite(torch.stack(
            torch._foreach_norm(g, float("inf"))))
    nf.index_add_(0, index, (~finite_flags).to(torch.int32))
    return sums[0], sums[1], sums[2], nf


def accumulate(state: HealthState, stats, applied) -> HealthState:
    """Fold one step's :func:`layer_stats` into the accumulator, on the
    device.  ``applied`` says whether the optimizer update was applied:
    a Python bool, or the bf16 step's 0-d ``finite`` tensor (False on a
    loss-scale skip step — those non-finites count as *benign*)."""
    import torch

    grad_sq, param_sq, update_sq, nonfinite = stats
    had_nf = nonfinite > 0
    if isinstance(applied, bool):
        patho = had_nf if applied else torch.zeros_like(had_nf)
        benign = torch.zeros_like(had_nf) if applied else had_nf
    else:
        patho = had_nf & applied
        benign = had_nf & ~applied
    return HealthState(
        steps=state.steps + 1,
        grad_sq=grad_sq, param_sq=param_sq, update_sq=update_sq,
        nonfinite_steps=state.nonfinite_steps + patho.to(torch.int32),
        benign_nonfinite_steps=state.benign_nonfinite_steps
        + benign.to(torch.int32),
        first_nonfinite=torch.where(
            (state.first_nonfinite == NEVER) & had_nf,
            state.steps, state.first_nonfinite))


# ----------------------------------------------------------- host side
def _finite_or_none(v: float) -> Optional[float]:
    return v if math.isfinite(v) else None


class HealthMonitor:
    """Rolling host-side detectors over drained :class:`HealthState`
    reports.  One instance per trainer; thread-safe (the drain runs on
    the training thread, ``/health`` reads from scraper threads)."""

    def __init__(self, layers: Sequence[str],
                 window: int = 32, spike_mad: float = 8.0,
                 plateau_rtol: float = 1e-4,
                 dead_ratio: float = 1e-10,
                 explode_ratio: float = 0.5,
                 patience: int = 2):
        self.layers = list(layers)
        self.window = max(4, int(window))
        self.spike_mad = float(spike_mad)
        self.plateau_rtol = float(plateau_rtol)
        self.dead_ratio = float(dead_ratio)
        self.explode_ratio = float(explode_ratio)
        self.patience = max(1, int(patience))
        self._losses: deque = deque(maxlen=self.window)
        self._dead_streak: Dict[str, int] = {}
        self._explode_streak: Dict[str, int] = {}
        self._fired: set = set()
        # conditions that held on the LAST drain — the "standing
        # alerts" set /healthz degrades on; rebuilt every observe() so
        # a recovered run goes back to "ok" (the historical _alerts
        # log keeps the incident for /health forensics)
        self._active: set = set()
        self._alerts: deque = deque(maxlen=64)
        self._lock = named_lock("observe.health")
        self.drains = 0

    @classmethod
    def from_flags(cls, layers: Sequence[str]) -> "HealthMonitor":
        from ..utils import FLAGS

        return cls(layers,
                   window=FLAGS.get("health_window"),
                   spike_mad=FLAGS.get("health_spike_mad"),
                   plateau_rtol=FLAGS.get("health_plateau_rtol"),
                   dead_ratio=FLAGS.get("health_dead_ratio"),
                   explode_ratio=FLAGS.get("health_explode_ratio"),
                   patience=FLAGS.get("health_patience"))

    # ------------------------------------------------------- detectors
    def _fire(self, kind: str, layer: str, detail: str,
              alerts: List[Dict[str, Any]]) -> None:
        """Warn-once per (kind, layer): the log line and the structured
        entry fire on the first occurrence; the counter counts every
        drain that re-observes the condition (alert pressure is a
        signal too)."""
        counter(
            "health_alerts_total",
            "training-health detector verdicts by kind "
            "(nonfinite | loss_spike | loss_plateau | dead_layer | "
            "exploding_layer) and layer").inc(kind=kind, layer=layer)
        key = (kind, layer)
        if key in self._fired:
            return
        self._fired.add(key)
        entry = {"kind": kind, "layer": layer, "detail": detail,
                 "ts": round(time.time(), 3)}
        self._alerts.append(entry)
        alerts.append(entry)
        from ..utils.logger import get_logger, warn_once

        warn_once(f"health:{kind}:{layer}",
                  "training-health alert [%s] layer=%s: %s",
                  kind, layer, detail, logger=get_logger("observe"))

    def _robust_window(self) -> Tuple[Optional[float], Optional[float]]:
        """(median, MAD) of the loss window (None, None when too few
        samples for a robust verdict)."""
        vals = sorted(self._losses)
        n = len(vals)
        if n < 4:
            return None, None
        med = (vals[n // 2] if n % 2
               else 0.5 * (vals[n // 2 - 1] + vals[n // 2]))
        dev = sorted(abs(v - med) for v in vals)
        mad = (dev[n // 2] if n % 2
               else 0.5 * (dev[n // 2 - 1] + dev[n // 2]))
        return med, mad

    def observe(self, report: Dict[str, Any],
                loss: Optional[float]) -> List[Dict[str, Any]]:
        """Run every detector over one drained report; returns the
        alerts NEWLY fired by this drain (the structured entries)."""
        alerts: List[Dict[str, Any]] = []
        active: set = set()
        with self._lock:
            self.drains += 1
            # --- non-finite localization: pathological only.  Benign
            # loss-scale skips are already counted by
            # loss_scale_skipped_steps_total and must not alert.
            patho = [(l, r) for l, r in report["layers"].items()
                     if r["nonfinite_steps"] > 0]
            if patho:
                firsts = [r["first_nonfinite"] for _, r in patho
                          if r["first_nonfinite"] != NEVER]
                first_step = min(firsts) if firsts else NEVER
                culprits = [l for l, r in patho
                            if r["first_nonfinite"] == first_step]
                for l in culprits or [l for l, _ in patho]:
                    active.add(("nonfinite", l))
                    self._fire(
                        "nonfinite", l,
                        f"gradients went inf/nan at step "
                        f"{report['base_step'] + max(first_step, 0)} "
                        "with the update APPLIED (no loss-scale "
                        "skip protected it)", alerts)
            # --- loss spike / plateau over the rolling robust window
            if loss is not None and math.isfinite(loss):
                med, mad = self._robust_window()
                if med is not None:
                    # sigma floor: a perfectly flat window has MAD 0,
                    # and the classic spike — constant loss, then a
                    # jump — must still trip the detector
                    sigma = max(1.4826 * (mad or 0.0),
                                self.plateau_rtol
                                * max(abs(med), 1e-12))
                    if loss > med + self.spike_mad * sigma:
                        active.add(("loss_spike", "_model"))
                        self._fire(
                            "loss_spike", "_model",
                            f"loss {loss:.6g} above rolling median "
                            f"{med:.6g} + {self.spike_mad:.3g} robust "
                            f"sigma ({sigma:.3g})", alerts)
                    elif (len(self._losses) == self.window
                          and max(self._losses) - min(self._losses)
                          <= self.plateau_rtol * max(abs(med), 1e-12)
                          and abs(loss - med)
                          <= self.plateau_rtol * max(abs(med), 1e-12)):
                        active.add(("loss_plateau", "_model"))
                        self._fire(
                            "loss_plateau", "_model",
                            f"loss flat within rtol "
                            f"{self.plateau_rtol:.1g} of {med:.6g} "
                            f"over the last {self.window} drains",
                            alerts)
                self._losses.append(loss)
            # --- dead / exploding layers from the update ratio
            for l, r in report["layers"].items():
                ratio = r["update_ratio"]
                grad = r["grad_norm"]
                if ratio is None or grad is None:
                    # a drain without a usable reading (non-finite
                    # norms) breaks the "N CONSECUTIVE drains" streaks
                    # — the non-finite detectors own this state
                    self._dead_streak[l] = 0
                    self._explode_streak[l] = 0
                    continue
                dead = (grad == 0.0 or ratio <= self.dead_ratio)
                self._dead_streak[l] = self._dead_streak.get(l, 0) + 1 \
                    if dead else 0
                if self._dead_streak[l] >= self.patience:
                    active.add(("dead_layer", l))
                    self._fire(
                        "dead_layer", l,
                        f"update ratio {ratio:.3g} <= "
                        f"{self.dead_ratio:.1g} for "
                        f"{self._dead_streak[l]} consecutive drains "
                        "(no learning signal reaches this layer)",
                        alerts)
                explode = ratio > self.explode_ratio
                self._explode_streak[l] = \
                    self._explode_streak.get(l, 0) + 1 if explode else 0
                if self._explode_streak[l] >= self.patience:
                    active.add(("exploding_layer", l))
                    self._fire(
                        "exploding_layer", l,
                        f"update ratio {ratio:.3g} > "
                        f"{self.explode_ratio:.3g} for "
                        f"{self._explode_streak[l]} consecutive drains "
                        "(step size is rewriting the layer)", alerts)
            self._active = active
        return alerts

    def recent_alerts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._alerts)

    def active_conditions(self) -> List[Tuple[str, str]]:
        """(kind, layer) conditions that held on the LAST drain — the
        "standing alerts" /healthz degrades on.  Empty once the run
        recovers (streaks reset, no pathological non-finites), even
        though the historical :meth:`recent_alerts` log keeps the
        incident for forensics."""
        with self._lock:
            return sorted(self._active)


# ------------------------------------------------------ trainer session
class HealthSession:
    """Everything the trainer holds for an enabled health path: the
    static layer grouping, the device accumulator, the drain cadence and
    the monitor.  :meth:`bind` fixes the device and the parameters this
    rank owns (all of them on one device); :meth:`fold` is the step's
    part, :meth:`drain` the fence."""

    def __init__(self, network, interval: int,
                 monitor: Optional[HealthMonitor] = None):
        self.interval = max(1, int(interval))
        self.pairs = layer_param_map(network)
        self.layers = [k for k, _ in self.pairs]
        self.groups = [names for _, names in self.pairs]
        #: every parameter in layer order, and its layer's position
        self.names = [n for names in self.groups for n in names]
        self._layer_of = [i for i, names in enumerate(self.groups)
                          for _ in names]
        self.monitor = monitor or HealthMonitor.from_flags(self.layers)
        self.state: Optional[HealthState] = None
        self.device = None
        self.owned = list(self.names)
        self._index = None
        self._sel = None
        self._world = None
        self._since_drain = 0
        self._base_step = 0

    def bind(self, device, owned: Optional[Sequence[str]] = None,
             world=None) -> None:
        """The device the state lives on, the parameters whose (shard)
        sums this rank folds (``None``: all), and the process group the
        drain gathers over (``None``: no collective)."""
        import torch

        owned_set = set(self.names if owned is None else owned)
        self.device = device
        self.owned = [n for n in self.names if n in owned_set]
        pos = [i for i, n in enumerate(self.names) if n in owned_set]
        self._index = torch.tensor([self._layer_of[i] for i in pos],
                                   dtype=torch.int64, device=device)
        self._sel = None if len(pos) == len(self.names) else \
            torch.tensor(pos, dtype=torch.int64, device=device)
        self._world = world

    def ensure_state(self) -> HealthState:
        if self.state is None:
            self.state = init_state(len(self.layers), self.device)
        return self.state

    def fold(self, grads: Dict[str, Any], params: Dict[str, Any],
             new_params: Dict[str, Any], applied=True,
             finite_flags=None) -> None:
        """Fold one step: ``grads``/``params``/``new_params`` by name
        (this rank's shards), ``finite_flags`` one per :attr:`names`
        entry from the bf16 step's sweep, ``applied`` its ``finite``."""
        if finite_flags is not None and self._sel is not None:
            finite_flags = finite_flags.index_select(0, self._sel)
        stats = layer_stats(self._index, [grads[n] for n in self.owned],
                            [params[n] for n in self.owned],
                            [new_params[n] for n in self.owned],
                            len(self.layers), finite_flags)
        self.state = accumulate(self.ensure_state(), stats, applied)

    def step_done(self) -> bool:
        """Tick the host-side step mirror; True when a drain is due."""
        self._since_drain += 1
        return self._since_drain >= self.interval

    def pending(self) -> bool:
        return self.state is not None and self._since_drain > 0

    def _fetch(self, loss) -> Tuple[Optional[float], List[float]]:
        """The state (reduced over the bound group first) and the
        loss in ONE device-to-host copy."""
        import torch
        import torch.distributed as dist

        st = self.state
        if self._world is not None:
            # one collective at the drain: every rank's fields gathered
            # (float64 holds the int32 counts exactly) and reduced here
            mine = torch.stack([t.to(torch.float64) for t in (
                st.grad_sq, st.param_sq, st.update_sq, st.nonfinite_steps,
                st.benign_nonfinite_steps,
                torch.where(st.first_nonfinite == NEVER,
                            torch.iinfo(torch.int32).max,
                            st.first_nonfinite))])
            every = [torch.empty_like(mine)
                     for _ in range(dist.get_world_size(self._world))]
            dist.all_gather(every, mine, group=self._world)
            every = torch.stack(every)
            sums = every[:, :3].sum(0)
            counts = every[:, 3:5].amax(0).to(torch.int32)
            first = every[:, 5].amin(0).to(torch.int32)
            st = st._replace(
                grad_sq=sums[0], param_sq=sums[1], update_sq=sums[2],
                nonfinite_steps=counts[0], benign_nonfinite_steps=counts[1],
                first_nonfinite=torch.where(
                    first == torch.iinfo(torch.int32).max, NEVER, first))
        parts = [st.steps.reshape(1), st.grad_sq, st.param_sq,
                 st.update_sq, st.nonfinite_steps,
                 st.benign_nonfinite_steps, st.first_nonfinite]
        has_loss = isinstance(loss, torch.Tensor)
        if has_loss:
            parts.insert(0, loss.detach().reshape(1))
        host = torch.cat([p.to(torch.float64) for p in parts]).cpu().tolist()
        if has_loss:
            return host[0], host[1:]
        return (None if loss is None else float(loss)), host

    # ---------------------------------------------------------- drain
    def drain(self, loss=None) -> Optional[Dict[str, Any]]:
        """Fetch the device accumulator (the amortized fence) with the
        step's ``loss`` (a 0-d device tensor rides the same copy),
        publish gauges/counters, run the detectors, reset the
        accumulator, and stash the structured report for ``/health``.
        Returns the report (None when nothing accumulated)."""
        if self.state is None or self._since_drain == 0:
            return None
        loss, host = self._fetch(loss)
        n = len(self.layers)
        steps = int(host[0])
        if steps == 0:
            self._since_drain = 0
            return None
        grad_sq, param_sq, update_sq = (host[1 + k * n:1 + (k + 1) * n]
                                        for k in range(3))
        nf, benign, first = ([int(v) for v in host[1 + k * n:
                                                   1 + (k + 1) * n]]
                             for k in range(3, 6))
        layers: Dict[str, Dict[str, Any]] = {}
        g_gauge = gauge(
            "health_grad_norm",
            "per-layer L2 gradient norm at the last drained step "
            "(--health_interval; layer names match the roofline "
            "attribution regions)")
        p_gauge = gauge(
            "health_param_norm",
            "per-layer L2 parameter norm at the last drained step")
        u_gauge = gauge(
            "health_update_ratio",
            "per-layer update ratio (L2 ||delta w|| / ||w||) at the "
            "last drained step — the learning-rate health signal")
        u_hist = histogram(
            "health_update_ratio_hist",
            "distribution of drained per-layer update ratios",
            buckets=(1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1,
                     0.5, 1.0))
        nf_ctr = counter(
            "health_nonfinite_steps_total",
            "steps whose per-layer gradients contained inf/nan, by "
            "layer; benign=true = the update was skipped by dynamic "
            "loss scaling (no alert), benign=false = the update "
            "applied (pathological, alerts)")
        # the norm gauges keep their last FINITE reading (a NaN value
        # would poison the strict-JSON metrics sink) — this 0/1 flag is
        # the live divergence state a dashboard overlays on them
        nf_flag = gauge(
            "health_layer_nonfinite",
            "1 while the layer's gradient norm at the last drain was "
            "inf/nan (its health_grad_norm gauge then holds the last "
            "finite reading), else 0")
        for i, name in enumerate(self.layers):
            gn = math.sqrt(grad_sq[i]) if grad_sq[i] >= 0 else \
                float("nan")
            pn = math.sqrt(param_sq[i]) if param_sq[i] >= 0 else \
                float("nan")
            un = math.sqrt(update_sq[i]) if update_sq[i] >= 0 else \
                float("nan")
            ratio = un / pn if pn and math.isfinite(un) \
                and math.isfinite(pn) else (0.0 if math.isfinite(un)
                                            else float("nan"))
            layers[name] = {
                "grad_norm": _finite_or_none(gn),
                "param_norm": _finite_or_none(pn),
                "update_norm": _finite_or_none(un),
                "update_ratio": _finite_or_none(ratio),
                "nonfinite_steps": nf[i],
                "benign_nonfinite_steps": benign[i],
                "first_nonfinite": first[i],
            }
            nf_flag.set(0.0 if math.isfinite(gn) else 1.0, layer=name)
            if math.isfinite(gn):
                g_gauge.set(gn, layer=name)
            if math.isfinite(pn):
                p_gauge.set(pn, layer=name)
            if math.isfinite(ratio):
                u_gauge.set(ratio, layer=name)
                u_hist.observe(ratio)
            if nf[i]:
                nf_ctr.inc(nf[i], layer=name, benign="false")
            if benign[i]:
                nf_ctr.inc(benign[i], layer=name, benign="true")
        counter("health_drains_total",
                "health-accumulator drains (every --health_interval "
                "steps and at pass boundaries)").inc()
        if loss is not None and math.isfinite(loss):
            histogram("health_loss",
                      "training loss at each health drain",
                      buckets=LOSS_BUCKETS).observe(loss)
        report = {
            "ts": round(time.time(), 3),
            "steps": steps,
            "base_step": self._base_step,
            "interval": self.interval,
            "loss": _finite_or_none(loss) if loss is not None else None,
            "layers": layers,
        }
        report["alerts"] = self.monitor.observe(report, report["loss"])
        # the structured alerts above are warn-once NEW firings; the
        # /health body must also show an ONGOING incident one drain
        # later, so the standing conditions and the recent log ride
        # along
        report["active"] = [{"kind": k, "layer": l}
                            for k, l in self.monitor.active_conditions()]
        report["recent_alerts"] = self.monitor.recent_alerts()[-5:]
        self._base_step += steps
        self._since_drain = 0
        self.state = init_state(len(self.layers), self.device)
        publish_report(report, self.monitor)
        return report

    def span_summary(self, report: Dict[str, Any]) -> Dict[str, Any]:
        """Compact drain summary for ``train_step`` span attributes."""
        norms = [(r["grad_norm"], l) for l, r in report["layers"].items()
                 if r["grad_norm"] is not None]
        out: Dict[str, Any] = {"health_drained_steps": report["steps"]}
        if norms:
            mx = max(norms)
            out["health_grad_norm_max"] = round(mx[0], 6)
            out["health_grad_norm_max_layer"] = mx[1]
        if report["alerts"]:
            out["health_alerts"] = ",".join(
                f"{a['kind']}:{a['layer']}" for a in report["alerts"])
        return out


# --------------------------------------------------- process-wide view
_latest_lock = named_lock("observe.health.latest")
_latest: Optional[Dict[str, Any]] = None
_latest_monitor: Optional[HealthMonitor] = None


def publish_report(report: Dict[str, Any],
                   monitor: Optional[HealthMonitor] = None) -> None:
    """Stash the most recent drained report (plus its monitor) for the
    ``/health`` endpoint and the ``/healthz`` degraded summary."""
    global _latest, _latest_monitor
    with _latest_lock:
        _latest = report
        if monitor is not None:
            _latest_monitor = monitor


def latest_report() -> Optional[Dict[str, Any]]:
    with _latest_lock:
        return _latest


def status_summary() -> Dict[str, Any]:
    """Small health digest for ``/healthz``: alive processes stay 200
    — alerts degrade the *detail*, never the liveness verdict.
    ``status`` keys on the conditions STANDING at the last drain, so a
    run that recovered from a transient incident reports ``ok`` again
    (the incident stays visible in ``last_alerts``)."""
    with _latest_lock:
        report, monitor = _latest, _latest_monitor
    alerts = monitor.recent_alerts() if monitor is not None else []
    active = monitor.active_conditions() if monitor is not None else []
    return {
        "status": "degraded" if active else "ok",
        "active": [{"kind": k, "layer": l} for k, l in active],
        "alerts_total": len(alerts),
        "last_alerts": alerts[-5:],
        "last_drain_ts": report["ts"] if report else None,
        "drained_steps": report["base_step"] + report["steps"]
        if report else 0,
    }


def reset() -> None:
    """Drop the process-wide latest report/monitor (tests)."""
    global _latest, _latest_monitor
    with _latest_lock:
        _latest = None
        _latest_monitor = None
