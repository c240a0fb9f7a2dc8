"""Worker-second goodput ledger for the elastic trainer fleet (a copy
of kubeflow_tpu/train/goodput.py; the port imports nothing of the JAX
package).

The elastic fleet (train/elastic.py) can lose a worker, shrink the
world and replay from the last COMMITTED checkpoint; this module
measures what that costs. It books every wall second a worker lives
into exactly one cause from a closed set:

  productive          — step compute that advanced the run past its
                        high-water step (the only seconds that count
                        toward goodput)
  replay              — steps re-run between the last committed
                        checkpoint and the crash point (the direct
                        price of a restart)
  checkpoint_save     — chief-side save dispatch + drain
  checkpoint_restore  — restore-or-init onto the current trainer
  compile             — the first step of a fresh trainer (below)
  stall               — soft-lockstep waits on a slower live member
  idle                — everything else (residual; join barriers,
                        heartbeat sleeps, host gaps)

Conservation invariant: sum(seconds over all causes) == wall seconds
since the ledger was born, and `unattributed == 0` — an overlapped
double-booking (a bug) surfaces as a positive `unattributed` residual
instead of silently inflating a cause.

The ledger is host time, on the host's monotonic clock. The reference
books a fresh trainer's first step to "compile" because it is XLA's
trace and compile; the port runs eagerly, and its first step on the
card holds the kernels' nvcc build at first use (a fresh process builds
every missing library under build/kernels/), their first loads and the
caching allocator's growth to the step's peak, so the port books that
step to "compile" too. A step's seconds are host time up to where the
caller has the loss as a number, which waits for the device.

The ledger is metric-free (importable in the coordinator, in workers,
and in fake-clock tests); train/elastic.py binds it to counters and
gauges on the worker's registry. MFU and tokens/s derive from the
model-FLOPs estimate (`train.trainer.estimate_step_flops`): MFU needs
the device's peak FLOP/s, which only the deployment knows, so it is an
optional constructor argument and reads 0.0 when absent.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable

from kubeflow_tpu_torch import obs
from kubeflow_tpu_torch.obs.cachestats import UNATTRIBUTED

# Closed set of causes a worker-second is booked to. These become the
# `cause` label on `train_goodput_seconds_total`, so the set is CLOSED
# by design (LabelGuard-free by construction).
GOODPUT_CAUSES = ("productive", "replay", "checkpoint_save",
                  "checkpoint_restore", "compile", "stall", "idle")
# The subset that is pure overhead — what the coordinator aggregates
# into `train_replay_seconds_total{cause}` (fleet seconds NOT spent
# advancing the run, by cause).
LOST_CAUSES = ("replay", "checkpoint_save", "checkpoint_restore",
               "compile", "stall", "idle")

_MAX_COUNTER_EVENTS = 2048
_EPS = 1e-6


class GoodputLedger:
    """Books one worker's wall seconds into exclusive causes.

    Usage (train/elastic.py's run_worker):
        ledger = GoodputLedger()
        with ledger.book("checkpoint_restore"):
            state = ckpt.restore_or_init(...)
        ledger.note_restore(int(state.step))
        ledger.note_step(step, dt, tokens=..., flops=...,
                         compiling=first_call)
        ...
        snap = ledger.snapshot()   # balanced view: booked == wall

    `book` frames may nest; attribution is exclusive (inner time is
    subtracted from the enclosing frame), mirroring PhaseProfiler.
    `snapshot`/`cause_seconds` never mutate: the idle residual (wall
    minus everything explicitly booked, including still-open frames) is
    computed at read time, so the conservation equality holds at EVERY
    scrape, not only at quiescence.
    """

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 peak_flops_per_s: float = 0.0,
                 wall: Callable[[], float] = time.time):
        self._lock = threading.Lock()
        self._clock = clock
        self._wall = wall
        self._t0 = clock()
        self.peak_flops_per_s = float(peak_flops_per_s)
        self.seconds = {c: 0.0 for c in (*GOODPUT_CAUSES, UNATTRIBUTED)}
        # open `book` frames: [cause, start, finished_child_seconds]
        self._frames: list[list] = []
        # replay horizon: steps <= this index already ran in a previous
        # incarnation and are re-runs, not progress
        self._max_step_seen = -1
        self._replay_until = -1
        self.productive_steps = 0
        self.replay_steps = 0
        self.tokens = 0            # tokens from PRODUCTIVE steps only
        self.flops = 0.0           # model FLOPs from productive steps
        self.last_step_seconds = 0.0
        self.restores = 0
        # Chrome "C" counter events: one all-zero seed so the track
        # exists in every merged trace, then one point per booking.
        self._events: deque = deque(maxlen=_MAX_COUNTER_EVENTS)
        self._emit_event()
        # metric bindings; exceptions swallowed (CacheLedger idiom)
        self.on_book: Callable[[str, float], None] | None = None

    # -- write side --------------------------------------------------------

    @contextlib.contextmanager
    def book(self, cause: str):
        """Book the frame's EXCLUSIVE wall time to `cause`."""
        if cause not in self.seconds:
            cause = UNATTRIBUTED
        with self._lock:
            self._frames.append([cause, self._clock(), 0.0])
        try:
            yield
        finally:
            now = self._clock()
            with self._lock:
                _, start, child = self._frames.pop()
                dt = now - start
                own = max(dt - child, 0.0)
                self.seconds[cause] += own
                if self._frames:
                    self._frames[-1][2] += dt
                self._emit_event()
            self._fire(cause, own)

    def note_step(self, step: int, seconds: float, *, tokens: int = 0,
                  flops: float = 0.0, compiling: bool = False) -> None:
        """Book one train-step wall. `step` is the PRE-step index (the
        step being computed); `compiling` attributes a first-call-after-
        rebuild step to `compile` (kernel builds and loads, allocator
        growth: the module docstring)."""
        seconds = max(float(seconds), 0.0)
        with self._lock:
            if compiling:
                cause = "compile"
            elif step <= self._replay_until:
                cause = "replay"
                self.replay_steps += 1
            else:
                cause = "productive"
                self.productive_steps += 1
                self.tokens += int(tokens)
                self.flops += float(flops)
                self.last_step_seconds = seconds
            self.seconds[cause] += seconds
            self._max_step_seen = max(self._max_step_seen, int(step))
            self._emit_event()
        self._fire(cause, seconds)

    def note_restore(self, restored_step: int) -> None:
        """Declare a restore landed at `restored_step`: any step index
        at or below the pre-crash high-water mark is now a re-run."""
        with self._lock:
            self.restores += 1
            if self._max_step_seen > int(restored_step):
                self._replay_until = self._max_step_seen

    # -- read side ---------------------------------------------------------

    def _open_seconds_locked(self, now: float) -> dict[str, float]:
        """Exclusive elapsed of still-open frames: frame i owns the
        span up to the next frame's start (or now), minus its finished
        children — exact because children are strictly nested."""
        out: dict[str, float] = {}
        for i, (cause, start, child) in enumerate(self._frames):
            end = self._frames[i + 1][1] if i + 1 < len(self._frames) \
                else now
            own = max(end - start - child, 0.0)
            out[cause] = out.get(cause, 0.0) + own
        return out

    def _balanced_view(self, now: float) -> tuple[dict[str, float], float]:
        """Balanced per-cause view AT `now`: explicit bookings + open
        frames + the idle residual, guaranteed to sum to the returned
        wall unless bookings overlapped (which books the excess to
        `unattributed` so the breach is visible, not hidden). One clock
        read drives both sides — a second read between the view and the
        wall would break the equality by the microseconds in between."""
        with self._lock:
            view = dict(self.seconds)
            for cause, own in self._open_seconds_locked(now).items():
                view[cause] += own
            wall = now - self._t0
        residual = wall - sum(view.values())
        if residual >= 0.0:
            view["idle"] += residual
        else:
            view[UNATTRIBUTED] += -residual
        return view, wall

    def cause_seconds(self) -> dict[str, float]:
        return self._balanced_view(self._clock())[0]

    def wall_seconds(self) -> float:
        return self._clock() - self._t0

    def snapshot(self) -> dict:
        """Heartbeat / debug payload: cause seconds, conservation
        fields, and the derived rates (goodput fraction, tokens/s, MFU
        when peak FLOP/s is known)."""
        view, wall = self._balanced_view(self._clock())
        booked = sum(view.values())
        productive = view["productive"]
        with self._lock:
            out = {
                "seconds": view,
                "wall_seconds": wall,
                "booked_seconds": booked,
                "productive_steps": self.productive_steps,
                "replay_steps": self.replay_steps,
                "restores": self.restores,
                "tokens": self.tokens,
                "flops": self.flops,
                "last_step_seconds": self.last_step_seconds,
            }
        out["goodput_fraction"] = productive / booked if booked > _EPS \
            else 0.0
        out["tokens_per_second"] = out["tokens"] / productive \
            if productive > _EPS else 0.0
        out["mfu"] = (out["flops"] / productive / self.peak_flops_per_s) \
            if productive > _EPS and self.peak_flops_per_s > 0 else 0.0
        out["conserved"] = (abs(booked - wall) <= max(_EPS, 1e-9 * wall)
                            and view[UNATTRIBUTED] <= _EPS)
        return out

    # -- chrome counter tracks --------------------------------------------

    def _emit_event(self) -> None:
        # caller holds the lock
        self._events.append({
            "name": "goodput_seconds", "ph": "C",
            "ts": round(self._wall() * 1e6, 1), "pid": 1, "tid": 0,
            "args": {c: round(self.seconds[c], 4)
                     for c in GOODPUT_CAUSES},
        })

    def counter_events(self, *, prefix: str = "") -> list[dict]:
        """Chrome "C" events for the merged `/elastic/traces` view
        (cumulative booked seconds per cause over time)."""
        with self._lock:
            evs = [dict(e) for e in self._events]
        if prefix:
            for e in evs:
                e["name"] = f"{prefix}.{e['name']}"
        return evs

    def _fire(self, cause: str, seconds: float) -> None:
        if self.on_book is not None:
            try:
                self.on_book(cause, seconds)
            except Exception:
                pass


# -- shared checkpoint-latency catalog ------------------------------------

_CKPT_SAVE_HELP = ("checkpoint save wall time (async: dispatch + "
                   "previous-save drain, not the device->disk copy "
                   "itself)")
_CKPT_RESTORE_HELP = ("checkpoint restore wall time onto the current "
                      "mesh (includes cross-replica-count resharding "
                      "on resize)")


def goodput_metrics(registry):
    """Get-or-create + zero-seed the worker-side goodput families.

    One definition site for name/help/label sets, used by BOTH the
    worker (whose registry actually observes them) and the coordinator
    (which seeds the same families so a scrape with zero live workers
    still shows the full catalog shape). Returns
    `(seconds_total, wall_gauge, tokens_per_s, replay_steps_total)`.
    """
    from kubeflow_tpu_torch.obs.metrics import Counter, Gauge

    seconds = registry.get("train_goodput_seconds_total")
    if seconds is None:
        seconds = Counter(
            "train_goodput_seconds_total",
            "Worker wall seconds booked by exclusive cause "
            "(conservation: sums to train_goodput_wall_seconds; "
            "unattributed stays 0)", registry)
    for c in (*GOODPUT_CAUSES, UNATTRIBUTED):
        seconds.inc(0.0, cause=c)
    wall = registry.get("train_goodput_wall_seconds")
    if wall is None:
        wall = Gauge(
            "train_goodput_wall_seconds",
            "Wall seconds since the worker's goodput ledger was born "
            "(the conservation denominator; federated sum = total "
            "fleet worker-seconds)", registry)
        wall.set(0.0)
    tokens_per_s = registry.get("train_tokens_per_second")
    if tokens_per_s is None:
        tokens_per_s = Gauge(
            "train_tokens_per_second",
            "Productive tokens over productive seconds per worker "
            "(federated sum = aggregate fleet tokens/s — the elastic "
            "scaling acceptance metric)", registry)
        tokens_per_s.set(0.0)
    replay_steps = registry.get("train_replay_steps_total")
    if replay_steps is None:
        replay_steps = Counter(
            "train_replay_steps_total",
            "Steps re-run between the last committed checkpoint and "
            "the crash point", registry)
    replay_steps.inc(0.0)
    return seconds, wall, tokens_per_s, replay_steps


def bind_ledger_metrics(registry, ledger: GoodputLedger):
    """Wire a worker registry to a ledger via a render-time collector:
    every `/metrics` scrape re-syncs the goodput families from a fresh
    balanced snapshot, so the exposition's conservation equality
    (sum over causes == wall gauge) holds at scrape time BY
    construction — the counters are the ledger, not a sampled copy."""
    seconds, wall, tokens_per_s, replay_steps = goodput_metrics(registry)

    def _collect():
        snap = ledger.snapshot()
        for c, v in snap["seconds"].items():
            cur = seconds.value(cause=c)
            if v > cur:
                seconds.inc(v - cur, cause=c)
        wall.set(snap["wall_seconds"])
        tokens_per_s.set(snap["tokens_per_second"])
        cur = replay_steps.value()
        if snap["replay_steps"] > cur:
            replay_steps.inc(snap["replay_steps"] - cur)

    registry.register_collector(_collect)
    return seconds, wall, tokens_per_s, replay_steps


def checkpoint_histograms(registry):
    """THE definition of `train_checkpoint_{save,restore}_seconds`.

    Both the Checkpointer (the observer) and the ElasticCoordinator
    (which zero-seeds the full train catalog on its own registry) used
    to register these independently; one get-or-create site means the
    name/help/bucket definitions cannot drift between them. Returns
    `(save_seconds, restore_seconds)`, both seeded.
    """
    save = obs.get_or_create_histogram(
        registry, "train_checkpoint_save_seconds", _CKPT_SAVE_HELP)
    restore = obs.get_or_create_histogram(
        registry, "train_checkpoint_restore_seconds", _CKPT_RESTORE_HELP)
    save.seed()
    restore.seed()
    return save, restore
