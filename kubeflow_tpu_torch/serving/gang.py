"""The lockstep gang of a tensor-parallel serving replica.

The reference has no counterpart: one controller drives every device of
its mesh and GSPMD inserts the collectives, so its engines and its HTTP
app are mesh-oblivious. The port runs one process a rank, each holding
its rank's cut of the weights (`bridge.tensor_rank_params`,
serving/engine.py), and requests arrive over HTTP at one of them. So
every other rank must run the same engine calls, in the same order, on
the same host arguments: the leading rank (index 0 of the group) runs
the HTTP app and the continuous batcher, and before each call of a
device method of its engines it broadcasts the method's name and host
arguments over the gang's control group; the followers run a loop that
receives each call and makes it on their own engines.

- `form(ranks, timeout_s=)` (collective over the world: every rank
  calls it, in the same order) makes the gang's two groups, the
  "tensor" axis's (`Gang.group`, which the engines take as `group=`)
  and a gloo control group, each with a timeout of its own: on the
  order of a minute, not gloo's half hour, so that a rank that stops
  taking part fails the others' collectives within it.
- `Gang.lead(engine)` wraps the engine's device methods (`ENGINE_OPS`);
  a `ContinuousEngine` built over it is announced to the followers with
  its arguments, its resolved seed among them (`adopt`, from the
  engine's constructor), and its device methods wrapped
  (`CONTINUOUS_OPS`), as `CompileWatch` wraps them. A call made inside
  a wrapped call (generate's prefill) is not sent again.
- `Gang.follow(engine)` is a follower's loop: it makes each call on
  its own engine (or the `ContinuousEngine` it built alike), until the
  leader's `stop()`.
- Arguments: host values (numbers, strings, lists, numpy arrays, CPU
  tensors) travel by value; a value an earlier call returned (a
  prefill's `DecodeState` and first tokens, the `SamplingParams` of
  `sampling()`, a registered prefix's state) travels as a handle to the
  follower's own result of that call; the leader's slot state and
  generator travel as markers for the follower's own (`slots()`,
  `gen`); any other device tensor travels as its host copy and any other
  generator as its state. A generate without `rng` gets one seeded on
  the leader, so that sampled rows draw alike. An object that a later
  call returns again (the slot state) keeps its handle; a result is
  freed on the followers once the leader's object is gone.
- After each call every rank says whether it raised (an all-reduce on
  the control group). A call that raised alike on every rank (a
  refusal, a bad argument) raises on the leader and the gang goes on;
  one that raised on some ranks only stops the gang: the leader raises
  `GangError` for it and for every later call (the batcher fails its
  requests through `_fail_all`), the followers leave their loops with
  it. A follower that raises mid-forward leaves the leader in a
  collective until the tensor group's timeout; the control group's is
  `CONTROL_FACTOR` times longer, so the two still agree afterwards.
- While idle the leader beats on the control group every quarter of
  the timeout, so that a follower waiting for the next call does not
  time out; one that hears nothing for the control timeout leaves its
  loop.

Everything on the card runs eagerly (both engines refuse
`cuda_graphs=True` at tensor > 1). `calls` counts the calls mirrored.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import threading
import time
import types
import weakref
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.parallel.comm import AxisGroup
from kubeflow_tpu_torch.parallel.mesh import TENSOR_AXIS
from kubeflow_tpu_torch.serving.continuous import ContinuousEngine, SlotState
from kubeflow_tpu_torch.serving.engine import DecodeState, SamplingParams

# the device methods a gang mirrors (those refused at tensor > 1, warmup
# and the block export and import, raise on the leader before any
# collective, and are not sent)
ENGINE_OPS = ("generate", "generate_stream", "score", "precompute_prefix",
              "prefill_chunked", "init_state")
CONTINUOUS_OPS = ("init_slots", "clear_slots", "reset_slots", "adopt_slot",
                  "copy_cells", "gather_seed", "prefill_batch",
                  "insert_many", "insert", "step", "sampling", "decode",
                  "append_rows", "prefill_slice")
# methods whose `rng=None` draws fresh entropy: the leader draws it
SEEDED = ("generate", "generate_stream")
# the control group's timeout over the tensor group's
CONTROL_FACTOR = 3


class GangError(RuntimeError):
    """A rank of the gang failed where the others did not, or the gang
    is stopped: no call runs on it any more."""


class _Ref(NamedTuple):
    """An argument that is not sent by value: `kind` "h" (an earlier
    result's handle), "slots" / "gen" (the slot state or generator of
    the continuous engine of handle `value`), "tensor" (a device
    tensor's host copy), "genstate" (a generator's state), "sp"
    (`SamplingParams` fields)."""
    kind: str
    value: Any


_DONE = object()   # a stream's end


def _registrable(x) -> bool:
    return isinstance(x, (torch.Tensor, DecodeState, SlotState,
                          SamplingParams, types.GeneratorType,
                          ContinuousEngine))


def _describe(err: BaseException | None) -> str | None:
    return None if err is None else f"{type(err).__name__}: {err}"


def _next(gen):
    try:
        return next(gen)
    except StopIteration:
        return _DONE


def form(ranks, *, timeout_s: float = 60.0) -> "Gang | None":
    """The gang of global `ranks` (collective over the world: every rank
    calls it, members or not, in the same order). -> this rank's `Gang`,
    or None for a rank outside it."""
    ranks = sorted(int(r) for r in ranks)
    tensor_pg = dist.new_group(ranks,
                               timeout=datetime.timedelta(seconds=timeout_s))
    control = dist.new_group(
        ranks, timeout=datetime.timedelta(seconds=CONTROL_FACTOR * timeout_s),
        backend="gloo")
    me = dist.get_rank()
    if me not in ranks:
        return None
    return Gang(AxisGroup(TENSOR_AXIS, tuple(ranks), ranks.index(me),
                          tensor_pg), control, timeout_s)


class Gang:
    """One rank's view of a serving gang (`form`)."""

    def __init__(self, group: AxisGroup, control, timeout_s: float):
        self.group = group
        self.control = control
        self.timeout_s = timeout_s
        self.leader = group.index == 0
        self.calls = 0
        self.broken: GangError | None = None
        self._src = group.ranks[0]
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next = 0
        self._ids: dict[int, int] = {}        # id(object) -> handle
        self._owners: dict[int, Any] = {}     # leader: handle -> weakref
        self._objs: dict[int, Any] = {}       # follower: handle -> object
        self._dead: list[int] = []
        self._device = None
        self._stopped = False
        self._halt = threading.Event()
        self._beat = None
        self._last = time.monotonic()

    # -- the leader ---------------------------------------------------------

    def lead(self, engine):
        """Lead the gang with `engine` (this rank's, built with
        `group=self.group`): its device methods are mirrored from now
        on. -> engine."""
        self._own(engine)
        self._wrap(self._register(engine), engine, ENGINE_OPS)
        engine.gang = self
        self._beat = threading.Thread(target=self._beat_loop,
                                      name="gang-beat", daemon=True)
        self._beat.start()
        return engine

    def adopt(self, ce: ContinuousEngine, kwargs: dict) -> None:
        """A `ContinuousEngine` built over the led engine (its
        constructor calls this): every follower builds its own with
        `kwargs` over its engine, and `ce`'s device methods are
        mirrored."""
        h = self._ids[id(ce.engine)]
        with self._lock:
            self._check()
            first = self._next
            self._announce(("call", first, self._take_dead(), h, "__new__",
                            ((), kwargs)))
            self._agree(None)
            self.calls += 1
            self._register(ce)
        self._owners[first] = weakref.ref(ce)
        self._wrap(first, ce, CONTINUOUS_OPS)

    def stop(self) -> None:
        """Shut the followers down (they return from `follow`) and stop
        the heartbeat; later calls raise `GangError`."""
        if not self.leader:
            raise ValueError("stop() is the leader's")
        self._halt.set()
        with self._lock:
            if self.broken is None and not self._stopped:
                try:
                    self._send(("stop",))
                except Exception:  # noqa: BLE001 — a dead follower
                    pass
            self._stopped = True
        if self._beat is not None and self._beat is not \
                threading.current_thread():
            self._beat.join()

    def _own(self, engine) -> None:
        if engine.group is None or engine.group.ranks != self.group.ranks:
            raise ValueError(
                "the engine's group is not the gang's: build it with "
                "group=gang.group")
        if self._next:
            raise ValueError("a gang serves one engine")
        self._device = engine.device

    def _register(self, obj) -> int:
        h = self._next
        self._next += 1
        key = id(obj)
        self._ids[key] = h
        weakref.finalize(obj, self._forget, key, h)
        return h

    def _forget(self, key: int, h: int) -> None:
        if self._ids.get(key) == h:
            del self._ids[key]
        self._dead.append(h)

    def _take_dead(self) -> list[int]:
        dead, self._dead = self._dead, []
        return dead

    def _wrap(self, h: int, obj, names) -> None:
        for name in names:
            fn = getattr(obj, name, None)
            if fn is not None:
                setattr(obj, name, self._mirrored(h, name, fn))

    def _mirrored(self, h: int, name: str, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if getattr(self._local, "depth", 0):
                return fn(*args, **kwargs)   # inside a mirrored call
            if name in SEEDED and kwargs.get("rng") is None:
                kwargs["rng"] = torch.Generator(
                    device=self._device).manual_seed(
                        int.from_bytes(os.urandom(8), "little") >> 1)
            return self._call(h, name, fn, args, kwargs)
        return call

    def _check(self) -> None:
        if self.broken is not None:
            raise self.broken
        if self._stopped:
            raise GangError("the serving gang is stopped")

    def _call(self, h: int, name: str, fn, args, kwargs):
        with self._lock:
            self._check()
            enc = (self._encode(args), self._encode(kwargs))
            first = self._next
            self._announce(("call", first, self._take_dead(), h, name, enc))
            result, err = self._run(fn, args, kwargs)
            self._agree(err)
            self.calls += 1
            return self._keep(result)

    def _announce(self, msg) -> None:
        """Send a call to the followers; a control group that fails
        stops the gang."""
        try:
            self._send(msg)
        except Exception as e:  # noqa: BLE001 — a follower is gone
            self._break(GangError(f"the gang's control group failed: "
                                  f"{_describe(e)}"))
            raise self.broken from e

    def _encode(self, x):
        if _registrable(x) and id(x) in self._ids:
            return _Ref("h", self._ids[id(x)])
        if isinstance(x, SlotState):
            return _Ref("slots", self._owner_of(lambda ce: ce._st is x,
                                                "slot state"))
        if isinstance(x, torch.Generator):
            for h, ref in self._owners.items():
                if ref() is not None and ref().gen is x:
                    return _Ref("gen", h)
            return _Ref("genstate", x.get_state())
        if isinstance(x, torch.Tensor):
            return _Ref("tensor", x.detach().cpu())
        if isinstance(x, SamplingParams):
            return _Ref("sp", tuple(self._encode(getattr(x, f.name))
                                    for f in dataclasses.fields(x)))
        if isinstance(x, (DecodeState, types.GeneratorType)):
            raise ValueError(f"a {type(x).__name__} that no call of the "
                             "gang returned cannot be sent to its ranks")
        if type(x) in (list, tuple):
            return type(x)(self._encode(v) for v in x)
        if isinstance(x, dict):
            return {k: self._encode(v) for k, v in x.items()}
        return x

    def _owner_of(self, pred, what: str) -> int:
        for h, ref in self._owners.items():
            ce = ref()
            if ce is not None and pred(ce):
                return h
        raise ValueError(f"a {what} that no engine of the gang owns")

    def _keep(self, result):
        """Register what a call returned (handles in walk order, the
        followers' alike): an object that has a handle already (the slot
        state that `step` and `insert_many` return each time) keeps it;
        a stream comes back as a mirrored stream."""
        if type(result) in (list, tuple):
            return type(result)(self._keep(v) for v in result)
        if _registrable(result):
            h = self._ids.get(id(result))
            if h is None:
                h = self._register(result)
            if isinstance(result, types.GeneratorType):
                return self._stream(h, result)
        return result

    def _stream(self, h: int, gen):
        def stream():
            while True:
                item = self._call(h, "__next__",
                                  functools.partial(_next, gen), (), {})
                if item is _DONE:
                    return
                yield item
        return stream()

    def _beat_loop(self) -> None:
        period = self.timeout_s / 4
        while not self._halt.wait(period):
            if time.monotonic() - self._last < period:
                continue
            with self._lock:
                if self.broken is not None or self._stopped:
                    return
                try:
                    self._send(("beat",))
                except Exception as e:  # noqa: BLE001 — a dead follower
                    self._break(GangError(f"the gang's heartbeat failed: "
                                          f"{_describe(e)}"))
                    return

    # -- the followers --------------------------------------------------------

    def follow(self, engine) -> None:
        """A follower's loop: make each call the leader sends on
        `engine` (this rank's, built with `group=self.group`) and the
        engines built over it, until the leader stops the gang. Raises
        `GangError` when the gang breaks."""
        if self.leader:
            raise ValueError("the leader leads; the other ranks follow")
        self._own(engine)
        self._objs[0] = engine
        self._ids[id(engine)] = 0
        self._next = 1
        try:
            self._loop()
        finally:
            # what the calls built (engines, pools, results) goes with
            # the gang
            self._objs.clear()
            self._ids.clear()

    def _loop(self) -> None:
        while True:
            try:
                msg = self._recv()
            except Exception as e:  # noqa: BLE001 — the leader is gone
                self._break(GangError(f"the leader went silent: "
                                      f"{_describe(e)}"))
                raise self.broken from e
            if msg[0] == "stop":
                self._stopped = True
                return
            if msg[0] == "beat":
                continue
            _, first, dead, h, name, (args, kwargs) = msg
            for d in dead:
                obj = self._objs.pop(d, None)
                if obj is not None:
                    del self._ids[id(obj)]
            self._next = first
            result, err = self._run(self._make, (h, name, args, kwargs), {})
            try:
                self._agree(err)
            except GangError:
                raise
            except Exception:  # noqa: BLE001 — raised alike everywhere
                continue
            self.calls += 1
            self._hold(result)

    def _make(self, h: int, name: str, args, kwargs):
        """The leader's call `name` on this rank's object of handle h."""
        obj = self._objs[h]
        args, kwargs = self._decode(args), self._decode(kwargs)
        if name == "__new__":
            return ContinuousEngine(obj, *args, **kwargs)
        if name == "__next__":
            return _next(obj)
        return getattr(obj, name)(*args, **kwargs)

    def _decode(self, x):
        if isinstance(x, _Ref):
            if x.kind == "h":
                return self._objs[x.value]
            if x.kind == "slots":
                return self._objs[x.value].slots()
            if x.kind == "gen":
                return self._objs[x.value].gen
            if x.kind == "tensor":
                return x.value.to(self._device)
            if x.kind == "genstate":
                g = torch.Generator(device=self._device)
                g.set_state(x.value)
                return g
            if x.kind == "sp":
                return SamplingParams(*(self._decode(v) for v in x.value))
            raise ValueError(f"unknown gang reference {x.kind!r}")
        if type(x) in (list, tuple):
            return type(x)(self._decode(v) for v in x)
        if isinstance(x, dict):
            return {k: self._decode(v) for k, v in x.items()}
        return x

    def _hold(self, result) -> None:
        """The follower's `_keep`: the same handles in the same order."""
        if type(result) in (list, tuple):
            for v in result:
                self._hold(v)
        elif _registrable(result) and id(result) not in self._ids:
            self._objs[self._next] = result
            self._ids[id(result)] = self._next
            self._next += 1

    # -- both -----------------------------------------------------------------

    def _run(self, fn, args, kwargs):
        self._local.depth = getattr(self._local, "depth", 0) + 1
        try:
            return fn(*args, **kwargs), None
        except BaseException as e:  # noqa: BLE001 — agreed on below
            return None, e
        finally:
            self._local.depth -= 1

    def _send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=self._src, group=self.control)
        self._last = time.monotonic()

    def _recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=self._src, group=self.control)
        return box[0]

    def _break(self, err: GangError) -> None:
        if self.broken is None:
            self.broken = err

    def _agree(self, err: BaseException | None) -> None:
        """Every rank's outcome of the call: returns when none raised,
        re-raises `err` when all raised alike, else stops the gang and
        raises `GangError`."""
        try:
            flag = torch.tensor([0 if err is None else 1])
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.control)
            if not int(flag):
                return
            said = [None] * self.group.size
            dist.all_gather_object(said, _describe(err), group=self.control)
        except Exception as e:  # noqa: BLE001 — a rank is gone
            self._break(GangError(
                f"rank {self.group.index} lost the gang after "
                f"{_describe(err) or 'a call'}: {_describe(e)}"))
            raise self.broken from (err or e)
        if all(s is not None and s == said[0] for s in said):
            raise err
        odd = [f"rank {r}: {s or 'no error'}" for r, s in enumerate(said)]
        self._break(GangError("the serving gang's ranks parted on a call ("
                              + "; ".join(odd) + "): the gang is stopped"))
        raise self.broken from err
