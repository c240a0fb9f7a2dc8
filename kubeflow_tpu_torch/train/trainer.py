"""Training on one device or on a mesh (counterpart:
kubeflow_tpu/train/trainer.py).

Model-agnostic, as the reference's: it takes llama (`llama.apply`, or
chunked CE over `llama.hidden` through `loss_fn`) and gemma
(`gemma.apply`, dense CE over the tied head) and the MoE family
(`llama_moe.loss_fn`: dense CE plus the weighted load-balance loss) the
same way. The reference jits a sharded step over a device mesh; the
port runs one card, eagerly: the loss and its gradients through autograd
(the model's attention through the flash kernels' `autograd.Function`),
then an AdamW or Adafactor update written out to match optax's, in
place. `freeze_labels` (LoRA's frozen base, train/lora.py) is the
reference's multi_transform: frozen leaves are no autograd leaves and
have no optimizer state. Checkpoints: train/checkpoint.py.

With `mesh=` (parallel/mesh.py) and the params' `logical_axes`, the
same step runs on every rank of the mesh under the sharding `rules`
(default LLAMA_RULES): parameters as FSDP blocks gathered per block
before use, the batch split over the data axes, the moments ZeRO-sliced
over "data" with `zero_optimizer`, and with tensor > 1 the heads, MLP
columns and vocab cut over "tensor", the blocks computing on their
own (train/fsdp.py has the layout, parallel/tensor.py the blocks'
collectives; the loss is then the same on every tensor rank). `step`
takes the global batch on every rank; `gather_params` assembles the
full params. Adafactor reduces over the axes each leaf is cut on
(`LeafCut`), `grad_accum` runs the reference's micro-steps over the
global rows, and a loss's `global_term` (the MoE load-balance loss,
routed over the global batch) enters the global loss once. Without a
mesh nothing of this runs.

The obs bridge, as the reference's: each step is a `train.step` span
and a `step` phase of a `PhaseProfiler(phases=TRAIN_PHASES)` (the time
between steps is `host_gap`), feeding `train_step_seconds`,
`train_compile_seconds` (the first step's wall time),
`train_step_phase_seconds` and `train_recompiles_total{fn="train_step"}`
(a `CompileWatch` over the step, keyed by the batch's shapes). The step
is eager: `step` is host time up to where the step returns, with no
synchronize added for it (on the card a full launch queue can hold the
host near the device's step time).

optax parity, where PyTorch's defaults differ:
- the learning-rate schedule is evaluated at the update count before it
  increments, so `warmup_cosine_decay_schedule(init_value=0)` gives
  lr 0 on the first update while the moments still update;
- `clip_by_global_norm` scales by max_norm / norm only when norm >=
  max_norm (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6);
- adamw decays every leaf, norms included, with eps 1e-8 and no
  eps_root; adafactor's weight decay is not scaled by the learning rate
  (optax adds it after the schedule).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import logging
import math
import time
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch import obs
from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.obs.metrics import Counter
from kubeflow_tpu_torch.parallel import comm, tensor

Params = dict


def estimate_step_flops(n_params: int, tokens: int) -> float:
    """Model FLOPs for one train step: the standard 6·N·T estimate
    (2·N·T forward + 4·N·T backward). MODEL flops, the numerator of MFU:
    attention's quadratic terms and rematerialisation are left out."""
    return 6.0 * float(n_params) * float(tokens)


_TERMS: contextvars.ContextVar = contextvars.ContextVar("global_terms",
                                                       default=None)


def global_term(x: torch.Tensor) -> torch.Tensor:
    """A term of a loss that every rank of the mesh trainer computes
    alike, over the global batch (the MoE family's weighted load-balance
    loss, parallel/moe.py): the mesh trainer adds it to the global loss
    once, where it weights the rank's own part by its share of the mask
    mass, and this returns 0 in its place. On one device it is x."""
    terms = _TERMS.get()
    if terms is None:
        return x
    terms.append(x)
    return torch.zeros_like(x)


def _masked_mean(nll: torch.Tensor,
                 mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _vocab_parallel_nll(m, sumexp, gold, group) -> torch.Tensor:
    """Per-position NLL from each vocab block's (max, sum-exp relative to
    that max, gold logit or 0): the max over the blocks as a shift with
    no gradient, the sum-exp and the gold logit summed over them."""
    top = comm.pmax(m, group)
    total = comm.psum(sumexp * torch.exp(m - top), group)
    return top + torch.log(total) - comm.psum(gold, group)


def cross_entropy_loss(logits: torch.Tensor,   # [b, s, vocab] fp32
                       targets: torch.Tensor,  # [b, s] int
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy over valid positions. Under tensor
    parallelism (parallel/tensor.py) `logits` is the rank's vocab block
    and the loss, reduced over the blocks, is the same on every rank."""
    group = tensor.group()
    if group is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return _masked_mean(logz - gold, mask)
    n = logits.shape[-1]
    local = targets.long() - tensor.vocab_start(n)
    inside = (local >= 0) & (local < n)
    m = logits.detach().amax(dim=-1)
    sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return _masked_mean(_vocab_parallel_nll(
        m, sumexp, torch.where(inside, picked, 0.0), group), mask)


def _ce_chunk(hidden, head_c, targets, m, acc, gold, off):
    """One vocab chunk of the online (max, sumexp, gold-logit) stats."""
    chunk = head_c.shape[1]
    logits_c = hidden @ head_c.float()                 # [b, s, chunk]
    new_m = torch.maximum(m, logits_c.max(dim=-1).values)
    acc = (acc * torch.exp(m - new_m)
           + torch.exp(logits_c - new_m[..., None]).sum(dim=-1))
    local = targets - off
    in_chunk = (local >= 0) & (local < chunk)
    picked = torch.gather(logits_c, -1,
                          local.clamp(0, chunk - 1).long()[..., None])[..., 0]
    return new_m, acc, gold + torch.where(in_chunk, picked, 0.0)


def chunked_cross_entropy_from_hidden(
    hidden: torch.Tensor,   # [b, s, D] final (normed) hidden states
    head: torch.Tensor,     # [D, vocab] unembedding matrix
    targets: torch.Tensor,  # [b, s] int
    mask: torch.Tensor | None = None,
    *,
    num_chunks: int = 8,
) -> torch.Tensor:
    """CE without materialising the full [b, s, vocab] fp32 logits: a
    loop over vocab chunks keeps the online (max, sumexp, gold-logit)
    stats, and each chunk body runs under `torch.utils.checkpoint`, so
    the backward recomputes the chunk's logits instead of storing them.
    Matches `cross_entropy_loss(hidden @ head, ...)` to fp32 rounding.
    Under tensor parallelism `head` is the rank's vocab block: its chunks
    are offset by the block's start, and the stats are reduced over the
    blocks at the end."""
    group = tensor.group()
    hidden = tensor.enter(hidden.float())
    b, s, _ = hidden.shape
    vocab = head.shape[1]
    # Largest divisor of vocab <= requested: never silently degrade to
    # one full-vocab chunk (that would materialise exactly the logits
    # this function exists to avoid).
    requested = num_chunks
    num_chunks = max(1, min(num_chunks, vocab))
    while vocab % num_chunks:
        num_chunks -= 1
    if num_chunks == 1 and requested > 1 and vocab > 4096:
        logging.getLogger(__name__).warning(
            "chunked CE running UNCHUNKED: vocab %d shares no divisor "
            "<= the requested chunk count %d — full [b, s, vocab] "
            "logits will materialize", vocab, requested)
    chunk = vocab // num_chunks
    start = tensor.vocab_start(vocab)
    dev = hidden.device
    m = torch.full((b, s), -math.inf, device=dev)
    acc = torch.zeros(b, s, device=dev)
    gold = torch.zeros(b, s, device=dev)
    # split once: its backward concatenates the chunks' head gradients
    # once, where slicing per chunk would write a full-size one per chunk
    for i, head_c in enumerate(head.split(chunk, dim=1)):
        m, acc, gold = checkpoint(_ce_chunk, hidden, head_c, targets, m,
                                  acc, gold, start + i * chunk,
                                  use_reentrant=False)
    if group is not None:
        return _masked_mean(_vocab_parallel_nll(m, acc, gold, group), mask)
    return _masked_mean((m + torch.log(acc)) - gold, mask)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    # Gradient accumulation: split each step's batch into this many
    # microbatches and average their grads (mask-weighted, fp32
    # accumulator) before ONE optimizer update. 1 = off.
    grad_accum: int = 1
    # "adamw" (two fp32 moments mirroring the params) or "adafactor"
    # (a factored second moment: a row and a column vector a matrix)
    optimizer: str = "adamw"
    # ZeRO-style partitioning of the optimizer state over the data axis
    # of a mesh (train/fsdp.py): each data-parallel rank holds and
    # updates its slice of every moment. An exact no-op without a mesh
    # or on data=1 meshes, as in the reference.
    zero_optimizer: bool = True


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear warmup from
    init_value to peak_value over warmup_steps, then cosine decay to
    end_value at decay_steps (which includes the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1 - alpha) * cosine**exponent + alpha)

    return schedule


def _named_leaves(tree: Params, prefix: str = "") -> list:
    """(dotted name, leaf) pairs of a nested dict, in insertion order."""
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.extend(_named_leaves(v, name + ".") if isinstance(v, dict)
                   else [(name, v)])
    return out


def _local_sq_norm(names, grads) -> torch.Tensor:
    return sum((g.float() ** 2).sum() for g in grads)


class LeafCut:
    """Where the part of a leaf that a rank's optimizer updates lies in
    the full leaf: the leaf's full `shape`, and the `cuts` [(dim,
    AxisGroup)] that made the part, in the order they were made (none:
    the whole leaf). Adafactor reduces over them: a mean along a dim
    sums over the ranks that dim is cut over, the leaf's RMS over every
    cut. A slot that does not mirror the leaf (Adafactor's factored rows
    and columns) has a full shape of its own and is held cut by
    `side(shape)` ([(dim, AxisGroup)]; default: whole on every rank)."""

    def __init__(self, shape, cuts=(), side=None):
        self.shape = tuple(shape)
        self.cuts = list(cuts)
        self.side = side if side is not None else (lambda shape: [])

    def mean(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The full leaf's mean along `dim`, as a full tensor (`dim`
        dropped), from x over this part."""
        if not self.cuts:
            return x.mean(dim)
        y = x.sum(dim)
        for d, g in reversed(self.cuts):
            y = (comm._psum(y, g) if d == dim
                 else comm._all_gather(y, d - (d > dim), g))
        return y / self.shape[dim]

    def part(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The part of x (a full tensor over the leaf's dims but `dim`)
        that lies over this part of the leaf."""
        for d, g in self.cuts:
            if d != dim:
                x = comm._block(x, d - (d > dim), g)
        return x

    def rms(self, x: torch.Tensor) -> torch.Tensor:
        """The full leaf's root mean square, from x over this part."""
        if not self.cuts:
            return x.square().mean().sqrt()
        sq = x.square().sum()
        for _, g in self.cuts:
            sq = comm._psum(sq, g)
        return (sq / math.prod(self.shape)).sqrt()

    def local_shape(self, shape) -> list:
        """The held shape of a side slot of full `shape`."""
        shape = list(shape)
        for d, g in self.side(shape):
            shape[d] //= g.size
        return shape

    def load(self, t: torch.Tensor, shape) -> torch.Tensor:
        """A side slot of full `shape`, whole, from what the rank holds."""
        for d, g in reversed(self.side(shape)):
            t = comm._all_gather(t, d, g)
        return t

    def store(self, t: torch.Tensor, full: torch.Tensor, shape) -> None:
        """Write the rank's part of a side slot's updated `full` into t."""
        cuts = self.side(shape)
        for d, g in cuts:
            full = comm._block(full, d, g)
        if cuts:
            t.copy_(full)


def _whole_leaf(name, p, g):
    return contextlib.nullcontext((p, g, LeafCut(p.shape)))


class _Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip), <inner>), and with
    `freeze_labels` the reference's multi_transform({"train": that chain,
    "freeze": set_to_zero()}). State: `{"count": n, slot: [tensor per
    trained leaf]}` for each of the optimizer's `slots`; frozen leaves
    have no state, get no update and take no part in the clip's norm
    (multi_transform hands each group only its own leaves)."""

    slots: tuple[str, ...] = ()

    def __init__(self, tc: TrainConfig, freeze_labels: Params | None = None):
        self.tc = tc
        self.freeze_labels = freeze_labels
        self.schedule = warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=tc.learning_rate,
            warmup_steps=tc.warmup_steps,
            decay_steps=max(tc.total_steps, tc.warmup_steps + 1),
            end_value=tc.learning_rate * 0.1)
        if freeze_labels is not None:
            bad = {lab for _, lab in _named_leaves(freeze_labels)} \
                - {"train", "freeze"}
            if bad:
                raise ValueError(f"freeze_labels: unknown labels "
                                 f"{sorted(bad)} (train | freeze)")

    def trained(self, params: Params) -> list[tuple[str, torch.Tensor]]:
        """(name, leaf) of every leaf the optimizer updates, in order."""
        named = _named_leaves(params)
        if self.freeze_labels is None:
            return named
        labels = _named_leaves(self.freeze_labels)
        if [n for n, _ in named] != [n for n, _ in labels]:
            raise ValueError("freeze_labels and params name different "
                             "leaves")
        return [nl for nl, (_, lab) in zip(named, labels) if lab == "train"]

    def init(self, params: Params, cut: Callable | None = None) -> dict:
        """Zero state for the trained leaves; `cut(name, p)` gives each
        leaf's `LeafCut` where p is a part of it (default: p whole)."""
        named = self.trained(params)
        cuts = [LeafCut(p.shape) if cut is None else cut(n, p)
                for n, p in named]
        return {"count": 0, **{slot: [self.zeros(slot, p, c) for (_, p), c
                                      in zip(named, cuts)]
                               for slot in self.slots}}

    def slot_shape(self, slot: str, shape) -> tuple | None:
        """A slot's full shape for a leaf of full `shape`, or None where
        it mirrors the leaf."""
        return None

    def zeros(self, slot: str, p: torch.Tensor, cut: LeafCut
              ) -> torch.Tensor:
        """The zero slot for the part p of a leaf that `cut` places."""
        shape = self.slot_shape(slot, cut.shape)
        if shape is None:
            return torch.zeros_like(p)
        return p.new_zeros(cut.local_shape(shape))

    @torch.no_grad()
    def update(self, grads: list, opt_state: dict, params: Params, *,
               sq_norm: Callable = _local_sq_norm,
               slot: Callable = _whole_leaf) -> None:
        """Apply one update to `params` and `opt_state` in place; `grads`
        are in the order of the trained leaves (`trained`). Two hooks
        for leaves held as blocks of a mesh (train/fsdp.py,
        models/llama_pp.py): `sq_norm(names, grads)` gives the clip's
        squared global norm (default: the local sum), and `slot(name, p,
        g)` is a context giving the parts of p and g that the leaf's
        moments cover and their `LeafCut`, and putting p together after
        the update (default: p and g whole). A slot that does not mirror
        the leaf is updated whole (`LeafCut.load`) and written back to
        the part the rank holds (`LeafCut.store`)."""
        named = self.trained(params)
        norm = torch.sqrt(sq_norm([n for n, _ in named], grads))
        # optax: where(norm < max, g, g / norm * max)
        clip = torch.where(norm < self.tc.grad_clip, torch.ones_like(norm),
                           self.tc.grad_clip / norm)
        count = opt_state["count"]
        lr = self.schedule(count)
        for i, ((name, p), g) in enumerate(zip(named, grads, strict=True)):
            held = [opt_state[s][i] for s in self.slots]
            with slot(name, p, g) as (ps, gs, cut):
                shapes = [self.slot_shape(s, cut.shape) for s in self.slots]
                state = [t if sh is None else cut.load(t, sh)
                         for t, sh in zip(held, shapes)]
                self._leaf(ps, gs * clip, state, count, lr, cut)
                for t, full, sh in zip(held, state, shapes):
                    if sh is not None:
                        cut.store(t, full, sh)
        opt_state["count"] = count + 1


class AdamW(_Optimizer):
    """adamw(schedule, b1, b2, eps=1e-8, weight_decay) after the clip.
    State: fp32 moments `mu` and `nu`."""

    slots = ("mu", "nu")
    eps = 1e-8

    def _leaf(self, p, g, state, count, lr, cut):
        tc = self.tc
        mu, nu = state
        mu.mul_(tc.b1).add_(g, alpha=1 - tc.b1)
        nu.mul_(tc.b2).addcmul_(g, g, value=1 - tc.b2)
        # in place where it can be: at Mixtral's widths one expert stack
        # is 3.8 GB in fp32, and each temporary is one more
        u = (nu / (1 - tc.b2 ** (count + 1))).sqrt_().add_(self.eps)
        u = (mu / (1 - tc.b1 ** (count + 1))).div_(u)
        u.add_(p, alpha=tc.weight_decay)
        p.add_(u, alpha=-lr)


def _factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax's rule: the two largest axes (second-largest first) when the
    second-largest has at least `min_dim_size_to_factor`, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Optimizer):
    """optax 0.2.6's adafactor(learning_rate=schedule,
    weight_decay_rate=weight_decay or None) after the clip, at its
    defaults, in its order: scale_by_factored_rms (decay 0.8, eps 1e-30,
    factored where two axes have >= 128), clip_by_block_rms(1.0), the
    schedule, scale_by_param_block_rms (min 1e-3), add_decayed_weights
    (not scaled by the learning rate), negate. No momentum. State per
    trained leaf: `v_row` and `v_col` (the factored second moment, the
    leaf's shape less its largest or second-largest axis) or `v` (the
    whole second moment); the slots a leaf does not use hold an empty
    tensor. One count serves the factored rms and the schedule, which
    optax counts apart in step. On a mesh (the `LeafCut` of the part a
    rank updates) the factored dims are the full leaf's, the row and
    column means and the RMS of the update and of the leaf are the full
    leaf's, and `v_row` and `v_col` are updated whole."""

    slots = ("v_row", "v_col", "v")
    decay_rate = 0.8
    eps = 1e-30
    clipping_threshold = 1.0
    min_scale = 1e-3

    def slot_shape(self, slot, shape):
        dims = _factored_dims(shape)
        if (dims is None) != (slot == "v"):
            return (0,)
        if slot == "v":
            return None
        d1, d0 = dims
        shape = list(shape)
        del shape[d0 if slot == "v_row" else d1]
        return tuple(shape)

    def _leaf(self, p, g, state, count, lr, cut):
        v_row, v_col, v = state
        # optax evaluates the decay in fp32: 1 - (count + 1)^-0.8
        decay = np.float32(1) - np.float32(count + 1) ** np.float32(
            -self.decay_rate)
        keep = float(np.float32(1) - decay)
        decay = float(decay)
        g2 = g * g + self.eps
        dims = _factored_dims(cut.shape)
        if dims is not None:
            d1, d0 = dims
            v_row.mul_(decay).add_(cut.mean(g2, d0) * keep)
            v_col.mul_(decay).add_(cut.mean(g2, d1) * keep)
            row_mean = v_row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
            u = (g * cut.part(v_row / row_mean, d0).rsqrt().unsqueeze(d0)
                 * cut.part(v_col, d1).rsqrt().unsqueeze(d1))
        else:
            v.mul_(decay).add_(g2 * keep)
            u = g * v.rsqrt()
        del g2
        u.div_(torch.clamp(cut.rms(u) / self.clipping_threshold, min=1.0))
        u.mul_(float(np.float32(lr)))
        rms = cut.rms(p)
        u.mul_(torch.where(rms <= self.min_scale,
                           torch.full_like(rms, self.min_scale), rms))
        if self.tc.weight_decay:
            u.add_(p, alpha=self.tc.weight_decay)
        p.sub_(u)


def make_optimizer(tc: TrainConfig, freeze_labels: Params | None = None
                   ) -> _Optimizer:
    """AdamW or Adafactor with warmup-cosine after a global-norm clip, as
    the reference's optax chain. `freeze_labels` (a params-shaped tree of
    "train" / "freeze") gives the frozen leaves zero updates and no
    optimizer state: for LoRA that empty state is the point."""
    if tc.optimizer == "adamw":
        return AdamW(tc, freeze_labels)
    if tc.optimizer == "adafactor":
        return Adafactor(tc, freeze_labels)
    raise ValueError(f"unknown optimizer {tc.optimizer!r} "
                     "(adamw | adafactor)")


def _prep(tree: Params, device: torch.device,
          labels: Params | None = None) -> Params:
    """Params on `device`; the leaves labelled "train" (all, without
    `labels`) become autograd leaves, the frozen ones stay plain tensors,
    so autograd computes no gradient for them."""
    out = {}
    for k, v in tree.items():
        lab = None if labels is None else labels[k]
        if isinstance(v, dict):
            out[k] = _prep(v, device, lab)
        else:
            out[k] = v.detach().to(device).requires_grad_(lab != "freeze")
    return out


def _leaves(params: Params) -> list:
    """Leaves of a nested dict, in insertion order."""
    return [v for _, v in _named_leaves(params)]


class TrainState:
    """Params, optimizer state and step count. `Trainer.step` updates it
    in place (the reference returns a new, donated one) and returns it."""

    def __init__(self, params, opt_state, step):
        self.params = params
        self.opt_state = opt_state
        self.step = step


class Trainer:
    """Init and step functions for a model on one device.

    `apply_fn(params, tokens) -> logits`; `init_fn(seed) -> params`
    (moved to `device`, which defaults to the CUDA card). `loss_fn(params,
    tokens, targets, mask) -> scalar` overrides the default apply_fn →
    cross-entropy pipeline, e.g. `chunked_cross_entropy_from_hidden`
    over `llama.hidden`. `freeze_labels` (a params-shaped "train" /
    "freeze" tree) freezes a subtree: no gradient, no update, no
    optimizer state (see `make_optimizer`; LoRA's
    `lora_freeze_labels`). `tracer` / `registry` receive the obs bridge's
    spans and families (default: `obs.DEFAULT_TRACER` and the process's
    default registry; several trainers in one process share the
    series). `mesh` / `logical_axes` / `rules`: training on a mesh (the
    module docstring); `device` is then this rank's device.
    `model_config`: the model's config, which a mesh with tensor > 1
    needs for its head counts (train/fsdp.py cuts on whole heads).
    `virtual_replicas`: the data-parallel replica count the state stands
    for, which checkpoints are stamped with: the mesh's data axis by
    default (1 without a mesh); an elastic worker that computes the full
    global step alone on its device passes the live world size
    (train/elastic.py)."""

    def __init__(self, apply_fn: Callable, init_fn: Callable[[int], Params],
                 train_config: TrainConfig = TrainConfig(),
                 loss_fn: Callable | None = None,
                 device: torch.device | str | None = None, *,
                 freeze_labels: Params | None = None,
                 tracer=None, registry=None, mesh=None,
                 logical_axes: Params | None = None, rules=None,
                 model_config=None,
                 virtual_replicas: int | None = None):
        self.mesh = mesh
        self.layout = None
        if virtual_replicas is None:
            virtual_replicas = (1 if mesh is None
                                else int(mesh.shape.get("data", 1)))
        self.virtual_replicas = int(virtual_replicas)
        if mesh is not None:
            if logical_axes is None:
                raise ValueError("a mesh needs the params' logical_axes")
            if rules is None:
                from kubeflow_tpu_torch.parallel.sharding import LLAMA_RULES
                rules = LLAMA_RULES
            from kubeflow_tpu_torch.train.fsdp import MeshLayout
            self.layout = MeshLayout(mesh, logical_axes, rules,
                                     train_config, model_config)
        self.apply_fn = apply_fn
        self.init_fn = init_fn
        self.tc = train_config
        self.loss_fn = loss_fn
        self.device = resolve_device(device)
        self.freeze_labels = freeze_labels
        self.optimizer = make_optimizer(train_config, freeze_labels)
        self._n_params: int | None = None
        self._opt_bytes: int | None = None
        self.tracer = tracer if tracer is not None else obs.DEFAULT_TRACER
        reg = registry if registry is not None else obs.default_registry()
        self.step_seconds = obs.get_or_create_histogram(
            reg, "train_step_seconds",
            "train step wall time on the host clock (no synchronize: "
            "the step returns once its work is queued); the first call "
            "includes the kernels' first loads")
        self.compile_seconds = obs.get_or_create_histogram(
            reg, "train_compile_seconds",
            "first-step wall time (kernel loads, allocator growth and "
            "the step itself)",
            buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                     120.0, 300.0, 600.0))
        self._stepped = False
        self.profiler = obs.PhaseProfiler(phases=obs.TRAIN_PHASES)
        self.phase_seconds = obs.get_or_create_histogram(
            reg, "train_step_phase_seconds",
            "Wall time per training phase: step (the step call, host "
            "clock) and host_gap (time between consecutive steps)")
        for phase in obs.TRAIN_PHASES:
            self.phase_seconds.seed(phase=phase)

        def on_phase(phase, seconds, tokens):
            if seconds is not None:
                self.phase_seconds.observe(seconds, phase=phase)

        self.profiler.on_phase = on_phase
        self.recompiles = reg.get("train_recompiles_total")
        if self.recompiles is None:
            self.recompiles = Counter(
                "train_recompiles_total",
                "Recompiles of the train step (a novel batch shape past "
                "the first step)", reg)
        self._compile_watch = obs.CompileWatch(
            tracer=self.tracer,
            on_recompile=lambda fn, sig: self.recompiles.inc(fn=fn))
        self._watched_step = self._compile_watch.watch(
            self._step, "train_step",
            key=lambda state, tokens, targets, mask: (tokens, targets,
                                                      mask))
        self.recompiles.inc(0, fn="train_step")
        self._last_step_end: float | None = None

    def _loss(self, params, tokens, targets, mask):
        if self.loss_fn is not None:
            return self.loss_fn(params, tokens, targets, mask)
        return cross_entropy_loss(self.apply_fn(params, tokens), targets,
                                  mask)

    def init(self, seed: int) -> TrainState:
        return self.init_from_params(self.init_fn(seed))

    def init_from_params(self, params: Params) -> TrainState:
        """Fresh optimizer state around existing params (fine-tuning).
        The params are moved to the device and become autograd leaves;
        tensors already there are used as they are, not copied."""
        if self.layout is not None:
            return self._mesh_state(params)
        params = _prep(params, self.device, self.freeze_labels)
        return self.state_from(params, self.optimizer.init(params), 0)

    def _mesh_state(self, params: Params, opt_state: dict | None = None,
                    step: int = 0) -> TrainState:
        """This rank's blocks of full params, and moments for the slices
        it updates: zeros, or cut from full `opt_state` slots (a
        restore)."""
        lay = self.layout
        self._n_params = sum(p.numel() for p in _leaves(params))
        local = lay.shard_params(params)
        local = _prep(local, self.device, self.freeze_labels)
        opt = self.optimizer
        named = opt.trained(local)
        if opt_state is None:
            opt_state = {"count": 0, **{slot: [
                opt.zeros(slot, lay.slot_view(n, p), lay.leaves[n].cut)
                .detach() for n, p in named] for slot in opt.slots}}
        else:
            opt_state = {"count": int(opt_state["count"]), **{slot: [
                lay.shard_slot(n, full, self._slot_shape(slot, n))
                .to(self.device)
                for (n, _), full in zip(named, opt_state[slot], strict=True)]
                for slot in opt.slots}}
        self._opt_bytes = lay.opt_state_bytes(named, self.optimizer)
        return TrainState(local, opt_state, int(step))

    def gather_params(self, state: TrainState) -> Params:
        """The full params (on a mesh: assembled from every rank's
        blocks, a collective every rank calls)."""
        if self.layout is None:
            return state.params
        return self.layout.gather_params(state.params)

    def gather_opt_state(self, state: TrainState) -> dict:
        """The full optimizer state, `{"count", slot: [...]}` in the
        order of the trained leaves (on a mesh: each moment assembled
        from every rank's ZeRO slices, a collective every rank calls)."""
        if self.layout is None:
            return state.opt_state
        named = self.optimizer.trained(state.params)
        return {"count": int(state.opt_state["count"]), **{slot: [
            self.layout.gather_slot(n, t, self._slot_shape(slot, n))
            for (n, _), t in zip(named, state.opt_state[slot], strict=True)]
            for slot in self.optimizer.slots}}

    def _slot_shape(self, slot: str, name: str) -> tuple | None:
        return self.optimizer.slot_shape(slot,
                                         self.layout.leaves[name].shape)

    def state_from(self, params: Params, opt_state: dict, step: int, *,
                   device: torch.device | str | None = None) -> TrainState:
        """A state around existing params and optimizer state (a restored
        checkpoint: `{"count", slot: [...]}` for the optimizer's slots,
        AdamW's `mu` and `nu` or Adafactor's `v_row`, `v_col` and `v`,
        each in the order of the trained leaves), on `device` (default:
        the trainer's). As in `init_from_params`, tensors already there
        are not copied. On a mesh the params and slots are full tensors
        (alike on every rank), cut to this rank's blocks and slices under
        the trainer's layout, on its device."""
        if self.layout is not None:
            return self._mesh_state(params, opt_state, step)
        device = self.device if device is None else torch.device(device)
        params = _prep(params, device, self.freeze_labels)
        n_trained = len(self.optimizer.trained(params))
        slots = {slot: [t.to(device) for t in opt_state[slot]]
                 for slot in self.optimizer.slots}
        if any(len(v) != n_trained for v in slots.values()):
            raise ValueError(f"optimizer state for {n_trained} trained "
                             "leaves expected")
        opt_state = {"count": int(opt_state["count"]), **slots}
        self._n_params = sum(p.numel() for p in _leaves(params))
        self._opt_bytes = sum(t.numel() * t.element_size()
                              for v in slots.values() for t in v)
        return TrainState(params, opt_state, int(step))

    def _value_and_grad(self, params, tokens, targets, mask):
        leaves = [p for _, p in self.optimizer.trained(params)]
        loss = self._loss(params, tokens, targets, mask)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def _batch(self, tokens, targets, mask):
        """The batch on the trainer's device, the mask all ones unless
        given."""
        tokens = torch.as_tensor(tokens, device=self.device)
        targets = torch.as_tensor(targets, device=self.device)
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=self.device)
        return tokens, targets, torch.as_tensor(mask, device=self.device)

    def step(self, state: TrainState, tokens, targets, mask=None):
        """One optimizer step on a [b, s] batch -> (state, loss), under a
        `train.step` span and the profiler's `step` phase."""
        tokens, targets, mask = self._batch(tokens, targets, mask)
        acc = self.tc.grad_accum
        if acc > 1 and tokens.shape[0] % acc:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"grad_accum {acc}")
        first = not self._stepped
        t0 = time.perf_counter()
        if self._last_step_end is not None:
            # input pipeline, checkpoint writes, logging: the host gap
            self.profiler.record("host_gap", t0 - self._last_step_end)
        with self.tracer.span("train.step", batch=int(tokens.shape[0]),
                              compile=first):
            with self.profiler.phase("step", tokens=int(tokens.shape[0])
                                     * int(tokens.shape[1])):
                out = self._watched_step(state, tokens, targets, mask)
        dt = time.perf_counter() - t0
        self._last_step_end = time.perf_counter()
        self.step_seconds.observe(dt)
        if first:
            self._stepped = True
            self.compile_seconds.observe(dt)
        return out

    def _mesh_grads(self, state: TrainState, tokens, targets, mask,
                    padded: bool = False):
        """The global loss of a global batch and each trained block's
        gradient of it (reduced over the ranks that share it): each rank
        weights the loss of its rows by its share of the mask mass, and
        the terms the loss marks `global_term` enter once. The tensor and
        routing contexts cover the backward too: remat reruns the blocks'
        collectives there. `padded`: the batch has padding rows."""
        lay = self.layout
        tokens, targets, mask = (lay.local_rows(x)
                                 for x in (tokens, targets, mask))
        weight = lay.loss_weight(mask)
        named = self.optimizer.trained(state.params)
        terms: list = []
        token = _TERMS.set(terms)
        try:
            with lay.parallel(padded=padded):
                loss = self._loss(lay.model_view(state.params), tokens,
                                  targets, mask) * weight
                once = sum(terms, torch.zeros((), device=loss.device))
                grads = torch.autograd.grad(loss + once,
                                            [p for _, p in named])
        finally:
            _TERMS.reset(token)
        total = comm._psum(loss.detach(), lay.batch) + once.detach()
        return total, named, lay.reduce_grads(named, grads)

    def _mesh_accumulated(self, state: TrainState, tokens, targets, mask):
        """`grad_accum` micro-steps on a mesh, the reference's: micro i is
        the global rows [i B / acc, (i + 1) B / acc), cut over the batch
        ranks (padded with mask-0 rows where they do not divide it), its
        loss and gradients weighted by its global mask mass into fp32
        sums, cast to the param dtype once."""
        acc = self.tc.grad_accum
        mb = tokens.shape[0] // acc
        pad = -mb % self.layout.batch.size
        gsum = lsum = wsum = None
        for i in range(acc):
            micro = [x[i * mb:(i + 1) * mb] for x in (tokens, targets, mask)]
            if pad:
                micro = [torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
                         for x in micro]
            loss, named, grads = self._mesh_grads(state, *micro,
                                                  padded=bool(pad))
            w = micro[2].float().sum()
            if gsum is None:
                gsum = [g.float() * w for g in grads]
                lsum, wsum = loss.float() * w, w
                continue
            for a, g in zip(gsum, grads):
                a.add_(g.float() * w)
            lsum, wsum = lsum + loss.float() * w, wsum + w
        denom = torch.clamp(wsum, min=1.0)
        grads = [(g / denom).to(p.dtype) for g, (_, p) in zip(gsum, named)]
        return lsum / denom, named, grads

    def _mesh_step(self, state: TrainState, tokens, targets, mask):
        lay = self.layout
        step = (self._mesh_accumulated if self.tc.grad_accum > 1
                else self._mesh_grads)
        loss, named, grads = step(state, tokens, targets, mask)
        with torch.no_grad():
            self.optimizer.update(grads, state.opt_state, state.params,
                                  sq_norm=lay.sq_norm, slot=lay.slot)
        state.step += 1
        return state, loss

    def grads(self, state: TrainState, tokens, targets,
              mask=None) -> list:
        """The gradients of one step's loss on a global [b, s] batch, as
        the optimizer would take them (before the clip), in the order of
        the trained leaves, as full leaves: on a mesh, reduced and
        gathered from every rank's blocks (a collective)."""
        tokens, targets, mask = self._batch(tokens, targets, mask)
        if self.layout is None:
            return list(self._value_and_grad(state.params, tokens, targets,
                                             mask)[1])
        _, named, grads = self._mesh_grads(state, tokens, targets, mask)
        return [self.layout.gather_leaf(n, g)
                for (n, _), g in zip(named, grads, strict=True)]

    def _step(self, state: TrainState, tokens, targets, mask):
        if self.layout is not None:
            return self._mesh_step(state, tokens, targets, mask)
        acc = self.tc.grad_accum
        if acc <= 1:
            loss, grads = self._value_and_grad(state.params, tokens,
                                               targets, mask)
        else:
            # Each micro loss is a masked MEAN, so grads and losses are
            # re-weighted by the micro's mask mass: the full-batch step up
            # to summation order.
            trained = [p for _, p in self.optimizer.trained(state.params)]
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in trained]
            lsum = torch.zeros((), device=self.device)
            wsum = torch.zeros((), device=self.device)
            for toks, tgts, m in zip(tokens.chunk(acc), targets.chunk(acc),
                                     mask.chunk(acc)):
                l_, g_ = self._value_and_grad(state.params, toks, tgts, m)
                w = m.float().sum()
                for a, g in zip(gsum, g_):
                    a.add_(g.float() * w)
                lsum = lsum + l_.float() * w
                wsum = wsum + w
            denom = torch.clamp(wsum, min=1.0)
            grads = [(g / denom).to(p.dtype)
                     for g, p in zip(gsum, trained)]
            loss = lsum / denom
        self.optimizer.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, loss

    @property
    def param_count(self) -> int:
        """Total parameter count, frozen leaves included, as the
        reference's (the N in 6·N·T); known once a state was built."""
        if self._n_params is None:
            raise RuntimeError("param_count is known after init() or "
                               "init_from_params()")
        return self._n_params

    def step_flops(self, batch: int, seq: int) -> float:
        """Model FLOPs one `step()` spends on a [batch, seq] block."""
        return estimate_step_flops(self.param_count, batch * seq)

    def opt_state_bytes(self) -> int:
        """Optimizer-state bytes, known once a state was built: on one
        device every slot of every trained leaf; on a mesh what this rank
        holds, as the reference's `opt_state_bytes(per_replica=True)`
        reckons it (`MeshLayout.opt_state_bytes`)."""
        if self._opt_bytes is None:
            raise RuntimeError("opt_state_bytes is known after init() or "
                               "init_from_params()")
        return self._opt_bytes
