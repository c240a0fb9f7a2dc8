"""Tensor parallelism (Megatron-style) inside the model blocks: the
context that names the "tensor" axis's group, and the helpers the
blocks call where their activations cross it.

No one module of the reference is the counterpart. There, GSPMD cuts
the params by the rules that map "heads", "kv_heads", "mlp" and
"vocab" to "tensor", pins the activations with the `act_*` rules and
`with_sharding_constraint` (kubeflow_tpu/parallel/sharding.py), and
XLA inserts the all-reduces. The port's collectives are explicit
(parallel/comm.py), so the blocks place them:

- every rank holds its block of the leaves cut on "tensor": wq, wk, wv,
  w_gate and w_up by output columns, wo and w_down by input rows, the
  embedding and lm_head by vocab (train/fsdp.py lays them out), always
  on whole heads; the MoE family's expert stacks by experts
  (parallel/moe.py), ViT's head by classes;
- `enter` (pvary) where the invariant residual enters per-rank work:
  after `attn_norm` and `mlp_norm`, and the final hidden before the
  head; `exit` (psum) after the row-parallel wo and w_down products;
- the embedding lookup zeroes the tokens outside the rank's vocab block
  and psums (ops/embedding.py); the head's logits stay vocab-local and
  the cross entropy reduces over the blocks (train/trainer.py).

Serving (serving/engine.py, serving/gang.py) runs the same blocks with
no backward: the engine's forward runs inside `parallel(group)`, reads
its K/V columns through `kv_columns`, calls `exit` after the wo and
w_down products, looks the embedding up in its vocab block, and
`gather_vocab` puts the head's vocab-local logits back together, so
that sampling sees the whole vocabulary on every rank.

`parallel(group)` sets the group for the code inside it, as the
reference's `set_mesh` does; outside one (or with a group of one rank)
every helper is the identity, at no cost. The mesh trainer's step runs
its forward and backward inside it. The models `bind` each block to the
group: autograd runs a CUDA backward, and remat's rerun of a block's
forward inside it (collectives and all, on every rank in the same
order), on a device thread of its own, where the caller's context is
not set.

Dtype of the all-reduces: `enter`'s backward and `exit` sum in fp32 and
round once to the activation dtype. A bf16 activation's partial sums
would otherwise be rounded at each addition, and gloo, which stages
through the host on one card, is not assured a bf16 sum on every build.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from kubeflow_tpu_torch.parallel import comm

_GROUP: contextvars.ContextVar = contextvars.ContextVar("tensor_group",
                                                        default=None)


@contextlib.contextmanager
def parallel(group: comm.AxisGroup | None):
    """The blocks inside run tensor-parallel over `group` (None, or a
    group of one rank: on one device)."""
    token = _GROUP.set(group if group is not None and group.size > 1
                       else None)
    try:
        yield
    finally:
        _GROUP.reset(token)


def group() -> comm.AxisGroup | None:
    """The tensor axis's group, or None on one device."""
    return _GROUP.get()


def bind(fn):
    """fn run under the group current now, wherever it is called: a
    checkpointed block that the backward reruns (with its collectives)
    on autograd's device thread."""
    g = group()
    if g is None:
        return fn

    def run(*args, **kwargs):
        with parallel(g):
            return fn(*args, **kwargs)

    return run


def enter(x: torch.Tensor) -> torch.Tensor:
    """x (the same on every tensor rank) entering per-rank work: the
    identity; the backward sums the ranks' partial gradients in fp32."""
    g = group()
    if g is None:
        return x
    return comm.pvary(x.float(), g).to(x.dtype)


def exit(x: torch.Tensor) -> torch.Tensor:  # noqa: A001 — enter's pair
    """The ranks' partial sums of a row-parallel product, summed in fp32
    and rounded once to x's dtype (the same on every rank)."""
    g = group()
    if g is None:
        return x
    return comm.psum(x.float(), g).to(x.dtype)


def vocab_start(local_vocab: int) -> int:
    """The first vocab id of this rank's block of `local_vocab` ids."""
    g = group()
    return 0 if g is None else g.index * local_vocab


def vocab_divides(vocab_size: int, size: int) -> None:
    """Refuses a vocabulary that the axis does not divide: the embedding
    and the head are cut into equal vocab blocks, one a rank."""
    if vocab_size % size:
        raise ValueError(f"vocab_size {vocab_size} is not divisible by "
                         f"tensor={size}: the embedding and the head are "
                         "cut into equal vocab blocks")


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """The head's vocab-local logits [..., V / t] -> [..., V] on every
    rank, the blocks in axis order (no gradient: serving)."""
    g = group()
    if g is None:
        return logits
    return comm._all_gather(logits.contiguous(), logits.ndim - 1, g)


def kv_columns(w: torch.Tensor, num_kv_heads: int,
               head_dim: int) -> torch.Tensor:
    """The columns of a K or V projection [..., n_kv * hd] that this
    rank's query heads read. A projection cut on its heads is used as
    it is; one held whole (the axis a multiple of n_kv, train/fsdp.py)
    gives the one head this rank's query heads share: rank i of t reads
    head i // (t / n_kv)."""
    g = group()
    if g is None or w.shape[-1] != num_kv_heads * head_dim:
        return w
    j = g.index // (g.size // num_kv_heads)
    return w[..., j * head_dim:(j + 1) * head_dim]


def kv_held_whole(num_heads: int, num_kv_heads: int, size: int) -> bool:
    """Whether a model's KV projections are held whole at tensor `size`
    (the axis a multiple of num_kv_heads) rather than cut on whole heads
    (num_kv_heads a multiple of the axis). Raises for query heads the
    axis does not divide, and for KV heads that neither divide nor are
    divided by it."""
    if num_heads % size:
        raise ValueError(f"num_heads {num_heads} is not divisible by "
                         f"tensor={size}: the cut falls on whole heads")
    if num_kv_heads % size == 0:
        return False
    if size % num_kv_heads:
        raise ValueError(
            f"num_kv_heads {num_kv_heads} at tensor={size}: neither "
            "divides the other, so the KV heads can be neither cut on "
            "whole heads nor held whole")
    return True


def read_in_rank_work(logical_axes: tuple) -> bool:
    """Whether a leaf held whole on every tensor rank is read inside
    per-rank work, so that each rank's gradient of it is partial and the
    trainer sums it over the axis: every such leaf but those over the
    residual width and unnamed dims alone, which the models read on the
    invariant side of `enter` and `exit`, so that their gradients come
    out whole (the norm scales; ViT's patch and position embeddings, CLS
    token and the biases added after `exit`; the MoE router, whose gate
    values `enter` per-rank work)."""
    return not set(logical_axes) <= {"layers", "embed", None}
