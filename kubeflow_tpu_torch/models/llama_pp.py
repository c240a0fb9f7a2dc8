"""Pipeline-parallel Llama: transformer blocks as GPipe stages
(counterpart: kubeflow_tpu/models/llama_pp.py).

The stacked block params (leaves [L, ...]) reshape to [S, L/S, ...]: S
stages of L/S layers, each stage running its layers through
`llama._block` (on the card the flash kernels, positions contiguous).
Embedding, final norm and head stay outside the pipeline (they do not
keep the activation's shape) and run alike on every stage. The
pipeline's backward already reruns each active tick's stage
(parallel/pipeline.py), so a stage's blocks are not checkpointed again
inside it.

`PipelineTrainer` steps this forward with the trainer's optimizer chain
(warmup-cosine AdamW or Adafactor after the global-norm clip,
`trainer.make_optimizer`) on a (stage, data) mesh: each rank holds its
stage's blocks (the contiguous stage-major split) and the embedding,
norm and head alike, and its moments mirror that; Adafactor's factored
`v_row` and `v_col`, which mirror no param, are held whole, as the
reference replicates them, and its means and RMS run over the full
leaf (a block's `LeafCut` is its stage's cut along the layers); the
batch splits over the data axis. Per-rank flash launches of
one step, with M microbatches over S stages and L/S layers a stage: (M
+ S - 1) L/S forward in the forward pass, M L/S forward again and M L/S
each of dQ and dK/dV in the backward. A mesh with tensor > 1 is
refused: tensor parallelism runs in the mesh trainer (train/fsdp.py).
"""

from __future__ import annotations

import contextlib

import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.models.llama import LlamaConfig, Params
from kubeflow_tpu_torch.ops.embedding import embed_lookup
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rotary import rope_frequencies
from kubeflow_tpu_torch.parallel import comm
from kubeflow_tpu_torch.parallel import pipeline as pp
from kubeflow_tpu_torch.parallel.mesh import TENSOR_AXIS
from kubeflow_tpu_torch.train import trainer as trainer_lib
from kubeflow_tpu_torch.train.fsdp import _rebuild, sharded_sq_norm
from kubeflow_tpu_torch.train.trainer import LeafCut, _named_leaves


def split_stages(params: Params, cfg: LlamaConfig, n_stages: int) -> Params:
    """Blocks [L, ...] -> [S, L/S, ...] (stage-major views)."""
    if cfg.num_layers % n_stages:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                         f"n_stages={n_stages}")
    per = cfg.num_layers // n_stages
    return {k: v.reshape(n_stages, per, *v.shape[1:])
            for k, v in params["blocks"].items()}


def merge_stages(staged_blocks: Params) -> Params:
    """Inverse of split_stages."""
    return {k: v.reshape(-1, *v.shape[2:]) for k, v in staged_blocks.items()}


def _stage_fn(cfg: LlamaConfig, mb: int, s: int, device):
    positions = torch.arange(s, dtype=torch.int32,
                             device=device).expand(mb, s)
    inv_freq = rope_frequencies(cfg.head_dim, theta=cfg.rope_theta,
                                device=device)

    def stage_fn(stage_blocks: Params, x: torch.Tensor) -> torch.Tensor:
        layers = {k: v.unbind(0) for k, v in stage_blocks.items()}
        n = len(next(iter(layers.values())))
        for li in range(n):
            x = llama._block(cfg, x, {k: v[li] for k, v in layers.items()},
                             positions, inv_freq, None,
                             contiguous_positions=True)
        return x

    return stage_fn


def _num_microbatches(S: int, b: int, num_microbatches: int | None) -> int:
    M = num_microbatches or 2 * S
    if b % M:
        raise ValueError(f"batch {b} not divisible by microbatches {M}")
    return M


def _head(params, cfg, y):
    y = rms_norm(y, params["final_norm"], cfg.norm_eps)
    return y.float() @ llama.unembed_matrix(params, cfg).float()


def apply_pipelined(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                    mesh, *, stage_axis: str = "stage",
                    num_microbatches: int | None = None) -> torch.Tensor:
    """Forward with the blocks pipelined over `stage_axis` -> logits
    [b, s, vocab] fp32, alike on every stage. `params` is the full tree
    every stage holds alike; microbatches default to 2 S."""
    S = mesh.shape[stage_axis]
    b, s = tokens.shape
    M = _num_microbatches(S, b, num_microbatches)
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    y = pp.pipeline_sharded(_stage_fn(cfg, b // M, s, tokens.device),
                            split_stages(params, cfg, S), x, mesh,
                            stage_axis=stage_axis, num_microbatches=M)
    return _head(params, cfg, y)


def loss_pipelined(params, cfg, tokens, targets, mesh, **kw) -> torch.Tensor:
    logits = apply_pipelined(params, cfg, tokens, mesh, **kw)
    return trainer_lib.cross_entropy_loss(logits, targets)


class PipelineTrainer:
    """The pipelined Llama forward under the trainer's optimizer chain on
    a (stage, data) mesh; `step` takes the global batch on every rank
    and returns the global loss."""

    def __init__(self, cfg: LlamaConfig, mesh, *, stage_axis: str = "stage",
                 data_axis: str = "data",
                 num_microbatches: int | None = None,
                 train_config: trainer_lib.TrainConfig = (
                     trainer_lib.TrainConfig()),
                 device: torch.device | str | None = None):
        if mesh.shape.get(TENSOR_AXIS, 1) > 1:
            raise ValueError(
                f"tensor parallelism is not ported for the pipeline "
                f"(PipelineTrainer on mesh {mesh.shape}): use stage and "
                "data axes")
        S = mesh.shape[stage_axis]
        if cfg.num_layers % S:
            raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                             f"{stage_axis}={S}")
        self.cfg = cfg
        self.mesh = mesh
        self.stage_axis = stage_axis
        self.stage = mesh.axis_group(stage_axis)
        self.data = mesh.axis_group(data_axis)
        self.num_microbatches = num_microbatches or 2 * S
        self.tc = train_config
        self.device = trainer_lib.resolve_device(device)
        self.optimizer = trainer_lib.make_optimizer(train_config)

    def init(self, seed: int) -> trainer_lib.TrainState:
        """Every rank draws the full params from `seed` and keeps its
        stage's blocks and the rest alike."""
        params = llama.init(self.cfg, seed, self.device, train=True)
        return self.init_from_params(params)

    def init_from_params(self, params: Params) -> trainer_lib.TrainState:
        S, idx = self.stage.size, self.stage.index
        local = dict(params)
        # a clone: a view would keep every stage's blocks alive
        local["blocks"] = {k: v[idx].clone() for k, v in
                           split_stages(params, self.cfg, S).items()}
        local = trainer_lib._prep(local, self.device)
        return trainer_lib.TrainState(
            local, self.optimizer.init(local, self._cut), 0)

    def _cut(self, name: str, p: torch.Tensor) -> LeafCut:
        """A leaf's LeafCut: a stage's blocks are cut along the layers."""
        if not name.startswith("blocks."):
            return LeafCut(p.shape)
        return LeafCut((p.shape[0] * self.stage.size, *p.shape[1:]),
                       [(0, self.stage)])

    @contextlib.contextmanager
    def _slot(self, name, p, g):
        yield p, g, self._cut(name, p)

    def _loss(self, params, tokens, targets):
        cfg = self.cfg
        b, s = tokens.shape
        M = _num_microbatches(self.stage.size, b, self.num_microbatches)
        x = embed_lookup(params["embed"], tokens, cfg.dtype)
        x_mb = x.reshape(M, b // M, *x.shape[1:])
        y = pp.pipeline(_stage_fn(cfg, b // M, s, tokens.device),
                        params["blocks"], x_mb, group=self.stage)
        logits = _head(params, cfg, y.reshape(b, *y.shape[2:]))
        return trainer_lib.cross_entropy_loss(logits, targets)

    def step(self, state: trainer_lib.TrainState, tokens, targets):
        tokens = torch.as_tensor(tokens, device=self.device)
        targets = torch.as_tensor(targets, device=self.device)
        n = self.data.size
        if tokens.shape[0] % n:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"data={n}")
        rows = lambda t: t.chunk(n, 0)[self.data.index]  # noqa: E731
        named = _named_leaves(state.params)
        loss = self._loss(state.params, rows(tokens), rows(targets)) / n
        grads = torch.autograd.grad(loss, [p for _, p in named])
        with torch.no_grad():
            self.optimizer.update([comm._psum(g, self.data) for g in grads],
                                  state.opt_state, state.params,
                                  sq_norm=self._sq_norm, slot=self._slot)
        state.step += 1
        return state, comm._psum(loss.detach(), self.data)

    def _sq_norm(self, names, grads) -> torch.Tensor:
        """The clip's squared norm: the blocks' summed over the stages,
        the shared leaves' (alike on every stage) counted once."""
        stage = (self.stage_axis,)
        return sharded_sq_norm(self.mesh, grads, [
            stage if n.startswith("blocks.") else () for n in names])

    def gather_params(self, state: trainer_lib.TrainState) -> Params:
        """The full params: the stages' blocks all-gathered along the
        layers (a collective every rank calls)."""
        out = dict(state.params)
        out["blocks"] = {k: comm._all_gather(v.detach(), 0, self.stage)
                         for k, v in state.params["blocks"].items()}
        return _rebuild(out, lambda _, t: t.detach())


def make_train_step(cfg: LlamaConfig, mesh, learning_rate: float = 1e-3,
                    **kw):
    """SGD with momentum over the pipelined loss (enough to prove the
    pipeline trains; `PipelineTrainer` is the real optimizer chain).
    `step(params, momentum, tokens, targets) -> (params, momentum, loss)`
    on the full params every stage holds alike."""

    def step(params, momentum, tokens, targets):
        leaves = [p.detach().requires_grad_(True) for _, p in
                  _named_leaves(params)]
        it = iter(leaves)
        live = _rebuild(params, lambda *_: next(it))
        loss = loss_pipelined(live, cfg, tokens, targets, mesh, **kw)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            gi = iter(grads)
            momentum = _rebuild(momentum, lambda _, m: 0.9 * m + next(gi))
            mi = iter(_named_leaves(momentum))
            params = _rebuild(params, lambda _, p: (
                p - learning_rate * next(mi)[1].to(p.dtype)))
        return params, momentum, loss.detach()

    return step
