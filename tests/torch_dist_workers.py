"""Torch-side cases of the port's distributed tests, run in each rank
of a gloo gang (tests/torch_dist.py). No JAX here: each returns tensors
the parent holds against the reference."""

import torch

from kubeflow_tpu_torch.parallel import MeshSpec, create_mesh
from kubeflow_tpu_torch.parallel import comm


def _t(x, grad=False):
    return torch.tensor(x).requires_grad_(grad)


def _with_grads(fn, *xs):
    """fn(*xs) and the gradients of sum(fn(...)**2) (every rank computes
    the same invariant loss: one copy)."""
    xs = [_t(x, True) for x in xs]
    out = fn(*xs)
    grads = torch.autograd.grad((out.float() ** 2).sum(), xs)
    return [out.detach(), *grads]


# -- test_torch_ring.py ------------------------------------------------------

def ring_cases(payload, rank, world):
    from kubeflow_tpu_torch.parallel import ring

    meshes = {4: create_mesh(MeshSpec(data=1, fsdp=4), device_type="cpu"),
              2: create_mesh(MeshSpec(data=2, fsdp=2), device_type="cpu")}
    out = {}
    for key, (q, k, v) in payload["qkv"].items():
        for size in (2, 4):
            for causal in (True, False):
                for name in ("ring", "ring_flash"):
                    fn = getattr(ring, f"{name}_attention_sharded")
                    out[(key, size, causal, name)] = _with_grads(
                        lambda q, k, v: fn(q, k, v, meshes[size],
                                           causal=causal), q, k, v)
    q, k, v = payload["ulysses"]
    for causal in (True, False):
        for impl in ("xla", "flash"):
            out[("ulysses", causal, impl)] = _with_grads(
                lambda q, k, v: ring.ulysses_attention_sharded(
                    q, k, v, meshes[4], causal=causal, impl=impl), q, k, v)
    # the per-rank (unsharded) entry points on this rank's blocks
    g = meshes[4].axis_group("fsdp")
    q, k, v = (torch.tensor(x).chunk(4, 1)[g.index].contiguous()
               for x in payload["qkv"]["gqa"])
    out["local"] = ring.ring_flash_attention(q, k, v, group=g)
    return out


# -- test_torch_moe_ep.py ----------------------------------------------------

def moe_ep_cases(payload, rank, world):
    from kubeflow_tpu_torch.parallel import moe

    mesh = create_mesh(MeshSpec(data=1, fsdp=2, tensor=2), device_type="cpu")
    out = {}
    x = torch.tensor(payload["x"])
    for name, cfg in payload["cfgs"].items():
        cfg = moe.MoEConfig(**cfg)
        params = {k: _t(v, True) for k, v in payload["params"].items()}
        y, aux = moe.moe_mlp_sharded(params, x, cfg, mesh)
        g_aux = torch.autograd.grad(aux, [params["router"]],
                                    retain_graph=True)[0]
        loss = (y ** 2).sum() + 0.01 * aux
        grads = torch.autograd.grad(loss, list(params.values()))
        out[name] = {"y": y.detach(), "aux": aux.detach(), "g_aux": g_aux,
                     "grads": dict(zip(params, grads))}
    # the per-rank entry point: this rank's tokens and experts
    g = mesh.axis_group("tensor")
    cfg = moe.MoEConfig(**payload["cfgs"]["generous"])
    local = {k: torch.tensor(v) for k, v in payload["params"].items()}
    for k in ("w_gate", "w_up", "w_down"):
        local[k] = local[k].chunk(2, 0)[g.index]
    batch = mesh.axis_group(("data", "fsdp", "tensor"))
    y, _ = moe.moe_mlp_expert_parallel(local, x.chunk(4, 0)[batch.index],
                                       cfg, group=g, token_groups=(batch,))
    out["local"] = y
    return out


# -- test_torch_pipeline.py --------------------------------------------------

def _mlp_stage(params, x):
    h = torch.nn.functional.gelu(x @ params["w1"] + params["b1"],
                                 approximate="none")
    return x + h @ params["w2"]


def pipeline_cases(payload, rank, world):
    import dataclasses

    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.models import llama, llama_pp
    from kubeflow_tpu_torch.parallel import Mesh, pipeline as pp
    from kubeflow_tpu_torch.train import TrainConfig

    out = {}
    stage4 = Mesh(torch.arange(4).numpy(), ("stage",), "cpu")
    sd = Mesh(torch.arange(4).numpy().reshape(2, 2), ("stage", "data"),
              "cpu")
    stacked = {k: _t(v, True) for k, v in payload["mlp"].items()}
    x = torch.tensor(payload["x"])
    for m in (1, 2, 4, 8):
        out[("mlp", m)] = pp.pipeline_sharded(
            _mlp_stage, stacked, x, stage4, stage_axis="stage",
            num_microbatches=m).detach()
    tgt = torch.tensor(payload["tgt"])
    y = pp.pipeline_sharded(_mlp_stage, stacked, x[:4], stage4,
                            stage_axis="stage", num_microbatches=2)
    loss = ((y - tgt) ** 2).mean()
    out["mlp_grads"] = dict(zip(stacked, torch.autograd.grad(
        loss, list(stacked.values()))))

    cfg = llama.LLAMA_TINY
    params = bridge.from_jax(payload["llama"], cfg, "cpu")
    toks = torch.tensor(payload["toks"]).long()
    tgts = torch.tensor(payload["tgts"]).long()
    out["logits"] = llama_pp.apply_pipelined(params, cfg, toks, sd,
                                             num_microbatches=2)
    leaves = {k: v.requires_grad_(True) for k, v in
              llama_pp._named_leaves(params)}
    live = llama_pp._rebuild(params, lambda n, _: leaves[n])
    loss = llama_pp.loss_pipelined(live, cfg, toks, tgts, sd,
                                   num_microbatches=2)
    out["pp_grads"] = dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))

    step = llama_pp.make_train_step(cfg, sd, learning_rate=5e-2,
                                    num_microbatches=2)
    p = bridge.from_jax(payload["llama"], cfg, "cpu")
    mom = llama_pp._rebuild(p, lambda _, t: torch.zeros_like(t))
    sgd = []
    for _ in range(3):
        p, mom, loss = step(p, mom, toks, tgts)
        sgd.append(float(loss))
    out["sgd"] = sgd

    cfg4 = dataclasses.replace(cfg, num_layers=4)
    tc = TrainConfig(warmup_steps=2, total_steps=10)
    trainer = llama_pp.PipelineTrainer(cfg4, sd, num_microbatches=4,
                                       train_config=tc, device="cpu")
    state = trainer.init_from_params(
        bridge.from_jax(payload["llama4"], cfg4, "cpu"))
    t4 = torch.tensor(payload["toks4"]).long()
    g4 = torch.tensor(payload["tgts4"]).long()
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, t4, g4)
        losses.append(float(loss))
    out["trainer_losses"] = losses
    out["trainer_params"] = trainer.gather_params(state)
    out["wq_local"] = tuple(state.params["blocks"]["wq"].shape)
    return out


# -- test_torch_fsdp.py ------------------------------------------------------

def _gathers_alive_after_forward(payload, mesh):
    """llama-tiny (4 layers, remat) under the trainer's mesh view: the
    shapes of the all-gathered tensors still alive once the loss is
    computed, before its backward, by remat policy."""
    import dataclasses
    import weakref

    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train import TrainConfig, Trainer

    out = {}
    gather = comm.all_gather
    made = []

    def recording(x, dim, group):
        y = gather(x, dim, group)
        made.append(weakref.ref(y))
        return y

    toks = torch.tensor(payload["toks"]).long()
    for policy in ("full", "mlp", "dots"):
        cfg = dataclasses.replace(llama.LLAMA_TINY, num_layers=4, remat=True,
                                  remat_policy=policy)
        trainer = Trainer(lambda p, t: llama.apply(p, cfg, t), None,
                          TrainConfig(), device="cpu", mesh=mesh,
                          logical_axes=llama.param_logical_axes(cfg))
        state = trainer.init_from_params(bridge.from_jax(
            payload["llama4"], cfg, "cpu"))
        lay = trainer.layout
        made.clear()
        comm.all_gather = recording
        try:
            logits = llama.apply(lay.model_view(state.params), cfg,
                                 lay.local_rows(toks))
            out[policy] = {"made": len(made), "alive": sorted(
                tuple(r().shape) for r in made if r() is not None)}
            # the backward recomputes each block and gathers its layer
            # again
            made.clear()
            logits.float().square().mean().backward()
            out[policy]["regathered"] = len(made)
        finally:
            comm.all_gather = gather
    return out


def fsdp_cases(payload, rank, world):
    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.models import gemma, llama, vit
    from kubeflow_tpu_torch.parallel import sharding
    from kubeflow_tpu_torch.train import TrainConfig, Trainer, lora
    from kubeflow_tpu_torch.train.trainer import cross_entropy_loss

    mesh = create_mesh(MeshSpec(data=2, fsdp=2), device_type="cpu")
    models = {"llama": (llama, llama.LLAMA_TINY),
              "gemma": (gemma, gemma.GEMMA_TINY)}
    toks = torch.tensor(payload["toks"]).long()
    tgts = torch.tensor(payload["tgts"]).long()
    out = {}
    for name, (mod, cfg) in models.items():
        for zero in (True, False):
            tc = TrainConfig(warmup_steps=1, total_steps=10,
                             zero_optimizer=zero)
            trainer = Trainer(lambda p, t, mod=mod, cfg=cfg: mod.apply(
                p, cfg, t), None, tc, device="cpu", mesh=mesh,
                logical_axes=mod.param_logical_axes(cfg))
            state = trainer.init_from_params(
                bridge.from_jax(payload[name], cfg, "cpu"))
            losses = []
            for _ in range(3):
                state, loss = trainer.step(state, toks, tgts)
                losses.append(float(loss))
            out[(name, zero)] = {
                "losses": losses, "params": trainer.gather_params(state),
                "opt_bytes": trainer.opt_state_bytes(),
                "local": {k: tuple(v.shape) for k, v in
                          state.params["blocks"].items()},
                "mu": tuple(state.opt_state["mu"][0].shape)}
    # ViT-tiny: biases over "heads" / "mlp" and the head's bias are held
    # whole on every rank; their gradients still sum over fsdp
    cfg = vit.VIT_TINY
    x, y1, w1 = (torch.tensor(payload["vit_" + k]) for k in ("x", "y", "w"))
    for zero in (True, False):
        tc = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=20,
                         zero_optimizer=zero)
        trainer = Trainer(vit.apply_fn(cfg), None, tc, device="cpu",
                          mesh=mesh, logical_axes=vit.param_logical_axes(cfg))
        state = trainer.init_from_params(
            bridge.from_jax(payload["vit"], cfg, "cpu"))
        losses = []
        for _ in range(3):
            state, loss = trainer.step(state, x, y1, w1)
            losses.append(float(loss))
        out[("vit", zero)] = {"losses": losses,
                              "params": trainer.gather_params(state)}
    # a LoRA pack on llama-tiny with wo, whose A is held whole
    cfg = llama.LLAMA_TINY
    lcfg = lora.LoraConfig(rank=4, alpha=8.0,
                           targets=("wq", "wk", "wv", "wo"))
    base_axes = llama.param_logical_axes(cfg)
    tree = lora.lora_train_tree(
        bridge.from_jax(payload["lora"]["base"], cfg, "cpu",
                        dtype=cfg.param_dtype),
        {"blocks": {n: {k: torch.tensor(v) for k, v in ab.items()}
                    for n, ab in payload["lora"]["lora"]["blocks"].items()}})

    def lora_model_loss(p, t, tg, m):
        return cross_entropy_loss(llama.apply(p, cfg, t), tg, m)

    trainer = Trainer(None, None, TrainConfig(warmup_steps=2, total_steps=100,
                                              learning_rate=3e-3),
                      loss_fn=lora.lora_loss_fn(lora_model_loss, lcfg),
                      device="cpu", mesh=mesh,
                      logical_axes={"base": base_axes,
                                    "lora": lora.lora_logical_axes(base_axes,
                                                                   lcfg)},
                      freeze_labels=lora.lora_freeze_labels(tree))
    state = trainer.init_from_params(tree)
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, toks, tgts)
        losses.append(float(loss))
    out["lora"] = {"losses": losses,
                   "params": trainer.gather_params(state)["lora"],
                   "wo_A": tuple(state.params["lora"]["blocks"]["wo"]["A"]
                                 .shape)}
    out["alive"] = _gathers_alive_after_forward(payload, mesh)
    # the checkpoint-resize bridge: shard, then gather back
    specs = sharding.logical_to_spec(sharding.LLAMA_RULES,
                                     llama.param_logical_axes(
                                         llama.LLAMA_TINY))
    shard_fns, gather_fns = sharding.make_shard_and_gather_fns(specs, mesh)
    w = torch.tensor(payload["llama"]["blocks"]["wq"])
    block = shard_fns["blocks"]["wq"](w)
    out["shard_gather"] = (tuple(block.shape),
                           bool(torch.equal(gather_fns["blocks"]["wq"](block),
                                            w)))
    return out
