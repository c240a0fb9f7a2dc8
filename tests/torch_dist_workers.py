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


# -- test_torch_elastic_gang.py ---------------------------------------------

def elastic_resize_cases(payload, rank, world):
    """Resize-on-restore over the mesh trainer: a ZeRO run saved at
    (data 2, fsdp 2), restored at (data 4, fsdp 1) and on one device;
    `resize_state` between the meshes and onto one device; the commit
    markers with one writing rank."""
    import logging
    import os
    import shutil

    import torch.distributed as dist

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train import TrainConfig, Trainer
    from kubeflow_tpu_torch.train.checkpoint import (
        COMMIT_MARKER, CheckpointConfig, Checkpointer,
    )
    from kubeflow_tpu_torch.train.elastic import resize_state

    cfg = llama.LLAMA_TINY
    meshes = {2: create_mesh(MeshSpec(data=2, fsdp=2), device_type="cpu"),
              4: create_mesh(MeshSpec(data=4, fsdp=1), device_type="cpu")}
    batches = [(torch.tensor(t).long(), torch.tensor(y).long())
               for t, y in payload["batches"]]

    def trainer(world_size):
        return Trainer(lambda p, t: llama.apply(p, cfg, t),
                       lambda seed: llama.init(cfg, seed, "cpu", train=True),
                       TrainConfig(warmup_steps=1, total_steps=100,
                                   zero_optimizer=True),
                       device="cpu", mesh=meshes.get(world_size),
                       logical_axes=llama.param_logical_axes(cfg))

    def full(tr, state):
        """Copies of the whole params and moments (a gather may hand back
        a live leaf, which the next step updates in place)."""
        params = tr.gather_params(state)
        return ({k: ({n: t.clone() for n, t in v.items()}
                     if isinstance(v, dict) else v.clone())
                 for k, v in params.items()},
                {k: [t.clone() for t in v] if isinstance(v, list) else v
                 for k, v in tr.gather_opt_state(state).items()})

    lines = []

    class Catch(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    ckpt_log = logging.getLogger("kubeflow_tpu_torch.train.checkpoint")
    ckpt_log.addHandler(Catch())
    ckpt_log.setLevel(logging.INFO)
    trs = {n: trainer(n) for n in (2, 4, 1)}
    out = {}
    d = payload["dir"]
    tr2 = trs[2]
    ck2 = Checkpointer(CheckpointConfig(os.path.join(d, "resize"),
                                        save_interval_steps=1,
                                        enable_async=False), tr2,
                       run_metadata={"run": "resize-test"})
    state = tr2.init(0)
    for s in range(3):
        state, _ = tr2.step(state, *batches[s])
    out["saved"] = ck2.save(state, force=True)
    out["saved_opt"] = full(tr2, state)[1]
    out["mu_local"] = tuple(state.opt_state["mu"][1].shape)
    oracle = []
    for s in range(3, 8):
        state, loss = tr2.step(state, *batches[s])
        oracle.append(float(loss))
    out["oracle"] = oracle
    ck2.close()
    for n in (4, 1):
        ck = Checkpointer(CheckpointConfig(os.path.join(d, "resize")),
                          trs[n])
        restored = ck.restore()
        got = {"step": restored.step, "stamp": ck.virtual_replicas,
               "meta": ck.restore_metadata(),
               "opt": full(trs[n], restored)[1], "losses": []}
        for s in range(3, 8):
            restored, loss = trs[n].step(restored, *batches[s])
            got["losses"].append(float(loss))
        out[("restore", n)] = got
        ck.close()
    out["log"] = list(lines)

    # live resize: mesh 2 -> mesh 4 and -> one device, without a disk
    state = tr2.init(7)
    state, _ = tr2.step(state, *batches[0])
    src = full(tr2, state)
    moved4 = resize_state(state, trs[4], from_trainer=tr2)
    moved1 = resize_state(state, trs[1], from_trainer=tr2)
    out["resize"] = {"src": src, "to4": full(trs[4], moved4),
                     "to1": full(trs[1], moved1),
                     "losses": [float(tr.step(st, *batches[1])[1])
                                for tr, st in ((tr2, state),
                                               (trs[4], moved4),
                                               (trs[1], moved1))]}

    # commit markers: rank 0 writes, every rank flushes
    mk = os.path.join(d, "markers")
    ck = Checkpointer(CheckpointConfig(mk, save_interval_steps=1,
                                       enable_async=True), tr2)
    state = tr2.init(0)
    state, _ = tr2.step(state, *batches[0])
    ck.save(state, force=True)
    state, _ = tr2.step(state, *batches[1])
    ck.save(state, force=True)          # flushes step 1's marker
    marks = {"after_second_save": ck.committed_steps()}
    ck.close()                          # drains, marks step 2
    marks["after_close"] = ck.committed_steps()
    marks["latest_path"] = ck.latest_committed_path()
    if rank == 0:                       # a crash mid-save left step 3
        os.makedirs(os.path.join(mk, "3", "junk"))
    dist.barrier()
    ck = Checkpointer(CheckpointConfig(mk, save_interval_steps=1,
                                       enable_async=False), tr2)
    marks["latest_committed"] = ck.latest_committed_step()
    marks["restored_step"] = ck.restore().step
    state, _ = tr2.step(state, *batches[2])
    marks["resaved"] = ck.save(state, force=True)   # over the stale dir
    marks["junk_gone"] = not os.path.exists(os.path.join(mk, "3", "junk"))
    marks["marker"] = os.path.exists(os.path.join(mk, "3", COMMIT_MARKER))
    marks["skip_committed"] = ck.save(state, force=True)
    ck.close()
    dist.barrier()
    only = os.path.join(d, "uncommitted_only")
    if rank == 0:
        os.makedirs(os.path.join(only, "5", "junk"))
    dist.barrier()
    ck = Checkpointer(CheckpointConfig(only), tr2)
    marks["fresh_step"] = ck.restore_or_init(0).step
    ck.close()
    dist.barrier()
    if rank == 0:
        shutil.rmtree(only)
    out["marks"] = marks
    return out
