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


# -- test_torch_tensor_parallel.py -------------------------------------------

def _full_state(tr, state):
    """Copies of the whole params and moments of a trainer's state."""
    from kubeflow_tpu_torch.train.checkpoint import flatten

    opt = tr.gather_opt_state(state)
    return ({k: v.clone() for k, v in flatten(tr.gather_params(state))
             .items()},
            {k: [t.clone() for t in v] if isinstance(v, list) else v
             for k, v in opt.items()})


def tensor_parallel_cases(payload, rank, world):
    """Llama-tiny, gemma-tiny and a LoRA pack trained tensor-parallel on
    (fsdp 2, tensor 2) and (data 2, tensor 2): the forward's logits, one
    step's gradients (with a control that sums a whole leaf over tensor
    once too often), 3 steps, remat policies, a checkpoint round trip."""
    import dataclasses
    import os

    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.models import gemma, llama
    from kubeflow_tpu_torch.parallel import tensor
    from kubeflow_tpu_torch.train import TrainConfig, Trainer, lora
    from kubeflow_tpu_torch.train.checkpoint import (
        CheckpointConfig, Checkpointer,
    )
    from kubeflow_tpu_torch.train.trainer import (
        chunked_cross_entropy_from_hidden, cross_entropy_loss,
    )

    ft = create_mesh(MeshSpec(data=1, fsdp=2, tensor=2), device_type="cpu")
    dt = create_mesh(MeshSpec(data=2, fsdp=1, tensor=2), device_type="cpu")
    df = create_mesh(MeshSpec(data=2, fsdp=2, tensor=1), device_type="cpu")
    toks = torch.tensor(payload["toks"]).long()
    tgts = torch.tensor(payload["tgts"]).long()
    tc = TrainConfig(warmup_steps=1, total_steps=10)
    out = {}

    def trainer(mod, cfg, mesh, **kw):
        return Trainer(lambda p, t: mod.apply(p, cfg, t), None,
                       kw.pop("tc", tc), device="cpu", mesh=mesh,
                       logical_axes=kw.pop(
                           "axes", mod.param_logical_axes(cfg)),
                       model_config=cfg, **kw)

    def steps(tr, state, n=3):
        losses = []
        for _ in range(n):
            state, loss = tr.step(state, toks, tgts)
            losses.append(float(loss))
        return state, losses

    def local_shapes(state):
        return {k: tuple(v.shape) for k, v in state.params["blocks"].items()}

    # llama-tiny on (fsdp 2, tensor 2): the forward, gradients, 3 steps
    cfg = llama.LLAMA_TINY
    tr = trainer(llama, cfg, ft)
    state = tr.init_from_params(bridge.from_jax(payload["llama"], cfg, "cpu"))
    lay = tr.layout
    with torch.no_grad(), lay.parallel():
        logits = llama.apply(lay.model_view(state.params), cfg,
                             lay.local_rows(toks))
    logits = comm._all_gather(logits, 2, lay.tensor)
    out["logits"] = comm._all_gather(logits, 0, lay.batch)
    names = [n for n, _ in tr.optimizer.trained(state.params)]
    out["llama_grads"] = dict(zip(names, tr.grads(state, toks, tgts)))
    # the control: final_norm's gradient (whole already) summed over
    # tensor as well
    keep = lay.leaves["final_norm"].grad_group
    lay.leaves["final_norm"].grad_group = ft.axis_group("tensor")
    out["control_grads"] = dict(zip(names, tr.grads(state, toks, tgts)))
    lay.leaves["final_norm"].grad_group = keep
    out["llama_local"] = local_shapes(state)
    state, losses = steps(tr, state)
    out["llama"] = {"losses": losses, "opt_bytes": tr.opt_state_bytes(),
                    "params": tr.gather_params(state)}

    # its checkpoint: saved here, restored on one device and on
    # (data 2, fsdp 2)
    saved = _full_state(tr, state)
    d = os.path.join(payload["dir"], "tp")
    ck = Checkpointer(CheckpointConfig(d, enable_async=False), tr)
    ck.save(state, force=True)
    ck.close()
    ckpt = {"saved_stamp": ck.restore_metadata()["virtual_replicas"]}
    for key, mesh in (("one", None), ("df", df)):
        other = Trainer(lambda p, t: llama.apply(p, cfg, t), None, tc,
                        device="cpu", mesh=mesh,
                        logical_axes=llama.param_logical_axes(cfg))
        ck = Checkpointer(CheckpointConfig(d), other)
        restored = ck.restore()
        params, opt = _full_state(other, restored)
        ckpt[key] = {
            "stamp": ck.virtual_replicas, "step": restored.step,
            "params": all(torch.equal(v, saved[0][k])
                          for k, v in params.items()),
            "opt": opt["count"] == saved[1]["count"] and all(
                torch.equal(a, b) for slot in ("mu", "nu")
                for a, b in zip(opt[slot], saved[1][slot], strict=True))}
        ck.close()
    out["ckpt"] = ckpt

    # remat policies: the same gradients when the backward reruns the
    # blocks and their collectives
    out["remat"] = {}
    for policy in ("full", "mlp", "dots"):
        rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        rtr = trainer(llama, rcfg, ft)
        rstate = rtr.init_from_params(
            bridge.from_jax(payload["llama"], rcfg, "cpu"))
        out["remat"][policy] = dict(zip(names, rtr.grads(rstate, toks,
                                                         tgts)))
    # the forward inside the context, the backward outside it, as
    # autograd's device thread runs a CUDA backward: the rerun blocks
    # carry their group (tensor.bind)
    lay = rtr.layout
    named = rtr.optimizer.trained(rstate.params)
    rows, targets = lay.local_rows(toks), lay.local_rows(tgts)
    with lay.parallel():
        loss = cross_entropy_loss(llama.apply(
            lay.model_view(rstate.params), rcfg, rows), targets)
    loss = loss * lay.loss_weight(torch.ones(rows.shape))
    grads = torch.autograd.grad(loss, [p for _, p in named])
    out["remat"]["outside"] = {
        n: lay.gather_leaf(n, g) for (n, _), g in
        zip(named, lay.reduce_grads(named, grads), strict=True)}

    # llama-tiny with the chunked loss from the final hidden
    def chunked(p, t, tg, m):
        return chunked_cross_entropy_from_hidden(
            llama.hidden(p, cfg, t), llama.unembed_matrix(p, cfg), tg, m)

    tr = trainer(llama, cfg, ft, loss_fn=chunked)
    state = tr.init_from_params(bridge.from_jax(payload["llama"], cfg, "cpu"))
    state, losses = steps(tr, state)
    out["chunked"] = {"losses": losses, "params": tr.gather_params(state)}

    # gemma-tiny on (data 2, tensor 2) with ZeRO: its one KV head held
    # whole
    gcfg = gemma.GEMMA_TINY
    tr = trainer(gemma, gcfg, dt)
    state = tr.init_from_params(bridge.from_jax(payload["gemma"], gcfg,
                                                "cpu"))
    gnames = [n for n, _ in tr.optimizer.trained(state.params)]
    out["gemma_grads"] = dict(zip(gnames, tr.grads(state, toks, tgts)))
    out["gemma_local"] = local_shapes(state)
    state, losses = steps(tr, state)
    out["gemma"] = {"losses": losses, "opt_bytes": tr.opt_state_bytes(),
                    "params": tr.gather_params(state)}

    # a LoRA pack on wq, wk, wv and wo over llama-tiny's frozen base
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

    tr = Trainer(None, None, TrainConfig(warmup_steps=2, total_steps=100,
                                         learning_rate=3e-3),
                 loss_fn=lora.lora_loss_fn(lora_model_loss, lcfg),
                 device="cpu", mesh=ft, model_config=cfg,
                 logical_axes={"base": base_axes,
                               "lora": lora.lora_logical_axes(base_axes,
                                                              lcfg)},
                 freeze_labels=lora.lora_freeze_labels(tree))
    state = tr.init_from_params(tree)
    base = {k: v.clone() for k, v in tr.gather_params(state)["base"]
            ["blocks"].items()}
    lnames = [n for n, _ in tr.optimizer.trained(state.params)]
    out["lora_grads"] = dict(zip(lnames, tr.grads(state, toks, tgts)))
    out["lora_local"] = {f"{n}.{k}": tuple(v.shape) for n, ab in
                         state.params["lora"]["blocks"].items()
                         for k, v in ab.items()}
    state, losses = steps(tr, state)
    full = tr.gather_params(state)
    out["lora"] = {"losses": losses, "params": full["lora"],
                   "base_unchanged": all(
                       torch.equal(v, base[k])
                       for k, v in full["base"]["blocks"].items())}
    out["context_left"] = tensor.group() is None
    return out


# -- test_torch_mesh_recipes.py ----------------------------------------------

def _guarded(out, key, fn):
    """out[key] = fn(), or the error it raised (on every rank alike: the
    refusals raise before any collective), so one case's failure leaves
    the others' results."""
    try:
        out[key] = fn()
    except Exception as e:  # noqa: BLE001 - reported to the parent
        out[key] = {"error": f"{type(e).__name__}: {e}"}


def _drops(moe, calls):
    """A stand-in for `moe._assign` that records each call's dropped and
    total choices."""
    assign = moe._assign

    def counted(*a, **kw):
        res = assign(*a, **kw)
        calls.append((int((~res[3]).sum()), res[3].numel()))
        return res

    return assign, counted


def _mesh_trainer(mod, cfg, mesh, tc, **kw):
    from kubeflow_tpu_torch.train import Trainer

    return Trainer(kw.pop("apply_fn", lambda p, t: mod.apply(p, cfg, t)),
                   None, tc, device="cpu", mesh=mesh,
                   logical_axes=mod.param_logical_axes(cfg),
                   model_config=cfg, **kw)


def _steps(tr, state, batch, n=3):
    losses = []
    for _ in range(n):
        state, loss = tr.step(state, *batch)
        losses.append(float(loss))
    return state, losses


def _moe_recipes(payload, meshes):
    """The MoE family: global routing on (data 2, fsdp 4) and
    tensor-parallel on (data 2, fsdp 2, tensor 2), 3 steps each, with
    the dropped choices of the first forward; one step's gradients at
    tensor 2, and the control that sums the router's whole gradient over
    "tensor"."""
    import dataclasses

    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.models import llama_moe
    from kubeflow_tpu_torch.parallel import moe
    from kubeflow_tpu_torch.train import TrainConfig

    cfg = dataclasses.replace(llama_moe.MIXTRAL_TINY, **payload["moe_cfg"])
    tc = TrainConfig(**payload["moe_tc"])
    batch = tuple(torch.tensor(payload["moe_" + k]).long()
                  for k in ("toks", "tgts"))
    out = {}
    for key in ("df", "dft"):
        def run(key=key):
            tr = _mesh_trainer(llama_moe, cfg, meshes[key], tc,
                               apply_fn=lambda p, t: llama_moe.apply(
                                   p, cfg, t)[0],
                               loss_fn=llama_moe.loss_fn(cfg))
            state = tr.init_from_params(bridge.from_jax(payload["moe"], cfg,
                                                        "cpu"))
            res = {}
            if key == "dft":
                names = [n for n, _ in tr.optimizer.trained(state.params)]
                res["grads"] = dict(zip(names, tr.grads(state, *batch)))
                lay = tr.layout
                router = lay.leaves["blocks.router"]
                keep = router.grad_group
                router.grad_group = meshes[key].axis_group(
                    ("data", "tensor"))
                res["control"] = dict(zip(names, tr.grads(state, *batch)))
                router.grad_group = keep
                res["experts"] = tuple(state.params["blocks"]["w_gate"]
                                       .shape)
            calls = []
            assign, moe._assign = _drops(moe, calls)
            try:
                state, loss = tr.step(state, *batch)
            finally:
                moe._assign = assign
            state, losses = _steps(tr, state, batch, 2)
            # every batch rank's choices, each layer's counted once
            drops = comm._psum(torch.tensor(calls), tr.layout.batch)
            res.update(losses=[float(loss)] + losses,
                       drops=[tuple(d) for d in drops.tolist()],
                       params=tr.gather_params(state))
            return res
        _guarded(out, key, run)

    def padded():
        tr = _mesh_trainer(llama_moe, cfg, meshes["dft"],
                           TrainConfig(**payload["moe_tc"], grad_accum=4),
                           apply_fn=lambda p, t: llama_moe.apply(p, cfg, t)[0],
                           loss_fn=llama_moe.loss_fn(cfg))
        state = tr.init_from_params(bridge.from_jax(payload["moe"], cfg,
                                                    "cpu"))
        tr.step(state, *batch)
        return {}
    _guarded(out, "padded", padded)
    return out


def _vit_block_bias_inside(cfg, x, p):
    """The ViT block with bo added inside per-rank work (before the
    `exit` that sums the ranks' partial products): the control."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.attention import dot_product_attention
    from kubeflow_tpu_torch.ops.norms import layer_norm
    from kubeflow_tpu_torch.parallel import tensor
    from kubeflow_tpu_torch.parallel.sharding import read_layer

    p = read_layer(p)
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    h = tensor.enter(layer_norm(x, p["ln1_w"], p["ln1_b"], cfg.norm_eps))
    q, k, v = ((h @ p["w" + n] + p["b" + n]).reshape(b, s, -1,
                                                     cfg.head_dim)
               for n in "qkv")
    attn = dot_product_attention(q, k, v, pos, pos, causal=False)
    x = x + tensor.exit(attn.reshape(b, s, -1) @ p["wo"] + p["bo"])
    h = tensor.enter(layer_norm(x, p["ln2_w"], p["ln2_b"], cfg.norm_eps))
    h = F.gelu(h @ p["w1"] + p["b1"], approximate="tanh")
    return x + tensor.exit(h @ p["w2"]) + p["b2"]


def _vit_recipes(payload, mesh):
    """ViT-tiny tensor-parallel on (data 2, fsdp 2, tensor 2): one
    step's gradients, 3 steps, and the control with bo inside per-rank
    work."""
    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.models import vit
    from kubeflow_tpu_torch.train import TrainConfig

    cfg = vit.VIT_TINY
    batch = tuple(torch.tensor(payload["vit_" + k]) for k in "xyw")
    tc = TrainConfig(**payload["vit_tc"])
    tr = _mesh_trainer(vit, cfg, mesh, tc, apply_fn=vit.apply_fn(cfg))
    state = tr.init_from_params(bridge.from_jax(payload["vit"], cfg, "cpu"))
    names = [n for n, _ in tr.optimizer.trained(state.params)]
    out = {"grads": dict(zip(names, tr.grads(state, *batch)))}
    block = vit._block
    vit._block = _vit_block_bias_inside
    try:
        out["control"] = dict(zip(names, tr.grads(state, *batch)))
    finally:
        vit._block = block
    out["local"] = {k: tuple(state.params["blocks"][k].shape)
                    for k in ("wq", "bq", "wo", "bo", "w1", "b1")}
    out["head"] = tuple(state.params["head_w"].shape)
    state, out["losses"] = _steps(tr, state, batch)
    out["params"] = tr.gather_params(state)
    return out


def _adafactor_recipes(payload, meshes):
    """Adafactor on llama-tiny at (data 2, fsdp 2, tensor 2) with and
    without ZeRO: 3 steps, the gathered state and its bytes; the ZeRO
    run saved and restored on the same mesh, on one device and on (data
    2, fsdp 4), each restored state's next loss."""
    import os

    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train import TrainConfig
    from kubeflow_tpu_torch.train.checkpoint import (
        CheckpointConfig,
        Checkpointer,
    )

    cfg = llama.LLAMA_TINY
    batch = (torch.tensor(payload["toks"]).long(),
             torch.tensor(payload["tgts"]).long())
    out = {}
    for zero in (True, False):
        tc = TrainConfig(**payload["ada_tc"], zero_optimizer=zero)
        tr = _mesh_trainer(llama, cfg, meshes["dft"], tc)
        state = tr.init_from_params(bridge.from_jax(payload["llama"], cfg,
                                                    "cpu"))
        names = [n for n, _ in tr.optimizer.trained(state.params)]
        held = {s: dict(zip(names, (tuple(t.shape)
                                    for t in state.opt_state[s])))
                for s in tr.optimizer.slots}
        state, losses = _steps(tr, state, batch)
        opt = _full_state(tr, state)[1]
        res = {"losses": losses, "held": held,
               "opt_bytes": tr.opt_state_bytes(),
               "params": tr.gather_params(state),
               "opt": {s: dict(zip(names, opt[s]))
                       for s in tr.optimizer.slots}}
        out[zero] = res
        if not zero:
            continue
        saved = _full_state(tr, state)
        d = os.path.join(payload["dir"], "ada")
        ck = Checkpointer(CheckpointConfig(d, enable_async=False), tr)
        ck.save(state, force=True)
        ck.close()
        _, res["next"] = tr.step(state, *batch)
        ckpt = {}
        for key, mesh in (("same", meshes["dft"]), ("one", None),
                          ("df", meshes["df"])):
            other = (tr if key == "same" else
                     _mesh_trainer(llama, cfg, mesh, tc))
            ck = Checkpointer(CheckpointConfig(d), other)
            restored = ck.restore()
            params, opt = _full_state(other, restored)
            ckpt[key] = {
                "step": restored.step,
                "params": all(torch.equal(v, saved[0][k])
                              for k, v in params.items()),
                "opt": opt["count"] == saved[1]["count"] and all(
                    torch.equal(a, b) for slot in tr.optimizer.slots
                    for a, b in zip(opt[slot], saved[1][slot],
                                    strict=True)),
                "next": float(other.step(restored, *batch)[1])}
            ck.close()
        res["ckpt"] = ckpt
        res["next"] = float(res["next"])
    return out


def _accum_recipes(payload, mesh):
    """grad_accum 1, 2 and 4 on (data 2, fsdp 2, tensor 2), one step on a
    ragged mask from the same params (acc 4: micros of 2 rows over 4
    batch ranks); acc 3's refusal."""
    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train import TrainConfig

    cfg = llama.LLAMA_TINY
    batch = tuple(torch.tensor(payload["acc_" + k])
                  for k in ("toks", "tgts", "mask"))
    batch = (batch[0].long(), batch[1].long(), batch[2])
    out = {}
    for acc in (1, 2, 4, 3):
        def run(acc=acc):
            tr = _mesh_trainer(llama, cfg, mesh,
                               TrainConfig(**payload["acc_tc"],
                                           grad_accum=acc))
            state = tr.init_from_params(bridge.from_jax(payload["llama"],
                                                        cfg, "cpu"))
            state, loss = tr.step(state, *batch)
            return {"loss": float(loss), "params": tr.gather_params(state)}
        _guarded(out, acc, run)
    return out


def _hybrid_recipe(payload, mesh):
    """llama-tiny on the hybrid (dcn 2, fsdp 2, tensor 2) mesh, 3
    steps."""
    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train import TrainConfig

    cfg = llama.LLAMA_TINY
    tr = _mesh_trainer(llama, cfg, mesh, TrainConfig(**payload["acc_tc"]))
    state = tr.init_from_params(bridge.from_jax(payload["llama"], cfg,
                                                "cpu"))
    batch = tuple(torch.tensor(payload["hyb_" + k]).long()
                  for k in ("toks", "tgts"))
    state, losses = _steps(tr, state, batch)
    lay = tr.layout
    return {"losses": losses, "params": tr.gather_params(state),
            "batch_axes": list(lay.batch_axes),
            "batch_group": lay.batch.name, "batch_size": lay.batch.size}


def _pipeline_adafactor(payload, mesh):
    """PipelineTrainer with Adafactor on (stage 2, data 4), llama-tiny
    at 4 layers, 2 microbatches, 3 steps."""
    import dataclasses

    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.models import llama, llama_pp
    from kubeflow_tpu_torch.train import TrainConfig

    cfg = dataclasses.replace(llama.LLAMA_TINY, num_layers=4)
    tr = llama_pp.PipelineTrainer(cfg, mesh, num_microbatches=2,
                                  train_config=TrainConfig(
                                      **payload["pp_tc"]), device="cpu")
    state = tr.init_from_params(bridge.from_jax(payload["llama4"], cfg,
                                                "cpu"))
    batch = tuple(torch.tensor(payload["pp_" + k]).long()
                  for k in ("toks", "tgts"))
    losses = []
    for _ in range(3):
        state, loss = tr.step(state, *batch)
        losses.append(float(loss))
    return {"losses": losses, "params": tr.gather_params(state),
            "v_row": tuple(state.opt_state["v_row"][
                [n for n, _ in tr.optimizer.trained(state.params)]
                .index("blocks.wq")].shape)}


def mesh_recipe_cases(payload, rank, world):
    """The mesh trainer's recipes on 8 ranks: MoE routed over the global
    batch and tensor-parallel, ViT tensor-parallel, Adafactor with and
    without ZeRO and its checkpoint, gradient accumulation, the hybrid
    mesh, and Adafactor under the pipeline trainer."""
    import numpy as np

    from kubeflow_tpu_torch.parallel import Mesh, create_hybrid_mesh

    meshes = {
        "df": create_mesh(MeshSpec(data=2, fsdp=4), device_type="cpu"),
        "dft": create_mesh(MeshSpec(data=2, fsdp=2, tensor=2),
                           device_type="cpu"),
        "hybrid": create_hybrid_mesh(MeshSpec(data=1, fsdp=2, tensor=2),
                                     num_slices=2, device_type="cpu"),
        "pp": Mesh(np.arange(8).reshape(2, 4), ("stage", "data"), "cpu"),
    }
    out = {"moe": _moe_recipes(payload, meshes)}
    _guarded(out, "vit", lambda: _vit_recipes(payload, meshes["dft"]))
    _guarded(out, "ada", lambda: _adafactor_recipes(payload, meshes))
    out["acc"] = _accum_recipes(payload, meshes["dft"])
    _guarded(out, "hybrid", lambda: _hybrid_recipe(payload,
                                                   meshes["hybrid"]))
    _guarded(out, "pp", lambda: _pipeline_adafactor(payload, meshes["pp"]))
    return out


# -- test_torch_tp_serving.py ------------------------------------------------

# the failure case's gang: a short tensor-group timeout
TP_FAIL_TIMEOUT_S = 8.0


def _tp_models(payload):
    from kubeflow_tpu_torch.models import gemma, llama
    from kubeflow_tpu_torch.serving.engine import GEMMA_FAMILY, LLAMA_FAMILY

    return {"llama": (llama.LLAMA_TINY, LLAMA_FAMILY),
            "gemma": (gemma.GEMMA_TINY, GEMMA_FAMILY),
            "tied": (payload["tied_cfg"], LLAMA_FAMILY)}


def _tp_engine(payload, model, gang, max_len, **kw):
    """This rank's engine of `model` at the gang's tensor size, from the
    parent's full params."""
    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.serving.engine import EngineConfig, InferenceEngine

    cfg, fam = _tp_models(payload)[model]
    full = bridge.from_jax(payload[model], cfg, "cpu")
    local = bridge.tensor_rank_params(full, cfg, gang.group.index,
                                      gang.group.size)
    return InferenceEngine(local, cfg, fam, EngineConfig(max_len=max_len),
                           device="cpu", cuda_graphs=False,
                           group=gang.group, **kw), full


def _tp_led(payload, model, gang, max_len, lead_fn):
    """The followers follow; the leader runs `lead_fn(engine, full
    params)` and stops the gang."""
    eng, full = _tp_engine(payload, model, gang, max_len)
    if not gang.leader:
        # the results the follower holds after each call
        held, hold = {}, gang._hold

        def tracked(result):
            hold(result)
            held[gang.calls] = len(gang._objs)

        gang._hold = tracked
        gang.follow(eng)
        return {"calls": gang.calls, "held": held}
    gang.lead(eng)
    try:
        out = lead_fn(eng, full)
    finally:
        gang.stop()
    out["calls"] = gang.calls
    return out


def _tp_engine_case(payload, model):
    """The slot engine's prefill / insert / step (the reference's
    tensor-parallel test), one-shot generate, its stream, chunked
    prefill, and score against the port's one-device engine."""
    import numpy as np

    from kubeflow_tpu_torch.serving.continuous import GREEDY, ContinuousEngine
    from kubeflow_tpu_torch.serving.engine import EngineConfig, InferenceEngine

    prompts, max_new = payload["engine_prompts"], payload["engine_new"]

    def run(eng, full):
        ce = ContinuousEngine(eng, max_slots=len(prompts))
        st = ce.init_slots()
        got = [[] for _ in prompts]
        for i, p in enumerate(prompts):
            pstate, first, _, _ = ce.prefill_batch(
                [p], ce.bucket_for(len(p), max_new), [GREEDY], ce.gen)
            st = ce.insert(st, i, pstate, first)
            got[i].append(int(first[0]))
        n = len(prompts)
        sp, _ = eng._resolve_sampling(np.zeros(n, np.float32),
                                      np.zeros(n, np.int64),
                                      np.ones(n, np.float32), None, batch=n)
        st, toks, _ = ce.step(st, sp, ce.gen, steps=max_new - 1)
        for i in range(n):
            got[i].extend(toks[i].tolist())
        arr, mask = payload["engine_batch"]
        one = eng.generate(arr, max_new=max_new, prompt_mask=mask).numpy()
        stream = np.concatenate(list(eng.generate_stream(
            arr, max_new=max_new, prompt_mask=mask, chunk=2)), 1)
        chunked = eng.generate(arr, max_new=max_new, prompt_mask=mask,
                               prefill_chunk=4).numpy()
        seq = np.concatenate([arr, one], 1)
        seq_mask = np.concatenate([mask, np.ones_like(one, bool)], 1)
        score = eng.score(seq, prompt_mask=seq_mask).numpy()
        cfg, fam = _tp_models(payload)[model]
        solo = InferenceEngine(full, cfg, fam, EngineConfig(max_len=64),
                               device="cpu")
        want_score = solo.score(seq, prompt_mask=seq_mask).numpy()
        return {"continuous": got, "generate": one, "stream": stream,
                "chunked": chunked, "score": score, "solo_score": want_score,
                "seq": seq, "seq_mask": seq_mask,
                "kv_heads": eng.kv_heads,
                "pool": tuple(st.k.shape), "cache": tuple(
                    eng.init_state(1).k.shape)}

    return run


def _tp_http_case(payload):
    """Rank 0's HTTP app over the gang's engine with continuous batching
    (chunked prefill), four prompts and the first one repeated; then a
    monolithic batcher over the same engine; then the one-shot app's
    window batcher and direct path."""
    import asyncio
    import weakref

    from aiohttp.test_utils import TestClient, TestServer

    from kubeflow_tpu_torch.obs.metrics import Registry
    from kubeflow_tpu_torch.serving import server
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher

    prompts, max_new = payload["http_prompts"], payload["http_new"]

    async def session(eng):
        app = server.create_serving_app(
            {"m": eng}, continuous=True, max_batch=4,
            prefill_chunk_tokens=8, kv_block_size=8, registry=Registry())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            async def ask(p):
                r = await client.post("/v1/models/m:generate", json={
                    "tokens": [p], "max_new": max_new})
                assert r.status == 200, await r.text()
                return (await r.json())["tokens"][0]

            wave = await asyncio.gather(*(ask(p) for p in prompts))
            again = await ask(prompts[0])
            stats = app[server.BATCHERS_KEY]["m"].prefix_cache_stats()
            metrics = await (await client.get("/metrics")).text()
        finally:
            await client.close()
        mono = ContinuousBatcher(eng, asyncio.Lock(), max_slots=4,
                                 kv_block_size=8)
        try:
            mwave = await asyncio.gather(*(mono.submit(p, max_new)
                                           for p in prompts))
            mrepeat = await mono.submit(prompts[0], max_new)
            mstats = mono.prefix_cache_stats()
            # the leader's live handles, its finalizers of them and its
            # calls after each of several requests more, one at a time
            handles = []
            for p in prompts + prompts:
                await mono.submit(p, max_new)
                g = eng.gang
                handles.append((len(g._ids), sum(
                    1 for f in list(weakref.finalize._registry)
                    if getattr(f.peek()[1], "__self__", None) is g),
                    g.calls))
        finally:
            await mono.close()
        # the one-shot modes: a window batcher's single prompt, then an
        # explicit 2-row batch on the direct path
        app = server.create_serving_app({"m": eng}, batch_window_ms=5.0,
                                        registry=Registry())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            oneshot = []
            for rows in ([prompts[1]], [prompts[3], prompts[3]]):
                r = await client.post("/v1/models/m:generate", json={
                    "tokens": rows, "max_new": max_new})
                assert r.status == 200, await r.text()
                oneshot.append((await r.json())["tokens"])
        finally:
            await client.close()
        return {"wave": wave, "repeat": again, "hits": stats["hits"],
                "mono": mwave, "mono_repeat": mrepeat,
                "mono_hits": mstats["hits"], "oneshot": oneshot,
                "handles": handles,
                "kv_family": [ln for ln in metrics.splitlines()
                              if ln.startswith("# HELP serving_kv")]}

    def run(eng, full):
        return asyncio.run(session(eng))

    return run


def _tp_refusals(payload, gang):
    """Each refusal at tensor > 1, raised on this rank before any
    collective. -> {case: error text}."""
    import asyncio
    import dataclasses

    import numpy as np

    from aiohttp.test_utils import TestClient, TestServer

    from kubeflow_tpu_torch import bridge
    from kubeflow_tpu_torch.models import llama, llama_moe
    from kubeflow_tpu_torch.obs.metrics import Registry
    from kubeflow_tpu_torch.serving import multilora, quant, server
    from kubeflow_tpu_torch.serving.continuous import (
        ContinuousBatcher, ContinuousEngine,
    )
    from kubeflow_tpu_torch.serving.engine import (
        MOE_LLAMA_FAMILY, EngineConfig, InferenceEngine,
    )
    from kubeflow_tpu_torch.serving.speculative import SpeculativeEngine
    from kubeflow_tpu_torch.train.lora import LoraConfig

    g = gang.group
    cfg = llama.LLAMA_TINY
    eng, full = _tp_engine(payload, "llama", gang, 64)
    local = bridge.tensor_rank_params(full, cfg, g.index, g.size)
    ec = EngineConfig(max_len=64)
    L, D = cfg.num_layers, cfg.hidden_size
    pack = multilora.build_pack(cfg, LoraConfig(rank=2, alpha=4.0,
                                                targets=("wq",)), {
        "a": {"blocks": {"wq": {"A": np.zeros((L, D, 2), np.float32),
                                "B": np.zeros((L, 2, cfg.q_dim),
                                              np.float32)}}}}, device="cpu")
    moe_cfg = llama_moe.MIXTRAL_TINY
    moe = llama_moe.init(moe_cfg, 0, "cpu")
    ce = ContinuousEngine(eng, max_slots=2)

    def reload():
        """`/v1/reload` on the app over this rank's engine: its 400's
        error."""
        async def post():
            client = TestClient(TestServer(server.create_serving_app(
                {"m": eng}, registry=Registry())))
            await client.start_server()
            try:
                r = await client.post("/v1/reload", json={
                    "version": "v2", "source": {"checkpoint": "none"}})
                return r.status, (await r.json())["error"]
            finally:
                await client.close()

        status, err = asyncio.run(post())
        if status == 400:
            raise ValueError(err)

    cases = {
        "graphs": lambda: InferenceEngine(local, cfg, eng.family, ec,
                                          device="cpu", group=g),
        "graphs_continuous": lambda: ContinuousEngine(eng, max_slots=2,
                                                      cuda_graphs=True),
        "reload": reload,
        "int8": lambda: InferenceEngine(quant.quantize_blocks(local), cfg,
                                        eng.family, ec, device="cpu",
                                        cuda_graphs=False, group=g),
        "int8_cut": lambda: bridge.tensor_rank_params(
            quant.quantize_blocks(full), cfg, g.index, g.size),
        "pack": lambda: InferenceEngine(local, cfg, eng.family, ec,
                                        device="cpu", cuda_graphs=False,
                                        adapter_pack=pack, group=g),
        "moe": lambda: InferenceEngine(moe, moe_cfg, MOE_LLAMA_FAMILY, ec,
                                       device="cpu", cuda_graphs=False,
                                       group=g),
        "moe_cut": lambda: bridge.tensor_rank_params(moe, moe_cfg, g.index,
                                                     g.size),
        "spec_continuous": lambda: ContinuousEngine(eng, max_slots=2,
                                                    draft=eng),
        "spec_batch1": lambda: SpeculativeEngine(eng, eng),
        "spill": lambda: ContinuousBatcher(eng, asyncio.Lock(),
                                           kv_spill_bytes=1 << 20),
        "migration": lambda: ce.export_blocks(ce.slots(), [1]),
        "warmup": lambda: eng.warmup((1,)),
        "warmup_continuous": lambda: ce.warmup(),
        "vocab": lambda: bridge.tensor_rank_params(
            full, dataclasses.replace(cfg, vocab_size=511), g.index, g.size),
        "heads": lambda: bridge.tensor_rank_params(
            full, dataclasses.replace(cfg, num_heads=3), g.index, g.size),
        "kv_heads": lambda: bridge.tensor_rank_params(
            full, dataclasses.replace(cfg, num_heads=6, num_kv_heads=3),
            g.index, g.size),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _tp_failure(payload, gang):
    """A follower that raises in a decode step: the leader's request
    fails (through the batcher's `_fail_all`), within the tensor group's
    timeout; a later request fails at once; the follower leaves its
    loop with the gang's error."""
    import asyncio
    import time

    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.serving.gang import GangError

    eng, _ = _tp_engine(payload, "llama", gang, 64)
    if not gang.leader:
        embed, calls = eng._embed, []

        def failing(tokens):
            calls.append(1)
            if len(calls) == 2:   # the first decode step
                raise RuntimeError("injected follower fault")
            return embed(tokens)

        eng._embed = failing
        try:
            gang.follow(eng)
            return {"follower": "returned"}
        except GangError as e:
            return {"follower": str(e)}
    gang.lead(eng)

    async def session():
        b = ContinuousBatcher(eng, asyncio.Lock(), max_slots=2, chunk=1)
        out = {}
        for key in ("first", "later"):
            t0 = time.monotonic()
            try:
                await b.submit(payload["engine_prompts"][0], 4)
                out[key] = ("ok", time.monotonic() - t0)
            except Exception as e:  # noqa: BLE001 — reported to the parent
                out[key] = (f"{type(e).__name__}: {e}",
                            time.monotonic() - t0)
        await b.close()
        return out

    out = asyncio.run(session())
    gang.stop()
    out["broken"] = str(gang.broken)
    return out


def tp_serving_cases(payload, rank, world):
    """Tensor-parallel serving on 4 ranks: at tensor 2, llama-tiny on
    ranks (0, 1) (the engines, then the HTTP app) beside gemma-tiny on
    (2, 3) (the engines, the refusals, then a follower's failure); at
    tensor 4, llama-tiny, gemma-tiny and the 262,144-token tied
    vocabulary's generate."""
    from kubeflow_tpu_torch.serving import gang as gang_lib

    all_ranks = list(range(world))
    gangs = {"l2": gang_lib.form([0, 1], timeout_s=60),
             "g2": gang_lib.form([2, 3], timeout_s=60),
             "fail": gang_lib.form([2, 3], timeout_s=TP_FAIL_TIMEOUT_S),
             "l4": gang_lib.form(all_ranks, timeout_s=60),
             "g4": gang_lib.form(all_ranks, timeout_s=60),
             "v4": gang_lib.form(all_ranks, timeout_s=60)}
    out = {}
    if rank < 2:
        engine_case = _tp_engine_case(payload, "llama")
        http_case = _tp_http_case(payload)
        out["llama2"] = _tp_led(payload, "llama", gangs["l2"], 64,
                                lambda eng, full: dict(
                                    engine_case(eng, full),
                                    http=http_case(eng, full)))
    else:
        out["gemma2"] = _tp_led(payload, "gemma", gangs["g2"], 64,
                                _tp_engine_case(payload, "gemma"))
        out["refusals"] = _tp_refusals(payload, gangs["g2"])
        out["failure"] = _tp_failure(payload, gangs["fail"])
    out["llama4"] = _tp_led(payload, "llama", gangs["l4"], 64,
                            _tp_engine_case(payload, "llama"))
    out["gemma4"] = _tp_led(payload, "gemma", gangs["g4"], 64,
                            _tp_engine_case(payload, "gemma"))

    def tied(eng, full):
        arr = payload["tied_prompt"]
        return {"generate": eng.generate(arr, max_new=payload["tied_new"])
                .numpy()}

    out["tied4"] = _tp_led(payload, "tied", gangs["v4"], 32, tied)
    return out
