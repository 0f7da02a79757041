"""One rank of the port's multi-rank CPU checks (`test_torch_parallel_train.py`).

    python _torch_parallel_worker.py RANK WORLD PORT TASK.pt OUT_DIR

Joins a gloo group of WORLD ranks on localhost:PORT (with a timeout, so a
rank that dies makes the others fail instead of hang), runs every job of the
task for this world size and writes what it computed to OUT_DIR/rank{RANK}.pt.
Imports torch and the port only.
"""
import os
import sys
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffusestylegesture_torch import diffusion as TD  # noqa: E402
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig  # noqa: E402
from diffusestylegesture_torch.models.mdm_plus import MDMPlus, MDMPlusConfig  # noqa: E402
from diffusestylegesture_torch.parallel import comm, multihost  # noqa: E402
from diffusestylegesture_torch.parallel.tp import (merge_qkv_params, split_qkv_params,  # noqa: E402
                                                   tensor_parallel_trunk)
from diffusestylegesture_torch.train import (LoopConfig, TrainConfig, TrainLoop,  # noqa: E402
                                             TrainState, make_train_step,
                                             make_zeggs_cond_builder)
from diffusestylegesture_torch.train.state import MeshPlan  # noqa: E402


def mdm_for(task, mesh, spec):
    """The task's MDM on this mesh: split q/k/v and Megatron under a model
    axis, sequence-parallel under seq, pipelined under pipe."""
    axes = mesh.mesh_dim_names
    extra = {}
    if "seq" in axes:
        extra.update(seq_parallel=True, seq_mesh=mesh)
    if "pipe" in axes:
        extra.update(trunk_impl="pipeline", pipe_mesh=mesh, pipe_microbatches=spec.get("M", 0))
    split = "model" in axes
    model = MDM(MDMConfig(**task["mdm_kw"], split_qkv=split, impl="plain", **extra))
    sd = task["model_sd"]
    model.load_state_dict(split_qkv_params(sd) if split else sd)
    if split:
        tensor_parallel_trunk(model, mesh.get_group("model"))
    return model


def train_job(task, spec):
    """Three injected-draw steps of the train step on this mesh."""
    mesh = multihost.global_mesh(spec["axes"], spec["shape"])
    model = mdm_for(task, mesh, spec)
    cfg = TrainConfig(**task["train_cfg"], schedule_sampler=spec["sampler"])
    plan = MeshPlan(mesh, spec.get("fsdp", False), partial=("model", "pipe"))
    state = TrainState(model, cfg, task["num_timesteps"], plan)
    sched = TD.Schedule.create(TD.named_beta_schedule("cosine", task["num_timesteps"]),
                               device="cpu")
    step = make_train_step(sched, cfg, make_zeggs_cond_builder(task["n_seed"]))
    n, r = plan.data_size, plan.data_rank
    out = {"steps": []}
    for i, (batch, d) in enumerate(zip(task["batches"], task["draws"][spec["sampler"]])):
        B = len(d["t"])
        lo, hi = r * B // n, (r + 1) * B // n
        local = {k: torch.from_numpy(v[lo:hi]) for k, v in batch.items()}
        m = step(state, local, None, t=torch.from_numpy(d["t"][lo:hi]),
                 noise=torch.from_numpy(d["noise"][lo:hi]),
                 cond_drop=tuple(torch.from_numpy(a[lo:hi]) for a in d["drops"]))
        rec = {k: m[k].detach().numpy().copy() for k in
               ("loss", "grad_norm", "param_norm", "loss_per_example", "t")}
        if i == 0:
            rec["mu"] = merge_qkv_params(state.optimizer.state_dict()["mu"])
        out["steps"].append(rec)
    out["params"] = merge_qkv_params(state.params.to_dict(state.params.data))
    out["ema"] = merge_qkv_params(state.ema_state_dict())
    out["moment_numel"] = state.optimizer.mu.numel()
    out["flat_numel"] = state.params.numel
    return out


def attention_job(task, shards):
    from diffusestylegesture_torch.parallel.seq_parallel import sequence_parallel_local_attention

    mesh = multihost.global_mesh(("seq",), (shards,))
    a = task["attention"]
    q, k, v = (torch.from_numpy(a[n]) for n in ("q", "k", "v"))
    out = sequence_parallel_local_attention(q, k, v, a["w"], mesh.get_group("seq"),
                                            torch.from_numpy(a["mask"]), heads=a["heads"],
                                            impl="plain")
    return out.numpy()


def pipeline_job(task, pipe):
    from diffusestylegesture_torch.models.transformer import Pipe, TorchTransformerEncoder

    p = task["pipeline"]
    mesh = multihost.global_mesh(("pipe",), (pipe,))
    enc = TorchTransformerEncoder(p["L"], p["D"], p["H"], p["F"])
    enc.load_state_dict(p["sd"])
    x = torch.from_numpy(p["x"])
    outs = {}
    with torch.no_grad():
        for M in (pipe, 2 * pipe):
            outs[f"M{M}"] = enc(x, impl="plain", pipe=Pipe(mesh.get_group("pipe"), M)).numpy()
    # gradients through the schedule (the backward's send / recv) and remat
    grads = {}
    for remat in (False, True):
        enc.zero_grad()
        xg = x.clone().requires_grad_(True)
        y = enc(xg, impl="plain", train=True, pipe=Pipe(mesh.get_group("pipe"), pipe, remat))
        (y ** 2).sum().backward()
        g = {n: q.grad.clone() if q.grad is not None else torch.zeros_like(q)
             for n, q in enc.named_parameters()}
        for t in g.values():
            comm.all_reduce_(t, mesh.get_group("pipe"))  # each stage holds its layers'
        grads[f"remat{int(remat)}"] = {"x": xg.grad.numpy(), **{n: t.numpy() for n, t in g.items()}}
    outs["grads"] = grads
    # the denoisers with a pipelined trunk
    for name, cls, cfg_cls in (("mdm", MDM, MDMConfig), ("mdm_plus", MDMPlus, MDMPlusConfig)):
        d = task[name + "_pipe"]
        model = cls(cfg_cls(**d["kw"], impl="plain", trunk_impl="pipeline", pipe_mesh=mesh))
        model.load_state_dict(d["sd"])
        with torch.no_grad():
            outs[name] = model(torch.from_numpy(d["x"]), torch.from_numpy(d["t"]),
                               {k: torch.from_numpy(v) for k, v in d["cond"].items()}).numpy()
    return outs


def wavlm_job(task, tp):
    from diffusestylegesture_torch.models.wavlm.model import WavLM, WavLMConfig
    from diffusestylegesture_torch.parallel.tp import wavlm_tp_forward

    w = task["wavlm"]
    mesh = multihost.global_mesh(("model",), (tp,))
    model = WavLM(WavLMConfig(**w["cfg"])).eval()
    model.load_state_dict(w["sd"])
    with torch.no_grad():
        return wavlm_tp_forward(model, torch.from_numpy(w["wav"]), mesh.get_group("model")).numpy()


def moe_job(task, world):
    from diffusestylegesture_torch.models.moe import MoEFeedForward, expert_parallel

    m = task["moe"]
    mesh = multihost.global_mesh(("expert",), (world,))
    layer = MoEFeedForward(m["D"], m["F"], m["E"], m["cf"])
    layer.load_state_dict(m["sd"])
    expert_parallel(layer, mesh.get_group("expert"))
    x = torch.from_numpy(m["x"])
    B = x.shape[0]
    r = comm.rank(mesh.get_group("expert"))
    xl = x[r * B // world:(r + 1) * B // world].clone().requires_grad_(True)
    y, aux = layer(xl)
    ((y ** 2).sum() + aux / world).backward()  # every rank's aux is the global one
    grads = {n: comm.all_reduce_(q.grad.clone(), mesh.get_group("expert")).numpy()
             for n, q in layer.named_parameters()}
    xg = comm.all_gather_cat(xl.grad, mesh.get_group("expert")).numpy()
    return {"y": comm.all_gather_cat(y.detach(), mesh.get_group("expert")).numpy(),
            "aux": float(aux), "grads": grads, "x_grad": xg}


def resume_job(task):
    """A packed world-1 checkpoint (step 2) resumed under tensor parallelism
    to step 4; then a fresh tp run writes its own checkpoint (step 2)."""
    res = task["resume"]
    tp = torch.distributed.get_world_size()
    mesh = multihost.global_mesh(("data", "model"), (1, tp))
    out = {}
    for key, ckpt, steps in (("resumed", res["packed_dir"], 4), ("written", res["tp_dir"], 2)):
        model = MDM(MDMConfig(**task["mdm_kw"], split_qkv=True, impl="plain"))
        model.load_state_dict(split_qkv_params(task["model_sd"]))
        loop = TrainLoop(model, TD.Schedule.create(TD.named_beta_schedule("cosine", 20),
                                                   device="cpu"),
                         iter([{k: v for k, v in b.items()} for b in task["batches"]]
                              + [dict(b) for b in task["batches"]]),
                         train_cfg=TrainConfig(**task["train_cfg"]),
                         loop_cfg=LoopConfig(num_steps=steps, log_interval=100, save_interval=0,
                                             checkpoint_dir=ckpt, mesh=mesh, tensor_parallel=tp),
                         cond_builder=make_zeggs_cond_builder(task["n_seed"]), seed=5)
        restored = {"params": merge_qkv_params(loop.state.params.to_dict(loop.state.params.data)),
                    "mu": merge_qkv_params(loop.state.optimizer.state_dict()["mu"]),
                    "ema": merge_qkv_params(loop.state.ema_state_dict())}
        out[key] = {"resume_step": loop.resume_step, "restored": restored,
                    "split": any(n.endswith("q_proj.weight") for n in loop.state.params.names)}
        loop.run()
        out[key]["step"] = loop.state.step
    return out


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    task = torch.load(sys.argv[4], weights_only=False)
    out_dir = sys.argv[5]
    multihost.initialize("cpu", timeout_s=120, init_method=f"tcp://localhost:{port}",
                         rank=rank, world_size=world)
    results = {}
    try:
        # each rank's host rows of the global batch, checked equal in count
        mesh = multihost.global_mesh(("data",))
        rows = multihost.global_batch_from_host_local(
            mesh, {"x": torch.full((2, 3), float(rank))})
        results["host_local"] = rows["x"].numpy()
        for name, spec in task["train"][world].items():
            results[f"train/{name}"] = train_job(task, spec)
        results["attention"] = attention_job(task, world)
        results["pipeline"] = pipeline_job(task, world)
        if world == 2:
            results["wavlm"] = wavlm_job(task, world)
            results["moe"] = moe_job(task, world)
            results["resume"] = resume_job(task)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # the other ranks fail on their timeout
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main()
