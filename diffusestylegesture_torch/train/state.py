"""Train state and the train step.

Port of `diffusestylegesture_tpu/train/state.py` (reference
`main/train/training_loop.py:246-289`, `main/diffusion/fp16_util.py:183-214`):
AdamW (lr 3e-5, weight decay 0 on the live config) with the linear lr anneal,
uniform or loss-aware timestep sampling, the masked SmoothL1 diffusion loss,
the global grad and param norms, EMA of the weights.

The model trains through its plain PyTorch ops (`MDMConfig(impl="plain")`),
the counterpart of the JAX trainer's XLA path: the CUDA kernels serve only,
as the Pallas kernels do, since neither has a backward.

The trainable parameters live in one flat float32 buffer (`FlatParams`),
their gradients in another, so the optimizer, EMA and norms are a few
elementwise kernels over the whole model, with no host sync: a non-finite
step is rejected on the device (`optax.apply_if_finite` semantics).

Across a `DeviceMesh` (`MeshPlan`, one process per card) the collectives act
on those flat buffers: the gradients of the groups whose ranks each hold
part of them (`model` under tensor parallelism, `pipe` under pipeline
parallelism) are summed over the group; then the `data` group averages them
(one all-reduce), or with `fsdp` reduce-scatters them so that AdamW and the
EMA run on this rank's 1/N slice and the updated slices are all-gathered
(`parallel/fsdp.py`). The per-example metrics, the loss and the loss-aware
sampler's (t, loss) pairs are gathered over `data`, so every rank logs and
samples the global batch. Each draw is made at the global batch
(`parallel/draws.py`): a sharded run draws what the unsharded run draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..diffusion import gaussian as G
from ..diffusion import resample
from ..diffusion.schedule import Schedule
from ..parallel import comm, draws
from ..parallel.fsdp import FlatShard


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-5
    weight_decay: float = 0.0
    lr_anneal_steps: int = 0
    ema_rate: float = 0.0  # 0 → no EMA
    schedule_sampler: str = "uniform"  # "uniform" | "loss-second-moment"
    lambda_vel: float = 0.0
    mean_type: G.MeanType = G.MeanType.START_X
    var_type: G.VarType = G.VarType.FIXED_SMALL
    loss_kind: G.LossKind = G.LossKind.MSE
    # reject a step whose gradients are not all finite (params, moments and
    # count stay); after this many in a row the next is applied anyway. 0: off
    skip_nonfinite_updates: int = 0
    # "bfloat16": the forward under bf16 autocast; master weights, moments and
    # EMA stay float32, and the loss is computed in float32
    compute_dtype: str = "float32"
    # weight of the MoE load-balance loss (Switch Transformer: 0.01); it acts
    # when the model's train forward returns (prediction, aux), as a model
    # with moe_experts > 0 does
    moe_aux_weight: float = 0.0


class FlatParams:
    """A module's trainable parameters as views into one flat float32 buffer,
    and their gradients as views into another: autograd accumulates into the
    existing `.grad` views, so a backward fills `grad` in place. The module
    must stay on its device afterwards (moving it would detach the views).
    `pad_multiple`: the buffers are zero-padded to a multiple of it (a ZeRO
    shard count); `numel` counts the parameters' elements."""

    def __init__(self, module: nn.Module, pad_multiple: int = 1):
        named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        if any(p.dtype != torch.float32 for _, p in named):
            raise ValueError("FlatParams: the parameters must be float32")
        self.names: List[str] = [n for n, _ in named]
        self.shapes = [p.shape for _, p in named]
        self.numels = [p.numel() for _, p in named]
        self.numel = sum(self.numels)
        pad = -self.numel % pad_multiple
        with torch.no_grad():
            self.data = torch.cat([p.detach().reshape(-1) for _, p in named]
                                  + [named[0][1].new_zeros(pad)])
        self.grad = torch.zeros_like(self.data)
        for (_, p), d, g in zip(named, self.views(self.data), self.views(self.grad)):
            p.data = d
            p.grad = g

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """`flat` split into tensors of the parameters' shapes (views)."""
        return [t.view(s) for t, s in zip(torch.split(flat[:self.numel], self.numels),
                                          self.shapes)]

    def to_dict(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{parameter name: copy of its part of `flat`}."""
        return {n: t.detach().clone() for n, t in zip(self.names, self.views(flat))}

    def from_dict(self, flat: torch.Tensor, tensors: Dict[str, torch.Tensor]) -> None:
        """Copy {parameter name: tensor} into `flat`; every name must be there."""
        missing = [n for n in self.names if n not in tensors]
        if missing:
            raise KeyError(f"{len(missing)} parameters missing, e.g. {missing[:3]}")
        with torch.no_grad():
            for n, t in zip(self.names, self.views(flat)):
                t.copy_(tensors[n])

    def mask(self, select: Callable[[str], bool], device=None) -> torch.Tensor:
        """A flat bool buffer, True over the parameters whose name `select` takes."""
        out = torch.zeros(self.data.shape, dtype=torch.bool, device=device or self.data.device)
        for n, v in zip(self.names, self.views(out)):
            if select(n):
                v.fill_(True)
        return out


class AdamW:
    """`optax.adamw(schedule, b1, b2, eps, weight_decay=...)`, optionally inside
    `optax.apply_if_finite(·, skip_nonfinite)`, over a `FlatParams`.

    Per step, in optax's order: mu, nu ← moments of g; u = (mu/(1−b1^k)) /
    (sqrt(nu/(1−b2^k)) + eps) with k the count after the step; u += wd·p;
    p += −lr(count)·u, the anneal lr·(1 − min(count/anneal_steps, 1)) read at
    the count before the step. torch.optim.AdamW differs: its default weight
    decay is 0.01, and it decays the weights before the Adam update.
    """

    def __init__(self, params: FlatParams, lr: float, weight_decay: float = 0.0,
                 lr_anneal_steps: int = 0, skip_nonfinite: int = 0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, shard: Optional[FlatShard] = None):
        self.params = params
        self.lr, self.weight_decay, self.lr_anneal_steps = lr, weight_decay, lr_anneal_steps
        self.skip_nonfinite, self.b1, self.b2, self.eps = skip_nonfinite, b1, b2, eps
        dev = params.data.device
        # ZeRO (`shard`): the update reads this rank's slice of the weights and
        # the reduce-scattered gradient of that slice, and the moments are
        # that slice's only
        self.shard = shard
        if shard is None:
            self.p, self.g = params.data, params.grad
        else:
            self.p = params.data[shard.lo:shard.hi]
            self.g = torch.zeros(shard.size, device=dev)
        self.mu = torch.zeros_like(self.p)
        self.nu = torch.zeros_like(self.p)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)
        # on the device once: a step copies nothing from the host
        self._lr = torch.tensor(lr, device=dev)

    def lr_at(self, count: torch.Tensor) -> torch.Tensor:
        if self.lr_anneal_steps:
            frac = 1.0 - torch.clamp(count.float() / self.lr_anneal_steps, max=1.0)
            return self.lr * frac
        return self._lr

    @torch.no_grad()
    def step(self) -> None:
        """One update, written into the existing buffers (`copy_`), so that a
        CUDA graph captured over a step keeps reading and writing them."""
        p, g = self.p, self.g
        b1, b2 = self.b1, self.b2
        count_inc = self.count + 1
        mu = (1 - b1) * g + b1 * self.mu
        nu = (1 - b2) * (g * g) + b2 * self.nu
        k = count_inc.float()
        u = (mu / (1 - b1 ** k)) / (torch.sqrt(nu / (1 - b2 ** k)) + self.eps)
        if self.weight_decay:
            u = u + self.weight_decay * p
        new_p = p + (-self.lr_at(self.count)) * u
        if not self.skip_nonfinite:
            p.copy_(new_p)
            self.mu.copy_(mu)
            self.nu.copy_(nu)
            self.count.copy_(count_inc)
            return
        finite = torch.isfinite(g).all()
        if self.shard is not None and self.shard.group is not None:  # every slice finite
            flag = finite.float().reshape(1)
            comm.all_reduce_(flag, self.shard.group, torch.distributed.ReduceOp.MIN)
            finite = flag[0] > 0
        self.notfinite_count.copy_(torch.where(finite, 0, self.notfinite_count + 1))
        self.total_notfinite.copy_(torch.where(finite, self.total_notfinite,
                                               self.total_notfinite + 1))
        ok = finite | (self.notfinite_count > self.skip_nonfinite)
        p.copy_(torch.where(ok, new_p, p))
        self.mu.copy_(torch.where(ok, mu, self.mu))
        self.nu.copy_(torch.where(ok, nu, self.nu))
        self.count.copy_(torch.where(ok, count_inc, self.count))

    def full(self, t: torch.Tensor) -> torch.Tensor:
        """A moment (or any slice-sized buffer) over the whole flat buffer:
        gathered from every rank's slice under ZeRO (a collective)."""
        return t if self.shard is None else self.shard.full(t)

    def state_dict(self) -> Dict:
        """Moments per parameter name (whole, also under ZeRO: every rank of the
        data group must call it), the count and the non-finite counters."""
        return {"count": self.count.clone(), "mu": self.params.to_dict(self.full(self.mu)),
                "nu": self.params.to_dict(self.full(self.nu)),
                "notfinite_count": self.notfinite_count.clone(),
                "total_notfinite": self.total_notfinite.clone()}

    def load_slice(self, dst: torch.Tensor, tensors: Dict[str, torch.Tensor]) -> None:
        """Copy {name: tensor} into a flat buffer, or into this rank's slice of one."""
        if self.shard is None:
            self.params.from_dict(dst, tensors)
            return
        full = torch.zeros_like(self.params.data)
        self.params.from_dict(full, tensors)
        dst.copy_(full[self.shard.lo:self.shard.hi])

    def load_state_dict(self, sd: Dict) -> None:
        self.load_slice(self.mu, sd["mu"])
        self.load_slice(self.nu, sd["nu"])
        for name in ("count", "notfinite_count", "total_notfinite"):
            if name in sd:
                getattr(self, name).copy_(torch.as_tensor(sd[name]).reshape(()))


class MeshPlan:
    """How the train step spreads over a `DeviceMesh` (`parallel/multihost.py`):
    the `data` group averages the gradients (`fsdp`: ZeRO over it, see
    `parallel/fsdp.py`), and under `partial` each named axis's group sums the
    gradients of the parameters its ranks hold a part of: `model` (tensor
    parallelism: the trunk's column- and row-parallel weights) and `pipe`
    (pipeline parallelism: the trunk's layers). The other parameters' gradients
    are whole on every rank of those groups and are taken from their rank 0."""

    def __init__(self, mesh, fsdp: bool = False, partial: Tuple[str, ...] = ()):
        self.mesh = mesh
        names = mesh.mesh_dim_names
        self.fsdp = fsdp
        self.data = mesh.get_group("data") if "data" in names else None
        self.data_size, self.data_rank = comm.size(self.data), comm.rank(self.data)
        self.partial = tuple(a for a in partial if a in names)

    def keep_masks(self, model: nn.Module,
                   params: FlatParams) -> List[Tuple[object, Optional[torch.Tensor]]]:
        """[(group, mask)] for the partial axes: before the group's sum, the
        gradient is multiplied by the mask, which keeps every element on the
        group's rank 0 and, on the other ranks, the elements of the parameters
        the axis holds in parts (None: keep all). The `pipe` axis holds the
        layers of the model's `TorchTransformerEncoder`, the trunk that
        `pipeline_apply` runs."""
        from ..models.transformer import TorchTransformerEncoder
        from ..parallel.tp import mdm_param_specs

        out = []
        for axis in self.partial:
            group = self.mesh.get_group(axis)
            if comm.rank(group) == 0:
                out.append((group, None))
                continue
            if axis == "model":
                specs = mdm_param_specs(dict(zip(params.names, params.shapes)))
                mask = params.mask(lambda n: "model" in specs[n])
            else:
                staged = {id(p) for m in model.modules()
                          if isinstance(m, TorchTransformerEncoder)
                          for p in m.layers.parameters()}
                if not staged:
                    raise ValueError("a pipe axis over a model without a TorchTransformerEncoder "
                                     "trunk: no layer is pipelined")
                named = dict(model.named_parameters())
                mask = params.mask(lambda n: id(named[n]) in staged)
            out.append((group, mask.float()))
        return out

    def draws(self, generator, batch: int):
        """The step's draws for `batch` local rows: at the global batch when the
        data group shards it."""
        if self.data_size == 1:
            return generator
        return draws.GlobalDraws(generator, self.data_rank * batch, (self.data_rank + 1) * batch,
                                 self.data_size * batch)


class TrainState:
    """The model (float32 master weights in a `FlatParams`), its AdamW, the EMA
    weights (flat, or None), the loss-aware sampler's state (or None) and the
    number of step calls made (`step`, a host int: a rejected step counts).
    `plan` (a `MeshPlan`): the step's collectives; under ZeRO the moments and
    the EMA hold this rank's slice of the flat buffer only."""

    def __init__(self, model: nn.Module, cfg: TrainConfig, num_timesteps: int = 1000,
                 plan: Optional[MeshPlan] = None):
        self.model = model
        self.plan = plan
        zero = plan is not None and plan.fsdp
        self.params = FlatParams(model, plan.data_size if zero else 1)
        shard = FlatShard(self.params.data.numel(), plan.data) if zero else None
        self.optimizer = AdamW(self.params, cfg.lr, cfg.weight_decay, cfg.lr_anneal_steps,
                               cfg.skip_nonfinite_updates, shard=shard)
        self.ema = self.optimizer.p.clone() if cfg.ema_rate else None
        self.loss_aware = (resample.LossAwareState.create(num_timesteps,
                                                          device=self.params.data.device)
                           if cfg.schedule_sampler == "loss-second-moment" else None)
        self.keep_masks = plan.keep_masks(model, self.params) if plan is not None else []
        self._send = torch.empty_like(self.optimizer.p) if zero else None
        self.step = 0

    def reduce_grads(self) -> None:
        """The mesh's gradient collectives (`MeshPlan`), after the backward:
        the partial axes' sums, then the data group's mean (or its ZeRO
        reduce-scatter into the optimizer's slice)."""
        plan, grad = self.plan, self.params.grad
        if plan is None:
            return
        with torch.no_grad():
            for group, mask in self.keep_masks:
                if mask is not None:
                    grad.mul_(mask)
                comm.all_reduce_(grad, group)
            if plan.fsdp:
                self.optimizer.shard.reduce_scatter_mean(grad, self.optimizer.g)
            elif plan.data is not None:
                comm.all_reduce_(grad, plan.data)
                grad.div_(plan.data_size)

    def grad_norm(self) -> torch.Tensor:
        """The global norm of the (reduced) gradient."""
        if self.plan is None or not self.plan.fsdp:
            return torch.linalg.vector_norm(self.params.grad)
        sq = (torch.linalg.vector_norm(self.optimizer.g) ** 2).reshape(1)
        return torch.sqrt(comm.all_reduce_(sq, self.plan.data))[0]

    def gather_params(self) -> None:
        """Under ZeRO: every rank's updated slice into the flat weights."""
        if self._send is not None:
            self._send.copy_(self.optimizer.p)
            self.optimizer.shard.all_gather(self._send, self.params.data)

    def ema_state_dict(self) -> Optional[Dict[str, torch.Tensor]]:
        """The EMA per parameter name (whole: under ZeRO a collective)."""
        return None if self.ema is None else self.params.to_dict(self.optimizer.full(self.ema))

    def state_dict(self) -> Dict:
        """Everything but the weights: step, optimizer, loss-aware history."""
        la = self.loss_aware
        return {"step": self.step, "optimizer": self.optimizer.state_dict(),
                "loss_aware": None if la is None else {"history": la.history.clone(),
                                                       "counts": la.counts.clone()}}

    def load_state_dict(self, sd: Dict, model_sd: Dict[str, torch.Tensor],
                        ema_sd: Optional[Dict[str, torch.Tensor]] = None) -> None:
        self.params.from_dict(self.params.data, model_sd)
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.ema is not None:
            self.optimizer.load_slice(self.ema, ema_sd if ema_sd is not None else model_sd)
        if self.loss_aware is not None and sd.get("loss_aware") is not None:
            self.loss_aware.history.copy_(sd["loss_aware"]["history"])
            self.loss_aware.counts.copy_(sd["loss_aware"]["counts"])
        self.step = int(sd["step"])


Batch = Dict[str, torch.Tensor]
CondBuilder = Callable[[Batch], Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]]


def make_train_step(sched: Schedule, cfg: TrainConfig,
                    cond_builder: Optional[CondBuilder] = None) -> Callable:
    """step(state, batch, generator, *, t=None, noise=None, cond_drop=None) → metrics.

    `batch` holds device tensors; `cond_builder(batch)` → (x_start (B, C, 1, T),
    cond, mask (B, 1, 1, T)), by default the ZEGGS assembly. From `generator`,
    in this order: t (unless given), the noise (unless given), then inside
    the model the style and seed drops (unless `cond_drop` is given) and the
    dropout masks layer by layer. The metrics are device tensors (no host
    sync): the loss terms per example, `loss`, `grad_norm`, `param_norm`,
    `t` and `loss_per_example`. A MoE model's train forward returns
    (prediction, aux); with `cfg.moe_aux_weight` the loss gains
    `moe_aux_weight · aux` and the metrics `moe_aux` (JAX `state.py:164-180`).

    `step.device_step` is the same step without the host's step count
    (`state.step`): all of it runs on the device and every state update is
    written into the state's buffers, so it can be captured into a CUDA graph
    (`utils/graphs.py::CapturedStep`), whose caller then counts the steps.
    """
    if cond_builder is None:
        cond_builder = zeggs_cond_builder
    loss_aware = cfg.schedule_sampler == "loss-second-moment"
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, not {cfg.compute_dtype!r}")
    bf16 = cfg.compute_dtype == "bfloat16"

    def device_step(state: TrainState, batch: Batch, generator: Optional[torch.Generator], *,
                    t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                    cond_drop=None) -> Dict[str, torch.Tensor]:
        x_start, cond, mask = cond_builder(batch)
        B, dev = x_start.shape[0], x_start.device
        T = sched.num_timesteps
        plan = state.plan
        if plan is not None:
            generator = plan.draws(generator, B)
        if t is None:
            t, weights = (resample.loss_aware_sample_t(generator, state.loss_aware, B)
                          if loss_aware else resample.uniform_sample_t(generator, B, T, dev))
        else:
            weights = (1.0 / (T * resample.loss_aware_weights(state.loss_aware)[t])
                       if loss_aware else torch.ones(B, device=dev))
        if noise is None:
            noise = draws.randn(x_start.shape, generator, dev)

        aux_acc = []

        def model_fn(x, tt):
            # no cast cache: a CUDA graph must not keep casts cached at capture
            with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16,
                                cache_enabled=False):
                out = state.model(x, tt, cond, train=True, generator=generator,
                                  cond_drop=cond_drop)
            if isinstance(out, tuple):  # (prediction, MoE load-balance loss)
                out, aux = out
                aux_acc.append(aux.float())
            return out.float()  # the diffusion loss in float32 whatever the forward's dtype

        state.params.grad.zero_()
        terms, _ = G.training_losses(sched, model_fn, x_start, t, noise, mask,
                                     mean_type=cfg.mean_type, var_type=cfg.var_type,
                                     loss_kind=cfg.loss_kind, lambda_vel=cfg.lambda_vel)
        loss = torch.mean(terms["loss"] * weights)
        terms = dict(terms)
        if aux_acc and cfg.moe_aux_weight:
            aux_mean = sum(aux_acc) / len(aux_acc)
            loss = loss + cfg.moe_aux_weight * aux_mean
            terms["moe_aux"] = aux_mean
        loss.backward()
        state.reduce_grads()
        data = plan.data if plan is not None else None
        # the global batch's per-example terms and t (in rank order), its mean loss
        terms = {k: comm.all_gather_cat(v.detach(), data) if v.dim() == 1 else v.detach()
                 for k, v in terms.items()}
        t = comm.all_gather_cat(t, data)
        if data is not None:
            loss = comm.all_reduce_(loss.detach().reshape(1), data)[0] / comm.size(data)
        if loss_aware:
            # the unweighted per-example losses (ref `training_loop.py:256-259`)
            new = resample.update_with_losses(state.loss_aware, t, terms["loss"])
            state.loss_aware.history.copy_(new.history)
            state.loss_aware.counts.copy_(new.counts)
        grad_norm = state.grad_norm()
        state.optimizer.step()
        with torch.no_grad():
            if state.ema is not None:
                r = cfg.ema_rate
                state.ema.copy_(state.ema * r + state.optimizer.p * (1 - r))
            state.gather_params()
            param_norm = torch.linalg.vector_norm(state.params.data)
        metrics = dict(terms)
        metrics.update(loss=loss.detach(), grad_norm=grad_norm, param_norm=param_norm, t=t,
                       loss_per_example=terms["loss"])
        return metrics

    def step(state: TrainState, *args, **kwargs) -> Dict[str, torch.Tensor]:
        metrics = device_step(state, *args, **kwargs)
        state.step += 1
        return metrics

    step.device_step = device_step
    return step


def make_zeggs_cond_builder(n_seed: int = 8) -> CondBuilder:
    """ZEGGS batch {'motion' (B, T, C), 'style' (B, 6), 'wavlm' (B, T, 1024)} →
    (x_start, cond, mask) (`main/train/training_loop.py:142-166`)."""

    def builder(batch: Batch):
        motion = batch["motion"].permute(0, 2, 1)[:, :, None, :]  # (B, C, 1, T)
        B, _, _, T = motion.shape
        dev = motion.device
        cond = {"seed": motion[..., :n_seed], "style": batch["style"], "audio": batch["wavlm"],
                "mask_local": torch.ones(B, T, dtype=torch.bool, device=dev)}
        return motion, cond, torch.ones(B, 1, 1, T, device=dev)

    return builder


zeggs_cond_builder = make_zeggs_cond_builder(8)


def make_beat_cond_builder(variant: str, n_seed: int) -> CondBuilder:
    """BEAT/TWH batch {'motion' (B, T, C), 'audio' (B, T, A), 'style' (B, S)} →
    (x_start, cond, mask) (`BEAT-TWH-main/train/training_loop.py:100-130`):
    attention4 feeds audio[:, n_seed:]; attention5 feeds audio[:, n_seed:-n_seed]
    and passes seed_last, the final n_seed motion frames; attention3 the whole
    audio."""
    if "attention5" in variant and n_seed <= 0:
        # [:-0] would be the empty slice and [-0:] the whole motion: the ground
        # truth passed as conditioning
        raise ValueError("attention5 requires n_seed > 0")

    def builder(batch: Batch):
        motion = batch["motion"].permute(0, 2, 1)[:, :, None, :]  # (B, C, 1, T)
        B, _, _, T = motion.shape
        dev = motion.device
        audio = batch["audio"]
        cond = {"seed": motion[..., :n_seed], "style": batch["style"],
                "mask_local": torch.ones(B, T, dtype=torch.bool, device=dev)}
        if "attention4" in variant:
            cond["audio"] = audio[:, n_seed:]
        elif "attention5" in variant:
            cond["audio"] = audio[:, n_seed:-n_seed]
            cond["seed_last"] = motion[..., -n_seed:]
        else:
            cond["audio"] = audio
        return motion, cond, torch.ones(B, 1, 1, T, device=dev)

    return builder
