"""The port's parallel plans and layout converters against the JAX package's,
on one process (no process group).

* `fsdp_param_specs` (alone, at two axis sizes, and over the tensor-parallel
  plan), `count_sharded`, `mdm_param_specs` (packed and split q/k/v),
  `wavlm_param_specs` and `moe_param_specs`: the same parameters sharded on
  the same physical dimensions as the JAX specs of the same weights, exactly.
  A JAX spec is carried into the port's names and layout by the weight
  converter itself: each dimension's index array goes through it.
* `split_qkv_params` / `merge_qkv_params`: exact, inverses, equal to the JAX
  converters' output, and on a train state's moments and EMA too; a split
  MDM's forward equals the packed one and the JAX split model (1e-5).
* The per-shard sequence-parallel attention (`local_attn_shard`) against the
  JAX `_local_attn_shard` (1e-5), the shard-count refusal (TWH T 150 at w 15:
  2 and 5 shards, not 4), `stack` / `unstack`, the serving mesh's helpers,
  and kernel B's packed weights of a split layer, made once.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu import parallel as jpar
from diffusestylegesture_tpu.models.mdm import MDM as FlaxMDM, MDMConfig as FlaxMDMConfig
from diffusestylegesture_tpu.models.moe import moe_param_specs as jax_moe_specs
from diffusestylegesture_tpu.models.wavlm import WavLM as FlaxWavLM
from diffusestylegesture_tpu.models.wavlm import WavLMConfig as FlaxWavLMConfig
from diffusestylegesture_tpu.parallel.seq_parallel import _local_attn_shard
from diffusestylegesture_torch import parallel as tpar
from diffusestylegesture_torch.models.convert import (mdm_state_dict_from_flax,
                                                      wavlm_state_dict_from_flax)
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.models.moe import moe_param_specs
from diffusestylegesture_torch.models.wavlm.model import WavLMConfig
from diffusestylegesture_torch.parallel.seq_parallel import check_shards, local_attn_shard
from diffusestylegesture_torch.train import TrainConfig, TrainState

from torch_port_utils import randomize_flax_params

B, NJ, T, NSEED = 4, 16, 22, 4
KW = dict(njoints=NJ, latent_dim=128, ff_size=64, num_layers=2, window_size=11, n_seed=NSEED,
          cond_mask_prob=0.0, dropout=0.0)
WAVLM = dict(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=96,
             encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4, num_buckets=40,
             max_distance=80, conv_feature_layers=((24, 10, 5), (24, 3, 2), (24, 2, 2)))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, NJ, 1, T)).astype(np.float32)
    cond = {"seed": x[..., :NSEED], "style": rng.standard_normal((B, 6)).astype(np.float32),
            "audio": rng.standard_normal((B, T, 1024)).astype(np.float32),
            "mask_local": np.ones((B, T), bool)}
    return x, np.zeros(B, np.int64), cond


def _flax_params(split=False, moe=0, seed=0):
    cfg = FlaxMDMConfig(**KW, split_qkv=split, moe_experts=moe)
    x, t, cond = _inputs()
    params = FlaxMDM(cfg).init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                               {k: jnp.asarray(v) for k, v in cond.items()})
    return {"params": randomize_flax_params(params["params"], seed)}


def specs_in_torch_layout(flax_params, flax_specs, convert):
    """{torch name: spec} of a JAX spec tree: flax dimension d of each leaf
    lands on the torch dimension along which the converted index array
    `np.indices(shape)[d]` varies."""
    leaves, treedef = jax.tree_util.tree_flatten(flax_params)
    spec_leaves = jax.tree_util.tree_leaves(
        flax_specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert len(spec_leaves) == len(leaves)
    dims = [convert(jax.tree_util.tree_unflatten(treedef, [
        np.indices(np.shape(a))[d].astype(np.float32) if np.ndim(a) > d
        else np.zeros(np.shape(a), np.float32) for a in leaves])) for d in range(4)]
    # which flax leaf each torch parameter came from
    marks = convert(jax.tree_util.tree_unflatten(treedef, [
        np.full(np.shape(a), i, np.float32) for i, a in enumerate(leaves)]))
    out = {}
    for name, t in marks.items():
        spec = tuple(spec_leaves[int(t.reshape(-1)[0])])
        parts = [None] * t.dim()
        for d, axis in enumerate(spec):
            if axis is None:
                continue
            a = dims[d][name].numpy()
            moving = [k for k in range(a.ndim) if a.shape[k] > 1 and
                      (np.diff(a, axis=k) != 0).any()]
            assert len(moving) == 1, (name, d, moving)
            parts[moving[0]] = axis
        while parts and parts[-1] is None:
            parts.pop()
        out[name] = tuple(parts)
    return out


def _torch_sd(flax_params):
    return mdm_state_dict_from_flax(flax_params)


@pytest.mark.parametrize("axis_size,with_tp", [(8, False), (4, False), (4, True)],
                         ids=["data8", "data4", "data4_over_tp"])
def test_fsdp_specs_match_jax(axis_size, with_tp):
    params = _flax_params(split=with_tp)
    base = jpar.mdm_param_specs(params["params"]) if with_tp else None
    jspecs = jpar.fsdp_param_specs(params["params"], axis_size, base_specs=base)
    ref = specs_in_torch_layout(params, {"params": jspecs}, _torch_sd)
    sd = _torch_sd(params)
    tbase = tpar.mdm_param_specs(sd) if with_tp else None
    ours = tpar.fsdp_param_specs(sd, axis_size, base_specs=tbase)
    assert set(ours) == set(ref)
    assert ours == ref
    assert tpar.count_sharded(ours) == jpar.count_sharded(jspecs) > 0
    if with_tp:
        assert tpar.count_sharded(ours, "model") == jpar.count_sharded(jspecs, "model") > 0


@pytest.mark.parametrize("split", [False, True], ids=["packed", "split_qkv"])
def test_tp_specs_match_jax(split):
    params = _flax_params(split=split)
    ref = specs_in_torch_layout(params, {"params": jpar.mdm_param_specs(params["params"])},
                                _torch_sd)
    ours = tpar.mdm_param_specs(_torch_sd(params))
    assert ours == ref
    col = [k for k, s in ours.items() if s == ("model",)]
    row = [k for k, s in ours.items() if s == (None, "model")]
    assert col and row and all("seqTransEncoder" in k for k in col + row)


def test_wavlm_specs_match_jax():
    fcfg = FlaxWavLMConfig(**WAVLM)
    wav = jnp.asarray(np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32))
    params = FlaxWavLM(fcfg).init(jax.random.PRNGKey(0), wav)
    params = {"params": randomize_flax_params(params["params"], 1)}
    cfg = WavLMConfig(**WAVLM)

    def convert(tree):
        return wavlm_state_dict_from_flax(tree, cfg)

    ref = specs_in_torch_layout(params, {"params": jpar.wavlm_param_specs(params["params"])},
                                convert)
    ours = tpar.wavlm_param_specs(convert(params))
    assert ours == ref
    assert ours["encoder.layers.0.self_attn.relative_attention_bias.weight"] == (None, "model")
    assert ours["encoder.layers.0.self_attn.grep_a"] == (None, "model")
    assert ours["encoder.layers.1.fc2.weight"] == (None, "model")


def test_moe_specs_match_jax():
    params = _flax_params(moe=4)
    ref = specs_in_torch_layout(params, {"params": jax_moe_specs(params["params"])},
                                _torch_sd)
    ours = moe_param_specs(_torch_sd(params))
    assert ours == ref
    assert ours["seqTransEncoder.layers.0.moe.w1"] == ("expert",)
    assert ours["seqTransEncoder.layers.0.moe.router.weight"] == ()


def test_split_and_merge_match_jax_and_are_exact_inverses():
    params = _flax_params()
    sd = _torch_sd(params)
    split = tpar.split_qkv_params(sd)
    assert split.keys() == _torch_sd(jpar.split_qkv_params(params)).keys()
    for k, v in _torch_sd(jpar.split_qkv_params(params)).items():
        assert torch.equal(split[k], v), k
    assert not any("in_proj" in k for k in split if "seqTransEncoder" in k)
    back = tpar.merge_qkv_params(split)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    # idempotent on the layout already there
    assert tpar.merge_qkv_params(sd).keys() == sd.keys()
    assert tpar.split_qkv_params(split).keys() == split.keys()


def test_split_and_merge_carry_moments_and_ema():
    torch.manual_seed(0)
    model = MDM(MDMConfig(**KW, impl="plain"))
    state = TrainState(model, TrainConfig(ema_rate=0.9), 20)
    g = torch.Generator().manual_seed(1)
    for buf in (state.optimizer.mu, state.optimizer.nu, state.ema):
        buf.copy_(torch.randn(buf.shape, generator=g))
    saved = {"model": state.params.to_dict(state.params.data), "ema": state.ema_state_dict(),
             "optimizer": state.optimizer.state_dict()}
    split = tpar.split_qkv_params(saved)
    for part in ("model", "ema"):
        assert any(k.endswith("q_proj.weight") for k in split[part])
    assert any(k.endswith("v_proj.bias") for k in split["optimizer"]["mu"])
    assert torch.equal(split["optimizer"]["count"], saved["optimizer"]["count"])
    back = tpar.merge_qkv_params(split)
    for part in ("model", "ema"):
        assert all(torch.equal(back[part][k], saved[part][k]) for k in saved[part])
    for m in ("mu", "nu"):
        assert all(torch.equal(back["optimizer"][m][k], saved["optimizer"][m][k])
                   for k in saved["optimizer"][m])
    # into a split model's state: exact
    split_model = MDM(MDMConfig(**KW, impl="plain", split_qkv=True))
    st2 = TrainState(split_model, TrainConfig(ema_rate=0.9), 20)
    st2.load_state_dict({"step": 0, "optimizer": split["optimizer"], "loss_aware": None},
                        split["model"], split["ema"])
    again = tpar.merge_qkv_params({"model": st2.params.to_dict(st2.params.data),
                                   "ema": st2.ema_state_dict(),
                                   "mu": st2.optimizer.state_dict()["mu"]})
    for part, ref in (("model", saved["model"]), ("ema", saved["ema"]),
                      ("mu", saved["optimizer"]["mu"])):
        assert all(torch.equal(again[part][k], ref[k]) for k in ref), part


def test_split_forward_matches_packed_and_jax():
    params = _flax_params()
    x, t, cond = _inputs(3)
    jsplit = FlaxMDM(FlaxMDMConfig(**KW, split_qkv=True))
    ref = np.asarray(jsplit.apply(jpar.split_qkv_params(params), jnp.asarray(x), jnp.asarray(t),
                                  {k: jnp.asarray(v) for k, v in cond.items()}))
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    outs = []
    for split in (False, True):
        model = MDM(MDMConfig(**KW, split_qkv=split, impl="plain"))
        sd = _torch_sd(params)
        model.load_state_dict(tpar.split_qkv_params(sd) if split else sd)
        with torch.no_grad():
            outs.append(model(torch.from_numpy(x), torch.from_numpy(t), tcond).numpy())
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5)
    np.testing.assert_allclose(outs[1], ref, atol=1e-5)


def test_kernel_b_reads_split_weights_packed_once():
    from diffusestylegesture_torch.models.transformer import TorchMultiheadAttention

    torch.manual_seed(0)
    a = TorchMultiheadAttention(32, 4, split_qkv=True)
    w1, b1 = a.packed_in_proj()
    w2, _ = a.packed_in_proj()
    assert w1 is w2 and w1.shape == (96, 32) and b1.shape == (96,)
    assert torch.equal(w1, torch.cat([a.q_proj.weight, a.k_proj.weight, a.v_proj.weight]))
    with torch.no_grad():
        a.k_proj.weight.add_(1.0)
    w3, _ = a.packed_in_proj()
    assert w3 is not w1 and torch.equal(w3[32:64], a.k_proj.weight)


def test_local_attn_shard_matches_jax():
    rng = np.random.default_rng(4)
    bh, ts, d, w = 6, 22, 16, 11
    q, k, v = (rng.standard_normal((bh, ts, d)).astype(np.float32) for _ in range(3))
    kh, vh = (rng.standard_normal((bh, w, d)).astype(np.float32) for _ in range(2))
    mask = (rng.random((bh, ts)) > 0.3).astype(np.float32)
    mask[:, ::w] = 1.0  # every window's first key attended: no row without a key
    mh = (rng.random((bh, w)) > 0.5).astype(np.float32)
    for pos0 in (0, 22):
        ref = _local_attn_shard(*(jnp.asarray(a) for a in (q, k, v, mask, kh, vh, mh)), pos0, w)
        ours = local_attn_shard(*(torch.from_numpy(a) for a in (q, k, v, mask, kh, vh, mh)),
                                pos0, w)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("n,w,shards,ok", [(88, 11, 2, True), (88, 11, 4, True),
                                           (88, 11, 8, True), (150, 15, 2, True),
                                           (150, 15, 5, True), (150, 15, 4, False)],
                         ids=["zeggs2", "zeggs4", "zeggs8", "twh2", "twh5", "twh4"])
def test_shard_counts(n, w, shards, ok):
    if ok:
        check_shards(n, w, shards)
    else:
        with pytest.raises(ValueError, match="whole"):
            check_shards(n, w, shards)


def test_stack_unstack_round_trip():
    from diffusestylegesture_torch.models.transformer import TorchTransformerEncoder

    enc = TorchTransformerEncoder(3, 32, 4, 48)
    sd = enc.state_dict()
    stacked = tpar.stack_layer_params(sd, 3)
    assert stacked["linear1.weight"].shape == (3, 48, 32)
    back = tpar.unstack_layer_params(stacked, 3)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


class _FakeMesh:
    mesh_dim_names = ("data", "model")

    def __init__(self, rank_model):
        self.r = rank_model

    def size(self, i):
        return (1, 2)[i]

    def get_local_rank(self, axis):
        return {"data": 0, "model": self.r}[axis]


def test_shard_params_and_train_state_cut_this_ranks_slices():
    torch.manual_seed(0)
    sd = MDM(MDMConfig(**KW, impl="plain", split_qkv=True)).state_dict()
    specs = tpar.mdm_param_specs(sd)
    name_q = "seqTransEncoder.layers.0.self_attn.q_proj.weight"
    name_o = "seqTransEncoder.layers.0.self_attn.out_proj.weight"
    parts = [tpar.shard_params(_FakeMesh(r), sd, specs) for r in (0, 1)]
    assert torch.equal(torch.cat([p[name_q] for p in parts], 0), sd[name_q])
    assert torch.equal(torch.cat([p[name_o] for p in parts], 1), sd[name_o])
    state = tpar.shard_train_state(_FakeMesh(1), {"model": sd, "optimizer": {"mu": sd},
                                                  "step": 3}, specs)
    assert state["step"] == 3 and state["optimizer"]["mu"][name_q].shape == (64, 128)


def test_serving_mesh_helpers():
    cpu = torch.device("cpu")
    mesh = tpar.make_mesh(("data",), devices=[cpu, cpu, cpu])
    assert mesh.shape == {"data": 3} and mesh.axis_devices("data") == [cpu] * 3
    from diffusestylegesture_torch.parallel.mesh import row_bounds

    assert row_bounds(7, 3) == [(0, 3), (3, 5), (5, 7)]
    assert row_bounds(2, 3) == [(0, 1), (1, 2), (2, 2)]
    parts = tpar.shard_batch(mesh, {"x": np.arange(7)})
    assert [p["x"].tolist() for p in parts] == [[0, 1, 2], [3, 4], [5, 6]]
    copies = tpar.replicate(mesh, torch.ones(2))
    assert len(copies) == 3
    with pytest.raises(ValueError, match="does not hold"):
        tpar.make_mesh(("data", "model"), (2, 2), devices=[cpu] * 3)


class _PipeMesh:
    mesh_dim_names = ("pipe",)

    def get_group(self, axis):
        return axis


def test_pipe_keep_mask_holds_the_trunk_layers_whatever_their_names(monkeypatch):
    """A pipe rank other than 0 keeps the gradients of the pipelined trunk's
    layers, found as the model's encoder layers (here under a prefix), and
    refuses a model without such a trunk."""
    from diffusestylegesture_torch.parallel import comm
    from diffusestylegesture_torch.train.state import FlatParams, MeshPlan

    monkeypatch.setattr(comm, "rank", lambda group: 0 if group is None else 1)
    plan = MeshPlan(_PipeMesh(), partial=("pipe",))
    torch.manual_seed(0)
    outer = torch.nn.ModuleDict({"denoiser": MDM(MDMConfig(**KW, impl="plain"))})
    params = FlatParams(outer)
    [(group, mask)] = plan.keep_masks(outer, params)
    assert group == "pipe"
    kept = [n for n, v in zip(params.names, params.views(mask)) if bool((v == 1).all())]
    dropped = [n for n, v in zip(params.names, params.views(mask)) if bool((v == 0).all())]
    assert len(kept) + len(dropped) == len(params.names)
    assert kept and all(n.startswith("denoiser.seqTransEncoder.layers.") for n in kept)
    assert not any(n.startswith("denoiser.seqTransEncoder.layers.") for n in dropped)
    lin = torch.nn.Linear(3, 3)
    with pytest.raises(ValueError, match="TorchTransformerEncoder"):
        plan.keep_masks(lin, FlatParams(lin))
