"""The MoE trunk of the PyTorch port (`models/moe.py`) against the JAX package's.

* The layer, from the same seeded weights and tokens: the routing (each
  token's expert, slot and keep flag) is equal exactly, and the smallest
  margin between a token's top-1 and top-2 router probabilities is printed
  (a float difference of 1e-7 could flip an argmax only inside it); outputs
  at 1e-5, the load-balance loss at 1e-6, gradients at rtol 1e-4. Once at
  the JAX default capacity factor 2.0, once at 0.25, where tokens overflow
  and are dropped (as JAX `tests/test_moe.py` does).
* Three AdamW + EMA steps of a MoE MDM with `moe_aux_weight` 0.01 in both
  trainers, the JAX draws replayed (as `test_torch_train_step.py`, the jitted
  JAX step's drops read back through an ordered callback): loss,
  `moe_aux`, norms, params and EMA at 1e-5.
* The CLIs: the port's `cli/train.py --moe_experts 2` trains (finite loss
  and `moe_aux`), and the JAX `cli/train.py --moe_experts 2` too; each
  checkpoint is served by the port's `cli/sample.py` (the expert count
  inferred from the checkpoint) and by the JAX CLI with its draws replayed,
  poses within 2e-3 relative (the windowed engine's bar): the JAX one as
  orbax and converted by `scripts/convert_orbax_to_torch.py`, the port's as
  its `model.pt` and as an orbax params dir of the same weights. An explicit
  `--moe_experts 0` trains dense.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
import yaml

import flax.linen as fnn
import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp

from diffusestylegesture_tpu.models import mdm as jax_mdm
from diffusestylegesture_tpu.models import moe as jax_moe
from diffusestylegesture_tpu.models.mdm import MDM as FlaxMDM, MDMConfig as FlaxMDMConfig
from diffusestylegesture_tpu.train import state as JS
from diffusestylegesture_torch.models.convert import mdm_state_dict_from_flax
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.models.moe import MoEFeedForward, capacity, route
from diffusestylegesture_torch.train import (TrainConfig, TrainState, make_train_step,
                                             make_zeggs_cond_builder)

from test_torch_train_loop import prepared  # noqa: F401  (module fixture)
from test_torch_train_step import (B, JSCHED, KW, NJ, NSEED, NT, STEP_CFG, STEP_TOL, T, TSCHED,
                                   assert_named_close, make_batch, noise_floor_entries,
                                   torch_batch)
from torch_port_utils import jax_loop_draws, np32, randomize_flax_params, rel_err, replay_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, F, E = 32, 48, 4


def _layer(cf):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 22, D)).astype(np.float32)
    fl = jax_moe.MoEFeedForward(D, F, E, cf)
    params = fl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"params": randomize_flax_params(params["params"], 1)}
    layer = MoEFeedForward(D, F, E, cf)
    p = params["params"]
    layer.router.weight.data = torch.from_numpy(np.asarray(p["router"]["kernel"]).T.copy())
    layer.router.bias.data = torch.from_numpy(np.asarray(p["router"]["bias"]))
    for name in ("w1", "b1", "w2", "b2"):
        getattr(layer, name).data = torch.from_numpy(np.asarray(p[name]))
    return fl, params, layer, x


def _jax_routing(params, x, cf):
    """The JAX layer's routing (`models/moe.py:55-63`) from its own router."""
    xf = jnp.asarray(x).reshape(-1, D)
    logits = fnn.Dense(E).apply({"params": params["params"]["router"]}, xf)
    probs = jax.nn.softmax(logits, axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    mask = jax.nn.one_hot(expert, E, dtype=jnp.float32)
    slot = jnp.sum((jnp.cumsum(mask, axis=0) * mask - mask) * mask, axis=-1).astype(jnp.int32)
    C = max(1, int(np.ceil(xf.shape[0] / E * cf)))
    return np.asarray(probs), np.asarray(expert), np.asarray(slot), np.asarray(slot < C)


@pytest.mark.parametrize("cf", [2.0, 0.25], ids=["capacity", "overflow"])
def test_layer_routing_values_and_aux_match_jax(cf):
    fl, params, layer, x = _layer(cf)
    probs, expert, slot, keep = _jax_routing(params, x, cf)
    G = x.shape[0] * x.shape[1]
    C = capacity(G, E, cf)
    with torch.no_grad():
        _, _, t_expert, _, t_slot, t_keep = route(torch.from_numpy(x).reshape(G, D),
                                                  layer.router, E, C)
    top2 = np.sort(probs, axis=-1)[:, -2:]
    print(f"capacity {C} of {G} tokens over {E} experts; smallest top-1/top-2 margin "
          f"{(top2[:, 1] - top2[:, 0]).min():.3e}; {int((~keep).sum())} dropped")
    np.testing.assert_array_equal(t_expert.numpy(), expert)
    np.testing.assert_array_equal(t_slot.numpy(), slot)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    assert keep.all() if cf == 2.0 else (~keep).sum() > G // 3
    ref, state = fl.apply(params, jnp.asarray(x), mutable=["losses"])
    jaux = jax.tree.leaves(state)[0]
    with torch.no_grad():
        out, aux = layer(torch.from_numpy(x))
    np.testing.assert_allclose(np32(out), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)
    if cf != 2.0:  # a dropped token contributes exactly zero
        assert not np32(out).reshape(G, D)[~keep].any()


@pytest.mark.parametrize("cf", [2.0, 0.25], ids=["capacity", "overflow"])
def test_layer_gradients_match_jax(cf):
    fl, params, layer, x = _layer(cf)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        out, state = fl.apply(p, xx, mutable=["losses"])
        return jnp.sum(out * w) + 3.0 * jax.tree.leaves(state)[0]

    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = layer(xt)
    ((out * torch.from_numpy(w)).sum() + 3.0 * aux).backward()
    jg = jgp["params"]
    pairs = [(xt.grad, jgx), (layer.router.weight.grad, np.asarray(jg["router"]["kernel"]).T),
             (layer.router.bias.grad, jg["router"]["bias"])]
    pairs += [(getattr(layer, n).grad, jg[n]) for n in ("w1", "b1", "w2", "b2")]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(np32(got), want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


def test_three_adamw_steps_with_aux_match_jax(monkeypatch):
    kw = dict(KW, moe_experts=2)
    fmodel = FlaxMDM(FlaxMDMConfig(**kw, cond_mask_prob=0.1, dropout=0.0))
    batch = make_batch(0)
    x = jnp.zeros((B, NJ, 1, T))
    cond = {"seed": x[..., :NSEED], "style": jnp.asarray(batch["style"]),
            "audio": jnp.asarray(batch["wavlm"]),
            "mask_local": jnp.ones((B, T), bool)}
    params = fmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((B,), jnp.int32), cond)
    params = {"params": randomize_flax_params(params["params"], 0)}
    model = MDM(MDMConfig(**kw, cond_mask_prob=0.1, dropout=0.0, impl="plain"))
    model.load_state_dict(mdm_state_dict_from_flax(params))

    # the JAX step jitted: its style and seed drops reach the host through an
    # ordered callback from its own mask_cond calls
    drops = []
    real = jax_mdm.mask_cond

    def recording(c, *, cond_mask_prob, train, uncond=None, rng=None):
        if train and cond_mask_prob > 0.0:
            jax.debug.callback(lambda d: drops.append(np.array(d)[:, 0]),
                               jax.random.bernoulli(rng, cond_mask_prob, (c.shape[0], 1)),
                               ordered=True)
        return real(c, cond_mask_prob=cond_mask_prob, train=train, uncond=uncond, rng=rng)

    monkeypatch.setattr(jax_mdm, "mask_cond", recording)
    jcfg = JS.TrainConfig(**STEP_CFG, moe_aux_weight=0.01, dropout_rng_impl="threefry")
    jstep = jax.jit(JS.make_train_step(jax_moe.make_moe_apply(fmodel), JSCHED, jcfg,
                                       JS.make_zeggs_cond_builder(NSEED)))
    jstate = JS.create_train_state(params, jcfg, NT)
    tcfg = TrainConfig(**STEP_CFG, moe_aux_weight=0.01)
    tstate = TrainState(model, tcfg, NT)
    tstep = make_train_step(TSCHED, tcfg, make_zeggs_cond_builder(NSEED))
    noisy = {}
    for i in range(3):
        key = jax.random.PRNGKey(200 + i)
        b = make_batch(30 + i)
        jstate, jm = jstep(jstate, b, key)
        jax.effects_barrier()
        rng_t, rng_noise, _, _ = jax.random.split(key, 4)
        (style, seed), drops[:] = drops, []
        tm = tstep(tstate, torch_batch(b), None,
                   t=torch.from_numpy(np.array(jax.random.randint(rng_t, (B,), 0, NT))),
                   noise=torch.from_numpy(np.array(jax.random.normal(rng_noise, (B, NJ, 1, T),
                                                                     jnp.float32))),
                   cond_drop=(torch.from_numpy(style), torch.from_numpy(seed)))
        noise_floor_entries(tstate, noisy)
        for k in ("loss", "moe_aux", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=f"{i} {k}")
        assert_named_close(tstate.params.to_dict(tstate.params.data),
                           mdm_state_dict_from_flax(jstate.params), f"step {i} params", noisy,
                           STEP_CFG["lr"] * tstate.step, **STEP_TOL)
        assert_named_close(tstate.ema_state_dict(), mdm_state_dict_from_flax(jstate.ema_params),
                           f"step {i} ema", noisy, STEP_CFG["lr"] * tstate.step, **STEP_TOL)


def _flax_params_from_port(sd, num_layers):
    """The port's MoE MDM state_dict → JAX MDM params: the JAX converter for the
    dense scopes (a MoE layer given empty stand-ins for linear1 / linear2),
    then each MoE layer's router and expert stacks under its `moe` scope."""
    from diffusestylegesture_tpu.models.convert import convert_mdm_zeggs

    sd = {k: v.numpy() for k, v in sd.items()}
    filled = dict(sd)
    moe_layers = [i for i in range(num_layers) if f"seqTransEncoder.layers.{i}.moe.w1" in sd]
    for i in moe_layers:
        for name in ("linear1", "linear2"):
            filled[f"seqTransEncoder.layers.{i}.{name}.weight"] = np.zeros((0, 0), np.float32)
            filled[f"seqTransEncoder.layers.{i}.{name}.bias"] = np.zeros(0, np.float32)
    params = convert_mdm_zeggs(filled, num_layers)
    for i in moe_layers:
        pre, layer = f"seqTransEncoder.layers.{i}.moe", params["seqTransEncoder"][f"layers_{i}"]
        del layer["linear1"], layer["linear2"]
        layer["moe"] = {"router": {"kernel": sd[f"{pre}.router.weight"].T,
                                   "bias": sd[f"{pre}.router.bias"]},
                        **{n: sd[f"{pre}.{n}"] for n in ("w1", "b1", "w2", "b2")}}
    return params


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_orbax_to_torch", os.path.join(REPO, "scripts", "convert_orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_moe_train_and_serve_match_jax_cli(prepared, tmp_path, monkeypatch,  # noqa: F811
                                               capsys):
    from diffusestylegesture_torch.cli import sample as torch_sample
    from diffusestylegesture_torch.cli import train as torch_train
    from diffusestylegesture_torch.motion import zeggs_features as torch_zf
    from diffusestylegesture_tpu.cli import sample as jax_sample
    from diffusestylegesture_tpu.cli import train as jax_train
    from diffusestylegesture_tpu.motion import zeggs_features as jax_zf

    # the prepared run at latent 96 (at 64 the seed embedding, latent − style
    # 64, would be empty, which flax's initializer refuses)
    with open(prepared / "zeggs.yml") as f:
        run_cfg = dict(yaml.safe_load(f), latent_dim=96)
    cfg = str(tmp_path / "moe.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(run_cfg, f)
    wav = str(prepared / "015_Happy_4_x_1_0.wav")
    sample_args = ["--config", cfg, "--audiowavlm_path", wav, "--sampler", "dpmpp",
                   "--respace", "2"]

    # the port's own trainer: MoE from the flag, its checkpoint served. It
    # also caches the windows' WavLM features beside the shards, which the JAX
    # trainer below reads (its yaml names no WavLM checkpoint)
    save = str(tmp_path / "port_train")
    res = torch_train.main(["--config", cfg, "--device", "cpu", "--save_dir", save,
                            "--moe_experts", "2", "--num_steps", "2", "--log_interval", "1"])
    logged = res["loop"].logged
    assert all(np.isfinite(d["loss"]) and np.isfinite(d["moe_aux"]) for d in logged)
    assert res["state"].model.cfg.moe_experts == 2
    out = torch_sample.main(sample_args + ["--model_path", os.path.join(save, "2"),
                                           "--save_dir", str(tmp_path / "served"),
                                           "--device", "cpu"])
    assert "MoE-trained (2 experts)" in capsys.readouterr().out
    assert out["poses"].shape == (1, 2 * 80 - 8, 1141) and np.isfinite(out["poses"]).all()

    jax_ckpt, port_dir = str(tmp_path / "jax_moe"), str(tmp_path / "port_moe")
    jax_cfg = dict(run_cfg, save_dir=jax_ckpt, wavlm_path=str(tmp_path / "no-wavlm.pt"))
    with open(tmp_path / "jax.yml", "w") as f:
        yaml.safe_dump(jax_cfg, f)
    jax_train.main(["--config", str(tmp_path / "jax.yml"), "--moe_experts", "2",
                    "--num_steps", "2"])
    _converter().convert(jax_ckpt, port_dir)
    sd = torch.load(os.path.join(port_dir, "model.pt"), weights_only=True)
    assert sd["seqTransEncoder.layers.0.moe.w1"].shape[0] == 2

    # each checkpoint served by both CLIs: the JAX-trained one (orbax, and its
    # conversion for the port) and the port-trained one (its model.pt, and the
    # same weights as an orbax params dir for the JAX CLI)
    port_orbax = str(tmp_path / "port_orbax")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(port_orbax, {"params": _flax_params_from_port(
        torch.load(os.path.join(save, "2", "model.pt"), weights_only=True),
        run_cfg["num_layers"])})
    ckptr.wait_until_finished()
    for jax_path, port_path in ((jax_ckpt, port_dir), (port_orbax, os.path.join(save, "2"))):
        poses = {}
        for name, cli, zf, model_path in (("jax", jax_sample, jax_zf, jax_path),
                                          ("torch", torch_sample, torch_zf, port_path)):
            argv = sample_args + ["--model_path", model_path, "--save_dir",
                                  str(tmp_path / name)]
            with monkeypatch.context() as m:
                real = zf.pose_features_to_bvh
                m.setattr(zf, "pose_features_to_bvh",
                          lambda p, path, _real=real, _name=name, **k: (
                              poses.__setitem__(_name, np.array(p)), _real(p, path, **k)))
                if name == "torch":
                    replay_draws(m, jax_loop_draws(jax.random.PRNGKey(123456), 2, 2,
                                                   (1, 1141, 1, 88)))
                    argv += ["--device", "cpu"]
                cli.main(argv)
            assert "MoE-trained (2 experts)" in capsys.readouterr().out
        assert poses["torch"].shape == poses["jax"].shape == (2 * 80 - 8, 1141)
        assert rel_err(poses["torch"], poses["jax"]) < 2e-3, jax_path

    dense = torch_train.main(["--config", cfg, "--device", "cpu", "--save_dir",
                              str(tmp_path / "dense"), "--moe_experts", "0", "--num_steps", "1"])
    assert dense["state"].model.cfg.moe_experts == 0
