"""The train step of the PyTorch port vs the JAX package's, at the layout of
`tests/test_train.py` (njoints 16, latent 128, one layer, T 22, cosine 20).

* Gradients: one loss (eval-mode forward, a partial mask) and its backward in
  both packages from the same converted weights; every parameter's gradient,
  mapped through `mdm_state_dict_from_flax`, agrees leaf by leaf at rtol 1e-4
  (atol 1e-6 of the leaf's largest entry, for entries near zero).
* Steps: three AdamW + EMA steps (lr 1e-3, weight decay 0.01, anneal 10, EMA
  0.99, condition drop 0.1, dropout 0) of `make_train_step` in both, the JAX
  draws (t, noise, the style and seed drops) recomputed from its key and
  injected into the port's step; params and EMA agree at 1e-5 (rtol and
  atol), loss, grad norm and param norm at 1e-5 relative. The same from a
  state carried across mid-run by `train_state_from_flax`. One exception:
  an entry whose gradient at some step lies below 1e-5 of its tensor's RMS
  sits at the float32 noise floor of a sum taken in another order, where
  Adam's g / (|g| + 1e-8) turns that noise into up to a whole lr-sized
  step; such entries are held to the update's own bound, lr per step. They
  are the attention's key bias (its gradient is zero in exact arithmetic:
  softmax ignores a shift shared by a row's scores) and a few others.
* A non-finite batch is rejected as `optax.apply_if_finite` rejects it.
* bf16 autocast against float32 within `tests/test_train.py`'s bars (loss 5%
  relative, grad norm 20%), master weights, moments and EMA float32.
* Dropout: with p = 0 (and no condition drop) the train forward equals the
  eval forward bitwise; with p > 0 it differs, and repeats for one seed.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.diffusion import gaussian as JG
from diffusestylegesture_tpu.models import mdm as jax_mdm
from diffusestylegesture_tpu.models.mdm import MDM as FlaxMDM, MDMConfig as FlaxMDMConfig
from diffusestylegesture_tpu.train import state as JS
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.diffusion import gaussian as TG
from diffusestylegesture_torch.models.convert import mdm_state_dict_from_flax, train_state_from_flax
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.train import (TrainConfig, TrainState, make_train_step,
                                             make_zeggs_cond_builder)

from torch_port_utils import np32, randomize_flax_params

B, NJ, T, NSEED, NT = 8, 16, 22, 4, 20
KW = dict(njoints=NJ, latent_dim=128, ff_size=64, num_layers=1, window_size=11, n_seed=NSEED)
BETAS = JD.named_beta_schedule("cosine", NT)
JSCHED = JD.Schedule.create(BETAS)
TSCHED = TD.Schedule.create(BETAS, device="cpu")
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def make_batch(seed):
    rng = np.random.default_rng(seed)
    return {"motion": rng.standard_normal((B, T, NJ)).astype(np.float32),
            "style": rng.standard_normal((B, 6)).astype(np.float32),
            "wavlm": rng.standard_normal((B, T, 1024)).astype(np.float32)}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def make_models(cond_mask_prob=0.1, dropout=0.0, seed=0):
    """(flax model, randomized flax params, the port's MDM holding the same weights)."""
    fmodel = FlaxMDM(FlaxMDMConfig(**KW, cond_mask_prob=cond_mask_prob, dropout=dropout))
    batch = make_batch(0)
    x = jnp.zeros((B, NJ, 1, T))
    cond = {"seed": x[..., :NSEED], "style": jnp.asarray(batch["style"]),
            "audio": jnp.asarray(batch["wavlm"]), "mask_local": jnp.ones((B, T), bool)}
    params = fmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((B,), jnp.int32), cond)
    params = {"params": randomize_flax_params(params["params"], seed)}
    model = MDM(MDMConfig(**KW, cond_mask_prob=cond_mask_prob, dropout=dropout, impl="plain"))
    model.load_state_dict(mdm_state_dict_from_flax(params))
    return fmodel, params, model


def flax_apply(fmodel):
    def apply(params, x, t, cond, train=False, rngs=None, uncond=None):
        return fmodel.apply(params, x, t, cond, train=train, rngs=rngs, uncond=uncond)
    return apply


def assert_named_close(port: dict, ref: dict, err="", noisy=None, bound=0.0, **tol):
    """Per tensor at `tol`; entries flagged in `noisy` (module docstring) within `bound`."""
    assert set(port) == set(ref)
    for k in ref:
        a, b = np32(port[k]), np32(ref[k])
        if noisy is None:
            np.testing.assert_allclose(a, b, err_msg=f"{err} {k}", **tol)
            continue
        flag = noisy[k]
        np.testing.assert_allclose(a[~flag], b[~flag], err_msg=f"{err} {k}", **tol)
        assert (np.abs(a - b)[flag] <= bound).all(), (err, k)


def noise_floor_entries(state, noisy):
    """Flag the entries whose gradient in `state` is below 1e-5 of its tensor's RMS."""
    for name, g in zip(state.params.names, state.params.views(state.params.grad)):
        g = g.numpy()
        low = np.abs(g) < 1e-5 * np.sqrt(np.mean(g.astype(np.float64) ** 2))
        noisy[name] = low if name not in noisy else noisy[name] | low


def test_gradients_match_jax_leaf_by_leaf():
    fmodel, params, model = make_models(cond_mask_prob=0.1, dropout=0.1)
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((B, NJ, 1, T)).astype(np.float32)
    noise = rng.standard_normal((B, NJ, 1, T)).astype(np.float32)
    t = rng.integers(0, NT, B)
    mask = np.ones((B, 1, 1, T), np.float32)
    mask[1, ..., -4:] = 0.0
    batch = make_batch(4)
    cond = {"style": batch["style"], "seed": x0[..., :NSEED], "audio": batch["wavlm"],
            "mask_local": np.ones((B, T), bool)}

    def loss_fn(p):
        terms, _ = JG.training_losses(
            JSCHED, lambda x, tt: fmodel.apply(p, x, tt, {k: jnp.asarray(v) for k, v in cond.items()}),
            jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise), jnp.asarray(mask))
        return terms["loss"].mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    terms, _ = TG.training_losses(
        TSCHED, lambda x, tt: model(x, tt, {k: torch.from_numpy(v) for k, v in cond.items()}),
        torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise), torch.from_numpy(mask))
    loss = terms["loss"].mean()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = mdm_state_dict_from_flax(jgrads)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(ref) and len(ref) >= 20
    for k, g in ref.items():
        g = g.numpy()
        np.testing.assert_allclose(np32(grads[k]), g, rtol=1e-4, atol=1e-6 * np.abs(g).max(),
                                   err_msg=k)


class JaxDraws:
    """The JAX train step's draws for a key: t and noise as the step splits
    them, and the style / seed drops recorded from the step's own `mask_cond`
    calls (the model's condition-mask key is derived inside flax)."""

    def __init__(self, monkeypatch, cond_mask_prob):
        self.drops = []
        real = jax_mdm.mask_cond

        def recording(c, *, cond_mask_prob, train, uncond=None, rng=None):
            if train and cond_mask_prob > 0.0:
                self.drops.append(np.asarray(
                    jax.random.bernoulli(rng, cond_mask_prob, (c.shape[0], 1)))[:, 0])
            return real(c, cond_mask_prob=cond_mask_prob, train=train, uncond=uncond, rng=rng)

        monkeypatch.setattr(jax_mdm, "mask_cond", recording)

    def take(self, key):
        rng_t, rng_noise, _, _ = jax.random.split(key, 4)
        t = np.asarray(jax.random.randint(rng_t, (B,), 0, NT))
        noise = np.asarray(jax.random.normal(rng_noise, (B, NJ, 1, T), jnp.float32))
        style, seed = self.drops
        self.drops = []
        return dict(t=torch.from_numpy(t), noise=torch.from_numpy(noise),
                    cond_drop=(torch.from_numpy(style), torch.from_numpy(seed)))


STEP_CFG = dict(lr=1e-3, weight_decay=0.01, lr_anneal_steps=10, ema_rate=0.99)


def run_both(monkeypatch, jstate, tstate, jstep, tstep, keys, batches, noisy=None):
    draws = JaxDraws(monkeypatch, 0.1)
    noisy = {} if noisy is None else noisy
    lr = STEP_CFG["lr"]
    for i, (key, batch) in enumerate(zip(keys, batches)):
        jstate, jm = jstep(jstate, batch, key)
        tm = tstep(tstate, torch_batch(batch), None, **draws.take(key))
        noise_floor_entries(tstate, noisy)
        for k in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=f"{i} {k}")
        np.testing.assert_allclose(np32(tm["loss_per_example"]), np.asarray(jm["loss_per_example"]),
                                   **STEP_TOL)
        assert_named_close(tstate.params.to_dict(tstate.params.data),
                           mdm_state_dict_from_flax(jstate.params), f"step {i} params", noisy,
                           lr * tstate.step, **STEP_TOL)
        assert_named_close(tstate.ema_state_dict(), mdm_state_dict_from_flax(jstate.ema_params),
                           f"step {i} ema", noisy, lr * tstate.step, **STEP_TOL)
    return jstate


def test_three_steps_match_jax(monkeypatch):
    fmodel, params, model = make_models()
    jcfg = JS.TrainConfig(**STEP_CFG, dropout_rng_impl="threefry")
    jstep = JS.make_train_step(flax_apply(fmodel), JSCHED, jcfg, JS.make_zeggs_cond_builder(NSEED))
    jstate = JS.create_train_state(params, jcfg, NT)
    tcfg = TrainConfig(**STEP_CFG)
    tstate = TrainState(model, tcfg, NT)
    tstep = make_train_step(TSCHED, tcfg, make_zeggs_cond_builder(NSEED))
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    jstate = run_both(monkeypatch, jstate, tstate, jstep, tstep, keys,
                      [make_batch(10 + i) for i in range(3)])
    assert tstate.step == 3 and int(tstate.optimizer.count) == int(jstate.opt_state[0].count) == 3


def test_train_state_from_flax_carries_a_run_across(monkeypatch):
    """Two JAX steps, the state converted into the port (the optimizer inside
    apply_if_finite), then one more step in each."""
    fmodel, params, model = make_models(seed=1)
    jcfg = JS.TrainConfig(**STEP_CFG, skip_nonfinite_updates=3, dropout_rng_impl="threefry")
    jstep = JS.make_train_step(flax_apply(fmodel), JSCHED, jcfg, JS.make_zeggs_cond_builder(NSEED))
    jstate = JS.create_train_state(params, jcfg, NT)
    for i in range(2):
        jstate, _ = jstep(jstate, make_batch(20 + i), jax.random.PRNGKey(i))
    host = jax.device_get(jstate)
    d = train_state_from_flax(host.params, host.opt_state, host.ema_params, host.step)
    assert d["step"] == 2 and int(d["optimizer"]["count"]) == 2
    tcfg = TrainConfig(**STEP_CFG, skip_nonfinite_updates=3)
    tstate = TrainState(model, tcfg, NT)
    tstate.load_state_dict(d, d["model"], d["ema"])
    # round trip: what the port holds is what was converted, bit for bit
    for name, got in (("model", tstate.params.to_dict(tstate.params.data)),
                      ("ema", tstate.ema_state_dict()),
                      ("mu", tstate.optimizer.state_dict()["mu"]),
                      ("nu", tstate.optimizer.state_dict()["nu"])):
        want = d[name] if name in ("model", "ema") else d["optimizer"][name]
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    assert tstate.step == 2 and int(tstate.optimizer.count) == 2
    tstep = make_train_step(TSCHED, tcfg, make_zeggs_cond_builder(NSEED))
    jstate = JS.create_train_state(params, jcfg, NT).replace(
        step=jstate.step, params=jstate.params, opt_state=jstate.opt_state,
        ema_params=jstate.ema_params)

    def jcount(s):
        return s.opt_state.inner_state[0].count

    # the entries at the noise floor in the JAX steps: their moments carry it
    noisy = {}
    for name, g in mdm_state_dict_from_flax(jax.device_get(
            jstate.opt_state.inner_state[0].mu)).items():
        g = g.numpy()
        noisy[name] = np.abs(g) < 1e-5 * np.sqrt(np.mean(g.astype(np.float64) ** 2))
    jstate = run_both(monkeypatch, jstate, tstate, jstep, tstep, [jax.random.PRNGKey(7)],
                      [make_batch(30)], noisy)
    assert int(tstate.optimizer.count) == int(jcount(jstate)) == 3


def test_nonfinite_batch_is_skipped_as_optax_apply_if_finite():
    fmodel, params, model = make_models(cond_mask_prob=0.0)
    jcfg = JS.TrainConfig(lr=1e-3, skip_nonfinite_updates=2, dropout_rng_impl="threefry")
    jstep = JS.make_train_step(flax_apply(fmodel), JSCHED, jcfg, JS.make_zeggs_cond_builder(NSEED))
    jstate = JS.create_train_state(params, jcfg, NT)
    tcfg = TrainConfig(lr=1e-3, skip_nonfinite_updates=2)
    tstate = TrainState(model, tcfg, NT)
    tstep = make_train_step(TSCHED, tcfg, make_zeggs_cond_builder(NSEED))
    good, bad = make_batch(7), make_batch(8)
    bad["motion"][:] = np.nan
    jleaf = lambda s: np.asarray(jax.tree_util.tree_leaves(s.params)[0])  # noqa: E731
    g = torch.Generator().manual_seed(0)

    tstep(tstate, torch_batch(good), g)
    jstate, _ = jstep(jstate, good, jax.random.PRNGKey(0))
    t_before, j_before = tstate.params.data.clone(), jleaf(jstate).copy()
    mu_before = tstate.optimizer.mu.clone()
    # two rejected steps: params, moments and count stay, in both
    for i in range(2):
        tstep(tstate, torch_batch(bad), g)
        jstate, _ = jstep(jstate, bad, jax.random.PRNGKey(1 + i))
        assert torch.equal(tstate.params.data, t_before)
        assert torch.equal(tstate.optimizer.mu, mu_before)
        np.testing.assert_array_equal(jleaf(jstate), j_before)
        assert int(tstate.optimizer.count) == int(jstate.opt_state.inner_state[0].count) == 1
    assert tstate.step == 3
    # a third in a row exceeds max_consecutive_errors: applied, in both
    tstep(tstate, torch_batch(bad), g)
    jstate, _ = jstep(jstate, bad, jax.random.PRNGKey(5))
    assert not torch.isfinite(tstate.params.data).all()
    assert not np.isfinite(jleaf(jstate)).all()
    assert int(tstate.optimizer.count) == int(jstate.opt_state.inner_state[0].count) == 2


def test_good_batch_updates_after_a_rejected_one():
    _, _, model = make_models(cond_mask_prob=0.0)
    cfg = TrainConfig(lr=1e-3, skip_nonfinite_updates=3)
    state = TrainState(model, cfg, NT)
    step = make_train_step(TSCHED, cfg, make_zeggs_cond_builder(NSEED))
    bad = make_batch(8)
    bad["motion"][:] = np.nan
    before = state.params.data.clone()
    g = torch.Generator().manual_seed(0)
    step(state, torch_batch(bad), g)
    assert torch.equal(state.params.data, before)
    step(state, torch_batch(make_batch(9)), g)
    assert float((state.params.data - before).abs().max()) > 0


def _one_step(compute_dtype, ema=0.0):
    _, _, model = make_models(cond_mask_prob=0.0)
    cfg = TrainConfig(lr=1e-3, compute_dtype=compute_dtype, ema_rate=ema)
    state = TrainState(model, cfg, NT)
    step = make_train_step(TSCHED, cfg, make_zeggs_cond_builder(NSEED))
    metrics = step(state, torch_batch(make_batch(2)), torch.Generator().manual_seed(7))
    return state, metrics


def test_bf16_step_matches_f32_within_tolerance():
    _, m32 = _one_step("float32")
    _, m16 = _one_step("bfloat16")
    l32, l16 = float(m32["loss"]), float(m16["loss"])
    assert np.isfinite(l16) and abs(l16 - l32) / abs(l32) < 0.05
    g32, g16 = float(m32["grad_norm"]), float(m16["grad_norm"])
    assert abs(g16 - g32) / g32 < 0.2


def test_bf16_master_weights_moments_and_ema_stay_f32():
    state, m = _one_step("bfloat16", ema=0.99)
    assert m["loss"].dtype == torch.float32
    tensors = [state.params.data, state.params.grad, state.ema, state.optimizer.mu,
               state.optimizer.nu] + list(state.model.parameters())
    assert all(t.dtype == torch.float32 for t in tensors)
    assert torch.isfinite(state.params.data).all()


def test_bf16_loss_decreases():
    _, _, model = make_models(cond_mask_prob=0.0)
    cfg = TrainConfig(lr=1e-3, compute_dtype="bfloat16")
    state = TrainState(model, cfg, NT)
    step = make_train_step(TSCHED, cfg, make_zeggs_cond_builder(NSEED))
    batch = torch_batch(make_batch(4))
    losses = [float(step(state, batch, torch.Generator().manual_seed(i))["loss"]) for i in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_every_parameter_gets_a_gradient():
    state, m = _one_step("float32")
    for name, p in state.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert float(p.grad.abs().sum()) > 0, name
    # the gradients are the views of the flat buffer the optimizer reads
    assert float(m["grad_norm"]) == pytest.approx(
        float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in state.model.parameters()))),
        rel=1e-5)


def _forward(model, train, seed=0):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, NJ, 1, T)).astype(np.float32))
    cond = {"style": torch.from_numpy(rng.standard_normal((B, 6)).astype(np.float32)),
            "seed": torch.from_numpy(rng.standard_normal((B, NJ, 1, NSEED)).astype(np.float32)),
            "audio": torch.from_numpy(rng.standard_normal((B, T, 1024)).astype(np.float32)),
            "mask_local": torch.ones(B, T, dtype=torch.bool)}
    t = torch.arange(B) * 2
    with torch.no_grad():
        return model(x, t, cond, train=train, generator=torch.Generator().manual_seed(seed))


def test_dropout_zero_train_equals_eval_bitwise():
    _, _, model = make_models(cond_mask_prob=0.0, dropout=0.0)
    assert torch.equal(_forward(model, True), _forward(model, False))
    _, _, model = make_models(cond_mask_prob=0.1, dropout=0.0)
    no_drop = (torch.zeros(B, dtype=torch.bool),) * 2
    with torch.no_grad():
        eval_out = _forward(model, False)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, NJ, 1, T)).astype(np.float32))
    cond = {"style": torch.from_numpy(rng.standard_normal((B, 6)).astype(np.float32)),
            "seed": torch.from_numpy(rng.standard_normal((B, NJ, 1, NSEED)).astype(np.float32)),
            "audio": torch.from_numpy(rng.standard_normal((B, T, 1024)).astype(np.float32)),
            "mask_local": torch.ones(B, T, dtype=torch.bool)}
    with torch.no_grad():
        injected = model(x, torch.arange(B) * 2, cond, train=True, cond_drop=no_drop)
    assert torch.equal(injected, eval_out)


def test_dropout_changes_the_output_and_repeats_for_a_seed():
    _, _, model = make_models(cond_mask_prob=0.0, dropout=0.1)
    eval_out = _forward(model, False)
    train_out = _forward(model, True, seed=1)
    assert not torch.equal(train_out, eval_out)
    assert torch.equal(train_out, _forward(model, True, seed=1))
    assert not torch.equal(train_out, _forward(model, True, seed=2))


def test_condition_drop_zeroes_style_and_seed_independently():
    _, _, model = make_models(cond_mask_prob=0.0, dropout=0.0)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, NJ, 1, T)).astype(np.float32))
    cond = {"style": torch.eye(6)[:2], "seed": torch.randn(2, NJ, 1, NSEED),
            "audio": torch.randn(2, T, 1024), "mask_local": torch.ones(2, T, dtype=torch.bool)}
    t = torch.tensor([3, 3])
    with torch.no_grad():
        both = model(x, t, cond, train=True, cond_drop=(torch.tensor([True, False]),
                                                        torch.tensor([True, False])))
        uncond = model(x, t, cond, uncond=torch.tensor([True, False]))
        style_only = model(x, t, cond, train=True, cond_drop=(torch.tensor([True, False]),
                                                              torch.tensor([False, False])))
    assert torch.equal(both, uncond)
    assert not torch.equal(style_only[0], both[0]) and torch.equal(style_only[1], both[1])


def test_train_mode_needs_the_plain_impl():
    model = MDM(MDMConfig(**KW, impl="kernel"))
    x = torch.zeros(1, NJ, 1, T)
    cond = {"style": torch.zeros(1, 6), "seed": torch.zeros(1, NJ, 1, NSEED),
            "audio": torch.zeros(1, T, 1024), "mask_local": torch.ones(1, T, dtype=torch.bool)}
    with pytest.raises(ValueError, match="no backward"):
        model(x, torch.zeros(1, dtype=torch.long), cond, train=True)
    with pytest.raises(ValueError, match="no backward"):
        model.seqTransEncoder(torch.zeros(1, T + 1, 128), impl="kernel", train=True)


def test_train_config_rejects_unknown_compute_dtype():
    with pytest.raises(ValueError, match="compute_dtype"):
        make_train_step(TSCHED, dataclasses.replace(TrainConfig(), compute_dtype="float16"))
