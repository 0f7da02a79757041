"""Training losses and the loss-aware timestep sampler of the PyTorch port vs
the JAX package.

The same inputs (numpy, from a seed) and the same toy model go through
`diffusion.gaussian.training_losses` in both packages: the per-example terms
agree at 1e-6 (rtol and atol) for every mean type, a partial mask, the
velocity term, KL, rescaled KL and the learned variances; so do
`vb_terms_bpd`, `prior_bpd` and `calc_bpd_loop` (the JAX loop's per-step
noise, drawn from its key, is injected into the port's).

One entry is held otherwise: at t = 0 the VB term is the discretized-Gaussian
decoder NLL (`losses.py:50-77`), whose float32 evaluation loses digits to the
cancellation in 1 + tanh(·) near −1, in both packages alike (tanh differs by
an ulp between XLA and PyTorch; the two float32 results differ by up to a few
percent). There each package is compared with the same formula evaluated in
float64 on the same float32 inputs: the port is held to at most twice the JAX
package's distance from it, plus 1e-6 relative.

The loss-aware sampler's history, counts and weights after the same
sequences of (t, loss) agree at 1e-6 (the history is copied, not computed:
they are equal).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.diffusion import gaussian as JG
from diffusestylegesture_tpu.diffusion import resample as JR
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.diffusion import gaussian as TG
from diffusestylegesture_torch.diffusion import resample as TR

from torch_port_utils import np32

TOL = dict(rtol=1e-6, atol=1e-6)
B, C, T, NT = 4, 6, 10, 20


def _scheds():
    betas = JD.named_beta_schedule("cosine", NT)
    return JD.Schedule.create(betas), TD.Schedule.create(betas, device="cpu")


def _inputs(seed=0, learned=False):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (B, C, 1, T)).astype(np.float32)
    noise = rng.standard_normal((B, C, 1, T)).astype(np.float32)
    t = np.array([0, 3, 11, NT - 1])
    mask = np.ones((B, 1, 1, T), np.float32)
    mask[1, ..., -3:] = 0.0
    mask[3, ..., :2] = 0.0
    w = (rng.standard_normal((2 * C if learned else C, C)) / np.sqrt(C)).astype(np.float32)
    return x0, noise, t, mask, w


def _model_fns(w):
    """out[b, o, 0, s] = tanh(sum_c w[o, c] x[b, c, 0, s] + 0.05 t_b): a
    deterministic toy model in each framework."""
    wj, wt = jnp.asarray(w), torch.from_numpy(w)

    def jfn(x, t):
        return jnp.tanh(jnp.einsum("oc,bcfs->bofs", wj, x) + 0.05 * t[:, None, None, None])

    def tfn(x, t):
        return torch.tanh(torch.einsum("oc,bcfs->bofs", wt, x) + 0.05 * t[:, None, None, None])

    return jfn, tfn


CASES = {
    "start_x": dict(mean_type="START_X"),
    "epsilon": dict(mean_type="EPSILON"),
    "previous_x": dict(mean_type="PREVIOUS_X"),
    "velocity": dict(mean_type="VELOCITY"),
    "start_x_vel": dict(mean_type="START_X", lambda_vel=0.5),
    "epsilon_vel": dict(mean_type="EPSILON", lambda_vel=2.0),
    "kl": dict(mean_type="EPSILON", loss_kind="KL"),
    "rescaled_kl": dict(mean_type="START_X", loss_kind="RESCALED_KL", var_type="FIXED_LARGE"),
    "learned_range": dict(mean_type="EPSILON", var_type="LEARNED_RANGE"),
    "learned_range_rescaled": dict(mean_type="START_X", var_type="LEARNED_RANGE",
                                   loss_kind="RESCALED_MSE"),
    "learned": dict(mean_type="EPSILON", var_type="LEARNED"),
}


def _kinds(case, mod):
    return dict(mean_type=getattr(mod.MeanType, case.get("mean_type", "START_X")),
                var_type=getattr(mod.VarType, case.get("var_type", "FIXED_SMALL")),
                loss_kind=getattr(mod.LossKind, case.get("loss_kind", "MSE")),
                lambda_vel=case.get("lambda_vel", 0.0))


def _decoder_nll_bits(x_start, means, log_scales, dtype):
    """`discretized_gaussian_log_likelihood` → mean NLL in bits per example,
    evaluated in numpy at `dtype` (float64: the yardstick)."""
    x, m, ls = (np.asarray(a).astype(dtype) for a in (x_start, means, log_scales))
    inv = np.exp(-ls)

    def cdf(v):
        return 0.5 * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (v + 0.044715 * v ** 3)))

    plus, minus = cdf(inv * (x - m + 1 / 255)), cdf(inv * (x - m - 1 / 255))
    logp = np.where(x < -0.999, np.log(np.clip(plus, 1e-12, None)),
                    np.where(x > 0.999, np.log(np.clip(1 - minus, 1e-12, None)),
                             np.log(np.clip(plus - minus, 1e-12, None))))
    return -logp.mean(axis=tuple(range(1, logp.ndim))) / np.log(2.0)


def _assert_terms(port, jax_value, t, t0_shift=None, err_msg=""):
    """1e-6 at t ≠ 0; at t = 0, `t0_shift` = (float64 − JAX float32) of the
    decoder NLL term there: the port within twice the JAX package's distance
    from the float64 value, plus 1e-6 relative."""
    port, jax_value = np32(port), np.asarray(jax_value)
    t = np.asarray(t)
    far = t != 0 if t0_shift is not None else np.ones_like(t, bool)
    np.testing.assert_allclose(port[far], jax_value[far], err_msg=err_msg, **TOL)
    if t0_shift is not None:
        exact = jax_value[~far].astype(np.float64) + t0_shift[~far]
        bound = 2 * np.abs(jax_value[~far] - exact) + 1e-6 * (np.abs(exact) + 1)
        assert (np.abs(port[~far] - exact) <= bound).all(), (err_msg, port[~far], exact, bound)


def _t0_shift(js, case, model_output, x0, x_t, t):
    """(float64 − float32) of the JAX decoder NLL at each example, times the
    factor the loss kind puts on the VB term; None where the case has no VB term."""
    kinds = _kinds(case, JG)
    learned = kinds["var_type"] in (JG.VarType.LEARNED, JG.VarType.LEARNED_RANGE)
    kl = kinds["loss_kind"] in (JG.LossKind.KL, JG.LossKind.RESCALED_KL)
    if not (learned or kl):
        return None
    out = JG.p_mean_variance(js, model_output, x_t, jnp.asarray(t), mean_type=kinds["mean_type"],
                             var_type=kinds["var_type"])
    log_scales = 0.5 * out.log_variance
    jax_f32 = -np.asarray(JG.mean_flat(JG.discretized_gaussian_log_likelihood(
        jnp.asarray(x0), means=out.mean, log_scales=log_scales)) / jnp.log(2.0))
    shift = _decoder_nll_bits(x0, out.mean, log_scales, np.float64) - jax_f32
    scale = {JG.LossKind.RESCALED_KL: NT, JG.LossKind.RESCALED_MSE: NT / 1000.0}
    return shift * scale.get(kinds["loss_kind"], 1.0)


@pytest.mark.parametrize("name", list(CASES))
def test_training_losses_match_jax(name):
    case = CASES[name]
    learned = "LEARNED" in case.get("var_type", "")
    js, ts = _scheds()
    x0, noise, t, mask, w = _inputs(1, learned)
    jfn, tfn = _model_fns(w)
    jterms, jxt = JG.training_losses(js, jfn, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise),
                                     jnp.asarray(mask), **_kinds(case, JG))
    tterms, txt = TG.training_losses(ts, tfn, torch.from_numpy(x0), torch.from_numpy(t),
                                     torch.from_numpy(noise), torch.from_numpy(mask),
                                     **_kinds(case, TG))
    np.testing.assert_allclose(np32(txt), np.asarray(jxt), **TOL)
    assert set(tterms) == set(jterms)
    shift = _t0_shift(js, case, jfn(jxt, jnp.asarray(t)), x0, jxt, t)
    for k in jterms:
        _assert_terms(tterms[k], jterms[k], t, shift if k in ("loss", "vb") else None, k)


def test_learned_variance_trains_the_mean_through_the_mse_only():
    """The VB term sees the mean prediction detached (the JAX stop_gradient)."""
    _, ts = _scheds()
    x0, noise, t, mask, w = _inputs(2, learned=True)
    out = torch.from_numpy(np.random.default_rng(3).standard_normal((B, 2 * C, 1, T))
                           .astype(np.float32)).requires_grad_()
    terms, _ = TG.training_losses(ts, lambda x, tt: out, torch.from_numpy(x0), torch.from_numpy(t),
                                  torch.from_numpy(noise), torch.from_numpy(mask),
                                  mean_type=TG.MeanType.EPSILON,
                                  var_type=TG.VarType.LEARNED_RANGE)
    terms["vb"].sum().backward()
    assert float(out.grad[:, :C].abs().max()) == 0.0
    assert float(out.grad[:, C:].abs().max()) > 0.0


@pytest.mark.parametrize("var_type", ["FIXED_SMALL", "FIXED_LARGE", "LEARNED_RANGE"])
def test_vb_terms_and_prior_bpd_match_jax(var_type):
    learned = var_type == "LEARNED_RANGE"
    js, ts = _scheds()
    x0, noise, t, _, w = _inputs(4, learned)
    jfn, tfn = _model_fns(w)
    jxt = JG.q_sample(js, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    jvb, jpx = JG.vb_terms_bpd(js, jfn(jxt, jnp.asarray(t)), jnp.asarray(x0), jxt, jnp.asarray(t),
                               mean_type=JG.MeanType.EPSILON,
                               var_type=getattr(JG.VarType, var_type))
    txt = torch.from_numpy(np.asarray(jxt))
    tvb, tpx = TG.vb_terms_bpd(ts, tfn(txt, torch.from_numpy(t)), torch.from_numpy(x0), txt,
                               torch.from_numpy(t), mean_type=TG.MeanType.EPSILON,
                               var_type=getattr(TG.VarType, var_type))
    shift = _t0_shift(js, dict(mean_type="EPSILON", var_type=var_type, loss_kind="KL"),
                      jfn(jxt, jnp.asarray(t)), x0, jxt, t)
    _assert_terms(tvb, jvb, t, shift)
    # pred_xstart = a·x_t − b·eps with a, b ≈ 50 at t = T−1: 1e-6 of the terms before
    # the cancellation
    a = np.asarray(js.sqrt_recip_alphas_cumprod)[t][:, None, None, None]
    b = np.asarray(js.sqrt_recipm1_alphas_cumprod)[t][:, None, None, None]
    eps = np.asarray(jfn(jxt, jnp.asarray(t)))[:, :C]
    np.testing.assert_allclose(np32(tpx), np.asarray(jpx), rtol=0,
                               atol=1e-6 * (np.abs(a * np.asarray(jxt)) + np.abs(b * eps)).max())
    np.testing.assert_allclose(np32(TG.prior_bpd(ts, torch.from_numpy(x0))),
                               np.asarray(JG.prior_bpd(js, jnp.asarray(x0))), **TOL)
    np.testing.assert_allclose(np32(TG.q_mean_variance(ts, torch.from_numpy(x0),
                                                       torch.from_numpy(t))[1]),
                               np.asarray(JG.q_mean_variance(js, jnp.asarray(x0),
                                                             jnp.asarray(t))[1]), **TOL)


@pytest.mark.parametrize("respaced", [False, True], ids=["full", "respaced"])
def test_calc_bpd_loop_matches_jax(respaced):
    betas = JD.named_beta_schedule("cosine", NT)
    if respaced:
        use = JD.space_timesteps(NT, "5")
        js, ts = JD.spaced_schedule(betas, use), TD.spaced_schedule(betas, use, device="cpu")
    else:
        js, ts = JD.Schedule.create(betas), TD.Schedule.create(betas, device="cpu")
    x0, _, _, _, w = _inputs(5)
    jfn, tfn = _model_fns(w)
    key = jax.random.PRNGKey(7)
    out_j = JG.calc_bpd_loop(js, jfn, jnp.asarray(x0), key)
    # the JAX loop's draws: per step t = T-1 … 0, key, k = split(key); normal(k)
    noises = []
    for _ in range(js.num_timesteps):
        key, nk = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(nk, x0.shape, jnp.float32)))
    out_t = TG.calc_bpd_loop(ts, tfn, torch.from_numpy(x0), noise=torch.from_numpy(np.stack(noises)))
    assert set(out_t) == set(out_j)
    for k in ("prior_bpd", "xstart_mse", "mse"):
        np.testing.assert_allclose(np32(out_t[k]), np.asarray(out_j[k]), err_msg=k, **TOL)
    # vb (N, T): the last column is t = 0, the decoder NLL (module docstring)
    steps = np.arange(js.num_timesteps - 1, -1, -1)
    jnoise = noises[-1]
    jxt = JG.q_sample(js, jnp.asarray(x0), jnp.zeros(B, jnp.int32), jnp.asarray(jnoise))
    shift = _t0_shift(js, dict(mean_type="START_X", loss_kind="KL"),
                      jfn(jxt, js.timestep_map[jnp.zeros(B, jnp.int32)]), x0, jxt,
                      np.zeros(B, np.int64))
    vb_t, vb_j = np32(out_t["vb"]), np.asarray(out_j["vb"])
    for i, step in enumerate(steps):
        _assert_terms(vb_t[:, i], vb_j[:, i], np.full(B, step), shift, f"vb t={step}")
    _assert_terms(out_t["total_bpd"], out_j["total_bpd"], np.zeros(B, np.int64), shift,
                  "total_bpd")


def test_calc_bpd_loop_draws_from_the_generator():
    _, ts = _scheds()
    x0, _, _, _, w = _inputs(6)
    _, tfn = _model_fns(w)
    run = lambda s: TG.calc_bpd_loop(ts, tfn, torch.from_numpy(x0),  # noqa: E731
                                     torch.Generator().manual_seed(s))["total_bpd"]
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


def _la_sequences(seed, T_steps, hpt, rounds, batch):
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        ts = rng.integers(0, T_steps, batch)
        losses = rng.random(batch).astype(np.float32) * (1 + r)
        if r % 5 == 2:
            losses[1] = np.nan  # never enters the history
        if r % 7 == 4:
            losses[-1] = np.inf
        yield ts, losses


@pytest.mark.parametrize("T_steps,hpt,rounds,batch", [(6, 4, 25, 9), (20, 10, 40, 16),
                                                      (3, 10, 6, 32)])
def test_loss_aware_state_and_weights_match_jax(T_steps, hpt, rounds, batch):
    js = JR.LossAwareState.create(T_steps, hpt)
    tstate = TR.LossAwareState.create(T_steps, hpt, device="cpu")
    for ts, losses in _la_sequences(T_steps + hpt, T_steps, hpt, rounds, batch):
        js = JR.update_with_losses(js, jnp.asarray(ts), jnp.asarray(losses))
        tstate = TR.update_with_losses(tstate, torch.from_numpy(ts), torch.from_numpy(losses))
        np.testing.assert_allclose(np32(tstate.history), np.asarray(js.history), **TOL)
        np.testing.assert_array_equal(tstate.counts.numpy(), np.asarray(js.counts))
        np.testing.assert_allclose(np32(TR.loss_aware_weights(tstate)),
                                   np.asarray(JR.loss_aware_weights(js)), **TOL)
    assert int(tstate.counts.min()) == hpt  # warmed: the weights are no longer uniform


def test_loss_aware_sampling():
    state = TR.LossAwareState.create(5, 2, device="cpu")
    state = TR.update_with_losses(state, torch.tensor([0, 0, 1, 1, 2, 2, 3, 3, 4, 4]),
                                  torch.tensor([1e-3, 1e-3, 1e-3, 1e-3, 5.0, 5.0,
                                                1e-3, 1e-3, 1e-3, 1e-3]))
    g = torch.Generator().manual_seed(0)
    t, weights = TR.loss_aware_sample_t(g, state, 4000)
    p = TR.loss_aware_weights(state)
    assert float(p[2]) > 0.99 and abs(float(p.sum()) - 1.0) < 1e-6
    assert float((t == 2).float().mean()) > 0.98
    torch.testing.assert_close(weights, 1.0 / (5 * p[t]))
    t_u, w_u = TR.uniform_sample_t(g, 4000, 5, "cpu")
    assert set(t_u.tolist()) == set(range(5)) and torch.equal(w_u, torch.ones(4000))
