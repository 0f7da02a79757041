"""The evaluation autoencoder of the PyTorch port vs the JAX package, on the CPU.

From converted weights (`autoencoder_state_dict_from_flax`) and windows made
with numpy, at a small size (12 features, hidden 16, latent 8, and latent 32
at window 40):

* the forward (reconstruction and latent) agrees at 1e-5, at window 40 and at
  odd and short windows, which exercise flax's asymmetric 'SAME' padding of
  the strided convolutions and the flipped kernel of its transposed ones;
* `embed_windows` agrees at 1e-5 over more windows than one batch;
* three Adam steps on fixed batches (the JAX reference is its loss with
  `optax.adam`): each loss at 1e-6 relative, the weights at 1e-5;
* `train_autoencoder` returns the untrained model and inf for 0 steps, and
  lowers the loss on the CPU, deterministically for a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusestylegesture_tpu.eval import embedding as JE
from diffusestylegesture_torch.eval import embedding as TE
from diffusestylegesture_torch.models.convert import autoencoder_state_dict_from_flax
from diffusestylegesture_torch.train import TrainConfig, TrainState

from torch_port_utils import np32, randomize_flax_params

TOL = dict(rtol=1e-5, atol=1e-5)


def make(window, latent=8, n=6, seed=0):
    """(JAX config, flax module, randomized params, the port's module, windows)."""
    kw = dict(window=window, feat_dim=12, hidden=16, latent=latent)
    fmodel = JE.GestureAutoencoder(JE.AEConfig(**kw))
    x = np.random.default_rng(seed).standard_normal((n, window, 12)).astype(np.float32)
    params = fmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"params": randomize_flax_params(params["params"], seed + 1)}
    model = TE.GestureAutoencoder(TE.AEConfig(**kw))
    model.load_state_dict(autoencoder_state_dict_from_flax(params))
    return JE.AEConfig(**kw), fmodel, params, model, x


@pytest.mark.parametrize("window,latent", [(40, 32), (41, 8), (37, 8), (13, 8), (10, 8)])
def test_forward_matches_jax(window, latent):
    _, fmodel, params, model, x = make(window, latent)
    jrecon, jz = fmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        recon, z = model(torch.from_numpy(x))
    assert recon.shape == (len(x), window, 12) and z.shape == (len(x), latent)
    np.testing.assert_allclose(np32(recon), np.asarray(jrecon), **TOL)
    np.testing.assert_allclose(np32(z), np.asarray(jz), **TOL)


def test_embed_windows_matches_jax():
    cfg, _, params, model, _ = make(40, 32)
    windows = np.random.default_rng(7).standard_normal((300, 40, 12)).astype(np.float32)
    ours = TE.embed_windows(model, windows)
    assert ours.shape == (300, 32)
    np.testing.assert_allclose(ours, JE.embed_windows(params, cfg, windows), **TOL)


def test_three_adam_steps_match_jax():
    lr, batch = 1e-3, 5
    _, fmodel, params, model, _ = make(40, 32, seed=2)
    data = np.random.default_rng(3).standard_normal((20, 40, 12)).astype(np.float32)

    def loss_fn(p, b):
        recon, _ = fmodel.apply(p, b)
        return jnp.mean((recon - b) ** 2)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    tx = optax.adam(lr)
    jparams, opt = params, tx.init(params)
    state = TrainState(model, TrainConfig(lr=lr))
    step = TE.make_autoencoder_step(state, torch.from_numpy(data), batch)
    rng = np.random.default_rng(4)
    for i in range(3):
        idx = rng.integers(0, len(data), batch)  # with replacement, as the JAX loop draws
        jloss, grads = grad_fn(jparams, jnp.asarray(data[idx]))
        updates, opt = tx.update(grads, opt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        out = step(None, idx=torch.from_numpy(idx))
        np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=1e-6, err_msg=f"{i}")
        ref = autoencoder_state_dict_from_flax(jparams)
        for k, v in state.params.to_dict(state.params.data).items():
            np.testing.assert_allclose(np32(v), np32(ref[k]), err_msg=f"step {i} {k}", **TOL)


def test_train_autoencoder_on_the_cpu():
    cfg = TE.AEConfig(window=16, feat_dim=12, hidden=16, latent=8)
    windows = np.random.default_rng(0).standard_normal((40, 16, 12)).astype(np.float32)
    untrained, loss = TE.train_autoencoder(windows, cfg, num_steps=0, device="cpu")
    assert loss == float("inf")
    model, loss = TE.train_autoencoder(windows, cfg, num_steps=30, lr=3e-3, device="cpu")
    again, loss2 = TE.train_autoencoder(windows, cfg, num_steps=30, lr=3e-3, device="cpu")
    assert loss == loss2 and all(torch.equal(a, b) for a, b in
                                 zip(model.state_dict().values(), again.state_dict().values()))
    x = torch.from_numpy(windows)
    with torch.no_grad():
        before = float(torch.mean((untrained(x)[0] - x) ** 2))
        after = float(torch.mean((model(x)[0] - x) ** 2))
    assert np.isfinite(loss) and after < before
    assert TE.embed_windows(model, windows).shape == (40, 8)


def test_train_autoencoder_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TE.train_autoencoder(np.zeros((4, 8, 3), np.float32), TE.AEConfig(window=8, feat_dim=3))
