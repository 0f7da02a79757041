"""Micro-batching `GestureServer` of the PyTorch port, on the CPU.

The JAX `tests/test_server.py` behaviours, ported: a single request, four
concurrent requests in one batch, bucketing by window count, a minority
bucket not starved, submit after stop, too-long rejection, a batch's failure
delivered to its futures while the server keeps serving; the server's
counters of padded rows and windows over a two-bucket run, and over a
bucket-5 batch of 3- and 5-window clips with dummy rows, where WavLM runs
only over the carried windows rounded up to whole chunks. Against the port's
own engine: the packed encoder's features of the carried windows equal the
whole grid's, and zero elsewhere; a solo request equals
`generate_multi_clip` on the padded batch under the request's seed
(bitwise: the same pieces in the same order).
Against the JAX package: the port's dispatch + finalize of a mixed batch
equals the JAX `_generate_multi` on the same padded batch with the same
per-window x_T (a deterministic DDIM-10 loop), within 2e-3 relative.
"""
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import jax

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.models.wavlm import make_zeggs_wavlm_fn as jax_wavlm_fn
from diffusestylegesture_tpu.sample import engine as jax_engine
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.models.wavlm import make_zeggs_wavlm_fn
from diffusestylegesture_torch.sample import (
    GestureServer,
    ServerConfig,
    ZeggsEngineConfig,
    ZeggsSampler,
    generate_multi_clip,
    slice_audio_windows,
)
from diffusestylegesture_torch.sample.server import _Request

from torch_port_utils import PerStep, ZEGGS_TINY_NJ, rel_err, replay_draws, zeggs_tiny_pair

NJ = 16


def _apply(mdm, x, t, cond, uncond=None):
    return mdm(x, t, cond, uncond=uncond)


def make_server(max_batch=4, max_delay_ms=80.0, buckets=(1, 2, 4)):
    torch.manual_seed(0)
    model = MDM(MDMConfig(njoints=NJ, latent_dim=96, ff_size=64, num_layers=1, n_seed=8,
                          audio_in_dim=32)).eval()
    ecfg = ZeggsEngineConfig(njoints=NJ)
    sched = TD.Schedule.create(TD.named_beta_schedule("cosine", 3), device="cpu")

    def wavlm_stub(_p, windows):
        return torch.zeros((windows.shape[0], ecfg.n_poses, 32))

    sampler = ZeggsSampler(_apply, wavlm_stub, sched, ecfg, device="cpu")
    server = GestureServer(sampler, model, {}, mean=np.zeros(NJ, np.float32),
                           std=np.ones(NJ, np.float32),
                           cfg=ServerConfig(max_batch=max_batch, max_delay_ms=max_delay_ms,
                                            window_buckets=buckets))
    return server, ecfg


def test_single_request():
    server, ecfg = make_server()
    server.start()
    try:
        audio = np.random.default_rng(0).standard_normal(
            ecfg.samples_per_stride * 2).astype(np.float32)
        poses = server.submit(audio, np.eye(6, dtype=np.float32)[0]).result(timeout=120)
        assert poses.shape == (2 * ecfg.stride - ecfg.n_seed, NJ)
        assert np.isfinite(poses).all()
    finally:
        server.stop()


def test_concurrent_requests_are_batched():
    server, ecfg = make_server(max_batch=4, max_delay_ms=300.0)
    server.start()
    try:
        audio = np.random.default_rng(1).standard_normal(
            ecfg.samples_per_stride).astype(np.float32)
        futs = [server.submit(audio, np.eye(6, dtype=np.float32)[i % 6]) for i in range(4)]
        for f in futs:
            assert f.result(timeout=180).shape == (ecfg.stride - ecfg.n_seed, NJ)
        assert server.batches_served == 1  # all four rode one engine call
        assert server.requests_served == 4
    finally:
        server.stop()


def test_mixed_lengths_bucketed_separately():
    server, ecfg = make_server(max_batch=8, max_delay_ms=150.0)
    server.start()
    try:
        rng = np.random.default_rng(2)
        short = rng.standard_normal(ecfg.samples_per_stride).astype(np.float32)
        long = rng.standard_normal(ecfg.samples_per_stride * 4).astype(np.float32)
        f1 = server.submit(short, np.eye(6, dtype=np.float32)[0])
        f2 = server.submit(long, np.eye(6, dtype=np.float32)[1])
        assert f1.result(timeout=180).shape[0] == ecfg.stride - ecfg.n_seed
        assert f2.result(timeout=180).shape[0] == 4 * ecfg.stride - ecfg.n_seed
        assert server.batches_served == 2  # different buckets
    finally:
        server.stop()


def test_minority_bucket_not_starved():
    """The next batch's bucket comes from the OLDEST unserved request (the
    pending deque's head): driven without the dispatcher thread."""
    server, ecfg = make_server(max_batch=2, max_delay_ms=50.0, buckets=(1, 2, 4))

    def req(windows):
        server._queue.put(_Request(audio=np.zeros(windows * ecfg.samples_per_stride, np.float32),
                                   style=np.zeros(6, np.float32), seed=0, num_windows=windows,
                                   future=Future()))

    for w in (1, 4, 1, 1, 1):  # a one-window stream with one four-window request in it
        req(w)
    assert [r.num_windows for r in server._collect_batch()] == [1, 1]
    assert [r.num_windows for r in server._collect_batch()] == [4]
    assert [r.num_windows for r in server._collect_batch()] == [1, 1]


def test_counters_of_a_two_bucket_run():
    """Padded rows, windows encoded, windows that carry no clip's audio and
    requests a bucket, over two batches run through dispatch + finalize."""
    server, ecfg = make_server(max_batch=4, buckets=(1, 2, 4))
    rng = np.random.default_rng(3)

    def req(windows, i):
        audio = rng.standard_normal(windows * ecfg.samples_per_stride + 50).astype(np.float32)
        return _Request(audio=audio, style=np.eye(6, dtype=np.float32)[i], seed=i,
                        num_windows=windows, future=Future(), id=i)

    batches = [[req(1, 0), req(1, 1)], [req(3, 2)]]
    for batch in batches:
        server._run_batch(batch)
    assert [r.future.result(timeout=0).shape[0] for b in batches for r in b] == \
        [ecfg.stride - ecfg.n_seed] * 2 + [3 * ecfg.stride - ecfg.n_seed]
    # bucket 1: 2 windows carry audio, rounded up to a chunk of 8 but at most the grid of
    # 4 rows × 1 window; bucket 4: 3 carry audio, rounded up to 8 of the grid's 4 × 4; the
    # conditioning invariants computed once a window sampled, 1 + 3
    assert server.counters() == {"served": 3, "batches": 2, "rows_padded": 2 + 3,
                                 "windows_encoded": 4 + 8, "windows_padding": 2 + 5,
                                 "windows_skipped": 0 + 8, "requests_by_bucket": {1: 2, 4: 1},
                                 "cond_encodes": 1 + 3}


@pytest.mark.parametrize("max_batch,clips,encoded", [(16, (3, 5, 3), 16), (2, (5, 3), 8),
                                                     (3, (5, 3, 3), 15)])
def test_counters_of_a_packed_bucket_five_batch(max_batch, clips, encoded):
    """3- and 5-window clips in bucket 5, with dummy rows or without: WavLM
    runs, in one `encode` call, over the carried windows rounded up to whole
    chunks of 8, and never over more than the max_batch × 5 grid."""
    server, ecfg = make_server(max_batch=max_batch, buckets=(1, 2, 5))
    seen = []
    encode = server.sampler.encode
    server.sampler.encode = lambda p, w: seen.append(int(w.shape[0])) or encode(p, w)
    rng = np.random.default_rng(6)
    batch = [_Request(audio=rng.standard_normal(w * ecfg.samples_per_stride + 9).astype(np.float32),
                      style=np.eye(6, dtype=np.float32)[i], seed=i, num_windows=w,
                      future=Future(), id=i) for i, w in enumerate(clips)]
    server._run_batch(batch)
    assert [r.future.result(timeout=0).shape[0] for r in batch] == \
        [w * ecfg.stride - ecfg.n_seed for w in clips]
    grid, carried = max_batch * 5, sum(clips)
    assert ZeggsSampler.ENCODE_CHUNK == 8 and seen == [encoded] and carried <= encoded <= grid
    assert server.counters() == {"served": len(clips), "batches": 1,
                                 "rows_padded": max_batch - len(clips),
                                 "windows_encoded": encoded, "windows_padding": encoded - carried,
                                 "windows_skipped": grid - encoded,
                                 "requests_by_bucket": {5: len(clips)},
                                 "cond_encodes": max(clips)}


def test_precomputed_conditioning_equals_the_per_step_server():
    """A batch of a 3- and a 1-window clip served with the conditioning
    invariants computed once a window gives bitwise the poses of the path
    that computes them every step (the model behind `PerStep`);
    `counters()` reports `cond_encodes`, a window each on the first path
    and none on the second."""
    rng = np.random.default_rng(9)
    audios = [rng.standard_normal(w * 64000 + 70).astype(np.float32) for w in (3, 1)]
    poses, encodes = {}, {}
    for path in ("precomputed", "per_step"):
        server, _ = make_server(max_batch=4, buckets=(1, 2, 4))
        if path == "per_step":
            server.params = PerStep(server.params)
        batch = [_Request(audio=a, style=np.eye(6, dtype=np.float32)[2 * i], seed=5,
                          num_windows=a.shape[0] // 64000, future=Future(), id=i)
                 for i, a in enumerate(audios)]
        server._run_batch(batch)
        poses[path] = [r.future.result(timeout=0) for r in batch]
        encodes[path] = server.counters()["cond_encodes"]
    assert encodes == {"precomputed": 3, "per_step": 0}
    for a, b in zip(poses["precomputed"], poses["per_step"]):
        np.testing.assert_array_equal(a, b)


def test_encode_packed_matches_the_grid_encode(pair):
    """A tiny WavLM over 3-, 5- and 1-window clips in 4 rows × bucket 5: the
    packed features of each carried window equal the whole grid's encode of
    the same window; the other places of the grid are zero."""
    sampler = _port_sampler("dpmpp", 5)
    ecfg = sampler.cfg
    rng = np.random.default_rng(8)
    clips = [slice_audio_windows((rng.standard_normal(w * ecfg.samples_per_stride + 17) * 0.1)
                                 .astype(np.float32), ecfg) for w in (3, 5, 1)]
    rows, bucket = 4, 5
    windows = np.zeros((rows, bucket, clips[0].shape[1]), np.float32)
    for i, c in enumerate(clips):
        windows[i, : len(c)] = c
    with torch.inference_mode():
        want = sampler.encode(pair["wavlm"], windows.reshape(rows * bucket, -1)).numpy()
        got, encoded = sampler.encode_packed(pair["wavlm"], clips, rows, bucket)
    want = want.reshape((rows, bucket) + want.shape[1:])
    got = got.numpy()
    assert got.shape == want.shape and encoded == 16  # 9 carried, rounded up to chunks of 8
    for i in range(rows):
        n = len(clips[i]) if i < len(clips) else 0
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=0, atol=1e-6)
        assert not got[i, n:].any()


def test_submit_after_stop_raises():
    server, ecfg = make_server()
    server.start()
    server.stop()
    with pytest.raises(RuntimeError, match="not running"):
        server.submit(np.zeros(ecfg.samples_per_stride, np.float32), np.zeros(6, np.float32))


def test_too_long_too_short_and_bad_style_rejected():
    server, ecfg = make_server(buckets=(1, 2))
    server.start()
    try:
        style = np.eye(6, dtype=np.float32)[0]
        with pytest.raises(ValueError, match="max bucket"):
            server.submit(np.zeros(ecfg.samples_per_stride * 5, np.float32), style)
        with pytest.raises(ValueError, match="too short"):
            server.submit(np.zeros(ecfg.samples_per_stride - 1, np.float32), style)
        with pytest.raises(ValueError, match="dims"):
            server.submit(np.zeros(ecfg.samples_per_stride, np.float32), np.zeros(5))
    finally:
        server.stop()


def test_batch_failure_propagates_and_server_survives():
    server, ecfg = make_server(max_batch=2, max_delay_ms=100.0)
    real = server.sampler.wavlm_apply
    calls = {"n": 0}

    def flaky(p, w):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected featurizer failure")
        return real(p, w)

    server.sampler.wavlm_apply = flaky
    server.start()
    try:
        audio = np.zeros(ecfg.samples_per_stride, np.float32)
        bad = server.submit(audio, np.eye(6, dtype=np.float32)[0])
        with pytest.raises(RuntimeError, match="injected"):
            bad.result(timeout=120)
        good = server.submit(audio, np.eye(6, dtype=np.float32)[1])
        assert good.result(timeout=120).shape == (ecfg.stride - ecfg.n_seed, NJ)
    finally:
        server.stop()


@pytest.fixture(scope="module")
def pair():
    return zeggs_tiny_pair(0)


def _port_sampler(sampler: str, steps: int):
    betas = TD.named_beta_schedule("cosine", 1000)
    sched = TD.spaced_schedule(betas, TD.space_timesteps(1000, f"ddim{steps}"), device="cpu")
    return ZeggsSampler(_apply, make_zeggs_wavlm_fn(88), sched,
                        ZeggsEngineConfig(njoints=ZEGGS_TINY_NJ, sampler=sampler), device="cpu")


def test_solo_request_equals_generate_multi_clip(pair):
    sampler = _port_sampler("dpmpp", 5)
    ecfg = sampler.cfg
    server = GestureServer(sampler, pair["mdm"], pair["wavlm"], pair["mean"], pair["std"],
                           ServerConfig(max_batch=2, window_buckets=(2,)), seed=3)
    audio = (np.random.default_rng(4).standard_normal(ecfg.samples_per_stride * 2 + 99)
             * 0.1).astype(np.float32)
    style = np.eye(6, dtype=np.float32)[2]
    server.start()
    try:
        served = server.submit(audio, style).result(timeout=300)
    finally:
        server.stop()
    seed = int(np.random.default_rng(3).integers(0, 2 ** 63 - 1, dtype=np.int64))
    direct = generate_multi_clip(sampler, pair["mdm"], pair["wavlm"],
                                 [audio, np.zeros(0, np.float32)],
                                 np.stack([style, np.zeros(6, np.float32)]),
                                 torch.Generator().manual_seed(seed), pair["mean"], pair["std"])
    assert served.shape == direct[0].shape == (2 * ecfg.stride - ecfg.n_seed, ZEGGS_TINY_NJ)
    np.testing.assert_array_equal(served, direct[0])


def test_dispatch_and_finalize_match_jax_generate_multi(pair, monkeypatch):
    """A batch of a two-window and a one-window clip, padded to max_batch 3 and
    bucket 2: the port's dispatch + finalize against the JAX `_generate_multi`
    over the same encoder features, with the same x_T per window."""
    steps, B, bucket = 10, 3, 2
    sampler = _port_sampler("ddim", steps)
    ecfg = sampler.cfg
    server = GestureServer(sampler, pair["mdm"], pair["wavlm"], pair["mean"], pair["std"],
                           ServerConfig(max_batch=B, window_buckets=(1, bucket)))
    rng = np.random.default_rng(5)
    audios = [(rng.standard_normal(ecfg.samples_per_stride * w + 50) * 0.1).astype(np.float32)
              for w in (2, 1)]
    styles = np.eye(6, dtype=np.float32)[[1, 4]]
    batch = [_Request(audio=a, style=s, seed=11, num_windows=len(a) // ecfg.samples_per_stride,
                      future=Future()) for a, s in zip(audios, styles)]
    noise = rng.standard_normal((bucket, B, ZEGGS_TINY_NJ, 1, 88)).astype(np.float32)
    replay_draws(monkeypatch, [[n] for n in noise])
    server._run_batch(batch)
    outs = [r.future.result(timeout=0) for r in batch]

    jsched = JD.spaced_schedule(JD.named_beta_schedule("cosine", 1000),
                                JD.space_timesteps(1000, f"ddim{steps}"))
    jsampler = jax_engine.ZeggsSampler(
        lambda p, x, t, c, uncond=None: pair["fm"].apply(p, x, t, c, uncond=uncond),
        jax_wavlm_fn(pair["fw"], 88), jsched,
        jax_engine.ZeggsEngineConfig(njoints=ZEGGS_TINY_NJ, sampler="ddim"))
    S = ecfg.samples_per_seed + ecfg.samples_per_stride
    windows = np.zeros((B, bucket, S), np.float32)
    jstyles = np.zeros((B, 6), np.float32)
    for i, (a, s) in enumerate(zip(audios, styles)):
        win = jax_engine.slice_audio_windows(a, jsampler.cfg)
        windows[i, : len(win)] = win
        jstyles[i] = s
    feats = jsampler.wavlm_apply(pair["wparams"], windows.reshape(B * bucket, S))
    feats = feats.reshape((B, bucket) + feats.shape[1:])
    out = jax_engine._generate_multi(jsampler, pair["mparams"], feats, jstyles,
                                     jax.random.PRNGKey(0), bucket, noise)
    seq = jax_engine.unnormalize_poses(np.asarray(out)[:, :, 0].transpose(0, 2, 1),
                                       pair["mean"], pair["std"])
    for i, req in enumerate(batch):
        ref = seq[i, : req.num_windows * ecfg.stride - ecfg.n_seed]
        assert outs[i].shape == ref.shape
        assert rel_err(outs[i], ref) < 2e-3
