"""The port's program spans (`utils/profiling.py`), on the CPU and, for graph
captures, on the card.

Tracing is off by default and a served batch then records nothing. Spans
nest, each taking its parent from the spans open on its own thread; a span
recorded across threads has no thread. Spans are stamped on the clock of the
profiler's host events: a `record_function` range opened inside a span lies
within it. A `GestureServer` on a toy model records one `server.request` span
a resolved request and a collect, dispatch and finalize span a batch, with
its request ids; a dispatch's rows and windows add up, and its padding and
skipped windows match the server's always-on counters. `BeatTwhSampler.generate` records
one `engine.window` a window with the schedule's steps, its `engine.begin`
saying whether the conditioning invariants were computed there (`cond`:
`precomputed`, or `per_step` in a guided run); `TextMotionSampler.
generate` one `t2m.generate` around `t2m.encode` and `t2m.sample`, which holds
`t2m.steps`, and nothing while tracing is off. On the card each
graph capture is a `graphs.capture` span that says what it captured: the
server's encoder one graph a packed window count.

Imports neither jax nor the JAX package: on a machine with a card and no JAX,
run the card's case with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing.py
"""
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from diffusestylegesture_torch import diffusion as D
from diffusestylegesture_torch import resolve_device
from diffusestylegesture_torch.models.clip_text import make_caption_encoder
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.models.mdm_text import TextMDM, TextMDMConfig
from diffusestylegesture_torch.models.mdm_plus import MDMPlus, MDMPlusConfig
from diffusestylegesture_torch.sample import (BeatEngineConfig, BeatTwhSampler, GestureServer,
                                              ServerConfig, TextMotionSampler, ZeggsEngineConfig,
                                              ZeggsSampler)
from diffusestylegesture_torch.utils import profiling

NJ, FEAT, MAX_BATCH, BUCKETS, STEPS = 16, 32, 4, (1, 2, 4), 3


@pytest.fixture
def tracing():
    profiling.clear()
    profiling.enable(True)
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.clear()


def _apply(mdm, x, t, cond, uncond=None):
    return mdm(x, t, cond, uncond=uncond)


def _wavlm_stub(_params, windows):
    return torch.zeros((windows.shape[0], 88, FEAT), device=windows.device) + windows.mean()


def _sampler(device, steps=STEPS):
    sched = D.Schedule.create(D.named_beta_schedule("cosine", steps), device=device)
    return ZeggsSampler(_apply, _wavlm_stub, sched, ZeggsEngineConfig(njoints=NJ), device=device)


def _server(device="cpu"):
    torch.manual_seed(0)
    model = MDM(MDMConfig(njoints=NJ, latent_dim=96, ff_size=64, num_layers=1, n_seed=8,
                          audio_in_dim=FEAT)).eval().to(device)
    return GestureServer(_sampler(device), model, {}, mean=np.zeros(NJ, np.float32),
                         std=np.ones(NJ, np.float32),
                         cfg=ServerConfig(max_batch=MAX_BATCH, max_delay_ms=300.0,
                                          window_buckets=BUCKETS))


def _serve(server, windows):
    """Clips of the given window counts, submitted together; their poses."""
    sps = server.sampler.cfg.samples_per_stride
    rng = np.random.default_rng(0)
    server.start()
    try:
        futs = [server.submit(rng.standard_normal(w * sps + 100).astype(np.float32),
                              np.eye(6, dtype=np.float32)[i % 6]) for i, w in enumerate(windows)]
        return [f.result(timeout=300) for f in futs]
    finally:
        server.stop()


def test_tracing_off_records_no_span():
    assert not profiling.enabled()
    profiling.clear()
    poses = _serve(_server(), [1, 2])
    assert len(poses) == 2 and profiling.spans() == []
    with profiling.span("off") as sp:
        assert not sp
        sp.set(never=1)
    assert profiling.record("off", 0, 1) is None and profiling.spans() == []


def test_spans_nest_by_thread(tracing):
    with profiling.span("outer", a=1) as outer:
        with profiling.span("inner") as inner:
            inner.set(b=2)
        with profiling.span("dropped") as dropped:
            dropped.drop()

        def other():
            with profiling.span("other thread"):
                pass
        t = threading.Thread(target=other)
        t.start()
        t.join(30)
        assert not t.is_alive()
    rid = profiling.record("request", 5, 9, parent=outer.id, c=3)
    got = {sp.name: sp for sp in profiling.spans()}
    assert set(got) == {"outer", "inner", "other thread", "request"}
    assert got["outer"].parent is None and got["outer"].attrs == {"a": 1}
    assert got["inner"].parent == got["outer"].id and got["inner"].attrs == {"b": 2}
    assert got["other thread"].parent is None
    assert got["other thread"].thread != got["outer"].thread == threading.get_ident()
    assert got["request"] == profiling.Span(rid, outer.id, "request", 5, 9, None, {"c": 3})
    assert got["outer"].start_ns <= got["inner"].start_ns <= got["inner"].end_ns \
        <= got["outer"].end_ns
    assert len({sp.id for sp in got.values()}) == 4
    profiling.clear()
    assert profiling.spans() == []


def test_spans_share_the_profiler_clock(tracing):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with record_function("inner_range"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    outer = [sp for sp in profiling.spans() if sp.name == "outer"][0]
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner_range"]
    assert ranges
    for e in ranges:
        assert outer.start_ns <= e.start_ns() <= e.end_ns() <= outer.end_ns


def test_server_spans_and_counters(tracing):
    server = _server()
    windows = [1, 1, 3, 2]
    poses = _serve(server, windows)
    assert [p.shape[0] for p in poses] == [w * 80 - 8 for w in windows]
    spans = profiling.spans()
    by_name = {}
    for sp in spans:
        by_name.setdefault(sp.name, []).append(sp)

    requests = {sp.attrs["request"]: sp for sp in by_name["server.request"]}
    assert len(requests) == len(windows) == len(by_name["server.request"])
    assert sorted(sp.attrs["windows"] for sp in requests.values()) == sorted(windows)
    assert all(sp.thread is None and not sp.attrs["failed"] for sp in requests.values())
    dispatches = by_name["server.dispatch"]
    assert sorted(r for d in dispatches for r in d.attrs["requests"]) == sorted(requests)
    for name in ("server.collect", "server.finalize"):
        assert sorted(sp.attrs["batch"] for sp in by_name[name]) == \
            sorted(d.attrs["batch"] for d in dispatches)
    padding = skipped = 0
    for d in dispatches:
        a = d.attrs
        assert a["batch"] == a["requests"][0]
        assert a["rows_real"] + a["rows_padded"] == MAX_BATCH == len(a["requests"]) + \
            a["rows_padded"]
        # WavLM runs over the carried windows rounded up to whole chunks, at most the grid
        grid, C = MAX_BATCH * a["bucket"], ZeggsSampler.ENCODE_CHUNK
        assert a["windows_encoded"] == min(-(-a["windows_carried"] // C) * C, grid)
        assert a["windows_skipped"] == grid - a["windows_encoded"]
        skipped += a["windows_skipped"]
        real = [requests[r].attrs["windows"] for r in a["requests"]]
        assert a["windows_carried"] == sum(real) and a["windows_sampled"] == max(real)
        assert all(requests[r].attrs["bucket"] == a["bucket"] for r in a["requests"])
        assert all(requests[r].start_ns <= d.start_ns < d.end_ns <= requests[r].end_ns
                   for r in a["requests"])
        padding += a["windows_encoded"] - a["windows_carried"]
        # the engine's spans of this batch nest under its dispatch
        inside = [sp for sp in spans if sp.parent == d.id]
        assert Counter(sp.name for sp in inside) == {"engine.encode": 1,
                                                     "engine.window": a["windows_sampled"]}
        enc = [sp for sp in inside if sp.name == "engine.encode"][0]
        assert enc.attrs == {"windows": a["windows_encoded"], "path": "eager"}
        begins = [sp for w in inside if w.name == "engine.window" for sp in spans
                  if sp.parent == w.id and sp.name == "engine.begin"]
        assert [sp.attrs for sp in begins] == [{"cond": "precomputed"}] * a["windows_sampled"]
    assert padding == server.windows_padding and skipped == server.windows_skipped
    assert server.windows_encoded == sum(d.attrs["windows_encoded"] for d in dispatches)
    assert server.rows_padded == sum(d.attrs["rows_padded"] for d in dispatches)
    assert server.requests_by_bucket == dict(Counter(requests[r].attrs["bucket"]
                                                     for r in requests))
    assert server.counters()["served"] == len(windows)
    assert server.counters()["cond_encodes"] == sum(
        d.attrs["windows_sampled"] for d in dispatches)


def test_beat_generate_spans_a_window_each(tracing):
    cfg = dict(njoints=36, latent_dim=96, ff_size=64, num_layers=1, source_audio_dim=40,
               audio_feat_dim=32, style_dim_in=4, n_seed=5, window_size=15)
    torch.manual_seed(0)
    model = MDMPlus(MDMPlusConfig(**cfg, cond_mode="cross_local_attention4_style1")).eval()
    steps = 4
    sched = D.Schedule.create(D.named_beta_schedule("cosine", steps), device="cpu")
    sampler = BeatTwhSampler(_apply, sched, BeatEngineConfig(
        n_poses=30, n_seed=5, njoints=36, audio_dim=40, variant="attention4"), device="cpu")
    rng = np.random.default_rng(0)
    out = sampler.generate(model, rng.standard_normal((60, 40)).astype(np.float32),
                           rng.standard_normal((5, 36)).astype(np.float32),
                           np.eye(4, dtype=np.float32)[1], torch.Generator().manual_seed(0),
                           np.zeros(12, np.float32), np.ones(12, np.float32))
    assert out.shape == (1, 60, 12)
    spans = profiling.spans()
    gen = [sp for sp in spans if sp.name == "beat.generate"]
    assert len(gen) == 1 and gen[0].attrs == {"windows": 3, "frames": 60}
    top = Counter(sp.name for sp in spans if sp.parent == gen[0].id)
    assert top == {"beat.prepare": 1, "engine.window": 3, "beat.output": 1}
    windows = sorted((sp for sp in spans if sp.name == "engine.window"),
                     key=lambda sp: sp.start_ns)
    assert [w.attrs for w in windows] == [{"window": i, "rows": 1} for i in range(3)]
    for w in windows:
        kids = sorted((sp for sp in spans if sp.parent == w.id), key=lambda sp: sp.start_ns)
        assert [k.name for k in kids] == ["engine.begin", "engine.steps", "engine.finish"]
        assert kids[0].attrs == {"cond": "precomputed"} and kids[1].attrs == {"steps": steps}
    assert sampler.cond_encodes == 3


def test_guided_windows_span_their_per_step_conditioning(tracing):
    """A guided ZEGGS run computes its conditioning at every step: each
    window's `engine.begin` says `per_step` and `cond_encodes` stays 0."""
    torch.manual_seed(0)
    model = MDM(MDMConfig(njoints=NJ, latent_dim=96, ff_size=64, num_layers=1, n_seed=8,
                          audio_in_dim=FEAT)).eval()
    sched = D.Schedule.create(D.named_beta_schedule("cosine", STEPS), device="cpu")
    sampler = ZeggsSampler(_apply, _wavlm_stub, sched,
                           ZeggsEngineConfig(njoints=NJ, guidance_scale=2.0), device="cpu")
    audio = np.random.default_rng(1).standard_normal(2 * 64000 + 9).astype(np.float32)
    sampler.generate(model, {}, audio, np.eye(6, dtype=np.float32)[[2]],
                     torch.Generator().manual_seed(0))
    begins = [sp for sp in profiling.spans() if sp.name == "engine.begin"]
    assert [sp.attrs for sp in begins] == [{"cond": "per_step"}] * 2
    assert sampler.cond_encodes == 0


def test_t2m_generate_spans_encode_and_sample():
    """`TextMotionSampler.generate` records its spans only while tracing is on."""
    clip = dict(width=32, layers=1, heads=2, vocab_size=100, projection_dim=16,
                context_length=8)
    torch.manual_seed(0)
    model = TextMDM(TextMDMConfig(njoints=NJ, latent_dim=32, ff_size=64, num_layers=1,
                                  num_heads=2, clip_dim=16)).eval()
    encode, _ = make_caption_encoder(**clip, device="cpu")
    sched = D.Schedule.create(D.named_beta_schedule("cosine", STEPS), device="cpu")
    engine = TextMotionSampler(model, encode, sched, "ddpm", 2.5)
    profiling.clear()
    engine.generate(["a person walks"], 8, 2, 0)
    assert profiling.spans() == []
    profiling.enable(True)
    try:
        out = engine.generate(["a person walks", "a man waves"], 8, 2, 0)
        spans = profiling.spans()
    finally:
        profiling.enable(False)
        profiling.clear()
    assert out.shape == (4, NJ, 1, 8)
    gen, = [sp for sp in spans if sp.name == "t2m.generate"]
    assert gen.attrs == {"prompts": 2, "rows": 4, "frames": 8}
    kids = sorted((sp for sp in spans if sp.parent == gen.id), key=lambda sp: sp.start_ns)
    assert [k.name for k in kids] == ["t2m.encode", "t2m.sample"]
    assert kids[0].attrs == {"prompts": 2, "tokens": 2 * 2 + 3 + 3}  # words + start / end
    assert kids[1].attrs == {"path": "eager"}
    steps, = [sp for sp in spans if sp.parent == kids[1].id]
    assert steps.name == "t2m.steps" and steps.attrs == {"steps": STEPS}
    assert len(spans) == 4


def test_trace_capture_restores_tracing(tmp_path):
    assert not profiling.enabled()
    with profiling.trace_capture(str(tmp_path)):
        assert profiling.enabled()
        with profiling.span("traced"):
            pass
    assert not profiling.enabled()
    assert [sp.name for sp in profiling.spans()] == ["traced"]
    profiling.clear()


@pytest.mark.cuda
def test_graph_captures_are_spans_on_the_card(tracing):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = resolve_device("cuda")
    poses = _serve(_server(dev), [1, 3, 2])
    assert [p.shape[0] for p in poses] == [72, 232, 152]
    spans = profiling.spans()
    caps = [sp for sp in spans if sp.name == "graphs.capture"]
    encoders = sorted(sp.attrs["shape"][0] for sp in caps if sp.attrs["what"] == "encoder")
    # one graph a packed window count: bucket 1's grid of 4 windows, then 8 (a chunk) for
    # the 2- and 3-window clips of buckets 2 and 4, whose second batch replays it
    assert encoders == [MAX_BATCH * 1, ZeggsSampler.ENCODE_CHUNK]
    steps = [sp for sp in caps if sp.attrs["what"] != "encoder"]
    assert steps and all(sp.attrs["batch"] == MAX_BATCH and sp.end_ns > sp.start_ns
                         for sp in steps)
    enc = [sp for sp in spans if sp.name == "engine.encode"]
    assert Counter(sp.attrs["path"] for sp in enc) == {"capture": 2, "replay": 1}
    begins = [sp for sp in spans if sp.name == "engine.begin"]
    assert len(begins) == 1 + 3 + 2 and all(sp.attrs == {"cond": "precomputed"} for sp in begins)
    # each capture nests in the span that needed it
    ids = {sp.id: sp.name for sp in spans}
    assert {ids[sp.parent] for sp in caps} == {"engine.encode", "engine.begin"}
