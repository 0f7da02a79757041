"""`sample/engine_t2m.py::TextMotionSampler` against the benchmark's plain
reference (`perfbench/reference/t2m.py`), on seeded random weights loaded into
both by name.

At toy widths on the CPU (latent 64, 2 layers of 2 heads, 24 frames; a CLIP
tower of width 64, 2 layers, a vocabulary of 1,000 and 16 tokens; 10 DDPM
steps): the text tower alone, and whole guided requests, agree within 1e-5
max abs; two requests with one seed are bitwise equal; the eager path counts
requests and rows and captures nothing. On the card (`cuda`; no JAX here, so
run with `python -m pytest --noconftest -p no:cacheprovider -q
tests/test_torch_t2m_engine.py`): the replays equal the eager loop bitwise,
two requests of one shape make one capture, and every step launches kernel B
once a layer.
"""
import numpy as np
import pytest
import torch

from diffusestylegesture_torch import diffusion as D
from diffusestylegesture_torch.models.clip_text import make_caption_encoder
from diffusestylegesture_torch.models.mdm_text import TextMDM, TextMDMConfig
from diffusestylegesture_torch.sample import TextMotionSampler
from perfbench.harness import weights as bench_weights
from perfbench.reference import diffusion as ref_diffusion
from perfbench.reference import t2m as ref_t2m

CFG = dict(njoints=263, nfeats=1, latent_dim=64, ff_size=128, num_layers=2, num_heads=2,
           diffusion_steps=10, noise_schedule="cosine",
           clip=dict(vocab_size=1000, width=64, layers=2, heads=4, context_length=16,
                     projection_dim=64))
FRAMES, REPS, SEED = 24, 2, 2 ** 33 + 17
PROMPTS = ["a person walks forward slowly", "a man waves his right hand twice"]
# The CPU bar of the sampling loops: program and reference make the same float32
# products on the same CPU, in other orders (the attention scale divided or
# multiplied, the tables built in float64 or float32), so they part by rounding.
ATOL = 1e-5


def build(device, seed=7):
    """(engine, reference) on the same seeded weights."""
    w = bench_weights.make([ref_t2m.mdm_layout(CFG), ref_t2m.clip_layout(CFG["clip"])], seed,
                           device)
    clip = CFG["clip"]
    model = TextMDM(TextMDMConfig(njoints=CFG["njoints"], latent_dim=CFG["latent_dim"],
                                  ff_size=CFG["ff_size"], num_layers=CFG["num_layers"],
                                  num_heads=CFG["num_heads"], clip_dim=clip["projection_dim"]))
    model.load_state_dict(w[0])
    model = model.to(device).eval()
    encode, _ = make_caption_encoder(width=clip["width"], layers=clip["layers"],
                                     heads=clip["heads"], vocab_size=clip["vocab_size"],
                                     projection_dim=clip["projection_dim"],
                                     context_length=clip["context_length"], device=device)
    encode.encoder.load_state_dict(w[1])
    sched = D.Schedule.create(D.named_beta_schedule("cosine", CFG["diffusion_steps"]),
                              device=device)
    return (lambda **kw: TextMotionSampler(model, encode, sched, "ddpm", 2.5, **kw),
            ref_t2m.TextToMotion(CFG, w[0], w[1], device))


def test_text_tower_matches_the_reference():
    make, ref = build("cpu")
    engine = make()
    ids = ref_t2m.hash_tokenize(PROMPTS, CFG["clip"]["context_length"], CFG["clip"]["vocab_size"])
    assert np.array_equal(ids, engine.tokenize(PROMPTS))
    with torch.no_grad():
        want = ref.encode(torch.as_tensor(ids))
    got = engine.encode(PROMPTS)
    assert got.shape == (2, CFG["clip"]["projection_dim"])
    assert float((got - want).abs().max()) <= ATOL


def test_guided_requests_match_the_reference():
    make, ref = build("cpu")
    got = make().generate(PROMPTS, FRAMES, REPS, SEED)
    assert got.shape == (REPS * len(PROMPTS), CFG["njoints"], 1, FRAMES)
    rows = list(range(REPS * len(PROMPTS)))
    ids = ref_t2m.hash_tokenize([PROMPTS[r % len(PROMPTS)] for r in rows],
                                CFG["clip"]["context_length"], CFG["clip"]["vocab_size"])
    with torch.no_grad():
        want = ref.sample(torch.as_tensor(ids), rows, len(rows), FRAMES, SEED, 2.5,
                          ref_diffusion.schedule(CFG, 0, "cpu"))
    err = float((got[:, :, 0].transpose(1, 2) - want).abs().max())
    assert err <= ATOL, err
    assert float(want.abs().mean()) > 0.1  # a real sample, not a vanishing one


def test_same_seed_is_bitwise_equal_and_the_eager_path_captures_nothing():
    make, _ = build("cpu")
    engine = make()
    a = engine.generate(PROMPTS[:1], FRAMES, 3, SEED)
    b = engine.generate(PROMPTS[:1], FRAMES, 3, SEED)
    c = engine.generate(PROMPTS[:1], FRAMES, 3, SEED + 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert engine.counters() == {"requests": 3, "rows": 9, "captures": 0, "replays": 0}
    assert engine.capture_seconds == 0.0
    with pytest.raises(ValueError, match="CUDA graphs"):
        make(graphs=True)


@pytest.mark.cuda
def test_cuda_replays_equal_the_eager_loop_and_capture_once():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from diffusestylegesture_torch.ops import build as kernels
    from diffusestylegesture_torch.ops import encoder_layer as el

    kernels.build_all()
    make, _ = build(torch.device("cuda"))
    captured, eager = make(), make(graphs=False)
    before = el.launches
    first = captured.generate(PROMPTS, FRAMES, REPS, SEED)
    second = captured.generate(PROMPTS, FRAMES, REPS, SEED)
    torch.cuda.synchronize()
    assert el.launches - before == 2 * CFG["diffusion_steps"] * CFG["num_layers"]
    assert captured.counters() == {"requests": 2, "rows": 8, "captures": 1, "replays": 2}
    other = captured.generate(PROMPTS[:1], FRAMES, 3, SEED)  # a second shape: a capture
    assert captured.counters()["captures"] == 2 and other.shape[0] == 3
    want = eager.generate(PROMPTS, FRAMES, REPS, SEED)
    assert torch.equal(first, second) and torch.equal(first, want)
    assert eager.counters()["captures"] == 0
