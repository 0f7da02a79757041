"""The text-to-motion system under test: `diffusestylegesture_torch`'s `TextMDM`
at HumanML3D widths, its CLIP text tower and `TextMotionSampler`, built as
`cli/generate.py` builds them (kernel B, float32 with TF32 off, DDPM over the
configuration's schedule), with weights the benchmark made, and the matching
plain reference (`perfbench/reference/t2m.py`).

A request spec: `words`, the length of its one prompt. The words, drawn from
the traffic's `vocabulary`, and the request's noise seed come from a
generator seeded with the run's seed and the request's id; the traffic fixes
the prompts a request, their repetitions, the guidance scale and the frames.
A request delivers every candidate motion: (repetitions × prompts, frames,
njoints) hml_vec features, un-normalized with the run's mean and std.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Dict, List

import numpy as np
import torch

from perfbench import counts
from perfbench.harness.compare import gap
from perfbench.reference import diffusion as ref_diffusion
from perfbench.reference import t2m as ref_t2m


def call_flops(B: int, T: int, cfg: dict) -> int:
    """FLOPs of one TextMDM call over B rows of T frames."""
    D, C = cfg["latent_dim"], cfg["njoints"] * cfg["nfeats"]
    el, _ = counts.encoder_layer(B, T + 1, D, cfg["num_heads"], cfg["ff_size"])
    return (2 * counts.linear(B, D, D) + counts.linear(B, cfg["clip"]["projection_dim"], D)
            + counts.linear(B * T, C, D) + cfg["num_layers"] * el + counts.linear(B * T, D, C))


def clip_flops(clip: dict) -> int:
    """FLOPs of the text tower over one prompt: the blocks' products, the causal
    scores and values over the keys a position may see, the projection."""
    L, W = clip["context_length"], clip["width"]
    block = (4 * counts.linear(L, W, W) + 2 * 2 * (L * (L + 1) // 2) * W
             + counts.linear(L, W, 4 * W) + counts.linear(L, 4 * W, W))
    return clip["layers"] * block + counts.linear(1, W, clip["projection_dim"])


class System:
    """Built once per process; `load` puts a seed's weights and inputs in place."""

    peak = "tf32"  # float32 operands: held against the TF32 rate (perfbench/counts)

    def __init__(self, cfg: dict, traffic: dict, device: torch.device):
        from diffusestylegesture_torch import diffusion as D
        from diffusestylegesture_torch.models.clip_text import make_caption_encoder
        from diffusestylegesture_torch.models.mdm_text import TextMDM, TextMDMConfig
        from diffusestylegesture_torch.sample import TextMotionSampler

        self.cfg, self.traffic, self.device = cfg, traffic, device
        if traffic.get("respace", 0):
            raise ValueError("the t2m system runs the configuration's own schedule")
        with torch.device(device):
            self.mdm = TextMDM(TextMDMConfig(
                njoints=cfg["njoints"], nfeats=cfg["nfeats"], latent_dim=cfg["latent_dim"],
                ff_size=cfg["ff_size"], num_layers=cfg["num_layers"],
                num_heads=cfg["num_heads"], activation=cfg["activation"],
                clip_dim=cfg["clip"]["projection_dim"], cond_mask_prob=cfg["cond_mask_prob"],
                impl="kernel")).eval()
        self.mdm.to(device)
        clip = cfg["clip"]
        self.encode, _ = make_caption_encoder(
            width=clip["width"], layers=clip["layers"], heads=clip["heads"],
            vocab_size=clip["vocab_size"], projection_dim=clip["projection_dim"],
            context_length=clip["context_length"], device=device)
        sched = D.Schedule.create(
            D.named_beta_schedule(cfg["noise_schedule"], cfg["diffusion_steps"]), device=device)
        self.steps = sched.num_timesteps
        self.engine = TextMotionSampler(self.mdm, self.encode, sched, traffic["sampler"],
                                        traffic["guidance"])
        self.rows = traffic["prompts"] * traffic["repetitions"]
        # the denoiser's batch: CFG runs the cond and uncond rows together
        self.batch = 2 * self.rows if traffic["guidance"] != 1.0 else self.rows

    def layouts(self) -> list:
        return [ref_t2m.mdm_layout(self.cfg), ref_t2m.clip_layout(self.cfg["clip"])]

    def load(self, weights: List[Dict[str, torch.Tensor]], seed: int) -> None:
        self.weights = weights
        self.mdm.load_state_dict(weights[0], strict=True)
        self.encode.encoder.load_state_dict(weights[1], strict=True)
        C = self.cfg["njoints"] * self.cfg["nfeats"]
        rng = np.random.default_rng([seed, 1])
        self.mean = rng.standard_normal(C).astype(np.float32)
        self.std = rng.uniform(0.05, 1.5, C).astype(np.float32)
        self.run_seed = seed

    def request(self, spec: dict):
        """(prompts, noise seed) of a request spec."""
        rng = np.random.default_rng([self.run_seed, 2, int(spec["id"])])
        vocab = self.traffic["vocabulary"]
        prompts = [" ".join(vocab[int(i)]
                            for i in rng.integers(len(vocab), size=int(spec["words"])))
                   for _ in range(self.traffic["prompts"])]
        return prompts, int(rng.integers(2 ** 62))

    def frames(self, spec: dict) -> int:
        return self.rows * self.traffic["frames"]

    def work(self, spec: dict) -> int:
        """Model FLOPs of a request: every guided denoiser call (the cond and
        uncond rows as one batch) and the text tower once a prompt."""
        t = self.traffic
        return (self.steps * call_flops(self.batch, t["frames"], self.cfg)
                + t["prompts"] * clip_flops(self.cfg["clip"]))

    def kernel_shapes(self) -> dict:
        c = self.cfg
        return {"encoder_layer": (self.batch, self.traffic["frames"] + 1, c["latent_dim"],
                                  c["num_heads"], c["ff_size"])}

    def start(self, seed: int, recorder) -> None:
        """The program of the cell's shape captured by one warm-up request (set-up)."""
        recorder.wrap(self.engine, "encode", "text")
        recorder.wrap(self.engine, "sample", "denoiser")
        t = self.traffic
        self.engine.generate(["a person walks forward"] * t["prompts"], t["frames"],
                             t["repetitions"], 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _generate(self, spec: dict) -> np.ndarray:
        prompts, seed = self.request(spec)
        t = self.traffic
        out = self.engine.generate(prompts, t["frames"], t["repetitions"], seed)
        return out[:, :, 0].transpose(1, 2).cpu().numpy() * self.std + self.mean

    def submit(self, spec: dict) -> Future:
        """Runs the request in the caller's thread; returns its resolved Future."""
        fut: Future = Future()
        try:
            fut.set_result(self._generate(spec))
        except Exception as e:  # the failure is the request's, counted as failed
            fut.set_exception(e)
        return fut

    def stop(self) -> None:
        pass

    def pick(self, specs: dict, done: dict, rng: np.random.Generator, n_rows: int) -> list:
        """A finished request and `n_rows` of its rows, drawn from the seed
        (every request has the same size): [(request id, [rows])]."""
        if not done:
            return []
        rids = sorted(done)
        rid = rids[int(rng.integers(len(rids)))]
        rows = sorted(int(r) for r in rng.choice(self.rows, size=min(n_rows, self.rows),
                                                 replace=False))
        return [(rid, rows)]

    def free(self) -> None:
        self.engine = self.mdm = self.encode = None

    def _normalized(self, precision: str, picks: list, specs: dict) -> dict:
        """The reference's normalized features of each picked row, in
        `precision`: request id → {row: (frames, C)}."""
        cfg, t, dev = self.cfg, self.traffic, self.device
        ref = ref_t2m.TextToMotion(cfg, self.weights[0], self.weights[1], dev, precision)
        sched = ref_diffusion.schedule(cfg, 0, dev)
        out = {}
        for rid, rows in picks:
            prompts, seed = self.request(specs[rid])
            ids = ref_t2m.hash_tokenize([prompts[r % len(prompts)] for r in rows],
                                        cfg["clip"]["context_length"], cfg["clip"]["vocab_size"])
            with torch.no_grad():
                x = ref.sample(torch.as_tensor(ids, device=dev), rows, self.rows, t["frames"],
                               seed, t["guidance"], sched)
            out[rid] = {r: x[k].cpu().numpy() for k, r in enumerate(rows)}
        return out

    def reference(self, precision: str, picks: list, specs: dict) -> dict:
        """The picked rows as `submit` would deliver them, computed by the
        reference in `precision` (the control puts these in the program's place)."""
        return {rid: {r: want * self.std + self.mean for r, want in rows.items()}
                for rid, rows in self._normalized(precision, picks, specs).items()}

    def compare(self, picks: list, specs: dict, outputs: dict) -> float:
        """The largest gap between a picked row and the float32 reference's,
        over normalized features."""
        worst = 0.0
        for rid, rows in self._normalized("float32", picks, specs).items():
            for r, want in rows.items():
                worst = max(worst, gap((outputs[rid][r] - self.mean) / self.std, want))
        return worst
