"""The TWH system under test: `diffusestylegesture_torch`'s MDM+ (`twh_mdm`
sizes) and `BeatTwhSampler`, built as `cli/sample_beat.py` builds them
(DiffuseStyleGesture+, DDPM over the configuration's schedule, the
reference's batch-axis crossfade), with weights the benchmark made, and the
matching plain reference (`perfbench/reference/twh.py`).

A request spec: `windows` whole windows (of n_poses − n_seed frames) of fused
text+audio features cut from the run's feature pool at `offset`, and a
one-hot `speaker`; the seed gesture, mean and std are the run's, made from
the seed.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Dict, List

import numpy as np
import torch

from perfbench import counts
from perfbench.harness.compare import gap
from perfbench.reference import diffusion as ref_diffusion
from perfbench.reference import twh as ref_twh


class System:
    """Built once per process; `load` puts a seed's weights and inputs in place."""

    peak = "tf32"  # float32 operands: held against the TF32 rate (perfbench/counts)

    def __init__(self, cfg: dict, traffic: dict, device: torch.device):
        from diffusestylegesture_torch import diffusion as D
        from diffusestylegesture_torch.models.mdm_plus import MDMPlus, MDMPlusConfig
        from diffusestylegesture_torch.sample import BeatEngineConfig, BeatTwhSampler

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.stride = cfg["n_poses"] - cfg["n_seed"]
        with torch.device(device):
            self.mdm = MDMPlus(MDMPlusConfig(
                njoints=cfg["njoints"], latent_dim=cfg["latent_dim"], ff_size=cfg["ff_size"],
                num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
                local_heads=cfg["local_heads"], source_audio_dim=cfg["source_audio_dim"],
                audio_feat_dim=cfg["audio_feat_dim"], style_dim_in=cfg["style_dim_in"],
                n_seed=cfg["n_seed"], cond_mode=cfg["cond_mode"],
                window_size=cfg["window_size"])).eval()
        self.mdm.to(device)
        self.sampler_name = traffic["sampler"]
        self.respace = traffic.get("respace", 0)
        if self.respace:
            raise ValueError("the TWH system runs the configuration's own schedule")
        sched = D.Schedule.create(
            D.named_beta_schedule(cfg["noise_schedule"], cfg["diffusion_steps"]), device=device)
        self.steps = sched.num_timesteps
        self.sampler = BeatTwhSampler(
            lambda mdm, x, t, cond, uncond=None: mdm(x, t, cond, uncond=uncond), sched,
            BeatEngineConfig(n_poses=cfg["n_poses"], n_seed=cfg["n_seed"],
                             njoints=cfg["njoints"], audio_dim=cfg["source_audio_dim"],
                             variant="attention4", sampler=self.sampler_name,
                             motion_feature_division=cfg["motion_feature_division"]),
            device=device)

    def layouts(self) -> list:
        return [ref_twh.layout(self.cfg)]

    def load(self, weights: List[Dict[str, torch.Tensor]], seed: int) -> None:
        self.weights = weights
        self.mdm.load_state_dict(weights[0], strict=True)
        cfg = self.cfg
        rng = np.random.default_rng([seed, 1])
        M = cfg["njoints"] // cfg["motion_feature_division"]
        self.mean = rng.standard_normal(M).astype(np.float32)
        self.std = rng.uniform(0.05, 1.5, M).astype(np.float32)
        self.seed_gesture = rng.standard_normal((cfg["n_seed"], cfg["njoints"])).astype(np.float32)
        longest = self.traffic["clips"]["windows"]["uniform_int"][1] * self.stride
        self.pool = rng.standard_normal((2 * longest, cfg["source_audio_dim"])).astype(np.float32)
        self.run_seed = seed

    def request(self, spec: dict):
        """(textaudio, speaker one-hot, generator seed) of a request spec."""
        n = self.frames(spec)
        start = int(spec["offset"] * (len(self.pool) - n))
        style = np.zeros(self.cfg["style_dim_in"], np.float32)
        style[int(spec["speaker"]) % self.cfg["style_dim_in"]] = 1.0
        gen_seed = int(np.random.default_rng([self.run_seed, 2, int(spec["id"])]).integers(2 ** 62))
        return self.pool[start:start + n], style, gen_seed

    def frames(self, spec: dict) -> int:
        return int(spec["windows"]) * self.stride

    def windows(self, spec: dict) -> int:
        return int(spec["windows"])

    def work(self, spec: dict) -> int:
        """Model FLOPs of a request: every denoiser call over its windows."""
        return self.windows(spec) * self.steps * counts.twh_call(1, self.cfg)

    def kernel_shapes(self) -> dict:
        c = self.cfg
        return {"encoder_layer": (1, c["n_poses"] + 1, c["latent_dim"], c["num_heads"],
                                  c["ff_size"]),
                "local_attention": (1, c["local_heads"], c["n_poses"],
                                    c["latent_dim"] // c["local_heads"], c["window_size"])}

    def start(self, seed: int, recorder) -> None:
        """The graphs of the B = 1 program captured by one one-window call (set-up)."""
        recorder.wrap(self.sampler, "generate", "denoiser")
        self._generate(np.zeros((self.stride, self.cfg["source_audio_dim"]), np.float32),
                       np.eye(self.cfg["style_dim_in"], dtype=np.float32)[0], 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _generate(self, textaudio, style, gen_seed):
        gen = torch.Generator(device=self.device).manual_seed(gen_seed)
        out = self.sampler.generate(self.mdm, textaudio, self.seed_gesture, style, gen,
                                    self.mean, self.std)
        return out[0]

    def submit(self, spec: dict) -> Future:
        """Runs the request in the caller's thread; returns its resolved Future."""
        fut: Future = Future()
        try:
            fut.set_result(self._generate(*self.request(spec)))
        except Exception as e:  # the failure is the request's, counted as failed
            fut.set_exception(e)
        return fut

    def stop(self) -> None:
        pass

    def pick(self, specs: dict, done: dict, rng: np.random.Generator, n_rows: int) -> list:
        """The longest clip finished in the window (ties drawn from the seed)."""
        if not done:
            return []
        longest = max(self.windows(specs[rid]) for rid in done)
        cands = sorted(rid for rid in done if self.windows(specs[rid]) == longest)
        return [cands[int(rng.integers(len(cands)))]]

    def free(self) -> None:
        self.sampler = self.mdm = None

    def _normalized(self, precision: str, picks: list, specs: dict) -> dict:
        """The reference's normalized poses of each picked request, in `precision`."""
        ref = ref_twh.Twh(self.cfg, self.weights[0], self.device, precision)
        sched = ref_diffusion.schedule(self.cfg, 0, self.device)
        dev, out = self.device, {}
        for rid in picks:
            textaudio, style, gen_seed = self.request(specs[rid])
            with torch.no_grad():
                out[rid] = ref.sample(torch.as_tensor(textaudio, device=dev),
                                      torch.as_tensor(self.seed_gesture, device=dev),
                                      torch.as_tensor(style, device=dev)[None], gen_seed,
                                      self.sampler_name, sched).cpu().numpy()
        return out

    def reference(self, precision: str, picks: list, specs: dict) -> dict:
        """The picked clips as `generate` would return them, computed by the
        reference in `precision` (the control puts these in the program's place)."""
        return {rid: want * self.std + self.mean
                for rid, want in self._normalized(precision, picks, specs).items()}

    def compare(self, picks: list, specs: dict, outputs: dict) -> float:
        """The largest gap between a picked clip and the float32 reference's."""
        worst = 0.0
        for rid, want in self._normalized("float32", picks, specs).items():
            worst = max(worst, gap((outputs[rid] - self.mean) / self.std, want))
        return worst
