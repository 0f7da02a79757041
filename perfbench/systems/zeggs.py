"""The ZEGGS system under test: `diffusestylegesture_torch`'s MDM, WavLM-Large,
`ZeggsSampler` and `GestureServer`, built as `cli/serve.py` builds them, with
weights the benchmark made (loaded by name, strictly), and the matching
plain reference (`perfbench/reference/zeggs.py`).

A request spec: `windows` strides of 16 kHz audio plus `extra` of one more
stride, cut from the run's audio pool at `offset` (a share of the room
left), and a one-hot `style`.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Dict, List

import numpy as np
import torch

from perfbench import counts
from perfbench.harness.compare import gap
from perfbench.reference import diffusion as ref_diffusion
from perfbench.reference import wavlm as ref_wavlm
from perfbench.reference import zeggs as ref_zeggs


def engine_config(cfg: dict) -> dict:
    """The configuration with the sizes the engine and the reference derive from it."""
    out = dict(cfg)
    out["fps"] = cfg["motion_resampling_framerate"]
    out["stride"] = cfg["n_poses"] - cfg["n_seed"]
    out["samples_per_stride"] = out["stride"] * cfg["sr"] // out["fps"]
    out["window_samples"] = cfg["n_poses"] * cfg["sr"] // out["fps"]
    return out


class System:
    """Built once per process; `load` puts a seed's weights and inputs in place."""

    peak = "tf32"  # float32 operands: held against the TF32 rate (perfbench/counts)

    def __init__(self, cfg: dict, traffic: dict, device: torch.device):
        from diffusestylegesture_torch import diffusion as D
        from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
        from diffusestylegesture_torch.models.wavlm import WavLM, WavLMConfig, make_zeggs_wavlm_fn
        from diffusestylegesture_torch.sample import ZeggsEngineConfig, ZeggsSampler

        self.cfg = cfg = engine_config(cfg)
        self.traffic, self.device = traffic, device
        w = cfg["wavlm"]
        wcfg = WavLMConfig(
            extractor_mode=w["extractor_mode"], encoder_layers=w["encoder_layers"],
            encoder_embed_dim=w["encoder_embed_dim"],
            encoder_ffn_embed_dim=w["encoder_ffn_embed_dim"],
            encoder_attention_heads=w["encoder_attention_heads"],
            layer_norm_first=w["layer_norm_first"],
            conv_feature_layers=tuple(tuple(c) for c in w["conv_feature_layers"]),
            conv_pos=w["conv_pos"], conv_pos_groups=w["conv_pos_groups"],
            num_buckets=w["num_buckets"], max_distance=w["max_distance"])
        mcfg = MDMConfig(
            njoints=cfg["njoints"], latent_dim=cfg["latent_dim"], ff_size=cfg["ff_size"],
            num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
            local_heads=cfg["local_heads"], n_seed=cfg["n_seed"], cond_mode=cfg["cond_mode"],
            audio_feat="wavlm", audio_in_dim=w["encoder_embed_dim"],
            style_dim_in=cfg["style_dim_in"], style_dim=cfg["style_dim"],
            window_size=cfg["window_size"])
        with torch.device(device):
            self.wavlm = WavLM(wcfg).eval()
            self.mdm = MDM(mcfg).eval()
        self.wavlm.to(device)
        self.mdm.to(device)
        self.sampler_name, self.respace = traffic["sampler"], traffic.get("respace", 0)
        betas = D.named_beta_schedule(cfg["noise_schedule"], cfg["diffusion_steps"])
        if self.respace:
            sched = D.spaced_schedule(
                betas, D.space_timesteps(cfg["diffusion_steps"], f"ddim{self.respace}"),
                device=device)
        else:
            sched = D.Schedule.create(betas, device=device)
        self.steps = sched.num_timesteps
        self.sampler = ZeggsSampler(
            lambda mdm, x, t, cond, uncond=None: mdm(x, t, cond, uncond=uncond),
            make_zeggs_wavlm_fn(cfg["n_poses"]), sched,
            ZeggsEngineConfig(n_poses=cfg["n_poses"], n_seed=cfg["n_seed"],
                              njoints=cfg["njoints"], fps=cfg["fps"], sr=cfg["sr"],
                              crossfade_n=traffic["server"]["crossfade_n"],
                              sampler=self.sampler_name),
            device=device)
        self.server = None

    # -- weights and inputs, made by the benchmark from the seed -------------

    def layouts(self) -> list:
        return [ref_zeggs.layout(self.cfg), ref_wavlm.layout(self.cfg["wavlm"])]

    def load(self, weights: List[Dict[str, torch.Tensor]], seed: int) -> None:
        self.weights = weights
        self.mdm.load_state_dict(weights[0], strict=True)
        self.wavlm.load_state_dict(weights[1], strict=True)
        rng = np.random.default_rng([seed, 1])
        C = self.cfg["njoints"]
        self.mean = rng.standard_normal(C).astype(np.float32)
        self.std = rng.uniform(0.05, 1.5, C).astype(np.float32)
        longest = self.traffic["clips"]["windows"]["uniform_int"][1] + 1
        self.pool = (0.1 * rng.standard_normal(
            2 * longest * self.cfg["samples_per_stride"])).astype(np.float32)

    def request(self, spec: dict):
        """(audio, style) of a request spec."""
        sps = self.cfg["samples_per_stride"]
        n = int(spec["windows"]) * sps + int(spec["extra"] * (sps - 1))
        start = int(spec["offset"] * (len(self.pool) - n))
        style = np.zeros(self.cfg["style_dim_in"], np.float32)
        style[int(spec["style"]) % self.cfg["style_dim_in"]] = 1.0
        return self.pool[start:start + n], style

    def frames(self, spec: dict) -> int:
        """Motion frames a request delivers."""
        return int(spec["windows"]) * self.cfg["stride"] - self.cfg["n_seed"]

    def windows(self, spec: dict) -> int:
        """Windows the program samples for a request (its FLOPs count these)."""
        return int(spec["windows"])

    def work(self, spec: dict) -> int:
        """Model FLOPs of a request: WavLM and every denoiser call over its own windows."""
        return self.windows(spec) * (
            self.steps * counts.zeggs_call(1, self.cfg)
            + counts.wavlm_window(self.cfg["wavlm"], self.cfg["window_samples"]))

    def kernel_shapes(self) -> dict:
        """Each kernel's arguments at the served batch (the server pads to max_batch)."""
        c, B = self.cfg, self.traffic["server"]["max_batch"]
        return {"encoder_layer": (B, c["n_poses"] + 1, c["latent_dim"], c["num_heads"],
                                  c["ff_size"]),
                "local_attention": (B, c["local_heads"], c["n_poses"],
                                    c["latent_dim"] // c["local_heads"], c["window_size"])}

    # -- the entry the window drives ------------------------------------------

    def start(self, seed: int, recorder) -> None:
        """The server as the serve CLI builds it, its engine's graphs for every
        bucket the traffic reaches captured beforehand (part of set-up)."""
        from diffusestylegesture_torch.sample import GestureServer, ServerConfig

        scfg, sampler, cfg, dev = self.traffic["server"], self.sampler, self.cfg, self.device
        recorder.wrap(sampler, "encode", "wavlm", count=lambda args: int(args[1].shape[0]))
        recorder.wrap(sampler, "sample_windows", "denoiser")

        class Recording(GestureServer):
            """Records each batch's seed, its requests in row order and its window count."""

            def _dispatch_batch(self, batch):
                out = super()._dispatch_batch(batch)
                self.batches.append((batch[0].seed, [r.future for r in batch],
                                     max(r.num_windows for r in batch)))
                return out

        self.server = Recording(
            sampler, self.mdm, self.wavlm, mean=self.mean, std=self.std,
            cfg=ServerConfig(max_batch=scfg["max_batch"], max_delay_ms=scfg["max_delay_ms"],
                             window_buckets=tuple(scfg["window_buckets"])), seed=seed)
        self.server.batches = []
        recorder.wrap(self.server, "_finalize_batch", "deliver")
        B, S = scfg["max_batch"], cfg["window_samples"]
        lo, hi = self.traffic["clips"]["windows"]["uniform_int"]
        buckets = sorted({self.server._bucket_for(n) for n in range(lo, hi + 1)})
        with torch.inference_mode():
            for b in buckets:
                feats = sampler.encode(self.wavlm, torch.zeros(B * b, S, device=dev))
            feats = feats.reshape((B, -1) + tuple(feats.shape[1:]))
            sampler.sample_windows(self.mdm, lambda w: feats[:, w], 1,
                                   torch.zeros(B, cfg["style_dim_in"], device=dev),
                                   torch.Generator(device=dev).manual_seed(0))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.server.start()

    def submit(self, spec: dict) -> Future:
        audio, style = self.request(spec)
        return self.server.submit(audio, style)

    def stop(self) -> None:
        self.server.stop(timeout=120.0)

    def pick(self, specs: dict, done: dict, rng: np.random.Generator, n_rows: int) -> list:
        """What to compare, drawn from the seed: the batch holding the longest
        clip finished in the window, and up to `n_rows` of its finished clips,
        the longest among them. `done`: request id → Future. Returns
        [(batch seed, batch rows, windows, [(row, request id)])]."""
        rid_of = {id(f): rid for rid, f in done.items()}
        found = [b for b in self.server.batches if any(id(f) in rid_of for f in b[1])]
        if not found:
            return []
        longest = max(max(int(specs[rid_of[id(f)]]["windows"]) for f in futs if id(f) in rid_of)
                      for _, futs, _ in found)
        cands = [b for b in found if any(id(f) in rid_of and
                                         int(specs[rid_of[id(f)]]["windows"]) == longest
                                         for f in b[1])]
        seed, futs, _ = cands[int(rng.integers(len(cands)))]
        rows = sorted(((i, rid_of[id(f)]) for i, f in enumerate(futs) if id(f) in rid_of),
                      key=lambda r: -int(specs[r[1]]["windows"]))
        rest = rows[1:]
        extra = [rest[i] for i in sorted(rng.choice(len(rest), size=min(n_rows - 1, len(rest)),
                                                    replace=False))] if rest else []
        keep = sorted([rows[0]] + extra)
        # the server pads every batch to max_batch rows, and the noise is drawn for all of them
        return [(seed, self.traffic["server"]["max_batch"], longest, keep)]

    def free(self) -> None:
        """Drop the program's state: server, sampler and its graphs, modules."""
        self.server = self.sampler = self.mdm = self.wavlm = None

    # -- the comparison --------------------------------------------------------

    def _normalized(self, precision: str, picks: list, specs: dict) -> dict:
        """The reference's poses of each picked request, computed in
        `precision`, normalized: request id → (frames, C)."""
        ref = ref_zeggs.Zeggs(self.cfg, self.weights[0], self.weights[1], self.device, precision)
        sched = ref_diffusion.schedule(self.cfg, self.respace, self.device)
        out = {}
        for seed, full, nw, rows in picks:
            reqs = [self.request(specs[rid]) for _, rid in rows]
            wins = [ref_zeggs.slice_windows(torch.as_tensor(a, device=self.device), self.cfg)
                    for a, _ in reqs]
            # windows past a clip's end are zeros, as the server pads them
            padded = torch.zeros(len(rows), nw, self.cfg["window_samples"], device=self.device)
            for k, w in enumerate(wins):
                padded[k, :min(nw, w.shape[0])] = w[:nw]
            with torch.no_grad():
                feats = ref.features(padded.reshape(len(rows) * nw, -1))
                feats = feats.reshape((len(rows), nw) + tuple(feats.shape[1:]))
                styles = torch.as_tensor(np.stack([s for _, s in reqs]), device=self.device)
                seq = ref.sample(feats, styles, seed, full, [r for r, _ in rows], nw,
                                 self.sampler_name, sched, self.traffic["server"]["crossfade_n"])
            for k, (_, rid) in enumerate(rows):
                out[rid] = seq[k, :self.frames(specs[rid])].cpu().numpy()
        return out

    def _std(self) -> np.ndarray:
        return np.clip(self.std, 0.01, None)

    def reference(self, precision: str, picks: list, specs: dict) -> dict:
        """The picked requests' poses as the server would deliver them, computed
        by the reference in `precision` (the control puts these in the
        program's place)."""
        return {rid: want * self._std() + self.mean
                for rid, want in self._normalized(precision, picks, specs).items()}

    def compare(self, picks: list, specs: dict, outputs: dict) -> float:
        """The largest gap (`compare.gap`) between a picked request's delivered
        poses and the float32 reference's, over normalized poses."""
        worst = 0.0
        for rid, want in self._normalized("float32", picks, specs).items():
            got = (outputs[rid] - self.mean) / self._std()
            worst = max(worst, gap(got, want))
        return worst
