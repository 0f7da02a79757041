"""Motion-quality gate for fast serving modes, read-only.

Port of `diffusestylegesture_tpu/sample/quality_gate.py`. The JAX
package's quality harness trained a real MDM, generated with each serving
mode and scored FGD and sample diversity against DDPM-1000; its verdicts
are shipped in `resources/quality_gate.json` (a copy of the JAX package's
manifest). The sampling CLI refuses a mode measured as degraded unless
told `--allow_degraded`; unmeasured modes pass with a note. The verdicts
carry over to this port only while its engine agrees with the JAX engine
(`tests/test_torch_engine.py`).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

MANIFEST_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "resources", "quality_gate.json",
)


def mode_key(sampler: str, respace: int, diffusion_steps: int) -> Optional[str]:
    """Manifest key of a serving mode; None = the ungated full-schedule DDPM."""
    if sampler == "ddpm" and not respace:
        return None
    return f"{sampler}{respace or diffusion_steps}"


def load_manifest(path: Optional[str] = None, family: str = "zeggs") -> Optional[dict]:
    """Family section of the manifest (a flat v1 manifest is the ZEGGS section)."""
    path = path or MANIFEST_PATH
    if not os.path.exists(path):
        return None
    with open(path) as f:
        raw = json.load(f)
    if "families" in raw:
        return raw["families"].get(family.lower())
    return raw if family.lower() == "zeggs" else None


def check_mode(sampler: str, respace: int, diffusion_steps: int,
               manifest: Optional[dict] = None, family: str = "zeggs") -> Tuple[str, str]:
    """→ (status, message); status ∈ {"baseline", "ok", "degraded", "unknown"}."""
    key = mode_key(sampler, respace, diffusion_steps)
    if key is None:
        return "baseline", "full-schedule DDPM (reference configuration)"
    return check_key(key, manifest, diffusion_steps=diffusion_steps, family=family)


def check_key(key: str, manifest: Optional[dict] = None, *,
              diffusion_steps: Optional[int] = None, family: str = "zeggs") -> Tuple[str, str]:
    """Gate an explicit manifest key. A manifest measured against another
    base schedule than ``ddpm{diffusion_steps}`` gives no verdict."""
    manifest = manifest if manifest is not None else load_manifest(family=family)
    if manifest is None:
        return "unknown", (f"serving mode {key!r} has no quality manifest for the "
                           f"{family!r} family")
    base = manifest.get("baseline")
    if diffusion_steps is not None and base is not None and base != f"ddpm{diffusion_steps}":
        return "unknown", (
            f"quality manifest was measured against {base}, not this config's "
            f"ddpm{diffusion_steps} base schedule — mode {key!r} has no applicable verdict")
    entry = manifest.get("modes", {}).get(key)
    if entry is None:
        return "unknown", (f"serving mode {key!r} not measured by the quality harness "
                           f"(measured: {sorted(manifest.get('modes', {}))})")
    if entry.get("ok", False):
        return "ok", (f"quality gate OK for {key}: FGD ratio vs DDPM-1000 "
                      f"{entry.get('fgd_ratio', float('nan')):.2f} "
                      f"(tolerance {manifest.get('fgd_ratio_tolerance')})")
    reasons = []
    fgd_tol = manifest.get("fgd_ratio_tolerance")
    fgd_ratio = entry.get("fgd_ratio")
    if fgd_tol is not None and fgd_ratio is not None and fgd_ratio > fgd_tol:
        reasons.append(f"FGD ratio vs DDPM-1000 {fgd_ratio:.2f} > tolerance {fgd_tol}")
    div_min = manifest.get("diversity_ratio_min")
    div_ratio = entry.get("diversity_ratio_vs_baseline")
    if div_min is not None and div_ratio is not None and div_ratio < div_min:
        reasons.append(f"sample diversity collapsed to {div_ratio:.3f}× the DDPM-1000 "
                       f"baseline (floor {div_min})")
    detail = "; ".join(reasons) or f"FGD ratio vs DDPM-1000 {fgd_ratio}"
    return "degraded", (f"serving mode {key} DEGRADED motion quality in the harness: "
                        f"{detail} (pass --allow_degraded to serve anyway)")
