"""Batch BVH -> glTF (GLB) export CLI, the rendering hand-off.

Port of `diffusestylegesture_tpu/cli/export_gltf.py` (its flags). The
reference's `ZEGGS/bvh2fbx/bvh2fbx.py` (+ `.bat`) retargets each generated BVH
onto an FBX character through the Windows-only FBX SDK; here each BVH becomes
a glTF 2.0 GLB (`motion/gltf_export.py`), which Blender, Unity, Unreal and
three.js import, and / or a self-contained browser player page
(`motion/mocap_player.py`). Host work only: no card, no matplotlib. Audio
cannot be embedded in glTF; the wav stays beside the asset.

Usage::

    python -m diffusestylegesture_torch.cli.export_gltf out/*.bvh --outdir renders/
    python -m diffusestylegesture_torch.cli.export_gltf clip.bvh --player
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert generated BVH files to glTF (GLB) and/or a "
                    "standalone browser-player HTML")
    ap.add_argument("bvh", nargs="+", help="input BVH file(s)")
    ap.add_argument("--outdir", default=None,
                    help="output directory (default: next to each input)")
    ap.add_argument("--player", action="store_true",
                    help="also write a self-contained HTML mocap player "
                         "per clip")
    ap.add_argument("--no_glb", action="store_true",
                    help="skip the GLB (with --player: HTML only)")
    args = ap.parse_args(argv)
    if args.no_glb and not args.player:
        ap.error("--no_glb without --player would write nothing; "
                 "add --player or drop --no_glb")

    from ..motion import pipeline as MP
    from ..motion.gltf_export import channeldata_to_gltf, write_glb
    from ..motion.mocap_player import write_mocap_player_html

    written = []
    for path in args.bvh:
        stem = os.path.splitext(os.path.basename(path))[0]
        outdir = args.outdir or os.path.dirname(path) or "."
        os.makedirs(outdir, exist_ok=True)
        track = MP.parse_bvh(path)
        if not args.no_glb:
            gltf, blob = channeldata_to_gltf(track)
            out = write_glb(gltf, blob, os.path.join(outdir, stem + ".glb"))
            print(f"{path} -> {out} ({os.path.getsize(out)} bytes)")
            written.append(out)
        if args.player:
            pos = MP.MocapParameterizer("position").transform(track)
            out = write_mocap_player_html(
                pos, os.path.join(outdir, stem + ".html"),
                frame_time=track.framerate)
            print(f"{path} -> {out}")
            written.append(out)
    return written


if __name__ == "__main__":
    main()
