"""Dataset preparation CLI (ZEGGS).

  python -m diffusestylegesture_torch.cli.prepare_data --dataset ZEGGS \\
      --source ./zeggs_raw --target ./data/zeggs_processed [--workers 4] \\
      [--normalize_loudness]

Port of `diffusestylegesture_tpu/cli/prepare_data.py` (reference
`main/mydiffusion_zeggs/zeggs_data_to_lmdb.py`): paired `<name>.wav` +
`<name>.bvh` clips → normalized npz shards and mean/std
(`data/zeggs.py::build_zeggs_dataset`). Host-side numpy work: it runs on
no device. `--normalize_loudness` runs the EBU R128 pass in place of the
reference's external `ffmpeg-normalize` pre-step. BEAT and TWH come with
their training slice.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="DiffuseStyleGesture data preparation (PyTorch port)")
    p.add_argument("--dataset", choices=["ZEGGS", "BEAT", "TWH"], required=True)
    p.add_argument("--source", required=True, help="directory of paired .wav / .bvh clips")
    p.add_argument("--target", required=True, help="output directory")
    p.add_argument("--fps", type=int, default=None)
    p.add_argument("--workers", type=int, default=0,
                   help="featurize the clips in N spawned processes (same output as serial)")
    p.add_argument("--normalize_loudness", action="store_true",
                   help="EBU R128 normalization to -23 LUFS (the reference's ffmpeg-normalize "
                        "pre-step)")
    args = p.parse_args(argv)

    if args.dataset != "ZEGGS":
        raise NotImplementedError(
            f"{args.dataset} data preparation comes with slice 4 of the port (BEAT/TWH "
            "training); use diffusestylegesture_tpu.cli.prepare_data until then")
    from ..data import build_zeggs_dataset

    stats = build_zeggs_dataset(args.source, args.target, fps=args.fps or 20,
                                workers=args.workers, loudnorm=args.normalize_loudness)
    print("mean/std written;", stats["mean"].shape)
    return stats


if __name__ == "__main__":
    main()
