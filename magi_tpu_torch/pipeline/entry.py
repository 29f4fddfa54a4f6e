"""CLI entry point, with the JAX package's flags:

    SKIP_LOAD_MODEL=1 python -m magi_tpu_torch.pipeline.entry \\
        --config_file example/4.5B/4.5B_base_config.json --mode t2v \\
        --prompt "a red cube" --output_path out.mp4

    ... --mode i2v --image_path first_frame.png
    ... --mode v2v --prefix_video_path prefix.mp4
    ... --mode t2v --prompts "a red cube" "a blue ball" [--interleave] \\
        [--output_paths a.mp4 b.mp4]

`--prompts` (t2v only) generates one video per prompt: in lockstep
(`MagiPipeline.run_text_to_video_batch`), or with `--interleave` round-robin
with the decode on a worker thread (`run_text_to_video_many`); the videos go
to `--output_paths`, by default `output_path` with `_0`, `_1`, ... before its
extension.  Without SKIP_LOAD_MODEL the DiT, VAE and T5 load from the
checkpoints the config's `runtime_config` names (`load`, `vae_pretrained`,
`t5_pretrained`).  Runs on CUDA unless `--device cpu` is given; the
denoise steps replay from CUDA graphs there unless `--eager` is given.
With MAGI_PROFILE_DIR set, each walk writes a profiler trace there.

A config whose world_size (dp_size * pp_size * cp_size * tp_size) is above
1 runs under torchrun, one process per rank, with the backend of its
`engine_config.distributed_backend` (nccl across cards, gloo for several
ranks on one card):

    SKIP_LOAD_MODEL=1 python -m torch.distributed.run --standalone \
        --nproc_per_node 8 -m magi_tpu_torch.pipeline.entry \
        --config_file example/24B/24B_distill_quant_config.json ...

Rank r takes cuda:(LOCAL_RANK % device count); rank 0 writes the videos.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from magi_tpu_torch.pipeline.pipeline import MagiPipeline


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="MAGI video generation (PyTorch/CUDA)")
    parser.add_argument("--config_file", type=str, required=True, help="magi config file (JSON)")
    parser.add_argument("--mode", type=str, choices=["t2v", "i2v", "v2v"], required=True)
    parser.add_argument("--prompt", type=str, default=None)
    parser.add_argument("--prompts", type=str, nargs="+", default=None,
                        help="several prompts (t2v only), one video each")
    parser.add_argument("--image_path", type=str, default=None, help="first-frame image for i2v")
    parser.add_argument("--prefix_video_path", type=str, default=None, help="prefix video for v2v")
    parser.add_argument("--output_path", type=str, default="output.mp4")
    parser.add_argument("--interleave", action="store_true",
                        help="with --prompts: round-robin the requests, decode on a worker")
    parser.add_argument("--output_paths", type=str, nargs="+", default=None, help="per-prompt output paths")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--eager", action="store_true",
                        help="run the denoise steps eagerly, not replayed from CUDA graphs")
    args = parser.parse_args(argv)
    if not (args.prompt or args.prompts):
        parser.error("--prompt or --prompts required")
    if args.mode == "i2v" and not args.image_path:
        parser.error("--image_path required for i2v")
    if args.mode == "v2v" and not args.prefix_video_path:
        parser.error("--prefix_video_path required for v2v")
    if args.prompts and args.mode != "t2v":
        parser.error("--prompts supports t2v only")
    if args.prompts and args.output_paths and len(args.output_paths) != len(args.prompts):
        parser.error("--output_paths needs one path per prompt")
    return args


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    pipeline = MagiPipeline(args.config_file, device=args.device, capture=not args.eager)
    if args.prompts:
        outs = args.output_paths
        if outs is None:
            stem, dot, ext = args.output_path.rpartition(".")
            outs = [f"{stem}_{i}{dot}{ext}" for i in range(len(args.prompts))]
        run = pipeline.run_text_to_video_many if args.interleave else pipeline.run_text_to_video_batch
        return run(args.prompts, outs)
    if args.mode == "i2v":
        return pipeline.run_image_to_video(prompt=args.prompt, image_path=args.image_path,
                                           output_path=args.output_path)
    if args.mode == "v2v":
        return pipeline.run_video_to_video(prompt=args.prompt, prefix_video_path=args.prefix_video_path,
                                           output_path=args.output_path)
    return pipeline.run_text_to_video(prompt=args.prompt, output_path=args.output_path)


if __name__ == "__main__":
    main()
