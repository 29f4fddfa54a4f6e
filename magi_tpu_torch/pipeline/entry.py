"""CLI entry point, with the JAX package's flags:

    SKIP_LOAD_MODEL=1 python -m magi_tpu_torch.pipeline.entry \\
        --config_file example/4.5B/4.5B_base_config.json --mode t2v \\
        --prompt "a red cube" --output_path out.mp4

Runs on CUDA unless `--device cpu` is given.  This slice runs `--mode t2v`
with one `--prompt`; i2v, v2v and `--prompts` batching raise
`NotImplementedError` naming their ROADMAP item.
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
    parser.add_argument("--prompts", type=str, nargs="+", default=None, help="batch of prompts (t2v only)")
    parser.add_argument("--image_path", type=str, default=None, help="first-frame image for i2v")
    parser.add_argument("--prefix_video_path", type=str, default=None, help="prefix video for v2v")
    parser.add_argument("--output_path", type=str, default="output.mp4")
    parser.add_argument("--interleave", action="store_true", help="with --prompts: round-robin requests")
    parser.add_argument("--output_paths", type=str, nargs="+", default=None, help="per-prompt output paths")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if not (args.prompt or args.prompts):
        parser.error("--prompt or --prompts required")
    return args


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.prompts:
        raise NotImplementedError("--prompts batching (DpBatchedSampler / walk_many) is ROADMAP queue 1 item 13")
    if args.mode != "t2v":
        raise NotImplementedError(f"--mode {args.mode} is ROADMAP queue 1 item 10")
    pipeline = MagiPipeline(args.config_file, device=args.device)
    return pipeline.run_text_to_video(prompt=args.prompt, output_path=args.output_path)


if __name__ == "__main__":
    main()
