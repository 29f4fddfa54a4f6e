from magi_tpu_torch.serve.generator import check_dependencies, generate_magi_video

__all__ = ["generate_magi_video", "check_dependencies"]
