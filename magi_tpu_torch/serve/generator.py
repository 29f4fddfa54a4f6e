"""Subprocess-launching generation wrapper (the port of
`magi_tpu.serve.generator`).  Each request runs the port's CLI entry
(`python -m magi_tpu_torch.pipeline.entry`) in a fresh process for failure
isolation, with the same flags and conditioning environment as the JAX
package's; a config of world_size > 1 runs it under torchrun, one process
per rank (the JAX service needs no launcher: its one process drives the
mesh).  The entry runs on the card; `device=` passes `--device` on
(the CPU tests give "cpu")."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import Optional

DEFAULT_CONFIGS = {
    "4.5B": "example/4.5B/4.5B_base_config.json",
    "4.5B-distill": "example/4.5B/4.5B_distill_config.json",
    "24B": "example/24B/24B_base_config.json",
    "24B-distill": "example/24B/24B_distill_config.json",
}


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def check_dependencies() -> dict:
    """torch, its version, the CUDA devices and whether the entry imports;
    `ready` needs a CUDA device."""
    deps = {"ready": False, "torch": False, "devices": 0, "entry_module": False, "errors": []}
    try:
        import torch

        deps["torch"] = True
        deps["torch_version"] = torch.__version__
        deps["cuda_version"] = torch.version.cuda
        try:
            deps["devices"] = torch.cuda.device_count()
            deps["backend"] = "cuda" if deps["devices"] else "cpu"
            if deps["devices"]:
                deps["device_name"] = torch.cuda.get_device_name(0)
        except Exception as e:  # a broken driver
            deps["errors"].append(f"device query failed: {e}")
    except ImportError as e:
        deps["errors"].append(f"torch import failed: {e}")
    try:
        import magi_tpu_torch.pipeline.entry  # noqa: F401

        deps["entry_module"] = True
    except ImportError as e:
        deps["errors"].append(f"entry import failed: {e}")
    deps["ready"] = deps["torch"] and deps["entry_module"] and deps["devices"] > 0
    return deps


def _stream_output(proc: subprocess.Popen, show_progress: bool, sink: list, times: Optional[list] = None) -> None:
    """The process's output lines into `sink` as they come (and, with
    `times`, each line's `time.time()` there), echoed to stderr under
    `show_progress`."""

    def reader(stream, prefix):
        for line in iter(stream.readline, ""):
            if times is not None:
                times.append(time.time())
            sink.append(line)
            if show_progress:
                print(f"[magi:{prefix}] {line}", end="", file=sys.stderr)

    threads = [
        threading.Thread(target=reader, args=(proc.stdout, "out"), daemon=True),
        threading.Thread(target=reader, args=(proc.stderr, "err"), daemon=True),
    ]
    for t in threads:
        t.start()
    proc.wait()
    for t in threads:
        t.join(timeout=5)


_FRIENDLY_ERRORS = {
    "RESOURCE_EXHAUSTED": "Out of device memory — try a smaller model size or resolution",
    "out of memory": "Out of device memory — try a smaller model size or resolution",
    "weight dir not found": "Model checkpoint not downloaded — set runtime_config.load",
    "No module named": "Missing python dependency",
}


def _engine_env(root: str) -> dict:
    env = dict(os.environ)
    # conditioning defaults, as the JAX package's service sets them
    env.setdefault("PAD_HQ", "true")
    env.setdefault("PAD_DURATION", "true")
    env.setdefault("OFFLOAD_T5_CACHE", "true")
    env.setdefault("OFFLOAD_VAE_CACHE", "true")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _entry_cmd(config_file: str, mode: str) -> list:
    """The engine's command: the CLI entry, under torchrun on a local
    rendezvous (`--standalone`) with one process per rank when the config's
    world_size (dp*pp*cp*tp) is above 1.  A config file that is not there
    is the entry's to report, as it is on one rank."""
    from magi_tpu_torch.core.config import MagiConfig

    entry = ["-m", "magi_tpu_torch.pipeline.entry", "--config_file", config_file, "--mode", mode]
    world = MagiConfig.from_json(config_file).engine_config.world_size if os.path.exists(config_file) else 1
    if world > 1:
        return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(world), *entry]
    return [sys.executable, *entry]


def generate_magi_video(
    prompt: str,
    mode: str = "t2v",
    image_path: Optional[str] = None,
    prefix_video_path: Optional[str] = None,
    model_size: str = "4.5B",
    gpus: int = 1,  # accepted for API compat; the port runs one card
    config_file: Optional[str] = None,
    output_dir: Optional[str] = None,
    show_progress: bool = True,
    timeout: Optional[float] = None,
    device: Optional[str] = None,
) -> dict:
    """One request in an engine subprocess; returns {"success",
    "output_path", "duration", "stderr"} or {"success": False, "error",
    ...}."""
    root = _repo_root()
    config_file = config_file or os.path.join(root, DEFAULT_CONFIGS.get(model_size, DEFAULT_CONFIGS["4.5B"]))
    output_dir = output_dir or os.getenv("OUT_DIR", os.path.join(tempfile.gettempdir(), "magi_outputs"))
    os.makedirs(output_dir, exist_ok=True)
    output_path = os.path.join(output_dir, f"magi_{uuid.uuid4().hex}.mp4")

    cmd = _entry_cmd(config_file, mode) + ["--prompt", prompt, "--output_path", output_path]
    if image_path:
        cmd += ["--image_path", image_path]
    if prefix_video_path:
        cmd += ["--prefix_video_path", prefix_video_path]
    if device:
        cmd += ["--device", device]
    return _launch(cmd, root, _engine_env(root), output_path, show_progress, timeout)


def generate_magi_video_batch(
    prompts: list,
    model_size: str = "4.5B",
    config_file: Optional[str] = None,
    output_dir: Optional[str] = None,
    show_progress: bool = True,
    timeout: Optional[float] = None,
    interleave: bool = False,
    device: Optional[str] = None,
) -> dict:
    """Batch t2v: one subprocess, N prompts denoised in lockstep
    (`--prompts`), or with `interleave=True` round-robin with the decode on
    a worker thread.  Returns {"success", "output_paths": [...]}."""
    if not prompts:
        raise ValueError("a batch needs at least one prompt")
    root = _repo_root()
    config_file = config_file or os.path.join(root, DEFAULT_CONFIGS.get(model_size, DEFAULT_CONFIGS["4.5B"]))
    output_dir = output_dir or os.getenv("OUT_DIR", os.path.join(tempfile.gettempdir(), "magi_outputs"))
    os.makedirs(output_dir, exist_ok=True)
    outs = [os.path.join(output_dir, f"magi_{uuid.uuid4().hex}.mp4") for _ in prompts]

    cmd = _entry_cmd(config_file, "t2v") + ["--prompts", *prompts, "--output_paths", *outs]
    if interleave:
        cmd.append("--interleave")
    if device:
        cmd += ["--device", device]
    result = _launch(cmd, root, _engine_env(root), outs[0], show_progress, timeout)
    if not result["success"]:
        return result
    finals = [p if os.path.exists(p) else p + ".npz" for p in outs]
    missing = [p for p in finals if not os.path.exists(p)]
    if missing:
        return {**result, "success": False, "error": f"missing outputs: {missing}"}
    return {**result, "output_paths": finals}


def _launch(cmd, root, env, output_path, show_progress, timeout) -> dict:
    """Run the engine; the result carries the output's last 50 lines
    (`stderr`) and every line with its second since the launch (`log`)."""
    t0 = time.time()
    lines: list = []
    times: list = []
    try:
        proc = subprocess.Popen(
            cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, bufsize=1,
        )
        timer = threading.Timer(timeout, proc.kill) if timeout else None
        if timer:
            timer.start()
        _stream_output(proc, show_progress, lines, times)
        if timer:
            timer.cancel()
        duration = time.time() - t0
        stderr_tail = "".join(lines[-50:])
        log = [(t - t0, line) for t, line in zip(times, lines)]
        written = os.path.exists(output_path) or os.path.exists(output_path + ".npz")
        if proc.returncode != 0 or not written:
            error = next((friendly for pattern, friendly in _FRIENDLY_ERRORS.items() if pattern in stderr_tail), None)
            return {
                "success": False,
                "error": error or f"generation exited with code {proc.returncode}",
                "stderr": stderr_tail,
                "duration": duration,
                "log": log,
            }
        final = output_path if os.path.exists(output_path) else output_path + ".npz"
        return {"success": True, "output_path": final, "duration": duration, "stderr": stderr_tail, "log": log}
    except Exception as e:
        return {"success": False, "error": str(e), "stderr": "".join(lines[-50:]), "duration": time.time() - t0}
