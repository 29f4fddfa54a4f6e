"""HTTP video-generation service with an OpenAI-compatible endpoint: the
port of `magi_tpu.serve.service`, on the stdlib http.server with the same
routes, response schemas, FIFO engine gate and `MAGI_*` settings.  Each
request runs the port's engine (`magi_tpu_torch.pipeline.entry`) in a
subprocess on the card (`serve.generator`):

  GET  /ping                 liveness
  GET  /health               dependency report
  POST /v1/chat/completions  OpenAI chat-completions-compatible
  POST /generate             direct generation API
  GET  /download/<file_id>   fetch a finished video

Run:  python -m magi_tpu_torch.serve.service [--port 8002]
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import os
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from magi_tpu_torch.serve.generator import check_dependencies, generate_magi_video

OUT_DIR = os.getenv("OUT_DIR", os.path.join(tempfile.gettempdir(), "magi_outputs"))
MAGI_MODEL_SIZE = os.getenv("MAGI_MODEL_SIZE", "4.5B")
MAGI_GPUS = int(os.getenv("MAGI_GPUS", "1"))
MAGI_CONFIG_FILE = os.getenv("MAGI_CONFIG_FILE")
MAGI_MAX_QUEUE = int(os.getenv("MAGI_MAX_QUEUE", "4"))
os.makedirs(OUT_DIR, exist_ok=True)


class HTTPError(Exception):
    def __init__(self, code: int, detail: str):
        super().__init__(detail)
        self.code = code
        self.detail = detail


class EngineGate:
    """Serializes access to the card across the ThreadingHTTPServer's
    request threads: each generation spawns a fresh engine subprocess, and
    two of them on one card would share its memory and time.  Requests
    queue strictly FIFO behind the running one (ticket numbers + a
    Condition: a bare threading.Lock would not guarantee wake-up order) up
    to `max_queue` in flight in all; beyond that a request is rejected 429
    with the exact in-flight count so clients can back off."""

    def __init__(self, max_queue: int):
        self._cond = threading.Condition()
        self._next_ticket = 0  # next ticket to hand out
        self._serving = 0  # ticket currently allowed to run
        self._abandoned: set = set()  # tickets whose waiter died mid-wait
        self.max_queue = max_queue

    def _advance(self):
        # caller holds self._cond
        self._serving += 1
        while self._serving in self._abandoned:
            self._abandoned.discard(self._serving)
            self._serving += 1
        self._cond.notify_all()

    @contextlib.contextmanager
    def acquire(self):
        with self._cond:
            in_flight = self._next_ticket - self._serving - len(self._abandoned)
            if in_flight >= self.max_queue:
                raise HTTPError(
                    429,
                    f"engine busy: {in_flight} request(s) in flight "
                    f"(max {self.max_queue}); retry later",
                )
            ticket = self._next_ticket
            self._next_ticket += 1
            try:
                while self._serving != ticket:
                    self._cond.wait()
            except BaseException:
                # never wedge the queue: hand the turn onward
                if self._serving == ticket:
                    self._advance()
                else:
                    self._abandoned.add(ticket)
                raise
        try:
            yield
        finally:
            with self._cond:
                self._advance()


ENGINE_GATE = EngineGate(MAGI_MAX_QUEUE)


def _decode_data_uri(uri: str) -> bytes:
    header, _, b64 = uri.partition(",")
    if not header.startswith("data:"):
        raise ValueError("Bad data URI")
    return base64.b64decode(b64)


def _fetch_image(url: str):
    from PIL import Image  # only image requests need PIL

    try:
        if url.startswith("data:"):
            data = _decode_data_uri(url)
        else:
            import urllib.request

            with urllib.request.urlopen(url, timeout=10) as r:
                data = r.read()
        return Image.open(io.BytesIO(data)).convert("RGB")
    except Exception as e:
        raise HTTPError(422, f"Cannot load image: {e}") from e


def _save_temp(img) -> str:
    path = os.path.join(OUT_DIR, f"inp_{uuid.uuid4().hex}.jpg")
    img.save(path, "JPEG", quality=95)
    return path


def _generate(prompt: str, img, model_size=None, gpus=None) -> dict:
    img_path = _save_temp(img) if img else None
    try:
        with ENGINE_GATE.acquire():
            out = generate_magi_video(
                prompt=prompt,
                mode="i2v" if img else "t2v",
                image_path=img_path,
                model_size=model_size or MAGI_MODEL_SIZE,
                gpus=gpus or MAGI_GPUS,
                config_file=MAGI_CONFIG_FILE,
                output_dir=OUT_DIR,
                show_progress=True,
            )
        if not out["success"]:
            raise HTTPError(500, f"Video generation failed: {out.get('error') or out.get('stderr')}")
        return out
    finally:
        if img_path and os.path.exists(img_path):
            try:
                os.remove(img_path)
            except Exception:
                pass


# ---------------------------------------------------------------------------
# route handlers
# ---------------------------------------------------------------------------


def route_ping() -> dict:
    return {"status": "ok", "model": MAGI_MODEL_SIZE, "gpus": MAGI_GPUS}


def route_health() -> dict:
    deps = check_dependencies()
    return {
        "status": "healthy" if deps["ready"] else "unhealthy",
        "dependencies": deps,
        "magi_config": {"model_size": MAGI_MODEL_SIZE, "gpus": MAGI_GPUS, "config_file": MAGI_CONFIG_FILE},
        "output_dir": OUT_DIR,
    }


def route_completions(body: dict, base_url: str) -> dict:
    messages = body.get("messages") or []
    last = next((m for m in reversed(messages) if m.get("role") == "user"), None)
    if last is None:
        raise HTTPError(400, "Need at least one user message")
    prompt_parts, img = [], None
    content = last.get("content")
    if isinstance(content, str):
        prompt_parts.append(content)
    else:
        for part in content or []:
            if part.get("type") == "text" and part.get("text"):
                prompt_parts.append(part["text"])
            if part.get("type") == "image_url" and img is None:
                img = _fetch_image(part["image_url"]["url"])
    prompt = " ".join(prompt_parts) or "(empty prompt)"

    out = _generate(prompt, img)
    url = f"{base_url}/download/{os.path.basename(out['output_path'])}"
    return {
        "id": f"chatcmpl-{uuid.uuid4().hex}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": body.get("model", "magi-video-001"),
        "choices": [
            {
                "index": 0,
                "message": {
                    "role": "assistant",
                    "content": url,
                    "metadata": {
                        "generated_with": "magi-tpu-torch",
                        "model_size": MAGI_MODEL_SIZE,
                        "prompt": prompt,
                    },
                },
                "finish_reason": "stop",
            }
        ],
    }


def route_generate(body: dict) -> dict:
    prompts = body.get("prompts")
    if prompts:  # several t2v prompts in one engine, lockstep or interleaved
        if body.get("image_url"):
            raise HTTPError(400, "batched generation is t2v-only")
        from magi_tpu_torch.serve.generator import generate_magi_video_batch

        with ENGINE_GATE.acquire():
            out = generate_magi_video_batch(
                prompts,
                model_size=body.get("model_size") or MAGI_MODEL_SIZE,
                config_file=MAGI_CONFIG_FILE,
                output_dir=OUT_DIR,
                interleave=bool(body.get("interleave")),
            )
        if not out.get("success"):
            raise HTTPError(500, out.get("error") or "generation failed")
        return {
            "success": True,
            "video_paths": out["output_paths"],
            "download_urls": [f"/download/{os.path.basename(p)}" for p in out["output_paths"]],
            "prompts": prompts,
            "duration": out.get("duration", 0),
        }
    prompt = body.get("prompt")
    if not prompt:
        raise HTTPError(400, "prompt required")
    img = _fetch_image(body["image_url"]) if body.get("image_url") else None
    model_size = body.get("model_size") or MAGI_MODEL_SIZE
    gpus = body.get("gpus") or MAGI_GPUS
    out = _generate(prompt, img, model_size, gpus)
    return {
        "success": True,
        "video_path": out["output_path"],
        "download_url": f"/download/{os.path.basename(out['output_path'])}",
        "prompt": prompt,
        "model_size": model_size,
        "gpus": gpus,
        "duration": out.get("duration", 0),
    }


class MagiHandler(BaseHTTPRequestHandler):
    def _send_json(self, obj: dict, code: int = 200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(data)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        if not length:
            return {}
        return json.loads(self.rfile.read(length))

    def log_message(self, fmt, *args):  # route through our logger
        from magi_tpu_torch.core.logger import magi_logger

        magi_logger.info("service: " + fmt % args)

    def do_GET(self):
        try:
            if self.path == "/ping":
                return self._send_json(route_ping())
            if self.path == "/health":
                return self._send_json(route_health())
            if self.path.startswith("/download/"):
                file_id = os.path.basename(self.path[len("/download/") :])
                path = os.path.join(OUT_DIR, file_id)
                if not os.path.exists(path):
                    raise HTTPError(404, "File not found")
                self.send_response(200)
                self.send_header("Content-Type", "video/mp4")
                self.send_header("Content-Length", str(os.path.getsize(path)))
                self.end_headers()
                with open(path, "rb") as f:
                    while chunk := f.read(1 << 20):
                        self.wfile.write(chunk)
                return
            raise HTTPError(404, "Not found")
        except HTTPError as e:
            self._send_json({"detail": e.detail}, e.code)

    def do_POST(self):
        try:
            body = self._read_body()
            host = self.headers.get("Host", "localhost")
            base_url = f"http://{host}"
            if self.path == "/v1/chat/completions":
                return self._send_json(route_completions(body, base_url))
            if self.path == "/generate":
                return self._send_json(route_generate(body))
            raise HTTPError(404, "Not found")
        except HTTPError as e:
            self._send_json({"detail": e.detail}, e.code)
        except Exception as e:
            self._send_json({"detail": f"Internal error: {e}"}, 500)


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8002)
    args = parser.parse_args()

    deps = check_dependencies()
    print("=" * 62)
    print("  MAGI video service (PyTorch/CUDA)")
    print(f"  model={MAGI_MODEL_SIZE} gpus={MAGI_GPUS} config={MAGI_CONFIG_FILE}")
    print(f"  dependencies ready: {deps['ready']}")
    print(f"  OpenAI API: http://localhost:{args.port}/v1/chat/completions")
    print(f"  Direct API: http://localhost:{args.port}/generate")
    print("=" * 62)
    ThreadingHTTPServer((args.host, args.port), MagiHandler).serve_forever()


if __name__ == "__main__":
    main()
