"""Python client for the MAGI video service (the port of
`magi_tpu.serve.client`), on the standard library's `urllib.request`: it
sends the same requests, and needs no `requests` package.

    client = MagiVideoClient("http://localhost:8002")
    client.ping()
    path = client.generate_video_openai("a red fox", image_path="fox.png")

An HTTP error status raises `urllib.error.HTTPError` (its `code`, e.g. 429
when the engine's queue is full).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import urllib.request
from typing import Optional


def _image_to_data_uri(image_path: str) -> str:
    ext = os.path.splitext(image_path)[1].lstrip(".").lower() or "png"
    with open(image_path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    return f"data:image/{ext};base64,{b64}"


class MagiVideoClient:
    def __init__(self, base_url: str = "http://localhost:8002", timeout: float = 3600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _get_json(self, path: str, timeout: float) -> dict:
        with urllib.request.urlopen(self.base_url + path, timeout=timeout) as r:
            return json.loads(r.read())

    def _post_json(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(self.base_url + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def ping(self) -> dict:
        return self._get_json("/ping", 10)

    def health(self) -> dict:
        return self._get_json("/health", 10)

    def generate_video_openai(
        self, prompt: str, image_path: Optional[str] = None, output_path: Optional[str] = None
    ) -> str:
        """OpenAI chat-completions style request; downloads the result and
        returns the local path."""
        content = [{"type": "text", "text": prompt}]
        if image_path:
            content.append({"type": "image_url", "image_url": {"url": _image_to_data_uri(image_path)}})
        resp = self._post_json("/v1/chat/completions",
                               {"model": "magi-video-001", "messages": [{"role": "user", "content": content}]})
        return self.download(resp["choices"][0]["message"]["content"], output_path)

    def generate_video_direct(
        self,
        prompt: str,
        image_path: Optional[str] = None,
        model_size: Optional[str] = None,
        gpus: Optional[int] = None,
        output_path: Optional[str] = None,
    ) -> str:
        payload = {"prompt": prompt}
        if image_path:
            payload["image_url"] = _image_to_data_uri(image_path)
        if model_size:
            payload["model_size"] = model_size
        if gpus:
            payload["gpus"] = gpus
        resp = self._post_json("/generate", payload)
        return self.download(self.base_url + resp["download_url"], output_path)

    def generate_video_batch(
        self,
        prompts: list,
        model_size: Optional[str] = None,
        output_dir: Optional[str] = None,
    ) -> list:
        """Several t2v prompts generated by one engine."""
        payload = {"prompts": prompts}
        if model_size:
            payload["model_size"] = model_size
        resp = self._post_json("/generate", payload)
        out = []
        for url in resp["download_urls"]:
            dst = os.path.join(output_dir, os.path.basename(url)) if output_dir else None
            out.append(self.download(self.base_url + url, dst))
        return out

    def download(self, url: str, output_path: Optional[str] = None) -> str:
        output_path = output_path or os.path.basename(url)
        with urllib.request.urlopen(url, timeout=self.timeout) as r, open(output_path, "wb") as f:
            while chunk := r.read(1 << 20):
                f.write(chunk)
        return output_path


def main() -> None:
    parser = argparse.ArgumentParser(description="MAGI video client")
    parser.add_argument("--url", default="http://localhost:8002")
    parser.add_argument("--prompt", required=True)
    parser.add_argument("--image", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--api", choices=["openai", "direct"], default="openai")
    parser.add_argument("--model_size", default=None)
    args = parser.parse_args()

    client = MagiVideoClient(args.url)
    print(client.ping())
    if args.api == "openai":
        path = client.generate_video_openai(args.prompt, args.image, args.output)
    else:
        path = client.generate_video_direct(args.prompt, args.image, args.model_size, output_path=args.output)
    print(f"saved: {path}")


if __name__ == "__main__":
    main()
