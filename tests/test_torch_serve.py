"""The port's serving layer (`magi_tpu_torch.serve`) against the JAX
package's (`magi_tpu.serve`): the cases of `tests/test_service.py` over
real HTTP on the port's handler with generation mocked (ping and health,
the OpenAI round trip, direct, batch, errors, the engine gate's
serialisation, its 429, strict FIFO and the abandoned waiter), driven
through the port's client (`urllib`, no `requests`); the route functions
of both packages give the same keys and values for the same bodies (ids,
times and the `generated_with` string apart); the generator's engine
command matches the JAX one's; and the port's generator runs its engine
end to end in a subprocess on the CPU, writing a video."""

import base64
import io
import os
import threading
import time
import urllib.error
from http.server import ThreadingHTTPServer

import pytest

from magi_tpu.serve import generator as jgen
from magi_tpu.serve import service as jsvc
from magi_tpu_torch.serve import generator as tgen
from magi_tpu_torch.serve import service as tsvc
from magi_tpu_torch.serve.client import MagiVideoClient
from tests.test_torch_walk import _tiny_json
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

VIDEO = b"\x00fakevideo"


def _fakes(out_dir, calls=None):
    def fake_generate(prompt, mode, image_path=None, **kw):
        assert (mode == "i2v") == (image_path is not None)
        if calls is not None:
            calls.append(dict(kw, prompt=prompt, mode=mode, image=image_path is not None))
        out = os.path.join(out_dir, "vid.mp4")
        with open(out, "wb") as f:
            f.write(VIDEO)
        return {"success": True, "output_path": out, "duration": 0.1}

    def fake_batch(prompts, **kw):
        paths = []
        for i, _ in enumerate(prompts):
            paths.append(os.path.join(out_dir, f"vid_b{i}.mp4"))
            with open(paths[-1], "wb") as f:
                f.write(VIDEO)
        return {"success": True, "output_paths": paths, "duration": 0.1}

    return fake_generate, fake_batch


def _mock(monkeypatch, svc, gen, out_dir, calls=None):
    fake_generate, fake_batch = _fakes(str(out_dir), calls)
    monkeypatch.setattr(svc, "OUT_DIR", str(out_dir))
    monkeypatch.setattr(svc, "generate_magi_video", fake_generate)
    monkeypatch.setattr(gen, "generate_magi_video_batch", fake_batch)


@pytest.fixture()
def server(tmp_path, monkeypatch):
    _mock(monkeypatch, tsvc, tgen, tmp_path)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tsvc.MagiHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()


def _png_uri():
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (8, 8), (200, 10, 10)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _status(fn) -> int:
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def test_ping_and_health(server):
    client = MagiVideoClient(server)
    assert client.ping()["status"] == "ok"
    h = client.health()
    assert "dependencies" in h and "status" in h
    deps = h["dependencies"]
    assert {"ready", "devices", "entry_module", "errors", "torch", "torch_version"} <= set(deps)
    assert deps["entry_module"] and deps["torch"]
    assert deps["ready"] == (deps["devices"] > 0)


def test_openai_completions_roundtrip(server, tmp_path):
    png = tmp_path / "in.png"
    png.write_bytes(base64.b64decode(_png_uri().split(",", 1)[1]))
    client = MagiVideoClient(server)
    out = client.generate_video_openai("a red square", image_path=str(png), output_path=str(tmp_path / "got.mp4"))
    with open(out, "rb") as f:
        assert f.read() == VIDEO


def test_direct_generate(server, tmp_path):
    client = MagiVideoClient(server)
    out = client.generate_video_direct("hello", output_path=str(tmp_path / "direct.mp4"))
    with open(out, "rb") as f:
        assert f.read() == VIDEO


def test_batch_generate(server, tmp_path):
    client = MagiVideoClient(server)
    dst = tmp_path / "batch"
    dst.mkdir()
    outs = client.generate_video_batch(["a", "b"], output_dir=str(dst))
    assert len(outs) == 2
    for p in outs:
        with open(p, "rb") as f:
            assert f.read() == VIDEO


def test_errors(server):
    client = MagiVideoClient(server)
    assert _status(lambda: client._post_json("/v1/chat/completions", {"messages": []})) == 400
    assert _status(lambda: client._post_json("/generate", {})) == 400
    assert _status(lambda: client._post_json("/generate", {"prompts": ["a"], "image_url": "x"})) == 400
    assert _status(lambda: client._get_json("/download/nope.mp4", 5)) == 404
    assert _status(lambda: client._get_json("/bogus", 5)) == 404
    assert _status(lambda: client._post_json("/bogus", {})) == 404


def _strip(d):
    """A route's response without its ids, times and `generated_with`."""
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in ("id", "created", "generated_with")}
    if isinstance(d, list):
        return [_strip(v) for v in d]
    return d


def test_routes_match_the_jax_service(tmp_path, monkeypatch):
    """The same bodies through both packages' route functions (generation
    mocked alike): the same responses, keys and values, but for ids,
    times and `generated_with`; and the same arguments reach generation."""
    calls = {"jax": [], "torch": []}
    for name, svc, gen in (("jax", jsvc, jgen), ("torch", tsvc, tgen)):
        _mock(monkeypatch, svc, gen, tmp_path, calls[name])
    uri = _png_uri()
    bodies = [
        {"messages": [{"role": "user", "content": "plain text"}]},
        {"model": "m1", "messages": [{"role": "system", "content": [{"type": "text", "text": "sys"}]},
                                     {"role": "user", "content": [{"type": "text", "text": "a red square"},
                                                                  {"type": "image_url", "image_url": {"url": uri}}]}]},
        {"messages": [{"role": "user", "content": [{"type": "image_url", "image_url": {"url": uri}}]}]},
    ]
    for body in bodies:
        j, t = jsvc.route_completions(body, "http://h"), tsvc.route_completions(body, "http://h")
        assert _strip(t) == _strip(j)
        assert t["choices"][0]["message"]["metadata"]["generated_with"] == "magi-tpu-torch"
    for body in ({"prompt": "hello"}, {"prompt": "p", "image_url": uri, "model_size": "24B", "gpus": 2},
                 {"prompts": ["a", "b"]}, {"prompts": ["a"], "interleave": True}):
        assert _strip(tsvc.route_generate(body)) == _strip(jsvc.route_generate(body))
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) == 5
    assert tsvc.route_ping() == jsvc.route_ping()
    th, jh = tsvc.route_health(), jsvc.route_health()
    assert set(th) == set(jh) and th["magi_config"] == jh["magi_config"] and th["output_dir"] == jh["output_dir"]
    assert {"ready", "devices", "entry_module", "errors"} <= set(th["dependencies"]) & set(jh["dependencies"])
    for route in (lambda s: s.route_completions({"messages": []}, ""), lambda s: s.route_generate({})):
        codes = []
        for svc in (jsvc, tsvc):
            with pytest.raises(Exception) as e:
                route(svc)
            codes.append((e.value.code, e.value.detail))
        assert codes[0] == codes[1]


def test_engine_command_matches_the_jax_generator(tmp_path, monkeypatch):
    """Both generators launch their package's entry with the same flags and
    the same conditioning environment; the port adds `--device` only when
    asked."""
    seen = {}

    class FakePopen:
        def __init__(self, cmd, cwd, env, **kw):
            seen.setdefault("runs", []).append((cmd, env))
            raise OSError("not launched")

    monkeypatch.setattr("subprocess.Popen", FakePopen)
    monkeypatch.delenv("PAD_HQ", raising=False)
    for gen in (jgen, tgen):
        gen.generate_magi_video("a cat", mode="i2v", image_path="x.png", config_file="c.json",
                                output_dir=str(tmp_path), show_progress=False)
        gen.generate_magi_video_batch(["a", "b"], config_file="c.json", output_dir=str(tmp_path),
                                      show_progress=False, interleave=True)
    tgen.generate_magi_video("a cat", config_file="c.json", output_dir=str(tmp_path), device="cpu")
    (j1, je), (j2, _), (t1, te), (t2, _), (t3, _) = seen["runs"]

    def norm(cmd):
        return [os.path.dirname(a) if a.startswith(str(tmp_path)) else a for a in cmd[3:]]

    assert j1[2] == "magi_tpu.pipeline.entry" and t1[2] == "magi_tpu_torch.pipeline.entry"
    assert norm(t1) == norm(j1) and norm(t2) == norm(j2)
    assert norm(t3)[-2:] == ["--device", "cpu"] and "--device" not in t1
    for k in ("PAD_HQ", "PAD_DURATION", "OFFLOAD_T5_CACHE", "OFFLOAD_VAE_CACHE"):
        assert te[k] == je[k] == "true"
    assert tgen._FRIENDLY_ERRORS.items() >= jgen._FRIENDLY_ERRORS.items()
    assert "out of memory" in tgen._FRIENDLY_ERRORS


def test_check_dependencies():
    deps = tgen.check_dependencies()
    assert deps["torch"] and deps["entry_module"] and not deps["errors"]
    assert deps["ready"] == (deps["devices"] > 0) and "jax" not in deps


def test_concurrent_requests_serialize_on_engine_gate(server, monkeypatch):
    """Three concurrent /generate requests run one after another: one
    engine subprocess on the card at a time."""
    running = {"n": 0, "max": 0}
    lock = threading.Lock()

    def slow_generate(prompt, mode, image_path=None, **kw):
        with lock:
            running["n"] += 1
            running["max"] = max(running["max"], running["n"])
        time.sleep(0.3)
        with lock:
            running["n"] -= 1
        path = os.path.join(tsvc.OUT_DIR, f"vid_{prompt}.mp4")
        with open(path, "wb") as f:
            f.write(VIDEO)
        return {"success": True, "output_path": path, "duration": 0.3}

    monkeypatch.setattr(tsvc, "generate_magi_video", slow_generate)
    client = MagiVideoClient(server)
    codes = []
    threads = [threading.Thread(target=lambda p=p: codes.append(_status(
        lambda: client._post_json("/generate", {"prompt": p})))) for p in ("a", "b", "c")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert codes == [200, 200, 200]
    assert running["max"] == 1, f"engine overlap: {running['max']} concurrent subprocesses"


def test_engine_gate_rejects_past_queue_limit(server, monkeypatch):
    """Requests beyond the in-flight cap get 429, not an unbounded queue."""
    monkeypatch.setattr(tsvc, "ENGINE_GATE", tsvc.EngineGate(max_queue=1))
    started = threading.Event()

    def slow_generate(prompt, mode, image_path=None, **kw):
        started.set()
        time.sleep(1.0)
        path = os.path.join(tsvc.OUT_DIR, "vid_q.mp4")
        with open(path, "wb") as f:
            f.write(VIDEO)
        return {"success": True, "output_path": path, "duration": 1.0}

    monkeypatch.setattr(tsvc, "generate_magi_video", slow_generate)
    client = MagiVideoClient(server)
    codes = {}

    def call(name):
        codes[name] = _status(lambda: client._post_json("/generate", {"prompt": name}))

    t1 = threading.Thread(target=call, args=("first",))
    t1.start()
    assert started.wait(5.0)
    t2 = threading.Thread(target=call, args=("second",))
    t2.start()
    t1.join()
    t2.join()
    assert codes == {"first": 200, "second": 429}


def test_engine_gate_is_strictly_fifo():
    """Waiters are served in ticket (arrival) order."""
    gate = tsvc.EngineGate(max_queue=16)
    order = []
    release = threading.Event()

    def holder():
        with gate.acquire():
            release.wait(5)

    h = threading.Thread(target=holder)
    h.start()
    time.sleep(0.1)

    def waiter(i):
        with gate.acquire():
            order.append(i)

    threads = []
    for i in range(6):
        t = threading.Thread(target=waiter, args=(i,))
        t.start()
        time.sleep(0.05)
        threads.append(t)
    release.set()
    h.join()
    for t in threads:
        t.join()
    assert order == list(range(6))


def test_engine_gate_abandoned_waiter_does_not_wedge():
    """A waiter killed mid-wait releases its turn: later arrivals still get
    served."""
    gate = tsvc.EngineGate(max_queue=16)
    release = threading.Event()
    ran = []

    def holder():
        with gate.acquire():
            release.wait(5)

    h = threading.Thread(target=holder)
    h.start()
    time.sleep(0.1)
    with gate._cond:
        dead = gate._next_ticket
        gate._next_ticket += 1
        gate._abandoned.add(dead)

    def waiter():
        with gate.acquire():
            ran.append(True)

    w = threading.Thread(target=waiter)
    w.start()
    time.sleep(0.1)
    release.set()
    h.join()
    w.join(5)
    assert ran == [True]


def test_generator_runs_the_engine_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """`generate_magi_video(device="cpu")` launches the port's entry in a
    subprocess on a tiny config with random weights: it writes a video
    (an .mp4, or the .npz fallback without an encoder), and its log says
    the walk's first step came."""
    monkeypatch.setenv("SKIP_LOAD_MODEL", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tgen.generate_magi_video("a red cube", config_file=_tiny_json(tmp_path), output_dir=str(tmp_path / "out"),
                                   show_progress=False, timeout=300, device="cpu")
    assert out["success"], out.get("error", "") + out.get("stderr", "")
    assert os.path.getsize(out["output_path"]) > 0 and out["output_path"].startswith(str(tmp_path / "out"))
    assert any("first step" in line for _, line in out["log"])
    assert all(a <= b for (a, _), (b, _) in zip(out["log"], out["log"][1:]))
