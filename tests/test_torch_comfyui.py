"""The port's ComfyUI pack (`magi_tpu_torch.comfyui`) against the JAX
package's: the node protocol, the mappings and every node's inputs and
outputs equal the JAX pack's (the category names the port), and
`MagiProcess` overrides the config and dispatches the mode as the JAX node
does, with the pipeline mocked in both; the save node copies."""

import json

import pytest

from magi_tpu.comfyui import NODE_CLASS_MAPPINGS as JAX_NODES
from magi_tpu.comfyui import NODE_DISPLAY_NAME_MAPPINGS as JAX_NAMES
from magi_tpu_torch.comfyui import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_node_protocol():
    assert set(NODE_CLASS_MAPPINGS) == set(NODE_DISPLAY_NAME_MAPPINGS)
    for name, cls in NODE_CLASS_MAPPINGS.items():
        assert callable(cls.INPUT_TYPES)
        assert "required" in cls.INPUT_TYPES()
        assert isinstance(cls.RETURN_TYPES, tuple)
        assert hasattr(cls, cls.FUNCTION)
        assert cls.CATEGORY == "MAGI (PyTorch/CUDA)"


@pytest.mark.parametrize("name", sorted(JAX_NODES))
def test_nodes_match_the_jax_pack(name):
    """The same mappings, and each node's inputs, outputs, function and
    output flag as the JAX pack's node of that name."""
    assert sorted(NODE_CLASS_MAPPINGS) == sorted(JAX_NODES) and NODE_DISPLAY_NAME_MAPPINGS == JAX_NAMES
    ours, theirs = NODE_CLASS_MAPPINGS[name], JAX_NODES[name]
    assert ours.__name__ == theirs.__name__ == name
    assert ours.INPUT_TYPES() == theirs.INPUT_TYPES()
    for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "OUTPUT_NODE"):
        assert getattr(ours, attr, None) == getattr(theirs, attr, None), attr
    assert theirs.CATEGORY == "MAGI-TPU" != ours.CATEGORY


def test_prompt_and_path_loaders(tmp_path):
    assert NODE_CLASS_MAPPINGS["MagiPromptLoader"]().load("hello") == ("hello",)
    f = tmp_path / "x.png"
    f.write_bytes(b"x")
    assert NODE_CLASS_MAPPINGS["MagiImageLoader"]().load(str(f)) == (str(f),)
    assert NODE_CLASS_MAPPINGS["MagiVideoLoader"]().load(str(f)) == (str(f),)
    with pytest.raises(AssertionError, match="not found"):
        NODE_CLASS_MAPPINGS["MagiVideoLoader"]().load(str(tmp_path / "missing.mp4"))


def _fake_pipeline(calls: list, returns):
    class FakePipeline:
        def __init__(self, config_path):
            with open(config_path) as f:
                calls.append(("cfg", json.load(f)))

        def run_text_to_video(self, prompt, out):
            calls.append(("t2v", prompt, out))
            return returns(out)

        def run_image_to_video(self, prompt, image_path, out):
            calls.append(("i2v", prompt, image_path, out))
            return returns(out)

        def run_video_to_video(self, prompt, video_path, out):
            calls.append(("v2v", prompt, video_path, out))
            return returns(out)

    return FakePipeline


def test_process_overrides_and_dispatch_match_the_jax_node(monkeypatch, tmp_path):
    """Each mode through both nodes with their pipelines mocked: the same
    overridden config reaches the pipeline, the same entry point runs with
    the same arguments, and the node returns the path the pipeline wrote
    (`<out>.npz` where the card has no encoder)."""
    import magi_tpu.pipeline.pipeline as jax_pipeline
    import magi_tpu_torch.pipeline.pipeline as torch_pipeline

    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(jax_pipeline, "MagiPipeline", _fake_pipeline(calls["jax"], lambda out: None))
    monkeypatch.setattr(torch_pipeline, "MagiPipeline",
                        _fake_pipeline(calls["torch"], lambda out: {"path": out + ".npz"}))
    img = tmp_path / "x.png"
    img.write_bytes(b"\x89PNG")
    cases = [("t2v", dict(seed=77, video_size_h=480, video_size_w=480, num_frames=48, num_steps=8, fps=12)),
             ("i2v", dict(seed=1, video_size_h=256, video_size_w=320, num_frames=24, num_steps=4, fps=12,
                          image_path=str(img))),
             ("v2v", dict(seed=5, video_size_h=256, video_size_w=256, num_frames=96, num_steps=16, fps=24,
                          video_path=str(img)))]
    for mode, kw in cases:
        outs = {}
        for name, nodes in (("jax", JAX_NODES), ("torch", NODE_CLASS_MAPPINGS)):
            (outs[name],) = nodes["MagiProcess"]().process("a red cube", "example/4.5B/4.5B_base_config.json", mode,
                                                           **kw)
        assert outs["torch"] == outs["jax"] + ".npz" and outs["jax"].endswith(f"magi_comfy_{kw['seed']}.mp4")
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) == 6
    rc = calls["torch"][0][1]["runtime_config"]
    assert (rc["seed"], rc["video_size_h"], rc["video_size_w"], rc["num_frames"], rc["num_steps"], rc["fps"]) == (
        77, 480, 480, 48, 8, 12)
    assert [c[0] for c in calls["torch"][1::2]] == ["t2v", "i2v", "v2v"]


def test_save_video_node(tmp_path):
    src = tmp_path / "in.mp4"
    src.write_bytes(b"fakevideo")
    dst = tmp_path / "out.mp4"
    node = NODE_CLASS_MAPPINGS["MagiSaveVideo"]()
    assert node.save(str(src), str(dst)) == (str(dst),)
    assert dst.read_bytes() == b"fakevideo"
