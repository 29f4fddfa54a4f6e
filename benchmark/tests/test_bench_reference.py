"""The plain reference against the program on the CPU: the w8a8 tree of the
24B at toy widths (the bf16 tree's fp32 case is the harness tests' cell),
the VAE decoder, and the reference's own imports."""

import ast
import glob
import os
import time

import pytest
import torch

from benchmark import cells, harness, weights as W
from benchmark.reference import vae as ref_vae
from benchmark.tests import tiny

BENCH = os.path.join(tiny.REPO, "benchmark")


@pytest.fixture(scope="module")
def root24(tmp_path_factory):
    # a w8a8 tree's int8 rounding edges flip under f32-level differences, and
    # at toy widths one flip moves a chunk by some 1e-3 of its update: tau 1e-2
    return tiny.make_root(str(tmp_path_factory.mktemp("checkout24")), base="magi-24B-distill-w8a8", tau=1e-2)


@pytest.mark.parametrize("control", ["w4a8", "attn_int8"])
def test_w8a8_reference_agrees_and_its_control_does_not(root24, control):
    """The w8a8 reference (int8 worked out from the drawn weights and their
    smooth factors) meets the program's int8 tree up to values on an int8
    rounding edge; the program's w4a8 path, and its int8 attention on top of
    the w8a8 tree, lie well outside."""
    cell = cells.load("tiny.t2v", root24)
    runs = [harness.run(cell, 31337, 0.5, False, "cpu", time.perf_counter(), control=c) for c in (None, control)]
    sound, control = (r["checks"]["chunk_tail"]["value"] for r in runs)
    assert sound < 0.05
    assert control > 3 * sound and control > 0.5


def test_vae_reference_matches_the_program_decoder():
    from magi_tpu_torch.core.utils import nest
    from magi_tpu_torch.models.vae.model import VaeConfig, ViTVAE
    from magi_tpu_torch.pipeline.video_process import f32_cthw_to_u8_thwc

    vc = dict(tiny.TINY_VAE, patch_size=8, patch_length=4, in_chans=3, z_chans=16)
    flat = {lf.path[len("vae/"):]: (W.draw_stacked(lf, 5, "cpu", vc["depth"]) if lf.stacked else W.draw(lf, 5, "cpu"))
            for lf in W.vae_leaves(vc)}
    vae = ViTVAE(VaeConfig(**vc), nest(flat.items()), capture=False)
    z = torch.randn(16, 6, 4, 6, generator=torch.Generator().manual_seed(0))
    ref = ref_vae.decode_chunk(vc, 5, "cpu", z, 0.18215, 24)
    zz = z.to(torch.bfloat16)[None] / 0.18215
    prog = torch.cat([vae.decode(zz[:, :, a : a + 3]) for a in (0, 3)], dim=2)
    prog = f32_cthw_to_u8_thwc(prog[0].float().numpy())
    assert ref.shape == prog.shape == (24, 32, 48, 3)
    diff = torch.from_numpy(ref.astype(float) - prog.astype(float))
    assert float(diff.abs().max()) <= 2 and float(diff.abs().mean()) < 0.1
    int8 = ref_vae.decode_chunk(vc, 5, "cpu", z, 0.18215, 24, int8=True)
    assert float(torch.from_numpy(int8.astype(float) - ref.astype(float)).abs().mean()) > 0.1


FORBIDDEN = {"jax", "jaxlib", "flax", "magi_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
    assert len(files) > 10
    for path in files:
        found = set(_imports(path))
        assert not found & FORBIDDEN, (path, found & FORBIDDEN)
        if os.sep + "reference" + os.sep in path:
            assert "magi_tpu_torch" not in found, path
