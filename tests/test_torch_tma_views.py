"""`ops.attention.token_major_view`: the strides the single-source
attention kernels (K2, K2g) build their TMA tensor maps from, on CPU
tensors, so it runs without a card.  The views the model passes (the
VAE's q, k, v inside its fused qkv; the DiT's caption v inside kv_x) give
their own strides; layouts TMA cannot load raise."""

import pytest
import torch

from magi_tpu_torch.ops.attention import token_major_view
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def _aligned(n: int) -> torch.Tensor:
    """A bf16 buffer of n elements whose base is 16-byte aligned."""
    buf = torch.zeros(n + 8, dtype=torch.bfloat16)
    off = (-buf.data_ptr() % 16) // 2
    return buf[off : off + n]


def _vae_qkv(B=2, N=5, h=4, hd=64):
    qkv = _aligned(B * N * 3 * h * hd).view(B, N, 3, h, hd)
    return [qkv[:, :, i].reshape(B * N, h, hd) for i in range(3)], (B * N, h, hd)


def _dit_v(S=7, hk=2, hd=128):
    kv = _aligned(S * hk * 2 * hd).view(S, hk, 2 * hd)
    return kv[..., hd:], (S, hk, hd)


def test_contiguous_tensor():
    t = _aligned(6 * 3 * 128).view(6, 3, 128)
    assert token_major_view("f", "q", t, CPU, (6, 3, 128)) == (t.data_ptr(), 3 * 128, 128)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_vae_views_of_qkv(which):
    views, shape = _vae_qkv()
    t = views[which]
    assert not t.is_contiguous()
    ptr, s_t, s_h = token_major_view("f", "qkv", t, CPU, shape)
    assert (ptr, s_t, s_h) == (t.data_ptr(), 3 * 4 * 64, 64)
    assert ptr % 16 == 0


def test_dit_caption_v_view():
    t, shape = _dit_v()
    ptr, s_t, s_h = token_major_view("f", "v", t, CPU, shape)
    assert (s_t, s_h) == (2 * 2 * 128, 2 * 128)
    assert ptr == t.data_ptr() and ptr % 16 == 0


def test_single_head_and_single_token_strides_are_not_used():
    t = _aligned(4 * 2 * 64).view(4, 2, 64)[:, :1]  # one head, head stride 64 of a 2-head buffer
    assert token_major_view("f", "k", t, CPU, (4, 1, 64))[1:] == (128, 64)
    one = _aligned(2 * 64).view(1, 2, 64)
    assert token_major_view("f", "k", one, CPU, (1, 2, 64))[1:] == (128, 64)
    empty = torch.zeros((0, 2, 64), dtype=torch.bfloat16)
    assert token_major_view("f", "k", empty, CPU, (0, 2, 64))[0] == empty.data_ptr()


def _strided_last():
    return _aligned(5 * 2 * 128).view(5, 2, 128)[..., ::2]


def _misaligned_base():
    return _aligned(5 * 2 * 64 + 1)[1:].view(5, 2, 64)


def _odd_token_stride():
    return _aligned(5 * (2 * 64 + 4)).view(5, 2 * 64 + 4)[:, : 2 * 64].reshape(5, 2, 64)


@pytest.mark.parametrize("make,match", [
    (_strided_last, "16 bytes"),
    (_misaligned_base, "16 bytes"),
    (_odd_token_stride, "16 bytes"),
    (lambda: torch.zeros((5, 2, 64), dtype=torch.float32), "bfloat16"),
    (lambda: torch.zeros((5, 2, 32), dtype=torch.bfloat16), "shape"),
])
def test_layouts_tma_cannot_load_raise(make, match):
    t = make()
    with pytest.raises(ValueError, match=match):
        token_major_view("f", "k", t, CPU, (5, 2, 64))


def test_other_device_raises():
    t = torch.zeros((5, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="meta"):
        token_major_view("f", "k", t, torch.device("meta"), (5, 2, 64))
