"""The port's packed-int4 CUDA kernels against their plain PyTorch versions,
on the card. Skips where torch.cuda.is_available() is false. The file
imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

(tests/conftest.py imports JAX.) Tolerance: the kernel and its plain
version round at the same points and differ only in how the f32 sums are
taken; the conv's tensor cores do not round to nearest after every
addition. 2e-5 of the output's largest magnitude.
"""

import pytest
import torch

from tfmq_dm_tpu_torch.ops import int4_kernels as K
from tfmq_dm_tpu_torch.ops.nn import exact_f32

REL_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    exact_f32()
    return torch.device("cuda")


def _assert_close(got, ref):
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= REL_TOL * scale


def _weights(g, shape, n, dev):
    wp = K.pack_int4(torch.randint(-8, 8, shape + (n,), generator=g,
                                   dtype=torch.int8))
    d = torch.rand(n, generator=g) * 0.05 + 0.01
    z = torch.randint(-8, 8, (n,), generator=g).float()
    b = torch.randn(n, generator=g)
    return [t.to(dev) for t in (wp, d, z, b)]


@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (1, 512, 128),
                                   (13, 1100, 70)])
def test_cuda_int4_linear_matches_plain(cuda, m, k, n):
    g = torch.Generator().manual_seed(m)
    wp, d, z, b = _weights(g, (k,), n, cuda)
    x = torch.randn(m, k, generator=g).to(cuda)
    before = K.LAUNCHES["int4_linear"]
    got = K.int4_linear(x, wp, d, z, b)
    assert K.LAUNCHES["int4_linear"] == before + 1
    _assert_close(got, K.int4_linear_plain(x, wp, d, z, b))


@pytest.mark.parametrize("b,h,cin,n,kk,padding", [
    (8, 16, 256, 256, 3, "SAME"), (8, 16, 256, 256, 1, "VALID"),
    (2, 5, 20, 37, 3, "SAME")])
def test_cuda_int4_conv2d_matches_plain(cuda, b, h, cin, n, kk, padding):
    g = torch.Generator().manual_seed(cin)
    wp, d, z, bias = _weights(g, (kk * kk, cin), n, cuda)
    x = torch.randn(b, h, h, cin, generator=g).to(torch.bfloat16).to(cuda)
    before = K.LAUNCHES["int4_conv2d"]
    got = K.int4_conv2d(x, wp, d, z, kk, kk, bias, padding)
    assert K.LAUNCHES["int4_conv2d"] == before + 1
    _assert_close(got, K.int4_conv2d_plain(x, wp, d, z, kk, kk, bias,
                                           padding))


def test_cuda_wrappers_reject_bad_inputs(cuda):
    """The wrapper checks type, shape and contiguity before it launches."""
    g = torch.Generator().manual_seed(0)
    wp, d, z, b = _weights(g, (64,), 32, cuda)
    with pytest.raises(ValueError, match="x: expected"):
        K.int4_linear(torch.randn(4, 64, device=cuda).half(), wp, d, z, b)
    with pytest.raises(ValueError, match="w_packed: expected"):
        K.int4_linear(torch.randn(4, 64, device=cuda), wp[:, :8], d, z, b)
    x = torch.randn(1, 4, 4, 64, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="x: expected"):
        K.int4_conv2d(x.transpose(1, 2), wp.reshape(1, 64, 16), d, z, 1, 1)
