"""The int4 kernels on a card against their plain versions: the W4A8
product and the int4 decode layer. This module imports no JAX (a machine
with a card need not have it); the suite's conftest and its xdist option
do, so run it there with

    python -m pytest -o addopts= --noconftest tests/test_torch_int4_cuda.py

Without a card every test skips. The layers and slabs are those of
``chip_smoke.py`` (seeded on the card), at the ``test`` preset's widths.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.ops import megakernel as tmk
from t5gemma_tts_tpu_torch.ops import quant as tquant

LAYERS = 2


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 5, 13, 16, 17, 64, 65, 129])
@pytest.mark.parametrize("k,n", [(2304, 1000), (2304, 1001), (9216, 1000)])
def test_cuda_w4a8_matches_plain(m, k, n):
    """The W4A8 kernel, on both routes (the GEMV at one row, the tensor
    cores above; N = 1001 odd, K = 9216 split over CTAs): its int32 part
    equal to the plain version's, outputs within 1 f32 ULP (bf16:
    equal)."""
    dev = _card()
    rng = np.random.default_rng(m)
    w = tquant.quantize_weight_int4_lanes(torch.from_numpy(
        (rng.standard_normal((k, n)) * 0.05).astype(np.float32)).to(dev))
    xi = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(
        np.float32)).to(dev)
    xi[:, 0] = 127
    unit = w._replace(scale=torch.ones_like(w.scale))
    assert torch.equal(tquant.w4a8_matmul(xi, unit),
                       tquant.w4a8_matmul_plain(xi, unit))
    x = torch.from_numpy((rng.standard_normal((m, k)) * 2).astype(
        np.float32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        before = tquant.w4a8_matmul.launches
        got = tquant.w4a8_matmul(xd, w)
        assert tquant.w4a8_matmul.launches == before + 1
        want = tquant.w4a8_matmul_plain(xd, w)
        if dtype == torch.float32:
            np.testing.assert_array_max_ulp(got.cpu().numpy(),
                                            want.cpu().numpy(), maxulp=1)
        else:
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_w4a8_refuses_unaligned_packed_rows():
    """K = 2320 packs a channel into 1160 bytes, no multiple of 16: the
    tensor-core route's TMA cannot read such rows, so the wrapper raises
    for M >= 2 (never falling back); one row takes the GEMV."""
    dev = _card()
    w = tquant.quantize_weight_int4_lanes(torch.from_numpy(
        (np.random.default_rng(5).standard_normal((2320, 64)) * 0.05)
        .astype(np.float32)).to(dev))
    x = torch.ones((2, 2320), device=dev)
    with pytest.raises(ValueError, match="refuses"):
        tquant.w4a8_matmul(x, w)
    assert torch.equal(tquant.w4a8_matmul(x[:1], w),
                       tquant.w4a8_matmul_plain(x[:1], w))


@pytest.mark.cuda
@pytest.mark.parametrize("b,quant", [(2, False), (1, True)])
def test_cuda_int4_decode_layer_matches_plain(b, quant):
    """The int4 decode layer against the plain version, every layer of a
    two-layer stack: relative Frobenius <= 5e-2 on h and 5e-3 on k/v (the
    int8 layer's bounds: sums in another order can flip an activation
    level); one decode_stack call is one launch."""
    dev = _card()
    smoke = _smoke()
    dims = dataclasses.replace(tconfig.backbone_preset("test").decoder,
                               num_layers=LAYERS, layer_types=())
    layers = smoke.random_quant_layers(dims, LAYERS, dev, seed=b, int4=True)
    assert isinstance(layers["mlp"]["down"], tquant.Int4Weight)
    args = smoke.decode_layer_inputs(
        dims, b, quant, prompt=37, gen_lens=[5, 0][:b], enc_lens=[9, 1][:b],
        gen_slab=256, device=dev, seed=10 + b, layers=LAYERS)
    for li in range(LAYERS):
        got = tmk.decode_layer(layers, dims, li=li, **args)
        want = tmk.decode_layer_plain(layers, dims, li=li, **args)
        for g, w, tol in zip(got, want, (5e-2, 5e-3, 5e-3)):
            assert smoke.rel_fro(g, w) <= tol
    before = tmk.decode_stack.launches
    tmk.decode_stack(layers, dims, **args)
    assert tmk.decode_stack.launches == before + 1
