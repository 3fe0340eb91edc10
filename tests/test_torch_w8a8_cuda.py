"""The W8A8 kernel on a card against its plain version, on both of its
routes: the GEMV of ``csrc/w8a8.cuh`` up to 16 rows, the tensor-core
product of ``csrc/w8a8_tc.cuh`` above (odd N, K split over CTAs, a K that
is a multiple of 16 but not of 32). This module imports no JAX (a machine
with a card need not have it; ``tests/test_torch_quant.py`` holds the same
product beside the JAX package), so run it there with

    python -m pytest -o addopts= --noconftest tests/test_torch_w8a8_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from t5gemma_tts_tpu_torch.ops import quant as tquant


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 5, 13, 16, 17, 64, 65, 129, 260])
@pytest.mark.parametrize("k,n", [(2304, 1000), (2304, 1001), (9216, 1000),
                                 (2320, 1001)])
def test_cuda_w8a8_tensor_cores_match_plain(m, k, n):
    """int32 part, int8 levels and scales equal to the plain version's,
    f32 outputs within 1 ULP, bf16 equal; one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(m)
    w = tquant.quantize_weight(torch.from_numpy(
        (rng.standard_normal((k, n)) * 0.05).astype(np.float32)).to(dev))
    xi = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(
        np.float32)).to(dev)
    xi[:, 0] = 127
    unit = w._replace(scale=torch.ones_like(w.scale))
    assert torch.equal(tquant.w8a8_matmul(xi, unit),
                       tquant.w8a8_matmul_plain(xi, unit))
    x = torch.from_numpy((rng.standard_normal((m, k)) * 2).astype(
        np.float32)).to(dev)
    x8, sx = tquant.quantize_act(x)
    w8, wsx = tquant.quantize_act_plain(x)
    assert torch.equal(x8, w8) and torch.equal(sx, wsx)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        before = tquant.w8a8_matmul.launches
        got = tquant.w8a8_matmul(xd, w)
        assert tquant.w8a8_matmul.launches == before + 1
        want = tquant.w8a8_matmul_plain(xd, w)
        if dtype == torch.float32:
            np.testing.assert_array_max_ulp(got.cpu().numpy(),
                                            want.cpu().numpy(), maxulp=1)
        else:
            assert torch.equal(got, want)
